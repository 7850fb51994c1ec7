"""Multi-host continuous-batching serving (counterpart of
``quantized_tpu/engine/multihost.py``).

Every rank runs its own admission queue and drains it into its rows of one
SPMD forward over the mesh: :class:`HostShardedExecutor` gathers the rows of
the ranks of a model group, forwards them with the weights sharded over
``model`` and returns this rank's logits (``engine.executor.MeshEngine``
with ``local_rows``), one CUDA graph per bucket as ``IntExecutor`` keeps.

The distributed problem continuous batching adds is step agreement: every
rank must enter the same forward the same number of times at the same
bucket, while requests reach each rank on their own. ``MultiHostBatcher``
agrees on it with a count exchange before each step: the ranks all-gather
``[pending, done, failed]``, all run the bucket of the largest count (a
rank with fewer pads; padded rows never mix into real ones) and stop only
when every rank is stopped and drained, so no rank leaves a collective
hanging. The exchange runs on a gloo group of its own beside the NCCL one,
over host tensors, so the scheduler thread never waits on the card to
agree on a bucket.

Host-death bound: the count exchange and the SPMD step each run under a
``peer_timeout_s`` watchdog (default 60 s). When a peer dies, the
survivor's next exchange fails: gloo raises as soon as the peer's
connection closes, or the watchdog fires within ``peer_timeout_s``. The
step's requests and everything queued then fail, the batcher stops
(submits raise) and the process can exit instead of hanging. A wait
abandoned by the watchdog stays on a daemon thread. On the card, a forward
whose NCCL collective lost its peer blocks in the card's stream; NCCL's own
watchdog (``TORCH_NCCL_ASYNC_ERROR_HANDLING``, on by default) aborts the
communicator after the process group's timeout (10 minutes by default) and
ends the process. So a survivor sees its requests fail within
``peer_timeout_s`` and its process end at NCCL's timeout unless it exits
first; exit it with ``os._exit``, since the abandoned collective never
returns.

The batcher runs at pipeline depth 1 only, as the JAX package's
``serve_multihost`` does. Batches are assembled in the executor's lent
pinned slots (``ContinuousBatcher._assemble``).
"""

from __future__ import annotations

import datetime
import logging
import queue
import threading
import time
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from quantized_tpu_torch.engine.batching import ContinuousBatcher
from quantized_tpu_torch.engine.executor import IntExecutor
from quantized_tpu_torch.parallel.collectives import _ALL_GATHER
from quantized_tpu_torch.parallel.mesh import check_mesh

logger = logging.getLogger(__name__)


class HostShardedExecutor(IntExecutor):
    """SPMD forward fed by each rank's own rows: every rank passes its rows
    (one bucket's worth), the ranks of a model group forward their rows
    together with the weights sharded over ``model``, and each gets its own
    rows' logits. The batch of the whole mesh is the bucket times the world
    size, ordered by rank."""

    LOCAL_ROWS = True

    def __init__(self, model, mesh, ingest: str = "f32", device="cuda", graphs: bool = True, slots: int = 4,
                 check_finite: bool = False):
        super().__init__(model, mesh=mesh, ingest=ingest, device=device, graphs=graphs, slots=slots,
                         check_finite=check_finite)


def _on_device(executor) -> None:
    """Make the executor's GPU this thread's current device."""
    if getattr(executor, "cuda", False):
        torch.cuda.set_device(executor.device)


class MultiHostBatcher(ContinuousBatcher):
    """Per-rank continuous batcher over an SPMD executor.

    ``batch_sizes`` are per-rank buckets. The scheduler loop is the
    parent's, with two agreed points: the bucket before each step and the
    stop before shutdown (module docstring). ``peer_timeout_s`` bounds every
    wait on the other ranks. Build it on every rank together: it makes its
    gloo group then."""

    def __init__(self, *args, peer_timeout_s: float = 60.0, **kwargs):
        if kwargs.get("pipeline_depth", 1) != 1:
            raise ValueError("the multi-host batcher runs at pipeline depth 1")
        super().__init__(*args, **kwargs)
        self.peer_timeout_s = peer_timeout_s
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self._counts_group = None
        if dist.is_initialized():
            timeout = datetime.timedelta(seconds=peer_timeout_s if peer_timeout_s else 1800)
            self._counts_group = dist.new_group(backend="gloo", timeout=timeout)

    def _bounded(self, what: str, fn: Callable):
        """Run ``fn`` (a wait on the other ranks) under the peer-death
        watchdog: ``TimeoutError`` after ``peer_timeout_s`` instead of
        blocking on a dead peer. The abandoned call stays on a daemon
        thread."""
        if self.world == 1 or self.peer_timeout_s is None:
            return fn()
        box = {}
        done = threading.Event()

        def run():
            try:
                _on_device(self.executor)
                box["out"] = fn()
            except Exception as e:  # noqa: BLE001 - raised again below, on the scheduler thread
                box["err"] = e
            finally:
                done.set()

        threading.Thread(target=run, daemon=True, name=f"qtpu-{what}").start()
        if not done.wait(self.peer_timeout_s):
            raise TimeoutError(f"multihost {what} exceeded peer_timeout_s={self.peer_timeout_s}s: "
                               "assuming peer host death")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def _drain(self, limit):
        """Bounded drain: an empty queue returns ``[]`` after at most
        ``max(max_wait_s, 50 ms)``, so every rank reaches the count exchange
        on a fixed heartbeat (an idle rank that never reached it would stall
        every other rank's requests); once requests arrived it waits for more
        no longer than the parent does."""
        out = []
        start = time.perf_counter()
        heartbeat = start + max(self.max_wait_s, 0.05)
        while len(out) < limit:
            got = self._drain_batch(limit - len(out))
            if got:
                now = time.perf_counter()
                out.extend(r for r in got if not self._expired(r, now))
                continue
            timeout = (start + self.max_wait_s if out else heartbeat) - time.perf_counter()
            try:
                r = self._queue.get(timeout=max(timeout, 0.0005))
            except queue.Empty:
                break
            if not self._expired(r, time.perf_counter()):
                out.append(r)
        return out

    def _coordinate(self, n_local: int, done_local: bool, err_local: bool = False) -> Tuple[int, bool, bool]:
        """All-gather ``[pending, done, failed]`` over the gloo group: the
        largest count, whether every rank is done, whether any failed."""
        flags = torch.tensor([n_local, int(done_local), int(err_local)], dtype=torch.int32)
        if self._counts_group is None:
            table = flags.reshape(1, 3)
        else:
            out = torch.empty(self.world * 3, dtype=torch.int32)

            def exchange():
                _ALL_GATHER(out, flags, group=self._counts_group)
                return out

            table = self._bounded("count-allgather", exchange).reshape(self.world, 3)
        return int(table[:, 0].max()), bool(table[:, 1].min()), bool(table[:, 2].max())

    def _fail_all(self, reqs, exc) -> None:
        """A fatal failure of the serving loop: fail this step's requests and
        every queued one, so no client blocks forever, and stop."""
        for r in reqs:
            if not r.future.done():
                self._complete(r.future, exc=exc)
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if not r.future.done():
                self._complete(r.future, exc=exc)
        self._stop.set()

    def _forward(self, batch: np.ndarray) -> np.ndarray:
        start = getattr(self.executor, "dispatch", None)
        out = start(batch) if start is not None else self.executor(batch)
        return out.wait() if hasattr(out, "wait") else np.asarray(out)

    def _loop(self):
        _on_device(self.executor)
        err = None
        while True:
            reqs = self._drain(self.batch_sizes[-1])
            done_local = self._stop.is_set() and self._queue.empty() and not reqs
            try:
                n_global, done_all, err_any = self._coordinate(len(reqs), done_local, err_local=err is not None)
            except Exception as e:  # noqa: BLE001 - peer death or an aborted group: no collective can succeed
                logger.error("multihost coordination failed: %r; stopping", e)
                self._fail_all(reqs, RuntimeError(f"peer coordination failed: {e!r}"))
                break
            if err_any:
                # a rank's executor raised: going on would leave peers inside
                # the forward's collectives, so every rank stops
                self._fail_all(reqs, err or RuntimeError("peer host reported executor failure"))
                break
            if done_all:
                break
            if n_global == 0:
                continue
            self.steps += 1
            bucket = self._pick_bucket(n_global)
            batch = self._assemble(reqs, bucket)
            try:
                logits = self._bounded("spmd-step", lambda: self._forward(batch))
            except TimeoutError as e:
                logger.error("multihost SPMD step timed out: %r; stopping", e)
                self._fail_all(reqs, RuntimeError(f"peer died mid-step: {e!r}"))
                break
            except Exception as e:  # noqa: BLE001 - surfaced through the next exchange, so every rank stops
                err = e
                for r in reqs:
                    self._complete(r.future, exc=e)
                continue
            t_done = time.perf_counter()
            for i, r in enumerate(reqs):
                self._complete(r.future, result=logits[i])
                self.latencies_ms.append((t_done - r.t_submit) * 1e3)
            self.batches_run += 1
            self.requests_done += len(reqs)
            self.padded_slots += bucket - len(reqs)


def serve_multihost(model, mesh, batch_sizes: Sequence[int] = (1, 8, 32), input_shape=None, ingest: str = "f32",
                    peer_timeout_s: float = 60.0, graphs: bool = True, request_timeout_s=None,
                    check_finite: bool = False) -> MultiHostBatcher:
    """Bring up this rank's share of the serving engine: a started
    :class:`MultiHostBatcher` whose ``submit`` admits this rank's requests,
    its buckets warmed (and captured) on every rank together. Call it on
    every rank of the mesh with the same model, buckets and input shape.
    The device is the rank's device of the mesh; ``graphs``,
    ``request_timeout_s`` and ``check_finite`` are the single-device
    server's."""
    if input_shape is None:
        size = getattr(model, "input_size", 224)
        input_shape = (size, size, 3)
    ex = HostShardedExecutor(model, mesh, ingest=ingest, device=check_mesh(mesh).device_type, graphs=graphs,
                             check_finite=check_finite)
    dtype = np.uint8 if ingest == "u8" else np.float32
    batcher = MultiHostBatcher(ex, input_shape, batch_sizes, dtype=dtype, peer_timeout_s=peer_timeout_s,
                               request_timeout_s=request_timeout_s)
    batcher.warmup()
    logger.info("multihost server up: %d ranks, buckets=%s input=%s", batcher.world, tuple(batch_sizes),
                input_shape)
    return batcher.start()
