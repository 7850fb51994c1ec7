"""Continuous request batching (counterpart of
``quantized_tpu/engine/batching.py``).

CNN serving has no KV cache and fixed shapes, but bucketing must be designed
in: requests are admitted to a queue, and the scheduler drains it into the
smallest batch bucket that covers the pending set (padding the tail), so
the executor sees exactly ``len(batch_sizes)`` input shapes. With the
port's :class:`~quantized_tpu_torch.engine.executor.IntExecutor` that is one
CUDA graph per bucket, captured at ``warmup``.

Metrics: per-request latency (admission -> result), batch occupancy,
throughput counters and per-stage host time, as JSON-able dicts.

Failure recovery: the engine's weights do not change while it serves, so
recovering from a crash means replaying the requests not yet answered.
``RequestLog`` journals every admitted request (a JSONL index and a raw
payload sidecar) and ``replay_request_log`` submits them again; each
request's result depends on its image alone (padded rows never mix), so a
replay reproduces the original outputs.

The executor may offer ``dispatch(batch)``, which starts a batch and returns
a handle whose ``wait()`` gives its logits as a numpy array: the batch's
copy to the host starts at dispatch, and resolving it waits on that batch
alone (a CUDA event, never a device-wide synchronize), so a device error
fails only that batch's requests. It may also offer ``input_slot(shape,
dtype)``, which lends a (pinned) array that the batch is assembled in and
then dispatched from, so each request's rows are copied once on the host. A plain callable returning an array (or
anything ``np.asarray`` takes) works too. This module itself imports only
numpy: its threads never touch CUDA; the executor does that.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class _Request:
    rid: int
    image: np.ndarray
    future: Future
    t_submit: float


class RequestLog:
    """Append-only request journal: ``path.jsonl`` (rid, offset, shape,
    dtype, ts) + ``path.bin`` (raw image bytes). Thread-safe; fsync on every
    append so a crash loses at most the in-flight write."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._idx = open(path + ".jsonl", "ab")
        self._bin = open(path + ".bin", "ab")
        self._lock = threading.Lock()

    def append(self, rid: int, image: np.ndarray) -> None:
        raw = np.ascontiguousarray(image).tobytes()
        with self._lock:
            off = self._bin.tell()
            self._bin.write(raw)
            self._idx.write((json.dumps({
                "rid": rid, "offset": off, "nbytes": len(raw),
                "shape": list(image.shape), "dtype": str(image.dtype),
                "ts": time.time(),
            }) + "\n").encode())
            self._bin.flush()
            self._idx.flush()
            os.fsync(self._bin.fileno())
            os.fsync(self._idx.fileno())

    def close(self) -> None:
        with self._lock:
            self._idx.close()
            self._bin.close()

    @staticmethod
    def read(path: str) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (rid, image) in journal order; tolerates a truncated tail
        (crash mid-append)."""
        with open(path + ".bin", "rb") as b:
            raw = b.read()
        with open(path + ".jsonl", "rb") as f:
            for line in f:
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    break  # truncated tail
                end = e["offset"] + e["nbytes"]
                if end > len(raw):
                    break
                img = np.frombuffer(raw[e["offset"]:end], dtype=e["dtype"]).reshape(e["shape"])
                yield e["rid"], img


def replay_request_log(path: str, batcher: "ContinuousBatcher") -> Dict[int, Future]:
    """Re-submit every journaled request to a (fresh) batcher. Returns
    {original_rid: Future}; results equal the pre-crash responses because
    per-request outputs are batch-independent."""
    futures: Dict[int, Future] = {}
    for rid, img in RequestLog.read(path):
        futures[rid] = batcher.submit(img)
    return futures


class ContinuousBatcher:
    """Drains an admission queue into padded fixed-size batches.

    executor: callable (batch NHWC) -> logits, or an object with
    ``dispatch`` (see the module docstring); one input shape per bucket
    (``warmup()`` runs each once, which captures the executor's graphs).
    """

    def __init__(
        self,
        executor: Callable[[np.ndarray], np.ndarray],
        input_shape: Tuple[int, int, int],
        batch_sizes: Sequence[int] = (1, 8, 32),
        max_wait_ms: float = 2.0,
        max_queue: int = 4096,
        request_log: Optional[str] = None,
        dtype=np.float32,
        pipeline_depth: int = 1,
        pad_workers: int = 4,
        request_timeout_s: Optional[float] = None,
    ):
        """``pipeline_depth``: number of batches allowed in flight before the
        scheduler blocks on results. Depth 2 uses the executor's asynchronous
        dispatch: batch k+1 is drained, padded and dispatched while batch k
        executes, hiding the dispatch and host-side assembly behind device
        compute (each batch's wait on its own result is the only forced
        sync). Depth 1 = dispatch-resolve-dispatch, minimizing latency for
        sparse traffic.

        Depth >= 2 additionally splits the scheduler into two stages
        (assembler thread: drain+pad; dispatcher thread: execute+resolve), so
        the pad memcpy of batch k+1 runs concurrently with the dispatch of
        batch k: the per-batch host cost becomes max(pad, dispatch) instead
        of their sum (``stats()`` reports both stages).

        ``pad_workers``: threads for the pad memcpy of large buckets (numpy
        row copies release the GIL); 0 = single-threaded assembly.

        ``request_timeout_s``: serving SLA — a request still queued this many
        seconds after admission fails fast with ``TimeoutError`` instead of
        riding an overloaded queue (checked at drain time; in-flight batches
        always complete). ``None`` (default) = no deadline."""
        self.executor = executor
        self.request_log = RequestLog(request_log) if request_log else None
        self.input_shape = tuple(input_shape)
        self.dtype = np.dtype(dtype)  # float32, or uint8 for the fused-ingest path
        self.batch_sizes = tuple(sorted(set(batch_sizes)))
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.max_wait_s = max_wait_ms / 1e3
        self.request_timeout_s = request_timeout_s
        self.requests_timed_out = 0
        self.pad_workers = max(0, int(pad_workers))
        self._pad_pool = (
            ThreadPoolExecutor(self.pad_workers, thread_name_prefix="qtpu-pad")
            if self.pad_workers > 1
            else None
        )
        self._queue: "queue.Queue[_Request]" = queue.Queue(max_queue)
        self._shed_q: "deque" = deque()
        self._shed_thread: Optional[threading.Thread] = None
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.latencies_ms: List[float] = []
        self.batches_run = 0
        self.requests_done = 0
        self.padded_slots = 0
        self.steps = 0
        # per-stage host-cost accounting (seconds, cumulative over batches):
        # drain (queue wait incl. max_wait), assemble (pad memcpy), dispatch
        # (executor call + async copy start), resolve (forced result fetch).
        # Two perf_counter calls per batch per stage — negligible; stats()
        # reports per-batch means so capacity gaps are attributable.
        self.stage_s = {"drain": 0.0, "assemble": 0.0, "dispatch": 0.0, "resolve": 0.0}

    # ------------------------------------------------------------- lifecycle
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        # Only retire the pad pool once the scheduler has actually exited: if
        # the join timed out (wedged executor) the assembler may still be
        # mid-_assemble, and shutting the pool under it would raise
        # "cannot schedule new futures after shutdown" and strand that batch.
        # (_assemble also falls back to the serial copy loop on that error.)
        if self._pad_pool is not None and (self._thread is None or not self._thread.is_alive()):
            self._pad_pool.shutdown(wait=False)
        # Close the stop/submit race: a submit() that passed the _stop check
        # just before stop() can enqueue after the scheduler's final
        # _queue.empty() evaluation — fail any stragglers so no client blocks
        # forever on an unresolved future.
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            self._complete(r.future, exc=RuntimeError("batcher stopped"))
        # drain any shed completions the shedder thread has not delivered yet
        if self._shed_thread is not None:
            self._shed_thread.join(timeout=10)
        while True:
            try:
                r, waited = self._shed_q.popleft()
            except IndexError:
                break
            self._complete(r.future, exc=TimeoutError(
                f"request {r.rid} queued {waited:.3f}s > "
                f"request_timeout_s={self.request_timeout_s}"))
        if self.request_log is not None:
            self.request_log.close()

    def warmup(self):
        """Precompile every bucket (one dummy batch each)."""
        for b in self.batch_sizes:
            self.executor(np.zeros((b, *self.input_shape), self.dtype))
        return self

    # ------------------------------------------------------------- client API
    def submit(self, image: np.ndarray) -> Future:
        if self._stop.is_set():
            raise RuntimeError("batcher is stopped")
        if tuple(image.shape) != self.input_shape:
            raise ValueError(f"expected image shape {self.input_shape}, got {image.shape}")
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        img = np.asarray(image, self.dtype)
        if self.request_log is not None:
            self.request_log.append(rid, img)
        fut: Future = Future()
        self._queue.put(_Request(rid, img, fut, time.perf_counter()))
        return fut

    # ------------------------------------------------------------- scheduler
    def _expired(self, r: _Request, now: float) -> bool:
        """SLA check at drain time: fail a request that outlived its deadline
        in the queue (in-flight batches always complete).

        The TimeoutError delivery is handed to a dedicated shedder thread:
        completing a future (set_exception + client callbacks) costs tens of
        microseconds of Python, and at heavy overload the drain discards
        thousands of expired requests per batch; done inline, that can
        starve the dispatch path into a livelock."""
        if self.request_timeout_s is None or now - r.t_submit <= self.request_timeout_s:
            return False
        self.requests_timed_out += 1
        self._shed_q.append((r, now - r.t_submit))
        if self._shed_thread is None or not self._shed_thread.is_alive():
            self._shed_thread = threading.Thread(
                target=self._shed_loop, daemon=True, name="qtpu-shed")
            self._shed_thread.start()
        return True

    def _shed_loop(self):
        """Deliver TimeoutErrors for shed requests off the scheduler thread."""
        while True:
            try:
                r, waited = self._shed_q.popleft()
            except IndexError:
                if self._stop.is_set():
                    return
                time.sleep(0.002)
                continue
            self._complete(r.future, exc=TimeoutError(
                f"request {r.rid} queued {waited:.3f}s > "
                f"request_timeout_s={self.request_timeout_s}"))

    def _drain_batch(self, limit: int) -> List[_Request]:
        """Pop up to ``limit`` queued requests under ONE mutex acquisition.

        The per-item ``queue.get`` path pays a lock acquisition and GIL
        churn per request, which at large buckets saturates the assembler
        stage. Batch-popping on the Queue's own mutex/deque amortizes that to one
        acquisition per batch while preserving every external Queue
        semantic (blocking put with maxsize, get timeouts, stop drain)."""
        q = self._queue
        with q.mutex:
            n = min(limit, len(q.queue))
            items = [q.queue.popleft() for _ in range(n)]
            if n:
                q.not_full.notify(n)
        return items

    def _drain(self, limit: int) -> List[_Request]:
        out: List[_Request] = []
        deadline = time.perf_counter() + self.max_wait_s
        while len(out) < limit:
            got = self._drain_batch(limit - len(out))
            if got:
                now = time.perf_counter()
                out.extend(r for r in got if not self._expired(r, now))
                continue
            # queue momentarily empty: block for the first arrival / deadline
            timeout = deadline - time.perf_counter()
            try:
                r = self._queue.get(timeout=max(timeout, 0.0005) if out else 0.05)
            except queue.Empty:
                if out or self._stop.is_set():
                    break
                continue
            if not self._expired(r, time.perf_counter()):
                out.append(r)
        return out

    def _pick_bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    @staticmethod
    def _complete(fut: Future, *, result=None, exc=None) -> bool:
        """Complete a future, tolerating client-side cancel() — without this
        an InvalidStateError would kill the scheduler/dispatcher thread and
        deadlock the assembler on the bounded dispatch queue."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
            return True
        except InvalidStateError:  # cancelled by the client
            return False

    def _resolve(self, entry) -> None:
        """Wait for one in-flight batch's results and complete its futures.
        With asynchronous dispatch, device and transfer errors surface here,
        not at the executor call: fail just this batch's requests."""
        t0 = time.perf_counter()
        reqs, bucket, out = entry
        try:
            logits = out.wait() if hasattr(out, "wait") else np.asarray(out)
        except Exception as e:  # noqa: BLE001 - a device or transfer error fails this batch only
            for r in reqs:
                self._complete(r.future, exc=e)
            return
        t_done = time.perf_counter()
        for i, r in enumerate(reqs):
            self._complete(r.future, result=logits[i])
            self.latencies_ms.append((t_done - r.t_submit) * 1e3)
        self.batches_run += 1
        self.requests_done += len(reqs)
        self.padded_slots += bucket - len(reqs)
        self.stage_s["resolve"] += time.perf_counter() - t0

    def _assemble(self, reqs: List[_Request], bucket: int) -> np.ndarray:
        """Pad ``reqs`` into a ``bucket``-row batch: straight into the
        executor's pinned input slot where it lends one (``input_slot``),
        its padded tail zeroed, else into ``np.zeros`` (calloc: the padded
        tail stays on the kernel's shared zero page; only copied rows fault
        in). Large buckets split the row memcpys over the pad pool (numpy
        array copies release the GIL)."""
        t0 = time.perf_counter()
        shape = (bucket, *self.input_shape)
        lend = getattr(self.executor, "input_slot", None)
        batch = lend(shape, self.dtype) if lend is not None else None
        n = len(reqs)
        if batch is None:
            batch = np.zeros(shape, self.dtype)
        else:
            batch[n:] = 0
        if self._pad_pool is not None and n >= 8 * self.pad_workers:
            chunk = -(-n // self.pad_workers)

            def copy_rows(lo: int) -> None:
                hi = min(lo + chunk, n)
                for i in range(lo, hi):
                    batch[i] = reqs[i].image

            try:
                list(self._pad_pool.map(copy_rows, range(0, n, chunk)))
            except RuntimeError:
                # pool shut down under us (stop() after a timed-out join):
                # finish this batch serially rather than stranding its futures
                for i, r in enumerate(reqs):
                    batch[i] = r.image
        else:
            for i, r in enumerate(reqs):
                batch[i] = r.image
        self.stage_s["assemble"] += time.perf_counter() - t0
        return batch

    def _dispatch(self, reqs: List[_Request], batch: np.ndarray):
        """Execute one padded batch; returns the in-flight entry or None on
        executor failure (those requests are failed here). An executor with
        ``dispatch`` starts the batch and its result copy to the host and
        returns at once; by the time the batch reaches ``_resolve`` its
        logits are usually on the host already."""
        t0 = time.perf_counter()
        try:
            start = getattr(self.executor, "dispatch", None)
            out = start(batch) if start is not None else self.executor(batch)
        except Exception as e:  # noqa: BLE001 - an executor failure fails this batch only
            for r in reqs:
                self._complete(r.future, exc=e)
            return None
        self.stage_s["dispatch"] += time.perf_counter() - t0
        return (reqs, len(batch), out)

    def _loop(self):
        if self.pipeline_depth > 1:
            return self._loop_pipelined()
        # depth 1: dispatch-resolve-dispatch, minimal latency for sparse traffic
        while not self._stop.is_set() or not self._queue.empty():
            t0 = time.perf_counter()
            reqs = self._drain(self.batch_sizes[-1])
            if not reqs:
                continue
            self.stage_s["drain"] += time.perf_counter() - t0
            self.steps += 1
            entry = self._dispatch(reqs, self._assemble(reqs, self._pick_bucket(len(reqs))))
            if entry is not None:
                self._resolve(entry)

    def _loop_pipelined(self):
        """Two-stage scheduler (depth >= 2): this thread assembles (drain +
        pad) while a dispatcher thread executes and resolves, so per-batch
        host cost is max(pad, dispatch) instead of pad + dispatch, and both
        overlap device compute. The dispatch queue bounds run-ahead; a
        ``None`` sentinel shuts the dispatcher down after a final flush."""
        from collections import deque

        dq: "queue.Queue" = queue.Queue(maxsize=2)

        def dispatcher():
            inflight: "deque" = deque()
            while True:
                try:
                    item = dq.get(timeout=0.005 if inflight else 0.2)
                except queue.Empty:
                    # traffic lull: flush pending results so nothing strands
                    while inflight:
                        self._resolve(inflight.popleft())
                    continue
                if item is None:
                    while inflight:
                        self._resolve(inflight.popleft())
                    return
                entry = self._dispatch(*item)
                if entry is not None:
                    inflight.append(entry)
                while len(inflight) >= self.pipeline_depth:
                    self._resolve(inflight.popleft())

        disp = threading.Thread(target=dispatcher, daemon=True, name="qtpu-dispatch")
        disp.start()
        try:
            while not self._stop.is_set() or not self._queue.empty():
                t0 = time.perf_counter()
                reqs = self._drain(self.batch_sizes[-1])
                if not reqs:
                    continue
                self.stage_s["drain"] += time.perf_counter() - t0
                self.steps += 1
                dq.put((reqs, self._assemble(reqs, self._pick_bucket(len(reqs)))))
        finally:
            dq.put(None)
            disp.join(timeout=30)

    # ------------------------------------------------------------- metrics
    def stats(self) -> Dict[str, float]:
        lat = np.asarray(self.latencies_ms) if self.latencies_ms else np.zeros(1)
        total = self.requests_done + self.padded_slots
        nb = max(self.batches_run, 1)
        return {
            "requests": self.requests_done,
            "batches": self.batches_run,
            "timed_out": self.requests_timed_out,
            "occupancy": self.requests_done / max(total, 1),
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p95_ms": float(np.percentile(lat, 95)),
            "latency_p99_ms": float(np.percentile(lat, 99)),
            # per-batch host-side stage means (ms): where scheduler time goes
            **{f"stage_{k}_ms": v * 1e3 / nb for k, v in self.stage_s.items()},
        }
