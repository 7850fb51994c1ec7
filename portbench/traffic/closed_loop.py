"""A closed loop of fixed-size batches, as offline scoring of an image set
sends them.

The pool holds ``pool_batches`` distinct batches of seeded images in pinned
host memory; batch k of the window is pool batch ``k % pool_batches``. Each
goes through the executor's ``dispatch`` (its copy to a pinned slot, the
host-to-device copy, the graph's replay, the logits' copy back), with up
to ``in_flight`` batches dispatched and each waited for in order. The
window runs until ``--seconds`` have passed since its first dispatch, then
waits for what is in flight: its length ends at the last batch's logits on
the host, and every batch dispatched counts.

Readings: ``images``, ``window_s``, ``dispatch_s`` (host seconds of each
``dispatch`` call), ``batches``; in a traced run ``slice`` (a profiled
second of the same loop after the window) and ``unit_ms``.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from portbench.port import front
from portbench.traffic import images

SAMPLE_STREAM = 5


class _Loop:
    def __init__(self, ex, batches, in_flight: int, spans, keep: int, rng):
        self.ex, self.batches, self.in_flight, self.spans = ex, batches, in_flight, spans
        self.q = deque()
        self.k = 0
        self.dispatch_s = []
        self.failed = 0
        self.keep, self.rng = keep, rng
        self.samples = []  # reservoir of (pool batch, logits) over every batch of the window
        self.t_last = None

    def dispatch(self) -> None:
        p = self.k % len(self.batches)
        t = time.perf_counter()
        with self.spans.span("dispatch"):
            h = self.ex.dispatch(self.batches[p])
        self.dispatch_s.append(time.perf_counter() - t)
        self.q.append((self.k, p, h))
        self.k += 1

    def finish_one(self, sample: bool) -> None:
        k, p, h = self.q.popleft()
        try:
            with self.spans.span("wait"):
                logits = h.wait()
        except Exception:  # noqa: BLE001 - a batch the program failed counts as failed, the run goes on
            self.failed += len(self.batches[p])
            return
        finally:
            self.t_last = time.perf_counter()
        if not sample:
            return
        if len(self.samples) < self.keep:
            self.samples.append((p, logits))
        else:
            j = int(self.rng.integers(0, k + 1))
            if j < self.keep:
                self.samples[j] = (p, logits)

    def run_until(self, deadline: float, sample: bool = True) -> None:
        while time.perf_counter() < deadline:
            self.dispatch()
            if len(self.q) >= self.in_flight:
                self.finish_one(sample)

    def drain(self, sample: bool = True) -> float:
        while self.q:
            self.finish_one(sample)
        return self.t_last


def run(r) -> None:
    cfg, mix = r.cfg, r.mix
    side, batch, n_pool = cfg["image_size"], mix["batch"], mix["pool_batches"]
    pool = images.make(n_pool * batch, side, r.seed, images.POOL, r.device).view(n_pool, batch, side, side, 3)
    host = pool.to("cpu")
    del pool
    if r.cuda:
        host = host.pin_memory()
    r.pool_u8 = host.view(n_pool * batch, side, side, 3)
    batches = [host[p].numpy() for p in range(n_pool)]
    ex = front.executor(r.engine, r.device, slots=mix["in_flight"] + 1, graphs=r.cuda)
    r.executor = ex
    for b in batches:  # captures the graph and warms every slot
        ex.dispatch(b).wait()
    if r.trace and r.cuda:
        r.slice.warm(lambda: ex.dispatch(batches[0]).wait())
    rng = np.random.default_rng([r.seed % (1 << 63), SAMPLE_STREAM])
    loop = _Loop(ex, batches, mix["in_flight"], r.spans, mix["compare_batches"], rng)

    t0 = r.start_window()
    loop.run_until(t0 + r.seconds)
    t_end = loop.drain()
    r.readings.update(images=loop.k * batch, window_s=t_end - t0, dispatch_s=loop.dispatch_s, batches=loop.k)
    r.attempted, r.failed = loop.k * batch, loop.failed
    r.samples = [(np.arange(p * batch, (p + 1) * batch), logits) for p, logits in loop.samples]
    r.window_closed()

    if r.trace and r.cuda:
        tail = _Loop(ex, batches, mix["in_flight"], r.spans, 0, rng)
        tail.run_until(time.perf_counter() + 0.2, sample=False)
        r.slice.start()
        k0 = tail.k
        tail.run_until(time.perf_counter() + mix["trace_slice_s"], sample=False)
        r.readings["slice"] = r.slice.stop(units=tail.k - k0)
        tail.drain(sample=False)
        x = torch.from_numpy(batches[0]).to(r.device)
        r.time_units(lambda: r.engine.run_u8(x), batch)
