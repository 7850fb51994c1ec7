"""An open loop of bursts of single-image requests, as clients of an image
classifier send them, into the program's continuous batcher.

The schedule is fixed by the mix and the window's length, and the seed only
orders it: whole cycles of the burst sizes ``burst`` (each size once a
cycle), as many as bring the images nearest ``seconds * rate``, at gaps
that are the quantiles ``(i + 0.5) / n`` of an exponential law scaled to
fill the window, both shuffled by the seed. So every seed sends the same images
count over the same time. Each request is one pool image drawn by the seed.

A request is due at its burst's time and timed from then to its answer,
so a stall also delays what is due behind it. The generator's own lateness
(send time less due time) is kept. After the window every request is given
``answer_wait_s`` to be answered; one that fails or never comes is counted
failed and stands above every latency.

Readings: ``latencies_ms`` (one per request due in the window, inf where
unanswered), ``lag_s``, ``images``, ``window_s``, ``batcher`` (the
batcher's ``stats()``); in a traced run ``slice`` (a profiled second of
the same schedule after the window) and ``unit_ms``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench.port import front
from portbench.traffic import images

SCHEDULE_STREAM, SAMPLE_STREAM = 4, 5


def schedule(mix, seconds: float, rng):
    """(offsets in seconds from the window's start, burst sizes)."""
    lo, hi = mix["burst"]
    cycle = np.arange(lo, hi + 1)
    n = len(cycle) * max(1, int(round(seconds * mix["rate_img_per_s"] / cycle.sum())))
    sizes = rng.permutation(np.resize(cycle, n))
    gaps = rng.permutation(-np.log1p(-(np.arange(n) + 0.5) / n))
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]]), sizes


class _Requests:
    """Answers of the submitted requests, recorded as they complete."""

    def __init__(self, n: int, keep):
        self.done = np.full(n, np.nan)  # stays NaN for a request that failed or never came
        self.keep = {int(i): None for i in keep}
        self.count = 0
        self.cond = threading.Condition()

    def callback(self, i: int):
        def on_done(fut):
            t = time.perf_counter()
            if fut.exception() is None:
                self.done[i] = t
                if i in self.keep:
                    self.keep[i] = np.array(fut.result(), copy=True)
            with self.cond:
                self.count += 1
                self.cond.notify_all()

        return on_done

    def wait(self, n: int, deadline: float) -> None:
        with self.cond:
            self.cond.wait_for(lambda: self.count >= n, timeout=max(0.0, deadline - time.perf_counter()))


def setup(r):
    cfg, mix = r.cfg, r.mix
    side = cfg["image_size"]
    pool = images.make(mix["pool_images"], side, r.seed, images.POOL, r.device).to("cpu")
    r.pool_u8 = pool
    b = front.batcher(r.engine, r.device, side, mix["buckets"], mix["max_wait_ms"], mix["pipeline_depth"],
                      graphs=r.cuda)
    r.batcher = b
    pool_np = pool.numpy()
    warm = [b.submit(pool_np[i % len(pool_np)]) for i in range(2 * max(mix["buckets"]))]
    for f in warm:  # the served path end to end, each bucket's graph replayed
        f.result(timeout=120)
    if r.trace and r.cuda:
        r.slice.warm(lambda: b.submit(pool_np[0]).result(timeout=120))
        for stage in front.BATCHER_STAGES:
            r.spans.wrap(b, stage, stage.lstrip("_"))
    return pool_np


def window(r, pool_np, seconds: float, rate=None, slice_s: float = 0.0):
    """Send the schedule of ``seconds`` (then ``slice_s`` more, profiled)
    and wait for every answer. Returns the requests' answers, their due
    times, their pool images, how many were due in the window proper, and
    the lateness of its bursts."""
    mix = dict(r.mix) if rate is None else {**r.mix, "rate_img_per_s": rate}
    b = r.batcher
    rng = np.random.default_rng([r.seed % (1 << 63), SCHEDULE_STREAM])
    offs, sizes = schedule(mix, seconds, rng)
    n_win = int(sizes.sum())
    if slice_s:
        o2, s2 = schedule(mix, slice_s, rng)
        offs, sizes = np.concatenate([offs, seconds + o2]), np.concatenate([sizes, s2])
        first_slice = len(offs) - len(o2)
    n = int(sizes.sum())
    which = rng.integers(0, len(pool_np), n)
    keep = np.random.default_rng([r.seed % (1 << 63), SAMPLE_STREAM]).choice(
        n_win, size=min(mix["compare_requests"], n_win), replace=False)
    reqs = _Requests(n, keep)
    burst_of = np.repeat(np.arange(len(sizes)), sizes)
    lag = np.zeros(len(sizes))
    i = 0
    t0 = r.start_window() + 0.005
    for j, (off, size) in enumerate(zip(offs, sizes)):
        due = t0 + off
        if slice_s and j == first_slice:
            r.slice.start()
            k0 = b.batches_run
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        lag[j] = time.perf_counter() - due
        with r.spans.span("generator"):
            for _ in range(int(size)):
                b.submit(pool_np[which[i]]).add_done_callback(reqs.callback(i))
                i += 1
    if slice_s:
        r.readings["slice"] = r.slice.stop(units=b.batches_run - k0)
    reqs.wait(n, t0 + offs[-1] + mix["answer_wait_s"])
    due = t0 + offs[burst_of]
    return reqs, due, which, n_win, lag[: int(np.searchsorted(offs, seconds))]


def run(r) -> None:
    pool_np = setup(r)
    slice_s = r.mix["trace_slice_s"] if r.trace and r.cuda else 0.0
    reqs, due, which, n_win, lag = window(r, pool_np, r.seconds, slice_s=slice_s)
    lat = (reqs.done[:n_win] - due[:n_win]) * 1e3
    lat[~np.isfinite(lat)] = np.inf
    answered = np.isfinite(reqs.done[:n_win])
    r.readings.update(latencies_ms=lat, lag_s=lag, images=int(answered.sum()),
                      window_s=float(np.nanmax(reqs.done[:n_win]) - due[0]) if answered.any() else float("nan"),
                      batcher=r.batcher.stats())
    r.attempted, r.failed = n_win, int(n_win - answered.sum())
    kept = [(i, v) for i, v in reqs.keep.items() if v is not None]
    if kept:
        idx = np.array([i for i, _ in kept])
        r.samples = [(which[idx], np.stack([v for _, v in kept]))]
    r.window_closed()
    r.batcher.stop()
    if r.trace and r.cuda:
        x = torch.from_numpy(pool_np[: max(r.mix["buckets"])]).to(r.device)
        r.time_units(lambda: r.engine.run_u8(x), len(x))
