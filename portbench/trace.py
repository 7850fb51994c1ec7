"""The traced run's instruments: host spans around the harness's calls into
the program, a profiled slice of the device's timeline, and device times of
the units of work in one eager forward.

- :class:`Spans` records (name, start, end) on the host clock, from any
  thread, in memory; nothing is written to disk.
- :class:`Slice` profiles a short stretch of a running window with
  ``torch.profiler`` (CUPTI). The device is busy where a kernel, copy or
  set ran: the union of those intervals, so that work which overlaps is
  counted once. Idle stretches are labelled by the harness spans open at
  their midpoint.
- :class:`GcPauses` records the pauses of Python's cyclic garbage
  collector, which stop every thread of the process.
- :func:`unit_times` times each unit (a residual block, a depthwise/pointwise
  pair) between CUDA events recorded by hooks at its start and end, with
  the device held by a sleep until the host has enqueued the whole
  forward, so no host time falls between the events.
"""

from __future__ import annotations

import statistics
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

MARK = "portbench.mark"


class Spans:
    """Host spans of the harness; ``span(name)`` is a context manager, and
    ``wrap(obj, attr, name)`` records every call of a bound method."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.items: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: int, t1: int) -> None:
        if self.enabled:
            with self._lock:
                self.items.append((name, t0, t1))

    def span(self, name: str):
        return _Span(self, name)

    def wrap(self, obj, attr: str, name: str) -> None:
        if not self.enabled:
            return
        inner = getattr(obj, attr)

        def call(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return inner(*args, **kwargs)
            finally:
                self.add(name, t0, time.perf_counter_ns())

        setattr(obj, attr, call)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.spans.add(self.name, self.t0, time.perf_counter_ns())
        return False


class GcPauses:
    """Seconds the cyclic garbage collector ran between ``start`` and ``stop``."""

    def __init__(self):
        self.pauses: List[Tuple[int, float]] = []
        self._t = 0.0

    def _callback(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((info["generation"], time.perf_counter() - self._t))

    def start(self) -> "GcPauses":
        import gc

        self._t0 = time.perf_counter()
        gc.callbacks.append(self._callback)
        return self

    def stop(self) -> dict:
        import gc

        gc.callbacks.remove(self._callback)
        return {"elapsed_s": time.perf_counter() - self._t0, "pause_s": sum(d for _, d in self.pauses),
                "pauses": len(self.pauses), "max_s": max((d for _, d in self.pauses), default=0.0),
                "gen2_pauses": sum(1 for g, _ in self.pauses if g == 2)}


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge overlapping or touching intervals; sorted, disjoint."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_and_gaps(intervals: List[Tuple[int, int]], w0: int, w1: int):
    """Busy nanoseconds of ``intervals`` clipped to [w0, w1], and the idle
    gaps between them there."""
    clipped = [(max(a, w0), min(b, w1)) for a, b in intervals if b > w0 and a < w1]
    merged = union(clipped)
    busy = sum(b - a for a, b in merged)
    gaps, t = [], w0
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return busy, gaps


def label_gaps(gaps: List[Tuple[int, int]], spans: List[Tuple[str, int, int]], limit: int = 5000):
    """Idle seconds and gap counts by the host spans open at each gap's
    midpoint (``"no span"`` where none was), over the ``limit`` longest gaps
    and the rest as ``"short gaps"``."""
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    if spans:
        names = np.array([s[0] for s in spans])
        starts = np.array([s[1] for s in spans], dtype=np.int64)
        ends = np.array([s[2] for s in spans], dtype=np.int64)
    for a, b in gaps[:limit]:
        mid = (a + b) // 2
        label = "no span"
        if spans:
            open_ = names[(starts <= mid) & (ends >= mid)]
            if len(open_):
                label = "+".join(sorted(set(open_.tolist())))
        out[label][0] += (b - a) / 1e9
        out[label][1] += 1
    rest = gaps[limit:]
    if rest:
        out["short gaps"][0] += sum(b - a for a, b in rest) / 1e9
        out["short gaps"][1] += len(rest)
    return out


class Slice:
    """A profiled stretch of a running window (see the module docstring)."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None

    @staticmethod
    def _profiler():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def warm(self, fn) -> None:
        """Bring the profiler up once in set-up, around ``fn()``, so that
        starting it inside a window costs no start-up."""
        with self._profiler():
            fn()
            torch.cuda.synchronize()

    def start(self) -> None:
        self.prof = self._profiler()
        self.prof.start()
        self._host0 = time.perf_counter_ns()
        with torch.profiler.record_function(MARK):
            pass

    def stop(self, units: int) -> dict:
        """Stop profiling; ``units`` is the work the window dispatched in
        the slice (batches). Returns the reading."""
        host1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == MARK)
        offset = mark.start_ns() - self._host0
        w0, w1 = self._host0 + offset, host1 + offset
        dev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0]
        busy, gaps = busy_and_gaps([(a, b) for _, a, b in dev], w0, w1)
        by_name: Dict[str, float] = defaultdict(float)
        for name, a, b in dev:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                by_name[name] += (b - a) / 1e9
        spans = [(n, a + offset, b + offset) for n, a, b in self.spans.items]
        labelled = label_gaps(gaps, spans)
        reading = {
            "window_s": (w1 - w0) / 1e9,
            "busy_s": busy / 1e9,
            "units": units,
            "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([f"{k} ({int(n)} gaps)", s] for k, (s, n) in labelled.items()),
                                key=lambda kv: -kv[1])[:10],
        }
        self.prof = None
        return reading


def unit_times(forward, hook_units, engine, repeats: int = 3) -> Dict[str, float]:
    """Device milliseconds of each unit of ``forward()`` (an eager forward
    of ``engine``), the median of ``repeats`` forwards."""
    times: Dict[str, List[float]] = defaultdict(list)
    forward()
    torch.cuda.synchronize()
    t = time.perf_counter()
    forward()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    cycles = 1 << 22
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = cycles / start.elapsed_time(end)
    for _ in range(repeats):
        events: Dict[str, List[torch.cuda.Event]] = defaultdict(lambda: [None, None])

        def record(name: str, which: int) -> None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][which] = ev

        handles = hook_units(engine, record)
        try:
            torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 1.0)))
            forward()
            torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
        for name, (a, b) in events.items():
            times[name].append(a.elapsed_time(b))
    return {name: statistics.median(v) for name, v in times.items()}
