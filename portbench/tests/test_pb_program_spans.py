"""The program's spans beside the device's timeline
(``portbench/program_spans.py``): starved, queued and unseen idle gaps on
synthetic profiler events, the refusal to read where launches go
unmatched, the executor's phases a batch; and the harness's existing
readers and breakdown unchanged by the program's spans."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from portbench import program_spans, spec, trace
from quantized_tpu_torch.utils import profiling
from quantized_tpu_torch.utils.profiling import Span

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class _Ev:
    """A profiler event as ``torch.profiler``'s kineto results give it."""

    def __init__(self, name, device, start, dur, corr=0):
        self._v = (name, device, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


HOST0, OFFSET, HOST1 = 1_000_000, 5_000_000_000, 2_000_000
W0, W1 = HOST0 + OFFSET, HOST1 + OFFSET


def _events():
    """One profiled millisecond: a batch's H2D copy and a graph of three
    kernels launched long before (queued gaps between them), then a gap
    that ends at a kernel launched in the middle of it (starved), the
    batch's D2H copy, and a last kernel after the window."""
    e = [_Ev(trace.MARK, CPU, W0, 1000),
         _Ev("cudaMemcpyAsync", CPU, W0 - 50_000, 2000, 11),
         _Ev("cudaGraphLaunch", CPU, W0 - 40_000, 9000, 12),
         _Ev("Memcpy HtoD (Pinned -> Device)", CUDA, W0 + 10_000, 90_000, 11),
         _Ev("k1", CUDA, W0 + 100_000, 200_000, 12),
         _Ev("k2", CUDA, W0 + 310_000, 190_000, 12),
         _Ev("k3", CUDA, W0 + 510_000, 90_000, 12),
         _Ev("cudaLaunchKernel", CPU, W0 + 650_000, 5000, 13),
         _Ev("k4", CUDA, W0 + 700_000, 100_000, 13),
         _Ev("cudaMemcpyAsync", CPU, W0 + 660_000, 3000, 14),
         _Ev("Memcpy DtoH (Device -> Pinned)", CUDA, W0 + 800_000, 50_000, 14),
         _Ev("cudaLaunchKernel", CPU, W0 + 870_000, 4000, 15),
         _Ev("k5", CUDA, W0 + 1_200_000, 10_000, 15),
         _Ev("aten::copy_", CPU, W0 + 5000, 4000)]
    return e


GAPS = [(W0, W0 + 10_000), (W0 + 300_000, W0 + 310_000), (W0 + 500_000, W0 + 510_000),
        (W0 + 600_000, W0 + 700_000), (W0 + 850_000, W1)]


def _device_intervals(events):
    return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.device_type() == CUDA and e.duration_ns() > 0]


def test_gaps_are_starved_or_queued_by_their_launching_call():
    busy, gaps = trace.busy_and_gaps(_device_intervals(_events()), W0, W1)
    assert gaps == GAPS
    k = program_spans.classify_gaps(gaps, _events())
    # starved: 600-700 us (k4 launched at 650) and 850-1000 us (k5 launched at 870)
    assert k["gaps"] == 5 and k["matched"] == 5 and k["starved_gaps"] == 2
    assert k["starved"] == [GAPS[3], GAPS[4]]
    assert k["starved_s"] == pytest.approx((100_000 + 150_000) / 1e9)
    assert k["queued_s"] == pytest.approx((10_000 + 10_000 + 10_000) / 1e9)
    assert k["starved_s"] + k["queued_s"] == pytest.approx((W1 - W0 - busy) / 1e9) and k["unseen_s"] == 0


def test_the_gap_at_the_window_start_is_unseen():
    """Work launched before the profiler started is not traced: the gap from
    the window's start to the first traced op is neither starved nor queued."""
    k = program_spans.classify_gaps(GAPS, _events(), window_start=W0)
    assert k["unseen_s"] == pytest.approx(10_000 / 1e9) and k["gaps"] == 4 and k["matched"] == 4
    assert k["queued_s"] == pytest.approx(20_000 / 1e9) and k["starved_s"] == pytest.approx(250_000 / 1e9)


def test_a_share_is_not_read_where_launches_go_unmatched():
    """Under 99% of the gaps matched to a launching call: None, not a
    guess; an op that ends a gap with no call anywhere leaves it unmatched."""
    events = [e for e in _events() if e.correlation_id() != 13 or e.device_type() == CUDA]
    k = program_spans.classify_gaps(GAPS, events)
    assert k["matched"] == 4 and k["starved_s"] is None and k["queued_s"] is None
    assert program_spans.classify_gaps([], events)["starved_s"] == 0.0
    assert program_spans.classify_gaps([(W1 + 10**9, W1 + 10**9 + 5)], events)["starved_s"] is None


def _spans(shift=0):
    """The program's spans of the fixture's batch (host clock)."""
    h = -OFFSET + shift
    return [Span("executor.dispatch", W0 + 600_000 + h, W0 + 770_000 + h, 1, 1, 0, 7),
            Span("executor.host_copy", W0 + 605_000 + h, W0 + 640_000 + h, 1, 2, 1, 7),
            Span("executor.enqueue", W0 + 645_000 + h, W0 + 768_000 + h, 1, 3, 1, 7),
            Span("executor.result_wait", W0 + 820_000 + h, W0 + 852_000 + h, 1, 4, 1, 7),
            Span("executor.result_copy", W0 + 852_000 + h, W0 + 880_000 + h, 1, 5, 1, 7)]


def test_phases_a_batch_over_the_window():
    spans = _spans() + [Span("executor.slot_wait", 10, 20, 1, 9, 1, 7),
                        Span("executor.dispatch", 10**12, 10**12 + 10, 1, 10, 0, 8)]
    got = program_spans.per_batch_ms(spans, 0, 10**11)
    assert got == {"executor.dispatch": 0.17, "executor.slot_wait": 1e-5, "executor.host_copy": 0.035,
                   "executor.enqueue": 0.123}
    assert program_spans.per_batch_ms(spans, 10**13, 10**14) is None


class _Prof:
    def __init__(self, events):
        self.profiler = types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: events))

    def stop(self):
        pass


def _stopped(events, monkeypatch, during=lambda: None):
    """``trace.Slice.stop``'s reading of ``events`` with the window [HOST0, HOST1]."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    sl = trace.Slice(trace.Spans(True))
    sl.spans.add("dispatch", HOST0 + 590_000, HOST0 + 680_000)
    sl.spans.add("wait", HOST0 + 800_000, HOST0 + 900_000)
    sl.prof, sl._host0 = _Prof(events), HOST0
    during()
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: HOST1)
    reading = sl.stop(units=1)
    monkeypatch.undo()
    return reading


def _existing(reading) -> dict:
    """Every existing reader that reads the slice or the dispatch times, and the breakdown."""
    run = types.SimpleNamespace(readings={"slice": reading, "dispatch_s": [0.0021, 0.0019]}, cuda=False)
    names = [m["name"] for m in spec.load_json(spec.ROOT / "BENCHMARK.json")["per_layer"]
             if m["name"].split(".")[0] in ("idle", "forward_device_ms", "dispatch_ms")]
    assert len(names) == 6
    return {"metrics": {n: spec.reader(n)(run) for n in names},
            "breakdown": {"device_ops": reading["device_ops"], "idle_gaps": reading["idle_gaps"]},
            "reading": {k: reading[k] for k in ("window_s", "busy_s", "units")}}


def test_existing_readers_are_unchanged_by_the_program_spans(monkeypatch):
    """The same profiled slice read with the program's recorder off, with it
    on and recording a batch's spans inside the slice, and with the
    program's spans also among the profiler's host events (as inside
    ``utils.profiling.trace``): ``idle.*``, ``forward_device_ms.*``,
    ``dispatch_ms.*`` and the breakdown read the same."""
    def batch():
        from quantized_tpu_torch.engine.executor import IntExecutor

        ex = IntExecutor(torch.nn.Flatten(), device="cpu")
        ex.dispatch(np.zeros((2, 3), np.float32)).wait()

    absent = _stopped(_events(), monkeypatch)
    profiling.enable()
    try:
        present = _stopped(_events(), monkeypatch, during=batch)
        recorded = profiling.take().spans
    finally:
        profiling.disable()
    assert len(recorded) == 5
    annotated = _events() + [_Ev(s.name, CPU, s.start_ns + OFFSET, s.end_ns - s.start_ns) for s in _spans()]
    in_host_events = _stopped(annotated, monkeypatch)
    want = _existing(absent)
    assert want["metrics"]["idle.resnet50"] == pytest.approx(100 * 280_000 / 1_000_000)
    assert want["breakdown"]["idle_gaps"] == [["no span (4 gaps)", pytest.approx(1.8e-4)],
                                              ["dispatch (1 gaps)", pytest.approx(1e-4)]]
    for other in (present, in_host_events):
        assert _existing(other) == want
