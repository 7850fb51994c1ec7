"""The port's span recorder (``utils.profiling``) and the spans the
executor records with it, and the batcher's queue wait, on the CPU; one
test on the card holds the executor's three dispatch phases against the
dispatch span.

The recorder is one per process: every test that turns it on turns it off
again (the ``recorder`` fixture), so no test sees another's spans.
"""

import json
import sys
import threading
import time
import tracemalloc
import urllib.request

import numpy as np
import pytest
import torch
from torch import nn
from torch_markers import cuda_device  # noqa: F401  (fixture)

from quantized_tpu_torch import utils
from quantized_tpu_torch.engine.batching import ContinuousBatcher
from quantized_tpu_torch.engine.executor import IntExecutor
from quantized_tpu_torch.utils import profiling

DISPATCH_CHILDREN = ("executor.slot_wait", "executor.host_copy", "executor.enqueue")


@pytest.fixture
def recorder():
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.take()


def _linear(features: int = 4 * 4 * 3, classes: int = 5) -> nn.Module:
    torch.manual_seed(0)
    return nn.Sequential(nn.Flatten(), nn.Linear(features, classes))


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_recorder_off_records_nothing_and_allocates_nothing():
    """Off (the default): a span site returns one shared object, records
    nothing and allocates nothing; the CPU executor's dispatch and wait
    leave the recorder empty."""
    assert not profiling.ENABLED
    assert profiling.span("a") is profiling.span("b", cause=None)
    assert profiling.phases(None, "a") is profiling.phases(None, "b")
    ex = IntExecutor(_linear(), device="cpu")
    ex.dispatch(np.ones((2, 4, 4, 3), np.float32)).wait()

    def sites(n):
        for _ in range(n):
            with profiling.span("executor.dispatch") as s:
                phase = profiling.phases(s, "executor.host_copy")
                phase.next("executor.enqueue")
                with profiling.span("executor.result_wait", cause=s):
                    pass

    sites(10)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        sites(10_000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__ and d.size_diff > 0]
    assert grown == []
    assert profiling.take() == ([], 0)


def test_span_fields_nesting_and_batches(recorder):
    """A span's fields: its name, perf_counter_ns start and end, the
    thread's native id, its id, its parent and its batch. Children share
    their parent's batch, a span with no parent begins a new one, and a
    span given a ``cause`` is that span's child and in its batch, not the
    one open on its thread; phases run end to end from the span's start to
    its end."""
    t = time.perf_counter_ns()
    with recorder.span("outer") as outer:
        with recorder.span("inner"):
            pass
        phase = recorder.phases(outer, "first")
        phase.next("second")
    with recorder.span("next"):
        with recorder.span("caused", cause=outer):
            pass
    spans, dropped = recorder.take()
    got = {s.name: s for s in spans}
    assert dropped == 0 and [s.name for s in spans] == ["inner", "first", "second", "outer", "caused", "next"]
    o, i, f, sec = got["outer"], got["inner"], got["first"], got["second"]
    assert o.id == outer.id and o.parent == 0 and o.batch > 0
    assert t <= o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns <= time.perf_counter_ns()
    assert i.parent == f.parent == sec.parent == o.id and {i.batch, f.batch, sec.batch} == {o.batch}
    assert f.start_ns == o.start_ns and sec.start_ns == f.end_ns and sec.end_ns == o.end_ns
    assert {s.thread for s in spans} == {threading.get_native_id()}
    nxt, caused = got["next"], got["caused"]
    assert nxt.parent == 0 and nxt.batch not in (0, o.batch)
    assert caused.parent == o.id and caused.batch == o.batch
    assert nxt.start_ns <= caused.start_ns <= caused.end_ns <= nxt.end_ns
    assert len({s.id for s in spans}) == len(spans)


def test_cpu_executor_dispatch_and_wait_join_one_batch(recorder):
    """The CPU path of ``dispatch``: ``executor.dispatch`` cut into the
    phases ``executor.host_copy`` and ``executor.enqueue``, one ending where
    the next begins, from the dispatch's start to its end; ``HostResult.wait``,
    from another thread, records ``executor.result_wait`` and
    ``executor.result_copy`` caused by that dispatch and in its batch. Two
    dispatches are two batches; a second wait records nothing."""
    ex = IntExecutor(_linear(), device="cpu")
    x = np.random.default_rng(0).standard_normal((3, 4, 4, 3)).astype(np.float32)
    first, second = ex.dispatch(x), ex.dispatch(x)
    waiter = threading.Thread(target=first.wait)
    waiter.start()
    waiter.join(timeout=30)
    assert not waiter.is_alive()
    np.testing.assert_array_equal(second.wait(), first.wait())
    spans, dropped = recorder.take()
    got = _by_name(spans)
    assert dropped == 0
    assert sorted(got) == ["executor.dispatch", "executor.enqueue", "executor.host_copy", "executor.result_copy",
                           "executor.result_wait"]
    dispatches = got["executor.dispatch"]
    assert len(dispatches) == 2 and dispatches[0].batch != dispatches[1].batch
    for d in dispatches:
        children = [s for s in spans if s.parent == d.id]
        assert sorted(s.name for s in children) == ["executor.enqueue", "executor.host_copy",
                                                    "executor.result_copy", "executor.result_wait"]
        assert all(s.batch == d.batch for s in children)
        copy, enqueue = (next(s for s in children if s.name == n) for n in ("executor.host_copy", "executor.enqueue"))
        assert copy.start_ns == d.start_ns and enqueue.start_ns == copy.end_ns and enqueue.end_ns == d.end_ns
        for s in children:
            if s.name in DISPATCH_CHILDREN:
                assert d.start_ns <= s.start_ns <= s.end_ns <= d.end_ns and s.thread == d.thread
            else:
                assert s.start_ns >= d.end_ns
    waited = [s for s in got["executor.result_wait"] if s.parent == dispatches[0].id][0]
    assert waited.thread != dispatches[0].thread


def test_four_threads_record_at_once(recorder):
    """Four threads nest spans at once under a short switch interval: every
    span is kept, ids are unique, and each child names its own thread's
    parent and batch."""
    n = 400
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    together = threading.Barrier(4)

    def work():
        together.wait(timeout=30)  # all four alive at once: four thread ids
        for _ in range(n):
            with recorder.span("t.outer"):
                with recorder.span("t.inner"):
                    pass

    try:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans, dropped = recorder.take()
    assert dropped == 0 and len(spans) == 4 * n * 2
    assert len({s.id for s in spans}) == len(spans)
    outers = {s.id: s for s in spans if s.name == "t.outer"}
    assert len({s.batch for s in outers.values()}) == 4 * n
    assert len({s.thread for s in outers.values()}) == 4
    for s in spans:
        if s.name == "t.inner":
            parent = outers[s.parent]
            assert parent.thread == s.thread and parent.batch == s.batch
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_capacity_counts_what_it_drops(recorder, monkeypatch):
    """Past its capacity the recorder keeps the first spans, counts the
    rest as dropped, and ``take`` empties it; ``enable`` starts empty and
    ``disable`` keeps what was recorded until ``take``."""
    monkeypatch.setattr(recorder, "CAPACITY", 5)
    recorder.enable()
    for k in range(8):
        with recorder.span(f"s{k}"):
            pass
    spans, dropped = recorder.take()
    assert [s.name for s in spans] == [f"s{k}" for k in range(5)] and dropped == 3
    assert recorder.take() == ([], 0)
    with recorder.span("kept"):
        pass
    recorder.disable()
    with recorder.span("off"):
        pass
    assert [s.name for s in recorder.take().spans] == ["kept"]
    recorder.enable()
    with recorder.span("before"):
        pass
    recorder.enable()
    assert recorder.take() == ([], 0)


@pytest.mark.parametrize("depth", [1, 3])
def test_batcher_queue_waits_through_the_executor(recorder, depth):
    """Through the batcher and the CPU executor, recorder on: each request's
    queue wait is noted once, within its latency; ``stats()`` reports their
    p50 and p95; the batcher records no spans of its own, and each batch's
    executor spans (dispatch, its phases, the wait caused by it) share a
    batch of their own."""
    ex = IntExecutor(_linear(), device="cpu")
    b = ContinuousBatcher(ex, (4, 4, 3), batch_sizes=(4,), max_wait_ms=2, pipeline_depth=depth)
    imgs = np.random.default_rng(1).standard_normal((12, 4, 4, 3)).astype(np.float32)
    futs = [b.submit(im) for im in imgs]  # queued before start: three batches of 4
    b.start()
    for f in futs:
        f.result(timeout=30)
    b.stop()
    spans, dropped = recorder.take()
    got = _by_name(spans)
    assert dropped == 0 and not [s for s in spans if s.name.startswith("batcher.")]
    dispatches = {s.id: s for s in got["executor.dispatch"]}
    assert len(dispatches) == 3 and len({s.batch for s in dispatches.values()}) == 3
    for name in ("executor.host_copy", "executor.enqueue", "executor.result_wait", "executor.result_copy"):
        assert sorted(s.batch for s in got[name]) == sorted(dispatches[s.parent].batch for s in got[name]), name
        assert len(got[name]) == 3, name
    assert len(b.queue_wait_ms) == 12 and len(b.latencies_ms) == 12
    assert 0 < min(b.queue_wait_ms) and max(b.queue_wait_ms) <= max(b.latencies_ms)
    st = b.stats()
    assert 0 < st["queue_wait_p50_ms"] <= st["queue_wait_p95_ms"] <= st["latency_p95_ms"]


def test_queue_wait_stats_without_the_recorder_and_over_http():
    """With the recorder off the batcher still measures each request's
    queue wait; ``stats()`` and the ``/stats`` endpoint report its p50 and
    p95 (a request held in the queue for a slow batch waits longer)."""
    from quantized_tpu_torch.engine.server import _start_http

    def slow(batch):
        time.sleep(0.05)
        return batch.reshape(batch.shape[0], -1)

    b = ContinuousBatcher(slow, (2, 2, 1), batch_sizes=(2,), max_wait_ms=1)
    futs = [b.submit(np.zeros((2, 2, 1), np.float32)) for _ in range(6)]
    b.start()
    httpd = _start_http(b, 0)  # ephemeral port on localhost
    try:
        for f in futs:
            f.result(timeout=30)
        stats = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/stats",
                                                  timeout=30).read())
    finally:
        httpd.shutdown()
        b.stop()
    assert profiling.take() == ([], 0)
    assert len(b.queue_wait_ms) == 6
    assert stats["queue_wait_p95_ms"] >= 50.0  # the last batch waited behind two slow ones
    assert stats["queue_wait_p50_ms"] <= stats["queue_wait_p95_ms"] <= stats["latency_p95_ms"]


def test_spans_are_ranges_of_trace_and_of_no_other_profiler(recorder, tmp_path):
    """With the recorder on, a span (not a phase, named where it ends) is a
    ``record_function`` range of ``trace(dir)``'s Chrome trace; inside
    another profiler session, and with the recorder off, it is not (the
    session's events stay as they were without the recorder)."""
    from torch.profiler import ProfilerActivity, profile

    ex = IntExecutor(_linear(), device="cpu")
    x = np.ones((2, 4, 4, 3), np.float32)
    with profiling.trace(str(tmp_path / "on")):
        ex.dispatch(x).wait()
    with profile(activities=[ProfilerActivity.CPU]) as other:
        ex.dispatch(x).wait()
    recorder.disable()
    with profiling.trace(str(tmp_path / "off")):
        ex.dispatch(x).wait()

    def names(path):
        with open(path / "trace.json") as f:
            return {e.get("name") for e in json.load(f)["traceEvents"]}

    assert {"executor.dispatch", "executor.result_wait", "executor.result_copy"} <= names(tmp_path / "on")
    assert not {n for n in names(tmp_path / "off") if str(n).startswith("executor.")}
    assert not {e.name for e in other.events() if e.name.startswith("executor.")}
    assert not profiling._RANGES
    assert len(recorder.take().spans) == 10


def test_annotate_is_gone_and_trace_stays():
    """``span`` replaced the unread ``annotate``; ``trace`` (the CLI's
    ``--profile``) stays, exported from ``utils``."""
    assert not hasattr(profiling, "annotate") and not hasattr(utils, "annotate")
    assert utils.trace is profiling.trace


class _U8Net(nn.Module):
    """A small net over uint8 NHWC batches, for the executor's u8 path on the card."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 16, 7, stride=4)
        self.fc = nn.Linear(16, 10)

    def forward(self, x):
        return self.fc(self.conv(x).mean((2, 3)))

    def run_u8(self, u8):
        return self(u8.permute(0, 3, 1, 2).float())


@pytest.mark.cuda
def test_dispatch_phases_cover_the_dispatch_on_the_card(cuda_device):
    """On the card, with a captured graph and pinned slots: the slot wait,
    host copy and enqueue phases cover each ``executor.dispatch`` span whole,
    one beginning where the last ended, from the span's start to its end,
    batches of 128 uint8 224x224 images with three in flight."""
    ex = IntExecutor(_U8Net(), ingest="u8", device=cuda_device, slots=4)
    x = np.random.default_rng(0).integers(0, 256, (128, 224, 224, 3), dtype=np.uint8)
    for _ in range(4):  # the capture and every slot once
        ex.dispatch(x).wait()
    profiling.enable()
    try:
        pending = []
        for _ in range(24):
            pending.append(ex.dispatch(x))
            if len(pending) >= 3:
                pending.pop(0).wait()
        for h in pending:
            h.wait()
    finally:
        profiling.disable()
    spans, dropped = profiling.take()
    assert dropped == 0
    dispatches = [s for s in spans if s.name == "executor.dispatch"]
    assert len(dispatches) == 24
    for d in dispatches:
        children = sorted((s for s in spans if s.parent == d.id and s.name in DISPATCH_CHILDREN),
                          key=lambda s: s.start_ns)
        assert [s.name for s in children] == list(DISPATCH_CHILDREN)
        assert children[0].start_ns == d.start_ns and children[-1].end_ns == d.end_ns, (children, d)
        assert all(a.end_ns == b.start_ns for a, b in zip(children, children[1:])), children
