"""Traffic and the end-to-end arithmetic: seeded repeats, due-time
latency, a rate over all the work and all the window, the device's idle
share from a union of intervals, percentiles over every request."""

from __future__ import annotations

import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from portbench import spec, stats, trace
from portbench.traffic import closed_loop, images, open_bursts

MIX = {"rate_img_per_s": 2000, "burst": [1, 32]}


def test_images_repeat_from_the_seed():
    a = images.make(3, 32, 2 ** 40 + 5, images.POOL, "cpu")
    assert torch.equal(a, images.make(3, 32, 2 ** 40 + 5, images.POOL, "cpu"))
    assert not torch.equal(a, images.make(3, 32, 2 ** 40 + 6, images.POOL, "cpu"))
    assert a.dtype == torch.uint8 and int(a.min()) >= 0 and int(a.max()) > 200


def test_schedule_repeats_and_every_seed_sends_the_same_work():
    offs, sizes = open_bursts.schedule(MIX, 2.0, np.random.default_rng([11, 4]))
    offs2, sizes2 = open_bursts.schedule(MIX, 2.0, np.random.default_rng([11, 4]))
    assert np.array_equal(offs, offs2) and np.array_equal(sizes, sizes2)
    offs3, sizes3 = open_bursts.schedule(MIX, 2.0, np.random.default_rng([12, 4]))
    assert not np.array_equal(sizes, sizes3)
    assert np.array_equal(np.sort(sizes), np.sort(sizes3))
    assert sizes.sum() == pytest.approx(2000 * 2.0, rel=0.07) and len(sizes) % 32 == 0
    assert offs[0] == 0.0 and offs[-1] < 2.0 and np.all(np.diff(offs) >= 0)


class _StallingBatcher:
    """Admits the first request only after ``stall`` seconds (a stalled
    front end); answers every request at once."""

    def __init__(self, stall: float):
        self.stall, self.first, self.batches_run = stall, True, 0

    def submit(self, image):
        if self.first:
            self.first = False
            time.sleep(self.stall)
        f = Future()
        f.set_result(np.zeros(4, np.float32))
        self.batches_run += 1
        return f


class _Stub:
    def __init__(self, batcher):
        self.mix = {**MIX, "compare_requests": 4, "answer_wait_s": 5}
        self.seed, self.batcher = 3, batcher
        self.spans, self.readings = trace.Spans(False), {}

    def start_window(self):
        return time.perf_counter()


def test_open_loop_latency_starts_at_the_due_time():
    """Requests due while the front end stalls are sent late; each is timed
    from when it was due, so its latency holds the stall's remainder."""
    stall = 0.3
    r = _Stub(_StallingBatcher(stall))
    reqs, due, _, n, lag = open_bursts.window(r, np.zeros((2, 4, 4, 3), np.uint8), 1.0)
    lat, off = reqs.done[:n] - due[:n], due[:n] - due[0]
    assert np.all(np.isfinite(lat)) and np.all(lat >= 0)
    stalled = off < stall - 0.05
    assert stalled.sum() > 10
    assert np.all(lat[stalled] >= stall - off[stalled] - 0.02)
    assert lag.max() >= stall - 0.02


class _SlowExecutor:
    """Each batch's logits are ready 20 ms after its dispatch."""

    def __init__(self):
        self.n = 0

    def dispatch(self, batch):
        t = time.perf_counter() + 0.02

        class H:
            def wait(self):
                time.sleep(max(0.0, t - time.perf_counter()))
                return np.zeros((len(batch), 10), np.float32)

        self.n += 1
        return H()


def test_rate_counts_all_the_work_over_all_the_window():
    batches = [np.zeros((8, 2, 2, 3), np.uint8)]
    loop = closed_loop._Loop(_SlowExecutor(), batches, 3, trace.Spans(False), 2, np.random.default_rng(0))
    t0 = time.perf_counter()
    loop.run_until(t0 + 0.3)
    t_end = loop.drain()
    assert t_end > t0 + 0.3 - 1e-3  # the batches in flight at the deadline are waited for
    run = type("R", (), {})()
    run.readings = {"images": loop.k * 8, "window_s": t_end - t0}
    rate = spec.reader("img_per_s.resnet50")(run)
    assert rate == pytest.approx(loop.k * 8 / (t_end - t0))
    assert loop.failed == 0 and len(loop.samples) == 2


def test_idle_share_is_the_union_of_intervals():
    busy, gaps = trace.busy_and_gaps([(0, 10), (5, 15), (20, 30), (28, 29), (38, 50)], 0, 40)
    assert busy == 10 + 5 + 10 + 2 and gaps == [(15, 20), (30, 38)]
    run = type("R", (), {})()
    run.readings = {"slice": {"busy_s": busy / 1e9, "window_s": 40 / 1e9, "units": 2}}
    assert spec.reader("idle.mobilenet_v1")(run) == pytest.approx(100 * (1 - 27 / 40))
    assert spec.reader("forward_device_ms.resnet50")(run) == pytest.approx(27 / 1e9 * 1e3 / 2)


def test_gaps_are_labelled_by_the_open_host_span():
    out = trace.label_gaps([(15, 20), (30, 38)], [("wait", 10, 22), ("dispatch", 31, 40)])
    assert out["wait"] == [5e-9, 1] and out["dispatch"] == [8e-9, 1]


def test_percentiles_over_every_request():
    lat = np.arange(1, 101, dtype=float)
    assert stats.percentile(lat, 95) == 95 and stats.percentile(lat, 50) == 50
    lat[-6:] = np.inf  # six of a hundred never answered
    assert stats.percentile(lat, 95) == np.inf and stats.percentile(lat, 50) == 50
    run = type("R", (), {})()
    run.readings = {"latencies_ms": lat}
    assert spec.reader("serve_p95_ms")(run) == np.inf
