"""Reductions that several metric readers share."""

from __future__ import annotations

from typing import Optional

from portbench.work import counts, peaks


def card_peaks(run) -> Optional[dict]:
    if not run.cuda:
        return None
    import torch

    return peaks.peak(torch.cuda.get_device_name(run.device))


def idle_pct(run) -> Optional[float]:
    """Percent of the profiled slice in which no kernel, copy or set ran."""
    sl = run.readings.get("slice")
    if not sl or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])


def forward_ops(run) -> int:
    """Integer operations of one image's forward: 2 x the MACs of every conv and the fc."""
    ref, cfg = run.ref, run.cfg
    return 2 * counts.forward_macs(ref.layer_shapes(cfg), ref.fc_features(cfg), cfg["num_classes"])


def img_per_s(run) -> Optional[float]:
    """Images whose logits reached host memory in the window, over its seconds."""
    r = run.readings
    if not r.get("window_s") or "images" not in r:
        return None
    return r["images"] / r["window_s"]


def dispatch_ms(run) -> Optional[float]:
    """Mean host milliseconds of one ``IntExecutor.dispatch`` call in the
    offline loop (the copy into a pinned slot, the enqueued copy and replay)."""
    d = run.readings.get("dispatch_s")
    return None if not d else 1e3 * sum(d) / len(d)


def mfu(run) -> Optional[float]:
    """The window's integer operations (2 x MACs of every conv and the fc a
    forward, times the images) a second, in percent of the card's int8 peak."""
    pk, r = card_peaks(run), run.readings
    if pk is None or not r.get("window_s") or not r.get("images"):
        return None
    return 100.0 * forward_ops(run) * r["images"] / r["window_s"] / pk["int8_ops_per_s"]


def forward_device_ms(run) -> Optional[float]:
    """Device milliseconds a batch: the union of kernel and copy intervals in
    the profiled slice over the batches dispatched in it."""
    sl = run.readings.get("slice")
    return None if not sl or not sl["units"] else 1e3 * sl["busy_s"] / sl["units"]


def unit_roofline(run) -> Optional[float]:
    """The units of work (residual blocks, depthwise/pointwise pairs) in
    whatever form the tuner gave them: the sum of their least times (their
    operations at the int8 peak or their bytes at the memory bandwidth,
    whichever is longer) over the sum of their device times in one eager
    forward, in percent."""
    pk, times = card_peaks(run), run.readings.get("unit_ms")
    if pk is None or not times:
        return None
    batch = run.readings["unit_batch"]
    units = {u["name"]: u for u in run.ref.units(run.cfg)}
    if set(times) != set(units):
        return None
    least = sum(counts.least_seconds(*counts.unit_work(units[n], batch), pk) for n in units)
    return 100.0 * least / (sum(times.values()) / 1e3)
