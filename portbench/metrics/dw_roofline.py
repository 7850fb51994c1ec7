"""EfficientNet-B0's depthwise kernel: the sum of the 16 depthwise convs'
least times (``work.mbconv.dw_work``: 2 x MACs at the int8 peak, or input,
weights, int8 output and int32 sums at the memory bandwidth) over the sum
of their device times between CUDA events at the ``block<k>.dw`` hooks of
one eager forward, in percent."""

from portbench.readings import card_peaks
from portbench.work import counts, mbconv


def read(run):
    pk, times = card_peaks(run), run.readings.get("unit_ms")
    if pk is None or not times:
        return None
    layers = mbconv.dw_layers(run.ref, run.cfg)
    if any(name not in times for name, _, _ in layers):
        return None
    batch = run.readings["unit_batch"]
    least = sum(counts.least_seconds(*mbconv.dw_work(spec, side, batch), pk) for _, spec, side in layers)
    return 100.0 * least / (sum(times[name] for name, _, _ in layers) / 1e3)
