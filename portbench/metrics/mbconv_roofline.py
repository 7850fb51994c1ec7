"""EfficientNet-B0's 16 MBConv blocks: the sum of their least times (their
operations at the int8 peak or their input, weights and output bytes at the
memory bandwidth, whichever is longer: ``counts.unit_work``) over the sum of
their device times between CUDA events at the ``block<k>`` hooks of one
eager forward, in percent."""

from portbench.readings import card_peaks
from portbench.work import counts


def read(run):
    pk, times = card_peaks(run), run.readings.get("unit_ms")
    if pk is None or not times:
        return None
    units = run.ref.units(run.cfg)
    if any(u["name"] not in times for u in units):
        return None
    batch = run.readings["unit_batch"]
    least = sum(counts.least_seconds(*counts.unit_work(u, batch), pk) for u in units)
    return 100.0 * least / (sum(times[u["name"]] for u in units) / 1e3)
