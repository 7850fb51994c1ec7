"""EfficientNet-B0's squeeze-excitation: the device time of the 16
``block<k>.se`` spans (the squeeze from the depthwise sums, the reduce and
expand products, the gate pass) over that of the 16 blocks, between CUDA
events of one eager forward, in percent."""


def read(run):
    times = run.readings.get("unit_ms")
    if not times:
        return None
    blocks = [u["name"] for u in run.ref.units(run.cfg)]
    if any(b not in times or f"{b}.se" not in times for b in blocks):
        return None
    return 100.0 * sum(times[f"{b}.se"] for b in blocks) / sum(times[b] for b in blocks)
