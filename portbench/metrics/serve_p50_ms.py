"""Median latency of every request due in the window, from due time to answer."""

from portbench.stats import percentile


def read(run):
    lat = run.readings.get("latencies_ms")
    return None if lat is None or len(lat) == 0 else percentile(lat, 50)
