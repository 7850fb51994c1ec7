"""95th percentile of the latency of every request due in the window, from
due time to answer; failed and unanswered requests count as infinite."""

from portbench.stats import percentile


def read(run):
    lat = run.readings.get("latencies_ms")
    return None if lat is None or len(lat) == 0 else percentile(lat, 95)
