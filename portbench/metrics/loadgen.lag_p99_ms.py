"""99th percentile of the load generator's lateness: a burst's send time
less its due time, over the window's bursts."""

from portbench.stats import percentile


def read(run):
    lag = run.readings.get("lag_s")
    return None if lag is None or len(lag) == 0 else 1e3 * percentile(lag, 99)
