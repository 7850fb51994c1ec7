"""One reader a metric, ``<metric>.py``, found by the metric's name in
``BENCHMARK.json``: ``read(run)`` reduces the run's readings to the
metric's value, or returns None where the run has nothing to read."""
