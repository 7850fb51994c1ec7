"""Percent of the traced window in which Python's cyclic garbage collector
ran (it stops every thread: the generator's, the batcher's, the executor's)."""


def read(run):
    g = run.readings.get("gc")
    return None if not g or g["elapsed_s"] <= 0 else 100.0 * g["pause_s"] / g["elapsed_s"]
