"""Requests over bucket rows dispatched, in percent (``stats()["occupancy"]``)."""


def read(run):
    st = run.readings.get("batcher")
    return None if not st or not st.get("batches") else 100.0 * st["occupancy"]
