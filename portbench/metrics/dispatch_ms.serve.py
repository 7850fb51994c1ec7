"""The batcher's host milliseconds a batch spends in the executor's
dispatch (``stats()["stage_dispatch_ms"]``)."""


def read(run):
    st = run.readings.get("batcher")
    return None if not st or not st.get("batches") else st["stage_dispatch_ms"]
