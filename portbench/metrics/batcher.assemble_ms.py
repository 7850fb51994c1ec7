"""The batcher's host milliseconds a batch spends assembling its rows
(``ContinuousBatcher.stats()["stage_assemble_ms"]``)."""


def read(run):
    st = run.readings.get("batcher")
    return None if not st or not st.get("batches") else st["stage_assemble_ms"]
