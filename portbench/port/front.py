"""The program's serving front: the executor (one CUDA graph per input
shape, pinned host slots) and the continuous batcher, built as the
program's own ``engine.server.serve`` builds them, less HTTP."""

from __future__ import annotations

import numpy as np


def executor(engine, device, slots: int, graphs: bool = True):
    from quantized_tpu_torch.engine.executor import IntExecutor

    return IntExecutor(engine, ingest="u8", device=device, graphs=graphs, slots=slots)


def batcher(engine, device, side: int, buckets, max_wait_ms: float, pipeline_depth: int, graphs: bool = True):
    """Warmed up (a graph captured for every bucket) and started."""
    from quantized_tpu_torch.engine.batching import ContinuousBatcher
    from quantized_tpu_torch.engine.server import make_executor

    ex = make_executor(engine, ingest="u8", device=device, graphs=graphs, pipeline_depth=pipeline_depth)
    b = ContinuousBatcher(ex, (side, side, 3), tuple(buckets), max_wait_ms=max_wait_ms, dtype=np.uint8,
                          pipeline_depth=pipeline_depth, request_timeout_s=None)
    return b.warmup().start()


BATCHER_STAGES = ("_drain", "_assemble", "_dispatch", "_resolve")
