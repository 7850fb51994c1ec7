"""Throughput of a model (counterpart of ``quantized_tpu/engine/bench_hook.py``):
images per second of one forward, timed by ``utils/timing.per_iter_time``
(CUDA events on the GPU, the host clock on the CPU). The JAX module's
``resnet50_int8_throughput`` builds its engine with ``convert_to_int``,
which the port does not have yet."""

from __future__ import annotations

import torch
from torch import nn

from quantized_tpu_torch.utils.timing import PROBE_LOOPS, per_iter_time


def model_throughput(model: nn.Module, x: torch.Tensor, target_secs: float = 1.0, reps: int = 3,
                     probe_loops: int = PROBE_LOOPS) -> float:
    """Images/s of ``model(x)`` (``model.run_u8(x)`` for uint8 images), with
    ``x`` on the model's device; the timing arguments go to ``per_iter_time``."""
    forward = model.run_u8 if x.dtype == torch.uint8 else model

    def step(carry, x):
        forward(x)
        return carry

    with torch.inference_mode():
        dt = per_iter_time(step, x, target_secs=target_secs, reps=reps, probe_loops=probe_loops)
    return x.shape[0] / dt
