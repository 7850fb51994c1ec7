"""Throughput of a model (counterpart of ``quantized_tpu/engine/bench_hook.py``):
images per second of one forward, timed by ``utils/timing.per_iter_time``
(CUDA events on the GPU, the host clock on the CPU), and
``resnet50_int8_throughput``, the ResNet-50 engine of ``convert_to_int``
against its float twin."""

from __future__ import annotations

import torch
from torch import nn

from quantized_tpu_torch._device import DeviceLike, resolve_device
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


def resnet50_int8_throughput(batch: int = 64, backend: str = "pallas", device: DeviceLike = "cuda"):
    """(img/s of the calibrated ResNet-50 converted by ``convert_to_int`` on
    ``backend``, its ratio to the float ResNet-50's img/s, a label), on f32
    ones of (batch, 224, 224, 3), as the JAX module measures them. The
    float twin runs in fp32 with TF32 off. The default backend is K2's
    (the JAX module's ``"xla"`` is the port's plain reference, whose rate
    is not the engine's)."""
    from quantized_tpu_torch.engine.convert import convert_to_int
    from quantized_tpu_torch.entry import _calibrated_model
    from quantized_tpu_torch.models import get_model

    dev = resolve_device(device)
    x = torch.ones((batch, 224, 224, 3), dtype=torch.float32, device=dev)
    qmodel = _calibrated_model("resnet_quantized_float_bn", device=dev, dataset="imagenet", depth=50)
    ips = model_throughput(convert_to_int(qmodel, weight_bits=8, backend=backend, device=dev), x)
    fmodel = get_model("resnet")(dataset="imagenet", depth=50).to(dev).eval()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ips_f = model_throughput(fmodel, x)
    return ips, ips / ips_f, f"int8-engine-{backend}"
