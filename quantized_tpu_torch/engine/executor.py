"""Executor around a converted integer model (counterpart of
``quantized_tpu/engine/executor.py``, single device).

PyTorch runs eagerly, so there is nothing to compile: the executor places
the model on its device, moves each request batch there, and runs the
forward under ``torch.inference_mode()``. Sharding over a mesh waits for the
distribution slice.
"""

from __future__ import annotations

import torch
from torch import nn

from quantized_tpu_torch._device import DeviceLike, resolve_device


class IntExecutor:
    """Forward executor for a converted model on one device.

    ``ingest="u8"`` accepts raw uint8 NHWC images and runs the model's fused
    normalize+quantize path (:meth:`Int8ResNet.run_u8`); ``"f32"`` takes
    normalized f32 images."""

    def __init__(self, model: nn.Module, ingest: str = "f32", device: DeviceLike = "cuda"):
        if ingest not in ("f32", "u8"):
            raise ValueError(f"ingest must be 'f32' or 'u8', got {ingest!r}")
        if ingest == "u8" and not hasattr(model, "run_u8"):
            raise ValueError(f"{type(model).__name__} has no uint8 ingest path")
        self.device = resolve_device(device)
        self.ingest = ingest
        self.model = model.to(self.device).eval()

    def __call__(self, x) -> torch.Tensor:
        dtype = torch.uint8 if self.ingest == "u8" else torch.float32
        x = torch.as_tensor(x).to(self.device, dtype, non_blocking=True)
        with torch.inference_mode():
            return self.model.run_u8(x) if self.ingest == "u8" else self.model(x)

    def warmup(self, example) -> "IntExecutor":
        self(example)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self
