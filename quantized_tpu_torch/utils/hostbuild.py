"""Host-side model construction (counterpart of
``quantized_tpu/utils/hostbuild.py``).

Models and engines are built and converted with every tensor on the CPU
(the conversions read each weight to numpy anyway), then the finished
module goes to the GPU in one ``.to(device)``:

    with host_build():
        model = get_model(name)(**config)
        eng = build_int8_resident(model, device="cpu")
    put_model(eng)
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from quantized_tpu_torch._device import DeviceLike, resolve_device


@contextlib.contextmanager
def host_build():
    """Tensors created inside land on the CPU, whatever the default device."""
    with torch.device("cpu"):
        yield


def put_model(model: nn.Module, device: DeviceLike = "cuda") -> nn.Module:
    """Move every parameter and buffer of ``model`` to ``device`` (CUDA
    unless the caller asks for the CPU); in place, and returned."""
    return model.to(resolve_device(device))
