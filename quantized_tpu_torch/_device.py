"""Device choice of the port's entry points: CUDA unless the caller asks for
the CPU, and never a quiet fall back to the CPU when CUDA was asked for."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for but torch sees no CUDA GPU; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return dev
