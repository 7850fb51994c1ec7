"""Calibrated-model entry of the port (counterpart of ``_calibrated_model``
in the JAX repository's ``__graft_entry__.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.models.layers import QuantMeasure


def _calibrated_model(name: str, device: DeviceLike = "cuda",
                      generator: Optional[torch.Generator] = None, **cfg) -> torch.nn.Module:
    """Build a model from ``generator`` (default seed 0) with every observer
    frozen at [-4, 4], in eval mode, on ``device``."""
    dev = resolve_device(device)
    model = get_model(name)(generator=generator, **cfg)
    for m in model.modules():
        if isinstance(m, QuantMeasure):
            m.running_min.fill_(-4.0)
            m.running_max.fill_(4.0)
    return model.eval().to(dev)
