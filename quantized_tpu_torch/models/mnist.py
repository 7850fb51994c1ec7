"""Toy MNIST net (counterpart of ``quantized_tpu/models/mnist.py``),
LeNet-style: conv(1->10, k5) -> pool -> conv(10->20, k5) -> pool -> fc
320->50 -> dropout -> fc 50->classes, NHWC. Factory: ``mnist``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from quantized_tpu_torch.models import layers


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class MnistNet(nn.Module):
    def __init__(self, num_classes: int = 10, *, generator: torch.Generator):
        super().__init__()
        self.conv1 = layers.Conv2d(1, 10, 5, generator=generator)
        self.conv2 = layers.Conv2d(10, 20, 5, generator=generator)
        # fc1 takes a flattened conv map: the reference flattens NCHW, this
        # model NHWC, so ingest and export permute its columns
        self.flatten_linear = ("fc1", (20, 4, 4))
        self.fc1 = layers.Linear(320, 50, generator=generator)
        self.fc2 = layers.Linear(50, num_classes, generator=generator)
        self.dropout = layers.Dropout(0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_max_pool_2x2(self.conv1(x)))
        x = F.relu(_max_pool_2x2(self.conv2(x)))
        x = x.reshape(x.shape[0], -1)
        x = self.dropout(F.relu(self.fc1(x)))
        return self.fc2(x)


def mnist(num_classes: int = 10, generator: Optional[torch.Generator] = None, **_) -> MnistNet:
    """Factory ``mnist(**model_config)``: parameters drawn on the CPU from
    ``generator`` (default: seed 0)."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    model = MnistNet(num_classes, generator=generator)
    model.regime = {0: {"optimizer": "SGD", "lr": 1e-2, "momentum": 0.5}}
    model.input_size = 28
    model.input_transform = "mnist"
    return model
