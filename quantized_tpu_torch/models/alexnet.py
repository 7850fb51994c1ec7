"""AlexNet-OWT-BN skeleton of the port (counterpart of
``quantized_tpu/models/alexnet.py``).

Five conv features with BN and ReLU (maxpools after conv1, conv2 and conv5,
each BEFORE its BN), a BN classifier of three dense layers with dropout.
Layout NHWC, kernels HWIO; submodule names match the JAX model
(``conv1``..``conv5``, ``bn1``..``bn5``, ``fc1``..``fc3``, ``bnf1``,
``bnf2``), so its parameters and statistics map onto this one key for key.

The skeleton takes its conv and dense constructors from the caller: the
float ``alexnet`` here, the quantized ones in ``alexnet_quantized.py``.
Dropout draws its masks from a stream of its own (``layers.Dropout``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from quantized_tpu_torch.models import layers

ALEXNET_REGIME = {
    0: {"optimizer": "SGD", "lr": 1e-2, "weight_decay": 5e-4, "momentum": 0.9},
    10: {"lr": 5e-3},
    15: {"lr": 1e-3, "weight_decay": 0},
    20: {"lr": 5e-4},
    25: {"lr": 1e-4},
}


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2 VALID maxpool, NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


def _bn(c: int) -> layers.BatchNorm:
    return layers.BatchNorm(c, momentum=0.9, epsilon=1e-5)


class AlexNetOWTBN(nn.Module):
    """The reference's AlexNetOWT_BN. ``conv(cin, cout, k, stride=,
    padding=, use_bias=, generator=)`` and ``linear(cin, cout, use_bias=,
    generator=)`` build its layers."""

    def __init__(self, num_classes: int = 1000, conv: Callable[..., nn.Module] = layers.Conv2d,
                 linear: Callable[..., nn.Module] = layers.Linear, dropout: float = 0.5, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.conv1 = conv(3, 64, 11, stride=4, padding=2, use_bias=False, generator=g)
        self.bn1 = _bn(64)
        self.conv2 = conv(64, 192, 5, stride=1, padding=2, use_bias=False, generator=g)
        self.bn2 = _bn(192)
        self.conv3 = conv(192, 384, 3, stride=1, padding=1, use_bias=False, generator=g)
        self.bn3 = _bn(384)
        self.conv4 = conv(384, 256, 3, stride=1, padding=1, use_bias=False, generator=g)
        self.bn4 = _bn(256)
        self.conv5 = conv(256, 256, 3, stride=1, padding=1, use_bias=False, generator=g)
        self.bn5 = _bn(256)
        # checkpoint-interop marker: fc1's input is a flattened conv map; the
        # reference flattens NCHW, this model NHWC, so a reference checkpoint's
        # fc1 columns are permuted (C, H, W) -> (H, W, C) on the way in
        self.flatten_linear = ("fc1", (256, 6, 6))
        self.fc1 = linear(256 * 6 * 6, 4096, use_bias=False, generator=g)
        self.bnf1 = _bn(4096)
        self.fc2 = linear(4096, 4096, use_bias=False, generator=g)
        self.bnf2 = _bn(4096)
        self.fc3 = linear(4096, num_classes, use_bias=True, generator=g)
        self.dropout = layers.Dropout(dropout, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(_maxpool(self.conv1(x))))
        x = F.relu(self.bn2(_maxpool(self.conv2(x))))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.relu(self.bn4(self.conv4(x)))
        x = F.relu(self.bn5(_maxpool(self.conv5(x))))
        x = x.reshape(x.shape[0], -1)  # NHWC 6x6x256 flatten
        x = self.dropout(F.relu(self.bnf1(self.fc1(x))))
        x = self.dropout(F.relu(self.bnf2(self.fc2(x))))
        return self.fc3(x)


def alexnet(num_classes: int = 1000, generator: Optional[torch.Generator] = None, **_) -> AlexNetOWTBN:
    """Factory ``alexnet(**model_config)``, the float model: parameters
    drawn on the CPU from ``generator`` (default: seed 0)."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    model = AlexNetOWTBN(num_classes, generator=generator)
    model.regime = ALEXNET_REGIME
    model.input_size = 224
    model.input_transform = "imagenet"
    return model
