"""MobileNet-v1 with quantized convs (counterpart of
``quantized_tpu/models/mobilenet.py``).

Standard v1: 3x3/32 s2 stem then 13 depthwise-separable blocks (dw 3x3 +
pw 1x1, BN + ReLU after each), global average pool, fc 1024 -> classes.
Layout NHWC, kernels HWIO (a depthwise kernel is (3, 3, 1, C)); submodule
names match the JAX model (``conv1``, ``bn1``, ``block{i}.dw/bn1/pw/bn2``,
``fc``), so its state maps onto this one key for key.

Only the quantized factory ``mobilenet_quantized`` is ported; the float
``mobilenet`` and the training regime wait with the float twins and the
training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from quantized_tpu_torch.models import layers

NUM_BITS = 8

# (out_channels, stride) per separable block
_V1_CONFIG = [
    (64, 1),
    (128, 2),
    (128, 1),
    (256, 2),
    (256, 1),
    (512, 2),
    (512, 1),
    (512, 1),
    (512, 1),
    (512, 1),
    (512, 1),
    (1024, 2),
    (1024, 1),
]


def _bn(c: int) -> layers.BatchNorm:
    return layers.BatchNorm(c, momentum=0.9, epsilon=1e-5)


class _SeparableBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, num_bits: int, *, generator: torch.Generator):
        super().__init__()
        self.dw = layers.QConv2d(cin, cin, 3, stride=stride, padding=1, groups=cin, use_bias=False,
                                 num_bits=num_bits, generator=generator)
        self.bn1 = _bn(cin)
        self.pw = layers.QConv2d(cin, cout, 1, stride=1, padding=0, use_bias=False,
                                 num_bits=num_bits, generator=generator)
        self.bn2 = _bn(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.dw(x)))
        return F.relu(self.bn2(self.pw(x)))


class MobileNetV1(nn.Module):
    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0, num_bits: int = NUM_BITS, *,
                 generator: torch.Generator):
        super().__init__()
        c = int(32 * width_mult)
        self.conv1 = layers.QConv2d(3, c, 3, stride=2, padding=1, use_bias=False, num_bits=num_bits,
                                    generator=generator)
        self.bn1 = _bn(c)
        for i, (cout_base, stride) in enumerate(_V1_CONFIG):
            cout = int(cout_base * width_mult)
            self.add_module(f"block{i}", _SeparableBlock(c, cout, stride, num_bits, generator=generator))
            c = cout
        self.num_blocks = len(_V1_CONFIG)
        self.fc = layers.QLinear(c, num_classes, num_bits=num_bits, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return self.fc(x.mean(dim=(1, 2)))


def _finish(model: MobileNetV1) -> MobileNetV1:
    model.input_size = 224
    model.input_transform = "imagenet"
    return model


def mobilenet_quantized(num_classes: int = 1000, width_mult: float = 1.0, num_bits: int = NUM_BITS,
                        generator: Optional[torch.Generator] = None, **_) -> MobileNetV1:
    """Factory ``mobilenet_quantized(**model_config)``: QConv2d/QLinear
    around float BN; parameters drawn on the CPU from ``generator``
    (default: seed 0)."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    return _finish(MobileNetV1(num_classes, width_mult, num_bits, generator=generator))
