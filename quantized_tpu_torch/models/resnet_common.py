"""ResNet skeleton of the port (counterpart of ``quantized_tpu/models/resnet_common.py``).

Geometries:
- ImageNet: 7x7/64 s2 stem, 3x3/s2 maxpool, four stages, global average
  pool, fc. Depths 18/34 (BasicBlock) and 50/101/152 (Bottleneck).
- CIFAR-10/100: 3x3/16 stem, three stages of n = (depth - 2) / 6
  BasicBlocks at 16/32/64 channels, global average pool, fc.

Layout NHWC, kernels HWIO; submodule names match the JAX model
(``layer1.0.conv1``, ``layer2.0.downsample.conv``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class LayerKit:
    """Constructors used by the skeleton. Signatures:
    conv(cin, cout, kernel_size, stride, padding, use_bias, generator=...),
    bn(c, generator=...), linear(cin, cout, generator=...)."""

    conv: Callable[..., nn.Module]
    bn: Callable[..., nn.Module]
    linear: Callable[..., nn.Module]


def _conv3x3(kit: LayerKit, cin: int, cout: int, stride: int, generator) -> nn.Module:
    return kit.conv(cin, cout, 3, stride=stride, padding=1, use_bias=False, generator=generator)


class Downsample(nn.Module):
    """1x1 strided conv + BN on the shortcut path."""

    def __init__(self, kit: LayerKit, cin: int, cout: int, stride: int, *, generator):
        super().__init__()
        self.conv = kit.conv(cin, cout, 1, stride=stride, padding=0, use_bias=False, generator=generator)
        self.bn = kit.bn(cout, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, kit: LayerKit, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[Downsample] = None, *, generator):
        super().__init__()
        self.conv1 = _conv3x3(kit, inplanes, planes, stride, generator)
        self.bn1 = kit.bn(planes, generator=generator)
        self.conv2 = _conv3x3(kit, planes, planes, 1, generator)
        self.bn2 = kit.bn(planes, generator=generator)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, kit: LayerKit, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[Downsample] = None, *, generator):
        super().__init__()
        g = generator
        self.conv1 = kit.conv(inplanes, planes, 1, stride=1, padding=0, use_bias=False, generator=g)
        self.bn1 = kit.bn(planes, generator=g)
        self.conv2 = _conv3x3(kit, planes, planes, stride, g)
        self.bn2 = kit.bn(planes, generator=g)
        self.conv3 = kit.conv(planes, planes * 4, 1, stride=1, padding=0, use_bias=False, generator=g)
        self.bn3 = kit.bn(planes * 4, generator=g)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + residual)


class _Stage(nn.Module):
    """Blocks named ``"0"``, ``"1"``, ... like the JAX stage."""

    def __init__(self, blocks: List[nn.Module]):
        super().__init__()
        for i, b in enumerate(blocks):
            self.add_module(str(i), b)
        self.num_blocks = len(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, str(i))(x)
        return x


def _make_stage(kit: LayerKit, block_cls, inplanes: int, planes: int, num_blocks: int, stride: int,
                generator):
    downsample = None
    if stride != 1 or inplanes != planes * block_cls.expansion:
        downsample = Downsample(kit, inplanes, planes * block_cls.expansion, stride, generator=generator)
    blocks = [block_cls(kit, inplanes, planes, stride, downsample, generator=generator)]
    inplanes = planes * block_cls.expansion
    for _ in range(1, num_blocks):
        blocks.append(block_cls(kit, inplanes, planes, generator=generator))
    return _Stage(blocks), inplanes


def max_pool_3x3_s2_nhwc(x: torch.Tensor) -> torch.Tensor:
    """3x3/s2/p1 max pool on NHWC floats (padding never wins the max)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


class ResNetImageNet(nn.Module):
    """ImageNet geometry (JAX ``ResNetImageNet``)."""

    def __init__(self, kit: LayerKit, block_cls, layers: Sequence[int], num_classes: int = 1000, *,
                 generator):
        super().__init__()
        g = generator
        self.conv1 = kit.conv(3, 64, 7, stride=2, padding=3, use_bias=False, generator=g)
        self.bn1 = kit.bn(64, generator=g)
        inplanes = 64
        self.layer1, inplanes = _make_stage(kit, block_cls, inplanes, 64, layers[0], 1, g)
        self.layer2, inplanes = _make_stage(kit, block_cls, inplanes, 128, layers[1], 2, g)
        self.layer3, inplanes = _make_stage(kit, block_cls, inplanes, 256, layers[2], 2, g)
        self.layer4, inplanes = _make_stage(kit, block_cls, inplanes, 512, layers[3], 2, g)
        self.fc = kit.linear(512 * block_cls.expansion, num_classes, generator=g)
        self.num_features = 512 * block_cls.expansion

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_3x3_s2_nhwc(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(x.mean(dim=(1, 2)))


class ResNetCifar(nn.Module):
    """CIFAR geometry (JAX ``ResNetCifar``): n = (depth - 2) // 6 BasicBlocks
    per stage."""

    def __init__(self, kit: LayerKit, depth: int = 18, num_classes: int = 10, *, generator):
        super().__init__()
        g = generator
        n = (depth - 2) // 6
        self.conv1 = kit.conv(3, 16, 3, stride=1, padding=1, use_bias=False, generator=g)
        self.bn1 = kit.bn(16, generator=g)
        inplanes = 16
        self.layer1, inplanes = _make_stage(kit, BasicBlock, inplanes, 16, n, 1, g)
        self.layer2, inplanes = _make_stage(kit, BasicBlock, inplanes, 32, n, 2, g)
        self.layer3, inplanes = _make_stage(kit, BasicBlock, inplanes, 64, n, 2, g)
        self.fc = kit.linear(64, num_classes, generator=g)
        self.num_features = 64

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.fc(x.mean(dim=(1, 2)))


IMAGENET_DEPTH_CONFIGS = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (Bottleneck, [3, 4, 6, 3]),
    101: (Bottleneck, [3, 4, 23, 3]),
    152: (Bottleneck, [3, 8, 36, 3]),
}


def build_resnet(kit: LayerKit, dataset: str = "imagenet", depth: int = 18,
                 num_classes: Optional[int] = None, generator: Optional[torch.Generator] = None
                 ) -> nn.Module:
    """Dataset/depth dispatch. Parameters are drawn on the CPU from
    ``generator`` (default: seed 0); the caller moves the model."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    if dataset == "imagenet":
        if depth not in IMAGENET_DEPTH_CONFIGS:
            raise ValueError(f"ImageNet depths are {sorted(IMAGENET_DEPTH_CONFIGS)}, got {depth}")
        block_cls, layers = IMAGENET_DEPTH_CONFIGS[depth]
        model = ResNetImageNet(kit, block_cls, layers, num_classes or 1000, generator=generator)
        model.input_size = 224
    elif dataset in ("cifar10", "cifar100"):
        default_classes = 10 if dataset == "cifar10" else 100
        model = ResNetCifar(kit, depth, num_classes or default_classes, generator=generator)
        model.input_size = 32
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    model.input_transform = dataset
    return model
