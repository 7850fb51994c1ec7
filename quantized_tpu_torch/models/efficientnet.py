"""EfficientNet-B0, float or with quantized convs. The first model of the
port that the JAX package lacks: its tests hold it against the plain
reference (``portbench/reference/efficientnet_b0.py``), not against JAX.

Tan & Le, "EfficientNet: Rethinking Model Scaling for CNNs" (ICML 2019,
arXiv:1905.11946), Table 1, with the block arguments of the authors'
release (``tensorflow/tpu`` ``models/official/efficientnet/efficientnet_builder.py``):

- a 3x3/2 stem conv to 32 channels, BN, SiLU;
- 16 MBConv blocks, :data:`B0_BLOCKS` as (expand, k, stride, out, repeats),
  the stride on a stage's first block. Each block: a 1x1 expand conv with
  BN and SiLU (none where expand is 1), a kxk depthwise conv with BN and
  SiLU, squeeze-excitation (the global mean, a 1x1 reduce conv with bias to
  ``max(1, int(0.25 * block_in))`` channels and SiLU, a 1x1 expand conv with
  bias back and the sigmoid, the product with the block's activation), a
  1x1 project conv with BN and no activation, and the identity skip where
  the stride is 1 and the width is kept (9 of the 16 blocks), through
  drop-connect while training;
- a 1x1 head conv to 1280 with BN and SiLU, the global mean, dropout while
  training, an fc to the classes.

Departures from the release: the padding is a symmetric ``k // 2`` (the
release pads "same", one more pixel at the bottom and right at stride 2);
the float kernels draw from the zoo's ``variance_scaling(2, fan_out)``
truncated normal and the fc from the zoo's uniform. BN is the release's:
eps 1e-3, momentum 0.99.

``efficientnet`` builds the float model with ``Conv2d``/``Linear``;
``efficientnet_quantized`` builds it with ``QConv2d``/``QLinear`` (a
``QuantMeasure`` on every conv and linear input) and one more
``QuantMeasure``, ``block<k>.dw_quant``, on each block's depthwise output
after its SiLU: the grid on which the int8 engine stores that activation
(``engine/int8_efficientnet.py``), a point the release's training graph
does not have. Layout NHWC, kernels HWIO (a depthwise kernel is (k, k, 1,
C)).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from quantized_tpu_torch.models import layers

NUM_BITS = 8
# (expand, kernel, stride, out channels, repeats) a stage: Table 1 of the paper
B0_BLOCKS = ((1, 3, 1, 16, 1), (6, 3, 2, 24, 2), (6, 5, 2, 40, 2), (6, 3, 2, 80, 3), (6, 5, 1, 112, 3),
             (6, 5, 2, 192, 4), (6, 3, 1, 320, 1))
STEM_WIDTH = 32
HEAD_WIDTH = 1280
SE_RATIO = 0.25
BN_EPS = 1e-3
BN_MOMENTUM = 0.99
DROP_CONNECT = 0.2  # the last block's rate; block i drops at DROP_CONNECT * i / blocks
DROPOUT = 0.2


# The release's schedule over its 350 epochs: RMSProp with momentum 0.9, lr
# 0.016 (at a batch of 256) decayed by 0.97 every 2.4 epochs, weight decay
# 1e-5 (its 5-epoch warmup and eps 1e-3 are not modelled)
EFFICIENTNET_REGIME = {0: {"optimizer": "rmsprop", "lr": 0.016, "momentum": 0.9, "weight_decay": 1e-5},
                       **{math.ceil(2.4 * i): {"lr": 0.016 * 0.97 ** i} for i in range(1, 146)}}


def block_args(blocks: Sequence[Sequence[int]] = B0_BLOCKS, stem_width: int = STEM_WIDTH
               ) -> List[Tuple[int, int, int, int, int]]:
    """Each block's (expand, kernel, stride, in channels, out channels)."""
    out, cin = [], stem_width
    for expand, k, stride, cout, repeats in blocks:
        for r in range(repeats):
            out.append((expand, k, stride if r == 0 else 1, cin, cout))
            cin = cout
    return out


def squeeze_width(cin: int) -> int:
    return max(1, int(SE_RATIO * cin))


def _bn(c: int) -> layers.BatchNorm:
    return layers.BatchNorm(c, momentum=BN_MOMENTUM, epsilon=BN_EPS)


class DropConnect(nn.Module):
    """Drops a whole sample's residual branch with probability ``p`` while
    training (kept samples divided by ``1 - p``), its mask drawn from a
    :class:`~quantized_tpu_torch.models.layers.RandomStream` of its own."""

    def __init__(self, p: float, *, generator: torch.Generator):
        super().__init__()
        self.p = p
        self.rng = layers.RandomStream(layers._seed_of(generator, "drop_connect"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand((x.shape[0], 1, 1, 1), generator=self.rng(x.device), device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class SqueezeExcite(nn.Module):
    """The global mean, ``reduce`` (1x1, bias) and SiLU, ``expand`` (1x1,
    bias) and the sigmoid: the gate, times the input."""

    def __init__(self, conv: Callable[..., nn.Module], c: int, squeeze: int, *, generator: torch.Generator):
        super().__init__()
        self.reduce = conv(c, squeeze, 1, use_bias=True, generator=generator)
        self.expand = conv(squeeze, c, 1, use_bias=True, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.silu(self.reduce(x.mean(dim=(1, 2), keepdim=True)))
        return x * torch.sigmoid(self.expand(s))


class MBConv(nn.Module):
    """One inverted-residual block (see the module docstring); ``dw_quant``
    is None in the float model."""

    def __init__(self, conv: Callable[..., nn.Module], expand: int, k: int, stride: int, cin: int, cout: int,
                 drop: float, num_bits: Optional[int], *, generator: torch.Generator):
        super().__init__()
        mid = cin * expand
        self.expand = conv(cin, mid, 1, use_bias=False, generator=generator) if expand != 1 else None
        self.bn0 = _bn(mid) if expand != 1 else None
        self.dw = conv(mid, mid, k, stride=stride, padding=k // 2, groups=mid, use_bias=False, generator=generator)
        self.bn1 = _bn(mid)
        self.dw_quant = layers.QuantMeasure(num_bits) if num_bits else None
        self.se = SqueezeExcite(conv, mid, squeeze_width(cin), generator=generator)
        self.project = conv(mid, cout, 1, use_bias=False, generator=generator)
        self.bn2 = _bn(cout)
        self.skip = stride == 1 and cin == cout
        self.drop = DropConnect(drop, generator=generator) if self.skip else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.expand is None else F.silu(self.bn0(self.expand(x)))
        h = F.silu(self.bn1(self.dw(h)))
        if self.dw_quant is not None:
            h = self.dw_quant(h)
        h = self.bn2(self.project(self.se(h)))
        return x + self.drop(h) if self.skip else h


class EfficientNet(nn.Module):
    """``conv(cin, cout, k, stride=, padding=, groups=, use_bias=,
    generator=)`` and ``linear(cin, cout, generator=)`` build its layers;
    ``num_bits`` (the quantized flavor) adds each block's ``dw_quant``."""

    def __init__(self, num_classes: int = 1000, blocks: Sequence[Sequence[int]] = B0_BLOCKS,
                 stem_width: int = STEM_WIDTH, head_width: int = HEAD_WIDTH,
                 conv: Optional[Callable[..., nn.Module]] = None, linear: Optional[Callable[..., nn.Module]] = None,
                 num_bits: Optional[int] = None, *, generator: torch.Generator):
        super().__init__()
        conv = conv or layers.Conv2d
        linear = linear or layers.Linear
        self.conv1 = conv(3, stem_width, 3, stride=2, padding=1, use_bias=False, generator=generator)
        self.bn1 = _bn(stem_width)
        args = block_args(blocks, stem_width)
        for i, (expand, k, stride, cin, cout) in enumerate(args):
            self.add_module(f"block{i}", MBConv(conv, expand, k, stride, cin, cout, DROP_CONNECT * i / len(args),
                                                num_bits, generator=generator))
        self.num_blocks = len(args)
        self.head = conv(args[-1][4], head_width, 1, use_bias=False, generator=generator)
        self.bn_head = _bn(head_width)
        self.dropout = layers.Dropout(DROPOUT, generator=generator)
        self.fc = linear(head_width, num_classes, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.bn1(self.conv1(x)))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        x = F.silu(self.bn_head(self.head(x)))
        return self.fc(self.dropout(x.mean(dim=(1, 2))))


def _finish(model: EfficientNet) -> EfficientNet:
    model.regime = EFFICIENTNET_REGIME
    model.input_size = 224
    model.input_transform = "imagenet"
    return model


def efficientnet(num_classes: int = 1000, blocks: Sequence[Sequence[int]] = B0_BLOCKS,
                 stem_width: int = STEM_WIDTH, head_width: int = HEAD_WIDTH,
                 generator: Optional[torch.Generator] = None, **_) -> EfficientNet:
    """Factory ``efficientnet(**model_config)``, the float B0 (or another
    block list): parameters drawn on the CPU from ``generator`` (default:
    seed 0)."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    return _finish(EfficientNet(num_classes, blocks, stem_width, head_width, generator=generator))


def efficientnet_quantized(num_classes: int = 1000, blocks: Sequence[Sequence[int]] = B0_BLOCKS,
                           stem_width: int = STEM_WIDTH, head_width: int = HEAD_WIDTH, num_bits: int = NUM_BITS,
                           generator: Optional[torch.Generator] = None, **_) -> EfficientNet:
    """Factory ``efficientnet_quantized(**model_config)``: QConv2d/QLinear
    around float BN, and each block's depthwise observer; parameters drawn
    on the CPU from ``generator`` (default: seed 0)."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    qconv = functools.partial(layers.QConv2d, num_bits=num_bits)
    qlinear = functools.partial(layers.QLinear, num_bits=num_bits)
    return _finish(EfficientNet(num_classes, blocks, stem_width, head_width, conv=qconv, linear=qlinear,
                                num_bits=num_bits, generator=generator))
