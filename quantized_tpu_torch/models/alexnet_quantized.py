"""Quantized AlexNet-OWT-BN (counterpart of
``quantized_tpu/models/alexnet_quantized.py``; BASELINE.json config #2,
"alexnet int8 quantized eval"): the AlexNet skeleton with QConv2d/QLinear
around float BN, each quantizing its output's cotangent at 8 bits in
training (no bi-precision). Factory: ``alexnet_quantized``."""

from __future__ import annotations

from typing import Optional

import torch

from quantized_tpu_torch.models import layers
from quantized_tpu_torch.models.alexnet import ALEXNET_REGIME, AlexNetOWTBN

NUM_BITS = 8
NUM_BITS_WEIGHT = 8
NUM_BITS_GRAD = 8


def _qconv(cin, cout, k, stride=1, padding=0, use_bias=True, *, generator):
    return layers.QConv2d(cin, cout, k, stride=stride, padding=padding, use_bias=use_bias,
                          num_bits=NUM_BITS, num_bits_weight=NUM_BITS_WEIGHT, num_bits_grad=NUM_BITS_GRAD,
                          generator=generator)


def _qlinear(cin, cout, use_bias=True, *, generator):
    return layers.QLinear(cin, cout, use_bias=use_bias, num_bits=NUM_BITS, num_bits_weight=NUM_BITS_WEIGHT,
                          num_bits_grad=NUM_BITS_GRAD, generator=generator)


def alexnet_quantized(num_classes: int = 1000, generator: Optional[torch.Generator] = None,
                      **_) -> AlexNetOWTBN:
    """Factory ``alexnet_quantized(**model_config)``: parameters drawn on the
    CPU from ``generator`` (default: seed 0)."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    model = AlexNetOWTBN(num_classes, conv=_qconv, linear=_qlinear, generator=generator)
    model.regime = ALEXNET_REGIME
    model.input_size = 224
    model.input_transform = "imagenet"
    return model
