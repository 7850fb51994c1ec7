"""Quantized ResNet, float-BN flavor (counterpart of
``quantized_tpu/models/resnet_quantized_float_bn.py``): QConv2d/QLinear
around float BatchNorm (eps 1e-5, running weight 0.9)."""

from __future__ import annotations

from quantized_tpu_torch.models import layers
from quantized_tpu_torch.models.resnet_common import LayerKit, build_resnet

NUM_BITS = 8
NUM_BITS_WEIGHT = 8


def _qconv(cin, cout, k, stride=1, padding=0, use_bias=True, *, generator):
    return layers.QConv2d(cin, cout, k, stride=stride, padding=padding, use_bias=use_bias,
                          num_bits=NUM_BITS, num_bits_weight=NUM_BITS_WEIGHT, generator=generator)


def _qlinear(cin, cout, *, generator):
    return layers.QLinear(cin, cout, num_bits=NUM_BITS, num_bits_weight=NUM_BITS_WEIGHT,
                          generator=generator)


def _bn(c):
    return layers.BatchNorm(c, momentum=0.9, epsilon=1e-5)


FLOATBN_KIT = LayerKit(conv=_qconv, bn=_bn, linear=_qlinear)


def resnet_quantized_float_bn(**config):
    """Factory ``resnet_quantized_float_bn(**model_config)`` (CPU parameters)."""
    return build_resnet(FLOATBN_KIT, **config)
