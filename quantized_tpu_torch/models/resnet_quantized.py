"""Quantized ResNet, RangeBN flavor (counterpart of
``quantized_tpu/models/resnet_quantized.py``, the reference's own model):
QConv2d/QLinear around RangeBN, with the reference's flagship training
setting (arXiv:1805.11046): 8-bit gradient quantization and bi-precision
convs and fc. Factory: ``resnet_quantized``."""

from __future__ import annotations

from quantized_tpu_torch.models import layers
from quantized_tpu_torch.models.resnet_common import LayerKit, build_resnet

NUM_BITS = 8
NUM_BITS_WEIGHT = 8
NUM_BITS_GRAD = 8
BIPRECISION = True


def _qconv(cin, cout, k, stride=1, padding=0, use_bias=True, *, generator):
    return layers.QConv2d(cin, cout, k, stride=stride, padding=padding, use_bias=use_bias,
                          num_bits=NUM_BITS, num_bits_weight=NUM_BITS_WEIGHT, num_bits_grad=NUM_BITS_GRAD,
                          biprecision=BIPRECISION, generator=generator)


def _qlinear(cin, cout, *, generator):
    return layers.QLinear(cin, cout, num_bits=NUM_BITS, num_bits_weight=NUM_BITS_WEIGHT,
                          num_bits_grad=NUM_BITS_GRAD, biprecision=BIPRECISION, generator=generator)


def _rangebn(c, *, generator):
    return layers.RangeBN(c, num_bits=NUM_BITS, num_bits_grad=NUM_BITS_GRAD, generator=generator)


RANGEBN_KIT = LayerKit(conv=_qconv, bn=_rangebn, linear=_qlinear)


def resnet_quantized(**config):
    """Factory ``resnet_quantized(**model_config)`` (CPU parameters)."""
    return build_resnet(RANGEBN_KIT, **config)
