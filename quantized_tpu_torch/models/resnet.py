"""Float ResNet (counterpart of ``quantized_tpu/models/resnet.py``): the fp32
twin of the quantized ResNets, the baseline a throughput ratio divides by.
Factory: ``resnet``; its state carries the JAX model's keys."""

from __future__ import annotations

from quantized_tpu_torch.models import layers
from quantized_tpu_torch.models.resnet_common import LayerKit, build_resnet


def _bn(c):
    # torch's BN momentum 0.1 is a running weight of 0.9
    return layers.BatchNorm(c, momentum=0.9, epsilon=1e-5)


FLOAT_KIT = LayerKit(conv=layers.Conv2d, bn=_bn, linear=layers.Linear)


def resnet(**config):
    """Factory ``resnet(**model_config)`` (CPU parameters)."""
    return build_resnet(FLOAT_KIT, **config)
