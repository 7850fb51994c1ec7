"""Model registry of the port: ``get_model(name)(**config)``; the same
names as the JAX package's ``MODEL_REGISTRY``."""

from quantized_tpu_torch.models.alexnet import alexnet
from quantized_tpu_torch.models.alexnet_quantized import alexnet_quantized
from quantized_tpu_torch.models.mnist import mnist
from quantized_tpu_torch.models.mobilenet import mobilenet, mobilenet_quantized
from quantized_tpu_torch.models.resnet import resnet
from quantized_tpu_torch.models.resnet_quantized import resnet_quantized
from quantized_tpu_torch.models.resnet_quantized_float_bn import resnet_quantized_float_bn

MODEL_REGISTRY = {
    "alexnet": alexnet,
    "alexnet_quantized": alexnet_quantized,
    "mnist": mnist,
    "mobilenet": mobilenet,
    "mobilenet_quantized": mobilenet_quantized,
    "resnet": resnet,
    "resnet_quantized": resnet_quantized,
    "resnet_quantized_float_bn": resnet_quantized_float_bn,
}


def get_model(name: str):
    """Look up a model factory by its reference-compatible name."""
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}") from None
