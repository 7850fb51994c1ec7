"""Data helpers of the port."""

from quantized_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
