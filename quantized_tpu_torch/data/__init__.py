"""Data layer of the port: the dataset registry (local files or a seeded
synthetic stand-in), the preprocessing transforms, and the binding of the
native C++ preprocessing pipeline."""

from quantized_tpu_torch.data.datasets import ArrayDataset, get_dataset
from quantized_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD, Transform, get_transform
