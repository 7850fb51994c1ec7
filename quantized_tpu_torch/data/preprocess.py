"""Preprocessing constants of the port (counterpart of
``quantized_tpu/data/preprocess.py``): the ImageNet normalization stats that
the uint8 ingest folds into its quantize. The transform pipelines wait for
the data slice."""

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
