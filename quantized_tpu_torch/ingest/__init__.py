"""Checkpoint ingest of the port: BN folding, observer calibration, and the
bridge that carries the JAX model's arrays into the port's model."""

from quantized_tpu_torch.ingest.bn_fold import fold_bn_into_conv
from quantized_tpu_torch.ingest.calibrate import ActQParams, activation_qparams_from_observer
from quantized_tpu_torch.ingest.jax_arrays import load_jax_arrays
