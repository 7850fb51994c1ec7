"""Checkpoint ingest of the port: BN folding, observer calibration, the
bridge that carries the JAX model's arrays into the port's model, and the
loader of reference PyTorch checkpoints (``.pth.tar``)."""

from quantized_tpu_torch.ingest.bn_fold import fold_bn_into_conv, fold_rangebn_into_conv, rangebn_fold_params
from quantized_tpu_torch.ingest.calibrate import (
    ActQParams,
    WeightQParams,
    activation_qparams_from_observer,
    linear_weight_qparams_per_channel,
    weight_qparams_per_channel,
    weight_qparams_per_tensor,
)
from quantized_tpu_torch.ingest.jax_arrays import load_jax_arrays
from quantized_tpu_torch.ingest.torch_loader import load_into_model, load_reference_checkpoint, state_dict_to_port
