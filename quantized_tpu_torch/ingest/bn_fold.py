"""BatchNorm folding (counterpart of ``quantized_tpu/ingest/bn_fold.py``).

Standard BN inference is ``y = (x - mu) / sqrt(var + eps) * gamma + beta``.
For a conv ``z = W * x + b`` feeding BN, folding absorbs the affine into the
conv (per out-channel c):

    f_c  = gamma_c / sqrt(var_c + eps)
    W'_c = W_c * f_c
    b'_c = beta_c + (b_c - mu_c) * f_c

RangeBN inference is ``y = (x - mu) / (scale + eps) * q(gamma) + q(beta)``,
where ``running_var`` holds the range-derived scale and the scale, gamma
and beta vectors pass through 8-bit fake-quant; its fold uses ``f_c =
q(gamma)_c / (q(scale)_c + eps)`` and ``q(beta)``
(:func:`rangebn_fold_params`, the one source of the fold's factors and of
the engine's observer clamp, ``engine.convert._rangebn_y_clip``).

Plain float32 numpy, in the JAX module's order of operations, so the folded
weights agree bit for bit (the fake-quant of the RangeBN vectors runs in
float32 torch, as the JAX module's runs in float32 jnp).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from quantized_tpu_torch.quantcore.affine import fake_quant_array


def fold_bn_into_conv(
    kernel_hwio: np.ndarray,
    bias: Optional[np.ndarray],
    gamma: np.ndarray,
    beta: np.ndarray,
    mean: np.ndarray,
    var: np.ndarray,
    eps: float = 1e-5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold standard float BN into HWIO conv weights. Returns (W', b')."""
    kernel_hwio = np.asarray(kernel_hwio, np.float32)
    factor = np.asarray(gamma, np.float32) / np.sqrt(np.asarray(var, np.float32) + eps)
    w = kernel_hwio * factor[None, None, None, :]
    b0 = np.zeros_like(factor) if bias is None else np.asarray(bias, np.float32)
    b = np.asarray(beta, np.float32) + (b0 - np.asarray(mean, np.float32)) * factor
    return w, b


def _fake_quant_np(v: np.ndarray, num_bits: int, own_range: bool) -> np.ndarray:
    """float32 fake-quant of a vector: on its own min/max, or on the chunk
    estimator's default (its global) range."""
    t = torch.from_numpy(np.asarray(v, np.float32))
    if own_range:
        return fake_quant_array(t, num_bits=num_bits, min_value=float(t.min()), max_value=float(t.max())).numpy()
    return fake_quant_array(t, num_bits=num_bits).numpy()


def rangebn_fold_params(
    gamma: Optional[np.ndarray],
    beta: Optional[np.ndarray],
    scale: np.ndarray,
    eps: float = 1e-5,
    num_bits: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """(factor, qbeta) of the RangeBN eval affine ``y = factor * (z - mean) +
    qbeta``, with the scale, gamma and beta vectors quantized as RangeBN's
    eval quantizes them: the one source of every fold's factors and of the
    engine's observer clamp, which must use the same factors."""
    scale = np.asarray(scale, np.float32)
    qscale = _fake_quant_np(scale, num_bits, own_range=True)
    qgamma = _fake_quant_np(gamma, num_bits, own_range=True) if gamma is not None else np.ones_like(scale)
    qbeta = _fake_quant_np(beta, num_bits, own_range=False) if beta is not None else np.zeros_like(scale)
    return (qgamma / (qscale + eps)).astype(np.float32), qbeta.astype(np.float32)


def fold_rangebn_into_conv(
    kernel_hwio: np.ndarray,
    bias: Optional[np.ndarray],
    gamma: Optional[np.ndarray],
    beta: Optional[np.ndarray],
    mean: np.ndarray,
    scale: np.ndarray,
    eps: float = 1e-5,
    num_bits: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold RangeBN (``running_var`` = the range-derived scale) into HWIO
    conv weights. Returns (W', b')."""
    kernel_hwio = np.asarray(kernel_hwio, np.float32)
    factor, qbeta = rangebn_fold_params(gamma, beta, scale, eps=eps, num_bits=num_bits)
    w = kernel_hwio * factor[None, None, None, :]
    b0 = np.zeros_like(factor) if bias is None else np.asarray(bias, np.float32)
    b = qbeta + (b0 - np.asarray(mean, np.float32)) * factor
    return w, b
