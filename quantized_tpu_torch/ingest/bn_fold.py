"""BatchNorm folding (counterpart of ``quantized_tpu/ingest/bn_fold.py``).

Standard BN inference is ``y = (x - mu) / sqrt(var + eps) * gamma + beta``.
For a conv ``z = W * x + b`` feeding BN, folding absorbs the affine into the
conv (per out-channel c):

    f_c  = gamma_c / sqrt(var_c + eps)
    W'_c = W_c * f_c
    b'_c = beta_c + (b_c - mu_c) * f_c

Plain float32 numpy, in the JAX module's order of operations, so the folded
weights agree bit for bit. The RangeBN fold waits for the RangeBN slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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
