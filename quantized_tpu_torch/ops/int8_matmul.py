"""int8 GEMM with the fused dequant/requant epilogue (kernel K1).

Integer contract (as in the JAX package): activations are logical uint8
``u`` on [0, 255] with integer zero-point ``zp``, stored as int8 ``a = u -
128``; weights are symmetric int8 with per-output-channel scales. The real
product folds into one per-column affine of the int32 accumulator:

    y_c = acc_c * alpha_c + beta_c
    alpha_c = s_a * s_wc
    beta_c  = alpha_c * (128 - zp) * colsum_c + bias_c

Public functions keep the JAX layouts: ``b`` is (K, N). The kernel wants the
weights K-major, (N, K); :class:`~quantized_tpu_torch.engine.int_layers.IntLinear`
stores that copy once, at build time, and calls the ``*_nk`` wrappers.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the CUDA kernel (``csrc/int8_gemm.cu``) or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from quantized_tpu_torch.ops import _cuda

_MATMUL = _cuda.CudaKernel(
    "int8_matmul", "int8_gemm.cu", "qt_int8_matmul",
    ["ptr"] * 5 + ["int"] * 4,
)
_MATMUL_REQUANT = _cuda.CudaKernel(
    "int8_matmul_requant", "int8_gemm.cu", "qt_int8_matmul_requant",
    ["ptr"] * 5 + ["int"] * 3 + ["float"] * 3,
)


def f32(v: float) -> float:
    """The float32 value of a Python scalar, as ``jnp.float32(v)`` makes it."""
    return float(np.float32(v))


def matmul_epilogue_params(
    act_scale: float,
    act_zero_point: int,
    weight_scale: torch.Tensor,  # (N,) f32 per-channel (or scalar broadcast)
    weight_colsum: torch.Tensor,  # (N,) int32: sum_k w[k, c]
    bias: Optional[torch.Tensor] = None,  # (N,) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute (alpha, beta) for the fused epilogue, in float32 and in the
    JAX package's order of operations."""
    ws = torch.broadcast_to(torch.as_tensor(weight_scale, dtype=torch.float32), weight_colsum.shape)
    alpha = torch.tensor(f32(act_scale), dtype=torch.float32) * ws
    beta = alpha * torch.tensor(f32(128 - act_zero_point), dtype=torch.float32) * weight_colsum.to(torch.float32)
    if bias is not None:
        beta = beta + torch.as_tensor(bias, dtype=torch.float32)
    return alpha, beta


def requant_scalars(out_scale: float, out_zp: int, relu: bool) -> Tuple[float, float, float]:
    """(inv, zps, lo) of the requant epilogue: ``inv = f32(1/s)``, ``zps =
    zp - 128``, ``lo`` = the clip floor (zps when ReLU is folded in)."""
    inv = f32(1.0 / out_scale)
    zps = f32(out_zp - 128)
    lo = zps if relu else -128.0
    return inv, zps, lo


def exact_int_matmul(a: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """int32 ``a @ w_nk.T`` for int8 operands, exactly: int32 on the CPU;
    float64 on a GPU, which has no integer matmul (|acc| <= 128*127*K stays
    far below 2**53, so every partial sum is exact)."""
    if a.is_cuda:
        return (a.to(torch.float64) @ w_nk.to(torch.float64).T).to(torch.int32)
    return a.to(torch.int32) @ w_nk.to(torch.int32).T


def _epilogue_f32(acc: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, relu: bool) -> torch.Tensor:
    y = acc.to(torch.float32) * alpha + beta
    return torch.clamp_min(y, 0.0) if relu else y


def int8_matmul_plain(a, w_nk, alpha, beta, relu: bool = False) -> torch.Tensor:
    """Plain version of K1's f32 form: ``relu?(A @ W^T * alpha + beta)``."""
    return _epilogue_f32(exact_int_matmul(a, w_nk), alpha, beta, relu)


def int8_matmul_requant_plain(a, w_nk, alpha, beta, out_scale: float, out_zp: int,
                              relu: bool = True) -> torch.Tensor:
    """Plain version of K1's requant form, in ``_requant_kernel``'s order:
    1/s folds into alpha/beta, the -128 shift into the zero-point, ReLU into
    the clip floor."""
    inv, zps, lo = requant_scalars(out_scale, out_zp, relu)
    alpha2 = alpha * inv
    beta2 = beta * inv + zps
    q = torch.round(exact_int_matmul(a, w_nk).to(torch.float32) * alpha2 + beta2)
    return torch.clamp(q, lo, 127.0).to(torch.int8)


def _check(a, w_nk, alpha, beta):
    if a.ndim != 2 or w_nk.ndim != 2 or a.shape[1] != w_nk.shape[1]:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(w_nk.shape)}^T do not multiply")
    n = w_nk.shape[0]
    if alpha.shape != (n,) or beta.shape != (n,):
        raise ValueError(f"alpha/beta must have shape ({n},)")
    _cuda.check_dtype(a, torch.int8, "a")
    _cuda.check_dtype(w_nk, torch.int8, "w")
    _cuda.check_dtype(alpha, torch.float32, "alpha")
    _cuda.check_dtype(beta, torch.float32, "beta")


def int8_matmul_nk(a, w_nk, alpha, beta, relu: bool = False) -> torch.Tensor:
    """f32 ``relu?(A @ W^T * alpha + beta)``; A (M, K) s8, W (N, K) s8."""
    _check(a, w_nk, alpha, beta)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, w_nk, alpha, beta, relu)
    dev = _cuda.require_cuda_tensors(a, w_nk, alpha, beta)
    (m, k), n = a.shape, w_nk.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    _MATMUL(dev, a.data_ptr(), w_nk.data_ptr(), alpha.data_ptr(), beta.data_ptr(), out.data_ptr(),
            m, n, k, int(relu))
    return out


def int8_matmul_requant_nk(a, w_nk, alpha, beta, out_scale: float, out_zp: int,
                           relu: bool = True) -> torch.Tensor:
    """s8 output on the (out_scale, out_zp) grid (stored u - 128)."""
    _check(a, w_nk, alpha, beta)
    if a.device.type == "cpu":
        return int8_matmul_requant_plain(a, w_nk, alpha, beta, out_scale, out_zp, relu)
    dev = _cuda.require_cuda_tensors(a, w_nk, alpha, beta)
    (m, k), n = a.shape, w_nk.shape[0]
    inv, zps, lo = requant_scalars(out_scale, out_zp, relu)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    _MATMUL_REQUANT(dev, a.data_ptr(), w_nk.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                    out.data_ptr(), m, n, k, inv, zps, lo)
    return out


def int8_matmul(a, b, alpha, beta, relu: bool = False) -> torch.Tensor:
    """JAX-layout entry: ``b`` is (K, N)."""
    return int8_matmul_nk(a, b.T.contiguous(), alpha, beta, relu)


def int8_matmul_requant(a, b, alpha, beta, out_scale: float, out_zp: int,
                        relu: bool = True) -> torch.Tensor:
    """JAX-layout entry: ``b`` is (K, N)."""
    return int8_matmul_requant_nk(a, b.T.contiguous(), alpha, beta, out_scale, out_zp, relu)
