"""Direct int8 convolution with the fused epilogue (kernel K2).

Counterpart of the JAX package's ``int8_conv_direct``: NHWC int8 in, the
conv as an implicit GEMM with int32 accumulation, then ``y = acc * alpha +
beta``, ReLU if asked, and either f32 out or the requant ``clip(rint(y *
f32(1/s) + (zp - 128)), -128, 127)`` onto the consumer's grid.

Two forms of one CUDA kernel (``csrc/int8_conv.cu``), chosen like the Pallas
ones: per-tap (Cin a multiple of 16), and gather-K for small Cin (``cin <=
32`` with more than one tap, where a K step straddles taps; any Cin, in
4-byte chunks where Cin is a multiple of 4 and in single bytes otherwise,
as for the CIFAR stem's Cin = 3). A per-tap conv over a Cin that is not a
multiple of 16 raises on the GPU. The kernels take the weights packed
(Cout, Kh*Kw*Cin), which
:class:`~quantized_tpu_torch.engine.int_layers.IntConv2d` stores once at
build time; :func:`int8_conv_direct` keeps the JAX signature (HWIO).

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernel or raises. The fused-residual variant
(``_conv_residual_kernel``) and ``int8_conv_flat`` are not ported yet; the
whole-block kernels are in ``ops/fused_block.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.int8_conv import Ints, _pair, int8_conv_acc, pack_conv_weight
from quantized_tpu_torch.ops.int8_matmul import f32

_CONV_ARGS = ["ptr"] * 5 + ["int"] * 16 + ["float"] * 2
CONV_TAP = _cuda.CudaKernel("int8_conv_direct", "int8_conv.cu", "qt_int8_conv_tap", _CONV_ARGS)
CONV_GATHERK = _cuda.CudaKernel(
    "int8_conv_direct_gatherk", "int8_conv.cu", "qt_int8_conv_gatherk", _CONV_ARGS
)


def use_gather_k(cin: int, kernel_size: Tuple[int, int]) -> bool:
    """The Pallas rule: ``cin <= 32 and taps > 1``."""
    kh, kw = kernel_size
    return cin <= 32 and kh * kw > 1


def conv_out_hw(h: int, w: int, kernel_size, stride, padding) -> Tuple[int, int]:
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel_size), _pair(stride), _pair(padding)
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


def int8_conv_direct_plain(
    x_q: torch.Tensor,
    w_ck: torch.Tensor,
    kernel_size: Tuple[int, int],
    alpha: torch.Tensor,
    beta: torch.Tensor,
    stride: Ints = 1,
    padding: Ints = 0,
    stored_zp: int = -128,
    relu: bool = False,
    out_requant: Optional[Tuple[float, int]] = None,
) -> torch.Tensor:
    """Plain version of K2: exact int32 accumulator, then the epilogue in
    ``int8_conv_direct``'s order, one float32 rounding per operation."""
    acc = int8_conv_acc(x_q, w_ck, kernel_size, stride, padding, stored_zp)
    y = acc.to(torch.float32) * alpha + beta
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_requant is None:
        return y
    q = torch.round(y * f32(1.0 / out_requant[0]) + f32(out_requant[1] - 128))
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def int8_conv_direct_ck(
    x_q: torch.Tensor,
    w_ck: torch.Tensor,
    kernel_size: Tuple[int, int],
    alpha: torch.Tensor,
    beta: torch.Tensor,
    stride: Ints = 1,
    padding: Ints = 0,
    stored_zp: int = -128,
    relu: bool = False,
    out_requant: Optional[Tuple[float, int]] = None,
) -> torch.Tensor:
    """K2 on packed (Cout, Kh*Kw*Cin) weights. NHWC f32 out, or int8 on
    ``out_requant``'s grid."""
    kh, kw = _pair(kernel_size)
    n, h, w, cin = x_q.shape
    cout = w_ck.shape[0]
    if w_ck.shape != (cout, kh * kw * cin):
        raise ValueError(f"packed weight {tuple(w_ck.shape)} does not fit a {kh}x{kw} conv over Cin={cin}")
    if alpha.shape != (cout,) or beta.shape != (cout,):
        raise ValueError(f"alpha/beta must have shape ({cout},)")
    _cuda.check_dtype(x_q, torch.int8, "x_q")
    _cuda.check_dtype(w_ck, torch.int8, "w")
    _cuda.check_dtype(alpha, torch.float32, "alpha")
    _cuda.check_dtype(beta, torch.float32, "beta")
    if x_q.device.type == "cpu":
        return int8_conv_direct_plain(x_q, w_ck, (kh, kw), alpha, beta, stride, padding,
                                      stored_zp, relu, out_requant)
    dev = _cuda.require_cuda_tensors(x_q, w_ck, alpha, beta)
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    ho, wo = conv_out_hw(h, w, (kh, kw), (sh, sw), (ph, pw))
    if out_requant is None:
        out = torch.empty((n, ho, wo, cout), dtype=torch.float32, device=dev)
        inv = zps = 0.0
    else:
        out = torch.empty((n, ho, wo, cout), dtype=torch.int8, device=dev)
        inv, zps = f32(1.0 / out_requant[0]), f32(out_requant[1] - 128)
    kernel = CONV_GATHERK if use_gather_k(cin, (kh, kw)) else CONV_TAP
    if kernel is CONV_TAP and cin % 16:
        raise ValueError(f"{kernel.name} gathers 16-byte chunks and needs Cin % 16 == 0, got Cin={cin}")
    kernel(dev, x_q.data_ptr(), w_ck.data_ptr(), alpha.data_ptr(), beta.data_ptr(), out.data_ptr(),
           n, h, w, cin, cout, kh, kw, sh, sw, ph, pw, ho, wo,
           int(stored_zp), int(relu), int(out_requant is not None), inv, zps)
    return out


def int8_conv_direct(
    x_q: torch.Tensor,
    w_q: torch.Tensor,  # (Kh, Kw, Cin, Cout) int8
    alpha: torch.Tensor,
    beta: torch.Tensor,
    stride: Ints = 1,
    padding: Ints = 0,
    stored_zp: int = -128,
    relu: bool = False,
    out_requant: Optional[Tuple[float, int]] = None,
) -> torch.Tensor:
    """JAX-layout entry (``w_q`` HWIO); packs the weights on each call."""
    return int8_conv_direct_ck(x_q, pack_conv_weight(w_q), tuple(w_q.shape[:2]), alpha, beta,
                               stride, padding, stored_zp, relu, out_requant)
