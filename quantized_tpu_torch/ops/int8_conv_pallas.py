"""Direct int8 convolution with the fused epilogue (kernel K2), its
fused-residual form (B8) and the flat-row conv (B7).

Counterparts of the JAX package's ``int8_conv_direct`` and
``int8_conv_flat``: NHWC int8 in, the conv as an implicit GEMM with int32
accumulation, then ``y = acc * alpha + beta``, with a residual ``y = y + (r
+ (128 - r_zp)) * r_scale`` (B8), ReLU if asked, and either f32 out or the
requant ``clip(rint(y * f32(1/s) + (zp - 128)), -128, 127)`` onto the
consumer's grid.

K2 is one CUDA kernel behind one C entry (``csrc/int8_conv.cu``), counted
under three names that stand for the Pallas bodies, chosen like them:
per-tap, gather-K for small Cin (``cin <= 32`` with more than one tap) and
the residual form (always per-tap in JAX). The kernel takes any Cin,
gathering 16-byte chunks where Cin is a multiple of 16, 4-byte chunks where
it is a multiple of 4 (the space-to-depth stem, MobileNet at width 0.75)
and single bytes otherwise (the Cin-3 stems, Cin 9). B7 (``csrc/int8_conv_flat.cu``) runs
stride-1 convs over the zero-point-padded image's flattened rows, every tap
one read at a constant offset. The kernels take the weights packed (Cout,
Kh*Kw*Cin), which :class:`~quantized_tpu_torch.engine.int_layers.IntConv2d`
stores once at build time; :func:`int8_conv_direct` and
:func:`int8_conv_flat` keep the JAX signatures (HWIO), without the TPU
tiling arguments (``nb``, ``block_h``/``block_m``, ``block_n``,
``interpret``).

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernel or raises. The whole-block kernels are in
``ops/fused_block.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.int8_conv import Ints, _pair, int8_conv_acc, pack_conv_weight, pad_stored_zp
from quantized_tpu_torch.ops.int8_matmul import exact_int_matmul, f32

# one C entry (qt_int8_conv) behind the three counted forms: x, w, alpha,
# beta, residual (None but for B8), out; the shape; the epilogue's scalars
_CONV_ARGS = ["ptr"] * 6 + ["int"] * 16 + ["float"] * 4
CONV_TAP = _cuda.CudaKernel("int8_conv_direct", "int8_conv.cu", "qt_int8_conv", _CONV_ARGS)
CONV_GATHERK = _cuda.CudaKernel("int8_conv_direct_gatherk", "int8_conv.cu", "qt_int8_conv", _CONV_ARGS)
CONV_RESIDUAL = _cuda.CudaKernel("int8_conv_direct_residual", "int8_conv.cu", "qt_int8_conv", _CONV_ARGS)
CONV_FLAT = _cuda.CudaKernel("int8_conv_flat", "int8_conv_flat.cu", "qt_int8_conv_flat",
                             ["ptr"] * 5 + ["int"] * 11 + ["float"] * 2)


Grid = Tuple[float, int]


def use_gather_k(cin: int, kernel_size: Tuple[int, int]) -> bool:
    """The Pallas rule of ``int8_conv_direct``: ``cin <= 32 and taps > 1``."""
    kh, kw = kernel_size
    return cin <= 32 and kh * kw > 1


def flat_gather_k(cin: int, kernel_size: Tuple[int, int]) -> bool:
    """The Pallas rule of ``int8_conv_flat``: ``cin < 128 and taps > 1``."""
    kh, kw = kernel_size
    return cin < 128 and kh * kw > 1


def conv_out_hw(h: int, w: int, kernel_size, stride, padding) -> Tuple[int, int]:
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel_size), _pair(stride), _pair(padding)
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


def _epilogue(acc: torch.Tensor, alpha, beta, relu: bool, out_requant: Optional[Grid],
              residual: Optional[torch.Tensor] = None, res_grid: Optional[Grid] = None) -> torch.Tensor:
    """``int8_conv_direct``'s epilogue on an int32 accumulator, one float32
    rounding per operation: ``acc * alpha + beta``, the dequantized residual
    ``(r + (128 - r_zp)) * r_scale``, ReLU, then f32 out or the requant."""
    y = acc.to(torch.float32) * alpha + beta
    if residual is not None:
        r_scale, r_zp = res_grid
        y = y + (residual.to(torch.float32) + f32(128 - r_zp)) * f32(r_scale)
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_requant is None:
        return y
    q = torch.round(y * f32(1.0 / out_requant[0]) + f32(out_requant[1] - 128))
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


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
    out_requant: Optional[Grid] = None,
    *,
    residual: Optional[torch.Tensor] = None,
    res_grid: Optional[Grid] = None,
) -> torch.Tensor:
    """Plain version of K2 (and of B8, given ``residual``): exact int32
    accumulator, then the epilogue in ``int8_conv_direct``'s order."""
    acc = int8_conv_acc(x_q, w_ck, kernel_size, stride, padding, stored_zp)
    return _epilogue(acc, alpha, beta, relu, out_requant, residual, res_grid)


def _check_conv(x_q, w_ck, kh, kw, alpha, beta):
    cin, cout = x_q.shape[3], w_ck.shape[0]
    if w_ck.shape != (cout, kh * kw * cin):
        raise ValueError(f"packed weight {tuple(w_ck.shape)} does not fit a {kh}x{kw} conv over Cin={cin}")
    if alpha.shape != (cout,) or beta.shape != (cout,):
        raise ValueError(f"alpha/beta must have shape ({cout},)")
    _cuda.check_dtype(x_q, torch.int8, "x_q")
    _cuda.check_dtype(w_ck, torch.int8, "w")
    _cuda.check_dtype(alpha, torch.float32, "alpha")
    _cuda.check_dtype(beta, torch.float32, "beta")


def _requant_args(out_requant: Optional[Grid], shape, dev):
    """The output tensor and the kernels' (out_int8, inv, zps)."""
    if out_requant is None:
        return torch.empty(shape, dtype=torch.float32, device=dev), 0, 0.0, 0.0
    out = torch.empty(shape, dtype=torch.int8, device=dev)
    return out, 1, f32(1.0 / out_requant[0]), f32(out_requant[1] - 128)


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
    out_requant: Optional[Grid] = None,
    *,
    residual: Optional[torch.Tensor] = None,
    res_grid: Optional[Grid] = None,
) -> torch.Tensor:
    """K2 on packed (Cout, Kh*Kw*Cin) weights. NHWC f32 out, or int8 on
    ``out_requant``'s grid. ``residual`` (N, Ho, Wo, Cout) int8 on
    ``res_grid`` = (scale, zero point) is added before ReLU (B8)."""
    kh, kw = _pair(kernel_size)
    n, h, w, cin = x_q.shape
    cout = w_ck.shape[0]
    _check_conv(x_q, w_ck, kh, kw, alpha, beta)
    ho, wo = conv_out_hw(h, w, (kh, kw), stride, padding)
    if residual is not None:
        if res_grid is None:
            raise ValueError("residual requires res_grid=(scale, zero_point)")
        if residual.shape != (n, ho, wo, cout):
            raise ValueError(f"residual {tuple(residual.shape)} is not the output's shape {(n, ho, wo, cout)}")
        _cuda.check_dtype(residual, torch.int8, "residual")
    if x_q.device.type == "cpu":
        return int8_conv_direct_plain(x_q, w_ck, (kh, kw), alpha, beta, stride, padding, stored_zp, relu,
                                      out_requant, residual=residual, res_grid=res_grid)
    tensors = (x_q, w_ck, alpha, beta) + (() if residual is None else (residual,))
    dev = _cuda.require_cuda_tensors(*tensors)
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    out, out_int8, inv, zps = _requant_args(out_requant, (n, ho, wo, cout), dev)
    if residual is None:
        kernel, r_ptr, r_off, r_scale = CONV_GATHERK if use_gather_k(cin, (kh, kw)) else CONV_TAP, None, 0.0, 0.0
    else:
        kernel, r_ptr, r_off, r_scale = CONV_RESIDUAL, residual.data_ptr(), f32(128 - res_grid[1]), f32(res_grid[0])
    kernel(dev, x_q.data_ptr(), w_ck.data_ptr(), alpha.data_ptr(), beta.data_ptr(), r_ptr, out.data_ptr(),
           n, h, w, cin, cout, kh, kw, sh, sw, ph, pw, ho, wo, int(stored_zp), int(relu), out_int8, inv, zps,
           r_off, r_scale)
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
    out_requant: Optional[Grid] = None,
    *,
    residual: Optional[torch.Tensor] = None,
    res_grid: Optional[Grid] = None,
) -> torch.Tensor:
    """JAX-layout entry (``w_q`` HWIO); packs the weights on each call. JAX
    takes ``residual`` fifth; here it and ``res_grid`` are keywords, so the
    port's callers keep their positional ``stride``."""
    return int8_conv_direct_ck(x_q, pack_conv_weight(w_q), tuple(w_q.shape[:2]), alpha, beta,
                               stride, padding, stored_zp, relu, out_requant,
                               residual=residual, res_grid=res_grid)


# ----------------------------------------------------------------- B7, the flat-row conv


def _check_stride1(stride: Ints):
    if _pair(stride) != (1, 1):
        raise ValueError(f"int8_conv_flat is stride-1 only, got stride {stride}")


def int8_conv_flat_plain(
    x_q: torch.Tensor,
    w_ck: torch.Tensor,
    kernel_size: Tuple[int, int],
    alpha: torch.Tensor,
    beta: torch.Tensor,
    stride: Ints = 1,
    padding: Ints = 0,
    stored_zp: int = -128,
    relu: bool = False,
    out_requant: Optional[Grid] = None,
) -> torch.Tensor:
    """Plain version of B7, in the flat formulation: the zero-point-padded
    image's rows flattened to Hp*Wp, flat output row r reading flat input row
    r + dh*Wp + dw for tap (dh, dw), every one of the Ho*Wp rows computed and
    the junk columns (w >= Wo) dropped, then ``int8_conv_direct``'s epilogue."""
    _check_stride1(stride)
    kh, kw = _pair(kernel_size)
    xp = pad_stored_zp(x_q, padding, stored_zp)
    n, hp, wp, cin = xp.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    rows = ho * wp
    offs = [dh * wp + dw for dh in range(kh) for dw in range(kw)]
    x_flat = xp.reshape(n, hp * wp, cin)
    need = rows + offs[-1]  # flat rows the last output row's taps reach
    if need > hp * wp:
        x_flat = F.pad(x_flat, (0, 0, 0, need - hp * wp), value=int(stored_zp))
    patches = torch.cat([x_flat[:, off: off + rows] for off in offs], dim=-1)
    acc = exact_int_matmul(patches.reshape(n * rows, -1), w_ck).reshape(n, ho, wp, -1)[:, :, :wo]
    return _epilogue(acc, alpha, beta, relu, out_requant)


def int8_conv_flat_ck(
    x_q: torch.Tensor,
    w_ck: torch.Tensor,
    kernel_size: Tuple[int, int],
    alpha: torch.Tensor,
    beta: torch.Tensor,
    stride: Ints = 1,
    padding: Ints = 0,
    stored_zp: int = -128,
    relu: bool = False,
    out_requant: Optional[Grid] = None,
    gather_k: Optional[bool] = None,
) -> torch.Tensor:
    """B7 on packed (Cout, Kh*Kw*Cin) weights: stride 1 only. ``gather_k``
    (default: :func:`flat_gather_k`) walks K over all taps at once instead
    of tap by tap; both compute the same function."""
    _check_stride1(stride)
    kh, kw = _pair(kernel_size)
    n, h, w, cin = x_q.shape
    cout = w_ck.shape[0]
    _check_conv(x_q, w_ck, kh, kw, alpha, beta)
    if x_q.device.type == "cpu":
        return int8_conv_flat_plain(x_q, w_ck, (kh, kw), alpha, beta, stride, padding, stored_zp, relu,
                                    out_requant)
    dev = _cuda.require_cuda_tensors(x_q, w_ck, alpha, beta)
    if gather_k is None:
        gather_k = flat_gather_k(cin, (kh, kw))
    xp = pad_stored_zp(x_q, padding, stored_zp)
    _, hp, wp, _ = xp.shape
    out, out_int8, inv, zps = _requant_args(out_requant, (n, hp - kh + 1, wp - kw + 1, cout), dev)
    CONV_FLAT(dev, xp.data_ptr(), w_ck.data_ptr(), alpha.data_ptr(), beta.data_ptr(), out.data_ptr(),
              n, hp, wp, cin, cout, kh, kw, int(stored_zp), int(relu), out_int8, int(gather_k), inv, zps)
    return out


def int8_conv_flat(
    x_q: torch.Tensor,
    w_q: torch.Tensor,  # (Kh, Kw, Cin, Cout) int8
    alpha: torch.Tensor,
    beta: torch.Tensor,
    stride: Ints = 1,
    padding: Ints = 0,
    stored_zp: int = -128,
    relu: bool = False,
    out_requant: Optional[Grid] = None,
    gather_k: Optional[bool] = None,
) -> torch.Tensor:
    """JAX-layout entry (``w_q`` HWIO); packs the weights on each call."""
    return int8_conv_flat_ck(x_q, pack_conv_weight(w_q), tuple(w_q.shape[:2]), alpha, beta, stride, padding,
                             stored_zp, relu, out_requant, gather_k)
