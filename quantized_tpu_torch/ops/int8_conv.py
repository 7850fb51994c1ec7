"""Int8 convolution helpers: zero-point padding, im2col, the im2col + K1
GEMM path (``int8_conv_gemm``) and the plain reference ``int8_conv_xla``,
which also runs the grouped convs (depthwise or any other grouping) that
the JAX package leaves to XLA, with its int16 emission (``round_s16``:
:func:`clip_s16_checked`, whose saturations ``QTPU_DEBUG_S16`` counts), and
the float conv of the bf16 backends (:func:`bf16_conv`).

Layouts are the JAX package's: NHWC int8 activations (stored u - 128), HWIO
int8 kernels. Padded taps hold the *stored zero-point* so they contribute
exactly 0 (see int8_matmul.py); padding with 0 would be wrong at every border
pixel.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from quantized_tpu_torch.ops.int8_matmul import (
    acc_epilogue,
    exact_int_matmul,
    int8_matmul_nk,
    int8_matmul_requant_nk,
)

Ints = Union[int, Tuple[int, int]]


def _pair(v: Ints) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def pad_stored_zp(x_q: torch.Tensor, padding: Ints, stored_zp: int) -> torch.Tensor:
    """Pad NHWC int8 activations with the stored zero-point (= zp - 128)."""
    ph, pw = _pair(padding)
    if ph == 0 and pw == 0:
        return x_q
    return F.pad(x_q, (0, 0, pw, pw, ph, ph), value=int(stored_zp))


def im2col_int8(x_q: torch.Tensor, kernel_size: Ints, stride: Ints = 1) -> torch.Tensor:
    """(N, Ho, Wo, Kh*Kw*C) patches of an already padded NHWC tensor, K
    ordered (kh, kw, c) to match an HWIO kernel reshaped to (Kh*Kw*Cin, Cout)."""
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride)
    n, h, w, c = x_q.shape
    ho = (h - kh) // sh + 1
    wo = (w - kw) // sw + 1
    cols = [
        x_q[:, i: i + (ho - 1) * sh + 1: sh, j: j + (wo - 1) * sw + 1: sw, :]
        for i in range(kh) for j in range(kw)
    ]
    return torch.stack(cols, dim=3).reshape(n, ho, wo, kh * kw * c)


def pack_conv_weight(w_q: torch.Tensor) -> torch.Tensor:
    """HWIO int8 kernel -> (Cout, Kh*Kw*Cin), K in (kh, kw, c) order: the
    K-major operand both conv kernels and the im2col GEMM take."""
    kh, kw, cin, cout = w_q.shape
    return w_q.permute(3, 0, 1, 2).reshape(cout, kh * kw * cin).contiguous()


def int8_conv_gemm_ck(
    x_q: torch.Tensor,
    w_ck: torch.Tensor,  # (Cout, Kh*Kw*Cin)
    kernel_size: Tuple[int, int],
    alpha: torch.Tensor,
    beta: torch.Tensor,
    stride: Ints = 1,
    padding: Ints = 0,
    stored_zp: int = -128,
    relu: bool = False,
    out_requant: Optional[Tuple[float, int]] = None,
) -> torch.Tensor:
    """im2col + K1 on packed weights. NHWC f32 out, or int8 on ``out_requant``."""
    xp = pad_stored_zp(x_q, padding, stored_zp)
    patches = im2col_int8(xp, kernel_size, stride)
    n, ho, wo, k = patches.shape
    a = patches.reshape(n * ho * wo, k)
    if out_requant is None:
        y = int8_matmul_nk(a, w_ck, alpha, beta, relu=relu)
    else:
        y = int8_matmul_requant_nk(a, w_ck, alpha, beta, out_requant[0], out_requant[1], relu=relu)
    return y.reshape(n, ho, wo, w_ck.shape[0])


def int8_conv_gemm(x_q, w_q, alpha, beta, stride: Ints = 1, padding: Ints = 0,
                   stored_zp: int = -128, relu: bool = False,
                   out_requant: Optional[Tuple[float, int]] = None) -> torch.Tensor:
    """JAX-layout entry (``w_q`` HWIO)."""
    return int8_conv_gemm_ck(x_q, pack_conv_weight(w_q), tuple(w_q.shape[:2]), alpha, beta,
                             stride, padding, stored_zp, relu, out_requant)


def int8_conv_acc(x_q: torch.Tensor, w_ck: torch.Tensor, kernel_size: Ints, stride: Ints,
                  padding: Ints, stored_zp: int, groups: int = 1) -> torch.Tensor:
    """Exact int32 NHWC accumulator of the zero-point-padded conv, on packed
    weights (Cout, Kh*Kw*C/groups); with ``groups`` > 1 output channels
    [g*Cout/groups, (g+1)*Cout/groups) read input channels
    [g*C/groups, (g+1)*C/groups), as ``feature_group_count`` does.
    ``F.conv2d`` in int32 on the CPU. A GPU has no integer conv, and a
    float conv library may pick a transform (FFT, Winograd) that rounds, so
    there it is im2col and a float64 matmul per group (every partial sum is
    an integer below 2**53, so exact)."""
    kh, kw = _pair(kernel_size)
    cout, k = w_ck.shape
    xp = pad_stored_zp(x_q, padding, stored_zp)
    if x_q.is_cuda:
        cg, og = xp.shape[-1] // groups, cout // groups
        accs = []
        for g in range(groups):
            patches = im2col_int8(xp[..., g * cg:(g + 1) * cg], (kh, kw), stride)
            accs.append(exact_int_matmul(patches.reshape(-1, k), w_ck[g * og:(g + 1) * og]))
        n, ho, wo, _ = patches.shape
        return (accs[0] if groups == 1 else torch.cat(accs, dim=-1)).reshape(n, ho, wo, cout)
    w = w_ck.reshape(cout, kh, kw, k // (kh * kw)).permute(0, 3, 1, 2).to(torch.int32)
    acc = F.conv2d(xp.to(torch.int32).permute(0, 3, 1, 2), w, stride=_pair(stride), groups=groups)
    return acc.permute(0, 2, 3, 1).contiguous()


def grouped_conv_acc(x_q: torch.Tensor, w_ck: torch.Tensor, kernel_size: Ints, stride: Ints,
                     padding: Ints, stored_zp: int, groups: int) -> torch.Tensor:
    """Exact int32 NHWC accumulator of a grouped conv over the
    zero-point-padded input, on packed weights (Cout, Kh*Kw*C/groups), for
    any ``groups`` that divides C and Cout. A depthwise conv (``groups`` =
    C = Cout) runs tap by tap in int32, the same integer ops on the CPU and
    on a GPU; any other grouping is :func:`int8_conv_acc` with ``groups``."""
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride)
    c = x_q.shape[-1]
    cout, k = w_ck.shape
    if groups < 1 or c % groups or cout % groups or k != kh * kw * (c // groups):
        raise ValueError(f"groups={groups} must divide C={c} and Cout={cout}, and a {kh}x{kw} kernel "
                         f"takes packed weights (Cout, {kh * kw * (c // max(groups, 1))}), got {tuple(w_ck.shape)}")
    if not groups == c == cout:
        return int8_conv_acc(x_q, w_ck, (kh, kw), (sh, sw), padding, stored_zp, groups)
    xp = pad_stored_zp(x_q, padding, stored_zp)
    n, hp, wp, _ = xp.shape
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    w = w_ck.to(torch.int32)
    acc = torch.zeros((n, ho, wo, c), dtype=torch.int32, device=x_q.device)
    for dy in range(kh):
        for dx in range(kw):
            tap = xp[:, dy: dy + (ho - 1) * sh + 1: sh, dx: dx + (wo - 1) * sw + 1: sw]
            acc += tap.to(torch.int32) * w[:, dy * kw + dx]
    return acc


def conv_epilogue(acc: torch.Tensor, alpha, beta, relu: bool = False,
                  out_requant: Optional[Tuple[float, int]] = None, round_s16: bool = False) -> torch.Tensor:
    """``int8_conv_xla``'s epilogue of an int32 accumulator: f32 ``relu?(acc
    * alpha + beta)``; int8 on ``out_requant``'s grid with 1/s folded into
    alpha and beta, the -128 shift into the zero point and ReLU into the clip
    floor; or, with ``round_s16`` (alpha and beta prescaled by the caller),
    the f32 value rounded to int16 by :func:`clip_s16_checked`."""
    y = acc_epilogue(acc, alpha, beta, relu, out_requant)
    return clip_s16_checked(torch.round(y)) if round_s16 and out_requant is None else y


def int8_conv_xla_ck(x_q, w_ck, kernel_size, alpha, beta, stride: Ints = 1, padding: Ints = 0,
                     stored_zp: int = -128, relu: bool = False,
                     out_requant: Optional[Tuple[float, int]] = None, groups: int = 1,
                     round_s16: bool = False) -> torch.Tensor:
    """``int8_conv_xla`` on packed (Cout, Kh*Kw*Cin/groups) weights."""
    if groups == 1:
        acc = int8_conv_acc(x_q, w_ck, kernel_size, stride, padding, stored_zp)
    else:
        acc = grouped_conv_acc(x_q, w_ck, kernel_size, stride, padding, stored_zp, groups)
    return conv_epilogue(acc, alpha, beta, relu, out_requant, round_s16)


def int8_conv_xla(x_q, w_q, alpha, beta, stride: Ints = 1, padding: Ints = 0,
                  stored_zp: int = -128, relu: bool = False,
                  out_requant: Optional[Tuple[float, int]] = None, groups: int = 1,
                  round_s16: bool = False) -> torch.Tensor:
    """Plain reference with ``int8_conv_xla``'s epilogue (the fused-requant
    form folds 1/s into alpha/beta and ReLU into the clip floor). ``groups``
    takes any grouping that divides C and Cout (:func:`grouped_conv_acc`);
    ``round_s16`` emits int16 (the shortcut leg of the unfused downsample
    blocks). ``y_clip`` (the RangeBN flavor) is not ported yet."""
    return int8_conv_xla_ck(x_q, pack_conv_weight(w_q), tuple(w_q.shape[:2]), alpha, beta, stride,
                            padding, stored_zp, relu, out_requant, groups, round_s16)


# Saturation count of the int16 shortcut legs: +-32767 counts are +-1024
# output steps at S16_FINE = 32, never reached by a calibrated leg, but a
# binding clip would break the leg's 1/(2*S16_FINE)-step error bound. Under
# QTPU_DEBUG_S16 every int16 emission counts its clipped elements (one
# device-to-host read per call) and logs them.
_s16_saturated_total = 0


def s16_saturated_total() -> int:
    """Saturated elements counted since the process started (under QTPU_DEBUG_S16)."""
    return _s16_saturated_total


def _s16_sat_report(n) -> None:
    global _s16_saturated_total
    n = int(n)
    if n:
        _s16_saturated_total += n
        logging.getLogger(__name__).error(
            "s16 residual-leg saturation: %d element(s) clipped at +-32767; the fine-grained leg's error "
            "bound is violated: lower S16_FINE for this layer or widen its calibration", n)


def clip_s16_checked(q: torch.Tensor) -> torch.Tensor:
    """``clip(q, +-32767)`` as int16, counting the clipped elements under
    QTPU_DEBUG_S16."""
    if os.environ.get("QTPU_DEBUG_S16"):
        _s16_sat_report((q.abs() > 32767.0).sum().item())
    return torch.clamp(q, -32767.0, 32767.0).to(torch.int16)


def bf16_conv(xb: torch.Tensor, w_oihw: torch.Tensor, stride: Ints, padding: Ints, groups: int = 1) -> torch.Tensor:
    """f32 NHWC conv of bf16 NHWC activations and bf16 (Cout, Cin/groups,
    Kh, Kw) weights, zero-padded: an f32 conv of the bf16 values that may
    use TF32 (every bf16 value is exact in TF32 and every product in f32, so
    this is the JAX package's bf16-operand, f32-accumulator conv up to
    summation order). The NHWC input is a ``channels_last`` NCHW tensor
    after its permute, so a GPU conv library reads it in place."""
    x = xb.permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, benchmark=torch.backends.cudnn.benchmark,
                                    deterministic=torch.backends.cudnn.deterministic, allow_tf32=True):
        y = F.conv2d(x.float(), w_oihw.float(), stride=_pair(stride), padding=_pair(padding), groups=groups)
    return y.permute(0, 2, 3, 1)
