"""Int8 convolution helpers: zero-point padding, im2col, the im2col + K1
GEMM path (``int8_conv_gemm``) and the plain reference ``int8_conv_xla``,
which also runs the grouped convs (depthwise or any other grouping) that
the JAX package leaves to XLA.

Layouts are the JAX package's: NHWC int8 activations (stored u - 128), HWIO
int8 kernels. Padded taps hold the *stored zero-point* so they contribute
exactly 0 (see int8_matmul.py); padding with 0 would be wrong at every border
pixel.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from quantized_tpu_torch.ops.int8_matmul import (
    exact_int_matmul,
    int8_matmul_nk,
    int8_matmul_requant_nk,
    requant_scalars,
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


def int8_conv_xla_ck(x_q, w_ck, kernel_size, alpha, beta, stride: Ints = 1, padding: Ints = 0,
                     stored_zp: int = -128, relu: bool = False,
                     out_requant: Optional[Tuple[float, int]] = None, groups: int = 1) -> torch.Tensor:
    """``int8_conv_xla`` on packed (Cout, Kh*Kw*Cin/groups) weights."""
    if groups == 1:
        acc = int8_conv_acc(x_q, w_ck, kernel_size, stride, padding, stored_zp)
    else:
        acc = grouped_conv_acc(x_q, w_ck, kernel_size, stride, padding, stored_zp, groups)
    if out_requant is not None:
        inv, zps, lo = requant_scalars(out_requant[0], out_requant[1], relu)
        q = torch.round(acc.to(torch.float32) * (alpha * inv) + (beta * inv + zps))
        return torch.clamp(q, lo, 127.0).to(torch.int8)
    y = acc.to(torch.float32) * alpha + beta
    return torch.clamp_min(y, 0.0) if relu else y


def int8_conv_xla(x_q, w_q, alpha, beta, stride: Ints = 1, padding: Ints = 0,
                  stored_zp: int = -128, relu: bool = False,
                  out_requant: Optional[Tuple[float, int]] = None, groups: int = 1) -> torch.Tensor:
    """Plain reference with ``int8_conv_xla``'s epilogue (the fused-requant
    form folds 1/s into alpha/beta and ReLU into the clip floor). ``groups``
    takes any grouping that divides C and Cout (:func:`grouped_conv_acc`);
    ``round_s16`` and ``y_clip`` are not ported yet."""
    return int8_conv_xla_ck(x_q, pack_conv_weight(w_q), tuple(w_q.shape[:2]), alpha, beta, stride,
                            padding, stored_zp, relu, out_requant, groups)
