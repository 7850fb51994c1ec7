"""Int4 weight-only quantization (BASELINE config #4: int4 weights, int8
activations) and its GEMM (kernel B6); counterpart of
``quantized_tpu/ops/int4.py``.

Weights are symmetric int4 on [-7, 7] per output channel, packed two
nibbles per int8 byte in *split-half* order: byte ``j`` of a packed
(K/2, N) array holds ``w[j]`` in its low nibble and ``w[j + K/2]`` in its
high nibble. Conv weights pack the same way along their channels
(:func:`pack_int4_conv_channels`), per tap. The bytes equal the JAX
package's.

:func:`int4_matmul` keeps the JAX signature (``w_packed`` is (K/2, N));
the engine stores the K-major form, (N, K/2), whose byte ``j`` of row ``n``
holds ``w[j, n]`` and ``w[j + K/2, n]``, and calls :func:`int4_matmul_nk`.
Odd K was padded with one zero weight before packing; A then has one
column fewer than twice the packed width, and the missing column
multiplies that zero weight.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the CUDA kernel (``csrc/int4_gemm.cu``, planned by
``gemm_plan(..., packed=True)``) or raises.

The JAX package's native-S4 forms, which it leaves to XLA, are plain
functions here, candidates of the autotuner and no kernels:
:func:`int4_conv_s4` (the "s4" conv backends: two convs over the input's
channel halves, one a nibble plane of the packed bytes),
:func:`int4_matmul_s4` (two GEMMs over A's halves) and
:func:`int4_matmul_unpacked_xla` (unpack, then kernel K1). Each product is
exact, so each equals the JAX form bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.int8_matmul import (
    GEMM_PLAN_ARGS,
    acc_epilogue,
    exact_int_matmul,
    gemm_plan,
    gemm_route,
    int8_matmul,
    int8_matmul_plain,
    int8_matmul_requant_plain,
    requant_scalars,
)

_INT4_MATMUL = _cuda.CudaKernel(
    "int4_matmul", "int4_gemm.cu", "qt_int4_matmul",
    ["ptr"] * 5 + ["int"] * 6 + ["float"] * 3 + GEMM_PLAN_ARGS,
)


def int4_weight_qparams(w_ko: np.ndarray) -> np.ndarray:
    """(K, N) weights -> per-column scales for the [-7, 7] grid."""
    absmax = np.max(np.abs(w_ko), axis=0)
    return np.maximum(absmax / 7.0, 1e-12).astype(np.float32)


def quantize_int4(w_ko: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """(K, N) weights onto the int4 grid of ``scale``, as int8 on [-7, 7]."""
    q = np.round(w_ko / scale[None, :])
    return np.clip(q, -7, 7).astype(np.int8)


def _pack_halves(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int4-valued int8 tensors of one shape -> one int8 byte each:
    ``lo`` in the low nibble, ``hi`` in the high nibble."""
    byte = (lo.to(torch.int32) & 0x0F) | ((hi.to(torch.int32) & 0x0F) << 4)  # 0..255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def _nibbles(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed bytes -> (low, high) nibbles, sign-extended to int8:
    ``((p & 0xF) ^ 8) - 8`` and the arithmetic shift ``p >> 4``. Both stay
    in [-8, 7], so int8 arithmetic never overflows."""
    if packed.dtype != torch.int8:
        raise TypeError(f"packed int4 weights must be int8, got {packed.dtype}")
    return ((packed & 0x0F) ^ 8) - 8, packed >> 4


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) int4-valued int8 -> (K/2, N) packed bytes, split-half order.
    K must be even (pad upstream)."""
    k = q.shape[0]
    if k % 2:
        raise ValueError(f"pad K to even before packing, got K={k}")
    return _pack_halves(q[: k // 2], q[k // 2:])


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (K/2, N) -> (K, N) int8."""
    return torch.cat(_nibbles(packed), dim=0)


def pack_int4_conv(q_hwio: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """(Kh, Kw, Cin, Cout) int4-valued int8 -> packed (ceil(Kh*Kw*Cin/2),
    Cout) bytes along the flattened contraction axis (odd K padded with a
    zero), and the original shape."""
    kh, kw, cin, cout = q_hwio.shape
    flat = q_hwio.reshape(kh * kw * cin, cout)
    if flat.shape[0] % 2:
        flat = torch.cat([flat, flat.new_zeros((1, cout))])
    return pack_int4(flat), (kh, kw, cin, cout)


def unpack_int4_conv(packed: torch.Tensor, shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """Inverse of :func:`pack_int4_conv` -> (Kh, Kw, Cin, Cout) int8."""
    kh, kw, cin, cout = shape
    return unpack_int4(packed)[: kh * kw * cin].reshape(kh, kw, cin, cout)


def pack_int4_conv_channels(q_hwio: torch.Tensor) -> torch.Tensor:
    """(Kh, Kw, Cg, Cout) int4-valued int8 -> (Kh, Kw, Cg/2, Cout) packed
    bytes, channel-split-half order: the byte at channel ``c`` holds ``q[...,
    c, :]`` (low nibble) and ``q[..., c + Cg/2, :]`` (high nibble). Cg must
    be even (the stem's Cin = 3 and depthwise convs stay unpacked)."""
    cg = q_hwio.shape[2]
    if cg % 2:
        raise ValueError(f"channel-split packing needs an even Cin per group, got {cg}")
    return _pack_halves(q_hwio[:, :, : cg // 2], q_hwio[:, :, cg // 2:])


def unpack_int4_conv_channels(packed: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """Inverse of :func:`pack_int4_conv_channels` -> (Kh, Kw, Cg, Cout)
    int8. ``dim`` names the packed channel axis of another layout (the
    engine's (Cout, Kh*Kw, Cg/2) uses -1)."""
    return torch.cat(_nibbles(packed), dim=dim)


def unpack_int4_nk(w_packed_nk: torch.Tensor) -> torch.Tensor:
    """(N, K/2) packed bytes -> (N, K) int8: the K-major weights whose
    column ``j`` is ``w[j]``, the column ``j + K/2`` is ``w[j + K/2]``."""
    return torch.cat(_nibbles(w_packed_nk), dim=1)


def _pad_odd_k(a: torch.Tensor, khalf: int) -> torch.Tensor:
    """A with one stored-0 column appended where K was odd (its weight is the
    packing pad, 0)."""
    k = a.shape[1]
    if k == 2 * khalf - 1:
        return torch.cat([a, a.new_zeros((a.shape[0], 1))], dim=1)
    if k != 2 * khalf:
        raise ValueError(f"A has K={k} columns but the packed weights hold {2 * khalf}")
    return a


def int4_matmul_plain(a, w_packed_nk, alpha, beta, relu: bool = False, out_scale: Optional[float] = None,
                      out_zp: Optional[int] = None) -> torch.Tensor:
    """Plain version of B6: unpack, the exact int32 product, then the
    epilogue in ``_int4_matmul_kernel``'s order: f32 ``relu?(acc * alpha +
    beta)``, or (with ``out_scale``/``out_zp``) ``clip(rint(acc * (alpha *
    inv) + (beta * inv + zp - 128)), lo, 127)`` with ``lo = zp - 128`` under
    ReLU, else -128."""
    a = _pad_odd_k(a, w_packed_nk.shape[1])
    w_nk = unpack_int4_nk(w_packed_nk)
    if out_scale is None:
        return int8_matmul_plain(a, w_nk, alpha, beta, relu)
    return int8_matmul_requant_plain(a, w_nk, alpha, beta, out_scale, out_zp, relu)


def _check(a, w_packed_nk, alpha, beta, out_scale, out_zp):
    if a.ndim != 2 or w_packed_nk.ndim != 2 or a.shape[1] not in (2 * w_packed_nk.shape[1],
                                                                  2 * w_packed_nk.shape[1] - 1):
        raise ValueError(f"A {tuple(a.shape)} does not multiply packed int4 weights {tuple(w_packed_nk.shape)}")
    n = w_packed_nk.shape[0]
    if alpha.shape != (n,) or beta.shape != (n,):
        raise ValueError(f"alpha/beta must have shape ({n},)")
    if (out_scale is None) != (out_zp is None):
        raise ValueError("out_scale and out_zp go together")
    _cuda.check_dtype(a, torch.int8, "a")
    _cuda.check_dtype(w_packed_nk, torch.int8, "w_packed")
    _cuda.check_dtype(alpha, torch.float32, "alpha")
    _cuda.check_dtype(beta, torch.float32, "beta")


def int4_matmul_nk(a, w_packed_nk, alpha, beta, relu: bool = False, out_scale: Optional[float] = None,
                   out_zp: Optional[int] = None) -> torch.Tensor:
    """A (M, K) s8 times split-half packed int4 W (N, K/2): f32 ``relu?(acc
    * alpha + beta)``, or s8 on the (out_scale, out_zp) grid."""
    _check(a, w_packed_nk, alpha, beta, out_scale, out_zp)
    if a.device.type == "cpu":
        return int4_matmul_plain(a, w_packed_nk, alpha, beta, relu, out_scale, out_zp)
    dev = _cuda.require_cuda_tensors(a, w_packed_nk, alpha, beta)
    (m, k), (n, khalf) = a.shape, w_packed_nk.shape
    if out_scale is None:
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        inv = zps = lo = 0.0
    else:
        out = torch.empty((m, n), dtype=torch.int8, device=dev)
        inv, zps, lo = requant_scalars(out_scale, out_zp, relu)
    plan = gemm_plan(m, n, k, packed=True, sms=_cuda.sm_count(dev))
    route = gemm_route(plan, a, w_packed_nk)
    _INT4_MATMUL(dev, a.data_ptr(), w_packed_nk.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                 out.data_ptr(), m, n, khalf, k, int(relu), int(out_scale is not None), inv, zps, lo,
                 int(route == "sm90"), *plan.args(), route=route)
    return out


def int4_matmul(a, w_packed, alpha, beta, relu: bool = False, out_scale: Optional[float] = None,
                out_zp: Optional[int] = None) -> torch.Tensor:
    """JAX-layout entry: ``w_packed`` is (K/2, N)."""
    return int4_matmul_nk(a, w_packed.T.contiguous(), alpha, beta, relu, out_scale, out_zp)


def int4_conv_s4(x_q: torch.Tensor, w_packed: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                 stride=(1, 1), padding=(0, 0), stored_zp: int = -128, relu: bool = False,
                 out_requant: Optional[Tuple[float, int]] = None, groups: int = 1) -> torch.Tensor:
    """The JAX package's ``int4_conv_s4`` on channel-split packed weights
    (Kh, Kw, Cg/2, Cout): the conv of each group's low input half with the
    low nibble plane plus the conv of its high half with the high plane, each
    exact (:func:`~quantized_tpu_torch.ops.int8_conv.grouped_conv_acc`), then
    ``int8_conv_xla``'s epilogue."""
    from quantized_tpu_torch.ops.int8_conv import conv_epilogue, grouped_conv_acc, pack_conv_weight

    kh, kw, cg2, _ = w_packed.shape
    n, h, w, cin = x_q.shape
    if cin != groups * 2 * cg2:
        raise ValueError(f"packed int4 kernel {tuple(w_packed.shape)} does not take {cin} channels "
                         f"in {groups} group(s)")
    xg = x_q.reshape(n, h, w, groups, 2 * cg2)
    acc = None
    for half, plane in zip((xg[..., :cg2], xg[..., cg2:]), _nibbles(w_packed)):
        part = grouped_conv_acc(half.reshape(n, h, w, groups * cg2), pack_conv_weight(plane), (kh, kw), stride,
                                padding, stored_zp, groups)
        acc = part if acc is None else acc + part
    return conv_epilogue(acc, alpha, beta, relu, out_requant)


def int4_matmul_s4(a, w_packed, alpha, beta, relu: bool = False, out_scale: Optional[float] = None,
                   out_zp: Optional[int] = None) -> torch.Tensor:
    """The JAX package's ``int4_matmul_s4`` on split-half packed weights
    (K/2, N): ``A[:, :K/2] @ lo + A[:, K/2:] @ hi``, each product exact, then
    B6's epilogue (f32, or s8 on the (out_scale, out_zp) grid)."""
    w_nk = w_packed.T
    _check(a, w_nk, alpha, beta, out_scale, out_zp)
    a = _pad_odd_k(a, w_nk.shape[1])
    khalf = w_nk.shape[1]
    lo, hi = _nibbles(w_nk)
    acc = exact_int_matmul(a[:, :khalf], lo) + exact_int_matmul(a[:, khalf:], hi)
    return acc_epilogue(acc, alpha, beta, relu, None if out_scale is None else (out_scale, out_zp))


def int4_matmul_unpacked_xla(a, w_packed, alpha, beta, relu: bool = False) -> torch.Tensor:
    """The JAX package's ``int4_matmul_unpacked_xla``: unpack the (K/2, N)
    bytes, then the int8 GEMM (kernel K1 on the GPU)."""
    return int8_matmul(a, unpack_int4(w_packed), alpha, beta, relu=relu)
