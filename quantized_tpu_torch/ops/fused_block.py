"""Fused int8 blocks: a whole ResNet block, or a MobileNet
depthwise-separable pair, in one launch, its interior activations kept out
of device memory.

Kernel B3, the bottleneck: counterparts of the JAX package's
``fused_bottleneck_s1`` (identity block) and ``fused_bottleneck_ds``
(downsample block, 1x1/s shortcut conv). Per output element, in the Pallas
kernels' order, one float32 rounding per operation:

    h1  = clip(round(acc1 * a1 + b1), lo1, 127)      conv1 1x1, onto conv2's grid
    h2  = clip(round(acc2 * a2 + b2), lo2, 127)      conv2 3x3/s over h1, halo = zp2_stored
    y   = acc3 * a3 + b3                             conv3 1x1, prescaled by the out grid
    idq = x * f32(id_k) + f32(id_c)                  identity (s1), or
    idq = accd * ad + bd                             shortcut conv (ds), and with ds_fine
        -> clip(round(idq * ds_fine), +-32767) * f32(1/ds_fine)
    out = clip(round(y + idq), shift, 127)

Kernel B4, the BasicBlock (ResNet-18/34 and the CIFAR nets): counterparts
of ``fused_basicblock_s1`` and ``fused_basicblock_ds``:

    h1  = clip(round(acc1 * a1 + b1), lo1, 127)      conv1 3x3/s over x, halo = zp1_stored
    y   = acc2 * a2 + b2                             conv2 3x3 over h1, halo = zp2_stored
    idq, out                                         as above

Kernel B5, the depthwise-separable pair (MobileNet-v1): counterpart of
``fused_dw_pw``:

    h1  = clip(round(acc1 * a1 + b1), lo1, 127)      depthwise 3x3/s over x, pad = zp1_stored
    out = clip(round(acc2 * a2 + b2), lo2, 127)      pointwise 1x1 over h1

A border is the stored zero point of the padded tensor's grid (it
dequantizes to exactly 0), never 0 and never a conv of padded input.

The CUDA kernels (``csrc/fused_block.cu``) take the weights K-major: a 1x1
conv (Cout, Cin), a 3x3 conv (Cout, 9*Cin) in (kh, kw, c) order, which is
how :class:`~quantized_tpu_torch.engine.int_layers.IntConv2d` already
stores a conv's weights; the ``*_ck`` wrappers take that form, and the
wrappers without the suffix keep the JAX signatures (HWIO and (Cin, Cout)).

A block of a kernel owns one image and a band of ``R`` output rows
(:func:`band_rows`, :func:`basicblock_band_rows`, :func:`dw_pw_band_rows`).
B3 and B4 recompute conv1 on the halo rows that the neighbouring band also
needs, so the interior activations live in its shared memory; B5 only
re-reads its input halo, since a depthwise output row belongs to one band.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.int8_conv import grouped_conv_acc, int8_conv_acc, pack_conv_weight
from quantized_tpu_torch.ops.int8_matmul import exact_int_matmul, f32

FUSED_S1 = _cuda.CudaKernel("fused_bottleneck_s1", "fused_block.cu", "qt_fused_bottleneck_s1",
                            ["ptr"] * 11 + ["int"] * 7 + ["float"] * 5)
FUSED_DS = _cuda.CudaKernel("fused_bottleneck_ds", "fused_block.cu", "qt_fused_bottleneck_ds",
                            ["ptr"] * 14 + ["int"] * 9 + ["float"] * 5)
BASIC_S1 = _cuda.CudaKernel("fused_basicblock_s1", "fused_block.cu", "qt_fused_basicblock_s1",
                            ["ptr"] * 8 + ["int"] * 8 + ["float"] * 4)
BASIC_DS = _cuda.CudaKernel("fused_basicblock_ds", "fused_block.cu", "qt_fused_basicblock_ds",
                            ["ptr"] * 11 + ["int"] * 9 + ["float"] * 4)
DW_PW = _cuda.CudaKernel("fused_dw_pw", "fused_dw_pw.cu", "qt_fused_dw_pw",
                         ["ptr"] * 8 + ["int"] * 8 + ["float"] * 2)

# Shared-memory plan of a kernel block (csrc/fused_block.cu keeps the same
# layout): the A and W staging tiles (64 rows at an 80-byte pitch each), h1
# for the band plus its halo, (R-1)*S + 3 rows of W + 2 pixels, and h2, R
# rows of W/S pixels, both at a pitch of Cm + 16 bytes per pixel.
STAGE_BYTES = 2 * 64 * 80
SMEM_PER_BLOCK = 232448  # the H100's opt-in limit for one block
SMEM_TWO_PER_SM = 113 * 1024  # small enough for two blocks to share an SM's 228 KB
TARGET_ROWS = 256  # GEMM rows (output pixels) a band aims for


def fused_smem_bytes(r: int, w: int, cm: int, stride: int) -> int:
    pitch = cm + 16
    return STAGE_BYTES + ((r - 1) * stride + 3) * (w + 2) * pitch + r * (w // stride) * pitch


def band_rows(ho: int, w: int, cm: int, stride: int) -> int:
    """Output rows per kernel block: about TARGET_ROWS output pixels, bands
    of equal height, fewer rows until two blocks fit on an SM."""
    wo = w // stride
    nb = -(-ho // max(1, min(ho, TARGET_ROWS // wo)))
    r = -(-ho // nb)
    while r > 1 and fused_smem_bytes(r, w, cm, stride) > SMEM_TWO_PER_SM:
        nb += 1
        r = -(-ho // nb)
    if fused_smem_bytes(r, w, cm, stride) > SMEM_PER_BLOCK:
        raise ValueError(f"a fused block over W={w}, Cm={cm} does not fit in shared memory")
    return r


# B4 keeps only h1 in shared memory: R + 2 rows of Wo + 2 pixels at a pitch
# of Cm + 16 bytes, beside the same staging tiles. A band recomputes conv1
# on 2 halo rows, a share of (R + 2) / R, so its bands are taller than
# B3's: at least MIN_BASIC_ROWS rows and TARGET_ROWS output pixels.
MIN_BASIC_ROWS = 8


def basicblock_smem_bytes(r: int, wo: int, cm: int) -> int:
    return STAGE_BYTES + (r + 2) * (wo + 2) * (cm + 16)


def basicblock_band_rows(ho: int, wo: int, cm: int) -> int:
    """Output rows per kernel block of B4: at least MIN_BASIC_ROWS rows and
    TARGET_ROWS output pixels, bands of equal height, fewer rows until two
    blocks fit on an SM."""
    r = min(ho, max(MIN_BASIC_ROWS, -(-TARGET_ROWS // wo)))
    nb = -(-ho // r)
    r = -(-ho // nb)
    while r > 1 and basicblock_smem_bytes(r, wo, cm) > SMEM_TWO_PER_SM:
        nb += 1
        r = -(-ho // nb)
    if basicblock_smem_bytes(r, wo, cm) > SMEM_PER_BLOCK:
        raise ValueError(f"a fused BasicBlock over Wo={wo}, Cm={cm} does not fit in shared memory")
    return r


# B5's shared memory (csrc/fused_dw_pw.cu keeps the same layout): the W
# staging tile; h1, R*Wo GEMM rows padded to a multiple of 64, stored as
# ceil(C/64) K chunks of 64-row tiles at the 80-byte pitch, so that each
# chunk is an A tile of the int8_mma.cuh product as it stands; the input
# band, (R-1)*S + 3 rows of W + 2 pixels of C bytes; the depthwise weights,
# 9*C bytes tap-major.
NUM_SMS = 132  # the H100 SXM's streaming multiprocessors


def dw_pw_smem_bytes(r: int, w: int, c: int, stride: int) -> int:
    rows = -(-r * (w // stride) // 64) * 64
    return 64 * 80 + -(-c // 64) * rows * 80 + ((r - 1) * stride + 3) * (w + 2) * c + 9 * c


def dw_pw_band_rows(n: int, ho: int, w: int, c: int, cout: int, stride: int) -> int:
    """Output rows per kernel block of B5, from a count of 64x64x64 tile
    steps: bands of equal height; of the heights whose blocks let two share
    an SM, the one that gives the busiest SM the fewest steps (blocks per
    SM, rounded up, times the pointwise GEMM's tile steps per block), the
    shorter on a tie. Short bands cost no recompute, only a re-read of the
    2-row input halo, so a small batch gets short bands and more blocks."""
    wo = w // stride
    plans = []  # (tile steps of the busiest SM, R)
    for nb in range(1, ho + 1):
        r = -(-ho // nb)
        if -(-ho // r) == nb and dw_pw_smem_bytes(r, w, c, stride) <= SMEM_TWO_PER_SM:
            steps = -(-r * wo // 64) * -(-cout // 64) * -(-c // 64)
            plans.append((-(-n * nb // NUM_SMS) * steps, r))
    if not plans:
        raise ValueError(f"a fused dw/pw pair over W={w}, C={c} does not fit in shared memory")
    return min(plans)[1]


# ----------------------------------------------------------------- plain versions


def _requant(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, lo: float) -> torch.Tensor:
    q = torch.round(acc.to(torch.float32) * a + b)
    return torch.clamp(q, f32(lo), 127.0).to(torch.int8)


def _h2(x_q, w1_nk, w2_ck, a1, b1, a2, b2, stride, lo1, lo2, zp2_stored) -> torch.Tensor:
    """conv1 and conv2 with their requant epilogues: h2, (N*Ho*Wo, Cm) int8."""
    n, h, w, c = x_q.shape
    cm = w1_nk.shape[0]
    h1 = _requant(exact_int_matmul(x_q.reshape(-1, c), w1_nk), a1, b1, lo1).reshape(n, h, w, cm)
    acc2 = int8_conv_acc(h1, w2_ck, (3, 3), stride, 1, int(zp2_stored))
    return _requant(acc2, a2, b2, lo2).reshape(-1, cm)


def _final(y: torch.Tensor, idq: torch.Tensor, shift: float) -> torch.Tensor:
    return torch.clamp(torch.round(y + idq), f32(shift), 127.0).to(torch.int8)


def _shortcut(x_q, wd_nk, ad, bd, stride, ds_fine) -> torch.Tensor:
    """The 1x1/s shortcut conv on x[::s, ::s], prescaled, with the int16 leg
    when ``ds_fine`` is set: (N*Ho*Wo, Cout) f32."""
    xs = x_q[:, ::stride, ::stride, :].reshape(-1, x_q.shape[-1])
    idq = exact_int_matmul(xs, wd_nk).to(torch.float32) * ad + bd
    if ds_fine:
        idq = torch.clamp(torch.round(idq * f32(ds_fine)), -32767.0, 32767.0) * f32(1.0 / ds_fine)
    return idq


def fused_bottleneck_s1_plain(x_q, w1_nk, w2_ck, w3_nk, a1, b1, a2, b2, a3, b3,
                              lo1, lo2, shift, zp2_stored, id_k, id_c) -> torch.Tensor:
    """Plain version of the identity block: exact int32 accumulators, then
    the epilogues in the Pallas kernel's order."""
    n, h, w, c = x_q.shape
    h2 = _h2(x_q, w1_nk, w2_ck, a1, b1, a2, b2, 1, lo1, lo2, zp2_stored)
    y = exact_int_matmul(h2, w3_nk).to(torch.float32) * a3 + b3
    idq = x_q.reshape(-1, c).to(torch.float32) * f32(id_k) + f32(id_c)
    return _final(y, idq, shift).reshape(n, h, w, c)


def fused_bottleneck_ds_plain(x_q, w1_nk, w2_ck, w3_nk, wd_nk, a1, b1, a2, b2, a3, b3, ad, bd,
                              stride, lo1, lo2, shift, zp2_stored, ds_fine=0.0) -> torch.Tensor:
    """Plain version of the downsample block; the shortcut reads x[::s, ::s]."""
    n, h, w, _ = x_q.shape
    s = int(stride)
    cout = w3_nk.shape[0]
    h2 = _h2(x_q, w1_nk, w2_ck, a1, b1, a2, b2, s, lo1, lo2, zp2_stored)
    y = exact_int_matmul(h2, w3_nk).to(torch.float32) * a3 + b3
    idq = _shortcut(x_q, wd_nk, ad, bd, s, ds_fine)
    return _final(y, idq, shift).reshape(n, h // s, w // s, cout)


def _basic_y(x_q, w1_ck, w2_ck, a1, b1, a2, b2, stride, lo1, zp1_stored, zp2_stored) -> torch.Tensor:
    """conv1 3x3/s with its requant, then conv2 3x3 prescaled: y, (N*Ho*Wo, Cm) f32."""
    h1 = _requant(int8_conv_acc(x_q, w1_ck, (3, 3), stride, 1, int(zp1_stored)), a1, b1, lo1)
    acc2 = int8_conv_acc(h1, w2_ck, (3, 3), 1, 1, int(zp2_stored))
    return acc2.reshape(-1, w2_ck.shape[0]).to(torch.float32) * a2 + b2


def fused_basicblock_s1_plain(x_q, w1_ck, w2_ck, a1, b1, a2, b2, lo1, shift, zp1_stored, zp2_stored,
                              id_k, id_c) -> torch.Tensor:
    """Plain version of the identity BasicBlock: exact int32 accumulators,
    then the epilogues in the Pallas kernel's order."""
    n, h, w, c = x_q.shape
    y = _basic_y(x_q, w1_ck, w2_ck, a1, b1, a2, b2, 1, lo1, zp1_stored, zp2_stored)
    idq = x_q.reshape(-1, c).to(torch.float32) * f32(id_k) + f32(id_c)
    return _final(y, idq, shift).reshape(n, h, w, c)


def fused_basicblock_ds_plain(x_q, w1_ck, w2_ck, wd_nk, a1, b1, a2, b2, ad, bd, stride, lo1, shift,
                              zp1_stored, zp2_stored, ds_fine=0.0) -> torch.Tensor:
    """Plain version of the downsample BasicBlock; the shortcut reads x[::s, ::s]."""
    n, h, w, _ = x_q.shape
    s = int(stride)
    cm = w1_ck.shape[0]
    y = _basic_y(x_q, w1_ck, w2_ck, a1, b1, a2, b2, s, lo1, zp1_stored, zp2_stored)
    idq = _shortcut(x_q, wd_nk, ad, bd, s, ds_fine)
    return _final(y, idq, shift).reshape(n, h // s, w // s, cm)


def fused_dw_pw_plain(x_q, wdw_ck, wpw_nk, a1, b1, a2, b2, stride, lo1, lo2, zp1_stored) -> torch.Tensor:
    """Plain version of the depthwise-separable pair: the exact int32
    depthwise accumulator over x padded with ``zp1_stored``, its requant,
    then the pointwise product and its requant, in ``_fused_dw_pw_kernel``'s
    order. Returns (N, H/s, W/s, Cout)."""
    n, _, _, c = x_q.shape
    acc1 = grouped_conv_acc(x_q, wdw_ck, (3, 3), int(stride), 1, int(zp1_stored), c)
    _, ho, wo, _ = acc1.shape
    h1 = _requant(acc1, a1, b1, lo1).reshape(-1, c)
    return _requant(exact_int_matmul(h1, wpw_nk), a2, b2, lo2).reshape(n, ho, wo, wpw_nk.shape[0])


# ----------------------------------------------------------------- wrappers


def _check(x_q, mats, vecs):
    """mats: (tensor, expected shape, name); vecs: (tensor, length, name)."""
    if x_q.ndim != 4:
        raise ValueError(f"x_q must be NHWC, got shape {tuple(x_q.shape)}")
    _cuda.check_dtype(x_q, torch.int8, "x_q")
    for t, shape, name in mats:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        _cuda.check_dtype(t, torch.int8, name)
    for t, n, name in vecs:
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
        _cuda.check_dtype(t, torch.float32, name)


def _check_widths(c: int, cm: int):
    if c % 16 or cm % 16:
        raise ValueError(f"the fused kernel gathers 16-byte chunks and needs C and Cm multiples of 16, "
                         f"got C={c}, Cm={cm}")


def fused_bottleneck_s1_ck(x_q, w1_nk, w2_ck, w3_nk, a1, b1, a2, b2, a3, b3,
                           lo1, lo2, shift, zp2_stored, id_k, id_c) -> torch.Tensor:
    """Identity block on K-major weights: w1 (Cm, C), w2 (Cm, 9*Cm), w3 (C, Cm)."""
    n, h, w, c = x_q.shape
    cm = w1_nk.shape[0]
    _check(x_q, [(w1_nk, (cm, c), "w1"), (w2_ck, (cm, 9 * cm), "w2"), (w3_nk, (c, cm), "w3")],
           [(a1, cm, "a1"), (b1, cm, "b1"), (a2, cm, "a2"), (b2, cm, "b2"), (a3, c, "a3"), (b3, c, "b3")])
    args = (lo1, lo2, shift, zp2_stored, id_k, id_c)
    if x_q.device.type == "cpu":
        return fused_bottleneck_s1_plain(x_q, w1_nk, w2_ck, w3_nk, a1, b1, a2, b2, a3, b3, *args)
    dev = _cuda.require_cuda_tensors(x_q, w1_nk, w2_ck, w3_nk, a1, b1, a2, b2, a3, b3)
    _check_widths(c, cm)
    r = band_rows(h, w, cm, 1)
    out = torch.empty_like(x_q)
    FUSED_S1(dev, x_q.data_ptr(), w1_nk.data_ptr(), w2_ck.data_ptr(), w3_nk.data_ptr(),
             a1.data_ptr(), b1.data_ptr(), a2.data_ptr(), b2.data_ptr(), a3.data_ptr(), b3.data_ptr(),
             out.data_ptr(), n, h, w, c, cm, r, int(zp2_stored),
             f32(lo1), f32(lo2), f32(shift), f32(id_k), f32(id_c))
    return out


def fused_bottleneck_ds_ck(x_q, w1_nk, w2_ck, w3_nk, wd_nk, a1, b1, a2, b2, a3, b3, ad, bd,
                           stride, lo1, lo2, shift, zp2_stored, ds_fine=0.0) -> torch.Tensor:
    """Downsample block on K-major weights: w1 (Cm, C), w2 (Cm, 9*Cm),
    w3 (Cout, Cm), wd (Cout, C). Returns (N, H/s, W/s, Cout)."""
    n, h, w, c = x_q.shape
    cm, cout, s = w1_nk.shape[0], w3_nk.shape[0], int(stride)
    _check(x_q, [(w1_nk, (cm, c), "w1"), (w2_ck, (cm, 9 * cm), "w2"), (w3_nk, (cout, cm), "w3"),
                 (wd_nk, (cout, c), "wd")],
           [(a1, cm, "a1"), (b1, cm, "b1"), (a2, cm, "a2"), (b2, cm, "b2"), (a3, cout, "a3"),
            (b3, cout, "b3"), (ad, cout, "ad"), (bd, cout, "bd")])
    _check_stride(s, h, w)
    args = (s, lo1, lo2, shift, zp2_stored, ds_fine)
    if x_q.device.type == "cpu":
        return fused_bottleneck_ds_plain(x_q, w1_nk, w2_ck, w3_nk, wd_nk, a1, b1, a2, b2, a3, b3,
                                         ad, bd, *args)
    dev = _cuda.require_cuda_tensors(x_q, w1_nk, w2_ck, w3_nk, wd_nk, a1, b1, a2, b2, a3, b3, ad, bd)
    _check_widths(c, cm)
    r = band_rows(h // s, w, cm, s)
    out = torch.empty((n, h // s, w // s, cout), dtype=torch.int8, device=dev)
    inv_fine = f32(1.0 / ds_fine) if ds_fine else 0.0
    FUSED_DS(dev, x_q.data_ptr(), w1_nk.data_ptr(), w2_ck.data_ptr(), w3_nk.data_ptr(),
             wd_nk.data_ptr(), a1.data_ptr(), b1.data_ptr(), a2.data_ptr(), b2.data_ptr(),
             a3.data_ptr(), b3.data_ptr(), ad.data_ptr(), bd.data_ptr(), out.data_ptr(),
             n, h, w, c, cm, cout, s, r, int(zp2_stored),
             f32(lo1), f32(lo2), f32(shift), f32(ds_fine), inv_fine)
    return out


def _check_stride(s: int, h: int, w: int):
    if s not in (1, 2) or h % s or w % s:
        raise ValueError(f"stride {s} over {h}x{w}: the fused block takes stride 1 or 2 over an "
                         f"image it divides")


def fused_basicblock_s1_ck(x_q, w1_ck, w2_ck, a1, b1, a2, b2, lo1, shift, zp1_stored, zp2_stored,
                           id_k, id_c) -> torch.Tensor:
    """Identity BasicBlock on K-major weights: w1 and w2 (C, 9*C)."""
    n, h, w, c = x_q.shape
    _check(x_q, [(w1_ck, (c, 9 * c), "w1"), (w2_ck, (c, 9 * c), "w2")],
           [(a1, c, "a1"), (b1, c, "b1"), (a2, c, "a2"), (b2, c, "b2")])
    args = (lo1, shift, zp1_stored, zp2_stored, id_k, id_c)
    if x_q.device.type == "cpu":
        return fused_basicblock_s1_plain(x_q, w1_ck, w2_ck, a1, b1, a2, b2, *args)
    dev = _cuda.require_cuda_tensors(x_q, w1_ck, w2_ck, a1, b1, a2, b2)
    _check_widths(c, c)
    r = basicblock_band_rows(h, w, c)
    out = torch.empty_like(x_q)
    BASIC_S1(dev, x_q.data_ptr(), w1_ck.data_ptr(), w2_ck.data_ptr(), a1.data_ptr(), b1.data_ptr(),
             a2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, h, w, c, c, r, int(zp1_stored),
             int(zp2_stored), f32(lo1), f32(shift), f32(id_k), f32(id_c))
    return out


def fused_basicblock_ds_ck(x_q, w1_ck, w2_ck, wd_nk, a1, b1, a2, b2, ad, bd, stride, lo1, shift,
                           zp1_stored, zp2_stored, ds_fine=0.0) -> torch.Tensor:
    """Downsample BasicBlock on K-major weights: w1 (Cm, 9*C), w2 (Cm, 9*Cm),
    wd (Cm, C). Returns (N, H/s, W/s, Cm)."""
    n, h, w, c = x_q.shape
    cm, s = w1_ck.shape[0], int(stride)
    _check(x_q, [(w1_ck, (cm, 9 * c), "w1"), (w2_ck, (cm, 9 * cm), "w2"), (wd_nk, (cm, c), "wd")],
           [(a1, cm, "a1"), (b1, cm, "b1"), (a2, cm, "a2"), (b2, cm, "b2"), (ad, cm, "ad"),
            (bd, cm, "bd")])
    _check_stride(s, h, w)
    args = (s, lo1, shift, zp1_stored, zp2_stored, ds_fine)
    if x_q.device.type == "cpu":
        return fused_basicblock_ds_plain(x_q, w1_ck, w2_ck, wd_nk, a1, b1, a2, b2, ad, bd, *args)
    dev = _cuda.require_cuda_tensors(x_q, w1_ck, w2_ck, wd_nk, a1, b1, a2, b2, ad, bd)
    _check_widths(c, cm)
    r = basicblock_band_rows(h // s, w // s, cm)
    out = torch.empty((n, h // s, w // s, cm), dtype=torch.int8, device=dev)
    inv_fine = f32(1.0 / ds_fine) if ds_fine else 0.0
    BASIC_DS(dev, x_q.data_ptr(), w1_ck.data_ptr(), w2_ck.data_ptr(), wd_nk.data_ptr(), a1.data_ptr(),
             b1.data_ptr(), a2.data_ptr(), b2.data_ptr(), ad.data_ptr(), bd.data_ptr(), out.data_ptr(),
             n, h, w, c, cm, s, r, int(zp1_stored), int(zp2_stored),
             f32(lo1), f32(shift), f32(ds_fine), inv_fine)
    return out


def fused_dw_pw_ck(x_q, wdw_ck, wpw_nk, a1, b1, a2, b2, stride, lo1, lo2, zp1_stored) -> torch.Tensor:
    """Depthwise-separable pair on K-major weights: depthwise (C, 9) in
    (kh, kw) order, pointwise (Cout, C). Returns (N, H/s, W/s, Cout)."""
    n, h, w, c = x_q.shape
    cout, s = wpw_nk.shape[0], int(stride)
    _check(x_q, [(wdw_ck, (c, 9), "wdw"), (wpw_nk, (cout, c), "wpw")],
           [(a1, c, "a1"), (b1, c, "b1"), (a2, cout, "a2"), (b2, cout, "b2")])
    _check_stride(s, h, w)
    args = (s, lo1, lo2, zp1_stored)
    if x_q.device.type == "cpu":
        return fused_dw_pw_plain(x_q, wdw_ck, wpw_nk, a1, b1, a2, b2, *args)
    dev = _cuda.require_cuda_tensors(x_q, wdw_ck, wpw_nk, a1, b1, a2, b2)
    r = dw_pw_band_rows(n, h // s, w, c, cout, s)
    out = torch.empty((n, h // s, w // s, cout), dtype=torch.int8, device=dev)
    DW_PW(dev, x_q.data_ptr(), wdw_ck.data_ptr(), wpw_nk.data_ptr(), a1.data_ptr(), b1.data_ptr(),
          a2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, h, w, c, cout, s, r, int(zp1_stored),
          f32(lo1), f32(lo2))
    return out


def _nk(w_kn: torch.Tensor) -> torch.Tensor:
    return w_kn.T.contiguous()


def fused_bottleneck_s1(x_q, w1, w2, w3, a1, b1, a2, b2, a3, b3,
                        lo1, lo2, shift, zp2_stored, id_k, id_c) -> torch.Tensor:
    """JAX-layout entry: w1 (C, Cm), w2 (3, 3, Cm, Cm) HWIO, w3 (Cm, C)."""
    return fused_bottleneck_s1_ck(x_q, _nk(w1), pack_conv_weight(w2), _nk(w3), a1, b1, a2, b2, a3, b3,
                                  lo1, lo2, shift, zp2_stored, id_k, id_c)


def fused_bottleneck_ds(x_q, w1, w2, w3, wd, a1, b1, a2, b2, a3, b3, ad, bd,
                        stride, lo1, lo2, shift, zp2_stored, ds_fine=0.0) -> torch.Tensor:
    """JAX-layout entry: w1 (C, Cm), w2 HWIO, w3 (Cm, Cout), wd (C, Cout)."""
    return fused_bottleneck_ds_ck(x_q, _nk(w1), pack_conv_weight(w2), _nk(w3), _nk(wd),
                                  a1, b1, a2, b2, a3, b3, ad, bd, stride, lo1, lo2, shift,
                                  zp2_stored, ds_fine)


def fused_basicblock_s1(x_q, w1, w2, a1, b1, a2, b2, lo1, shift, zp1_stored, zp2_stored,
                        id_k, id_c) -> torch.Tensor:
    """JAX-layout entry: w1 and w2 (3, 3, C, C) HWIO."""
    return fused_basicblock_s1_ck(x_q, pack_conv_weight(w1), pack_conv_weight(w2), a1, b1, a2, b2,
                                  lo1, shift, zp1_stored, zp2_stored, id_k, id_c)


def fused_basicblock_ds(x_q, w1, w2, wd, a1, b1, a2, b2, ad, bd, stride, lo1, shift, zp1_stored,
                        zp2_stored, ds_fine=0.0) -> torch.Tensor:
    """JAX-layout entry: w1 (3, 3, C, Cm) and w2 (3, 3, Cm, Cm) HWIO, wd (C, Cm)."""
    return fused_basicblock_ds_ck(x_q, pack_conv_weight(w1), pack_conv_weight(w2), _nk(wd),
                                  a1, b1, a2, b2, ad, bd, stride, lo1, shift, zp1_stored, zp2_stored,
                                  ds_fine)


def fused_dw_pw(x_q, wdw, wpw, a1, b1, a2, b2, stride, lo1, lo2, zp1_stored) -> torch.Tensor:
    """JAX-layout entry: wdw (3, 3, C), wpw (C, Cout)."""
    return fused_dw_pw_ck(x_q, wdw.reshape(9, -1).T.contiguous(), _nk(wpw), a1, b1, a2, b2, stride,
                          lo1, lo2, zp1_stored)
