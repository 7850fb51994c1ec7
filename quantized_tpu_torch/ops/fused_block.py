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

B3 and B4 run the Hopper mainloop (``csrc/block_sm90.cuh``) under the
launch plan of :func:`block_plan`: a cluster of q blocks per band of output
rows (and nb whole images where an image is small) splits the channels of
each stage, and the blocks share h1 and h2 through distributed shared
memory; each launch is counted under route "sm90" (``KERNELS[name].routes``).
Bands recompute conv1 on the halo rows that the neighbouring band also
needs. The stage probes of the bottleneck (:func:`fused_stage_ck`,
``bench/fused_probe.py``'s ``k_conv1`` and ``k_conv12``) are the same
mainloop stopped after conv1 or conv2. B5 owns one image and a band of
rows a block (:func:`dw_pw_band_rows`) and only re-reads its input halo,
since a depthwise output row belongs to one band.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.int8_conv import grouped_conv_acc, int8_conv_acc, pack_conv_weight
from quantized_tpu_torch.ops.int8_matmul import exact_int_matmul, f32

BLOCK_PLAN_ARGS = ["int"] * 5  # the C entries' trailing plan arguments: BlockPlan.args()
FUSED_S1 = _cuda.CudaKernel("fused_bottleneck_s1", "fused_block.cu", "qt_fused_bottleneck_s1",
                            ["ptr"] * 11 + ["int"] * 7 + ["float"] * 5 + BLOCK_PLAN_ARGS)
FUSED_DS = _cuda.CudaKernel("fused_bottleneck_ds", "fused_block.cu", "qt_fused_bottleneck_ds",
                            ["ptr"] * 14 + ["int"] * 9 + ["float"] * 5 + BLOCK_PLAN_ARGS)
BASIC_S1 = _cuda.CudaKernel("fused_basicblock_s1", "fused_block.cu", "qt_fused_basicblock_s1",
                            ["ptr"] * 8 + ["int"] * 8 + ["float"] * 4 + BLOCK_PLAN_ARGS)
BASIC_DS = _cuda.CudaKernel("fused_basicblock_ds", "fused_block.cu", "qt_fused_basicblock_ds",
                            ["ptr"] * 11 + ["int"] * 9 + ["float"] * 4 + BLOCK_PLAN_ARGS)
# the stage probes of the bottleneck (one C entry, counted under the two Pallas bodies' names)
_STAGE_ARGS = ["ptr"] * 6 + ["int"] * 12
STAGE_CONV1 = _cuda.CudaKernel("fused_stages_conv1", "fused_stages.cu", "qt_fused_stages", _STAGE_ARGS)
STAGE_CONV12 = _cuda.CudaKernel("fused_stages_conv12", "fused_stages.cu", "qt_fused_stages", _STAGE_ARGS)
DW_PW = _cuda.CudaKernel("fused_dw_pw", "fused_dw_pw.cu", "qt_fused_dw_pw",
                         ["ptr"] * 8 + ["int"] * 8 + ["float"] * 2)

SMEM_PER_BLOCK = 232448  # the H100's opt-in limit for one block
SMEM_TWO_PER_SM = 113 * 1024  # small enough for two blocks to share an SM's 228 KB


# ----------------------------------------------------------------- the Hopper mainloop's plan
#
# B3 and B4 run the mainloop of csrc/block_sm90.cuh: a cluster of q blocks
# per band of output rows (and nb images where an image is small), each
# block one slice of Cm/q (and Cout/q) channels, its h1 (and h2) whole in
# shared memory; jobs of 128 GEMM rows x bn channels, the weights in 128-byte
# K stages through a ring of `stages` slots. The constants mirror the header's.
BLOCK_TILE_M = 128  # GEMM rows per job: two consumer warpgroups of 64
BLOCK_KB = 128  # K bytes per ring stage
BLOCK_STAGES = 4  # ring slots, fewer where shared memory is short
BLOCK_QS = (1, 2, 4, 8)  # cluster sizes (8: the portable limit)
BLOCK_BNS = (64, 32, 16)  # wgmma N of a job, the widest that divides the slices
BLOCK_KINDS = ("bottleneck", "basic")


class BlockPlan(NamedTuple):
    q: int  # blocks of a cluster, each Cm/q (and Cout/q) channels
    nb: int  # images per cluster (more than 1 only where R covers the image)
    r: int  # output rows per band
    bn: int  # wgmma N: channels per job
    stages: int  # ring slots
    smem: int  # dynamic shared memory per block, bytes
    blocks: int  # q x bands x image groups
    steps: int  # ring stages of the busiest block: the plan's cost per wave

    def args(self):
        """The C entry's plan arguments: q, nb, bn, stages, smem."""
        return [self.q, self.nb, self.bn, self.stages, self.smem]


def block_h1_shape(kind: str, r: int, w: int, stride: int):
    """h1 per image: (rows, pixels a row). B3: the band's (r - 1) * s + 3
    input rows of w + 2 pixels (conv2's halo); B4: r + 2 output-grid rows of
    w/s + 2 pixels."""
    if kind == "bottleneck":
        return (r - 1) * stride + 3, w + 2
    return r + 2, w // stride + 2


def block_smem_bytes(kind: str, bn: int, stages: int, nb: int, r: int, w: int, cm: int, stride: int) -> int:
    """``smem_bytes`` of block_sm90.cuh: 1024 bytes of alignment slack, the
    ring (bn x 128 bytes a slot), 16 bytes a slot for its mbarrier, h1 and,
    for B3, h2 (r rows of w/s pixels), at a pixel pitch of Cm + 16 bytes."""
    hr, wp = block_h1_shape(kind, r, w, stride)
    h2 = r * (w // stride) if kind == "bottleneck" else 0
    return 1024 + stages * bn * BLOCK_KB + 16 * stages + nb * (hr * wp + h2) * (cm + 16)


def block_gemms(kind: str, nb: int, r0: int, rb: int, h: int, w: int, c: int, cm: int, cout: int, stride: int,
                ds: bool):
    """The GEMMs of one block whose band starts at output row r0 with rb
    rows over nb images: (rows, K of the first operand, K of the shortcut
    conv or 0, output channels of the cluster), in the kernel's order."""
    ho, wo = h // stride, w // stride
    if kind == "bottleneck":
        hb = r0 * stride - 1
        lr_lo, lr_hi = max(0, -hb), min((rb - 1) * stride + 3, h - hb)
        m1, m2 = nb * (lr_hi - lr_lo) * w, nb * rb * wo
        return [(m1, c, 0, cm), (m2, 9 * cm, 0, cm), (m2, cm, c if ds else 0, cout)]
    i_lo, i_hi = max(0, r0 - 1), min(ho, r0 + rb + 1)
    return [(nb * (i_hi - i_lo) * wo, 9 * c, 0, cm), (nb * rb * wo, 9 * cm, c if ds else 0, cm)]


def block_steps(gemms, q: int, bn: int) -> int:
    """Ring stages of a block: per GEMM, row tiles x channel jobs x K stages."""
    return sum(-(-m // BLOCK_TILE_M) * (n // q // bn) * (-(-ka // BLOCK_KB) + -(-kb // BLOCK_KB))
               for m, ka, kb, n in gemms)


# How many clusters of q blocks are resident at once, at one block an SM
# (a block takes most of an SM's shared memory, or its registers). A
# cluster's blocks share one GPC; the H100 SXM does not report its GPCs'
# sizes, so the plan takes its 132 SMs in 8 GPCs of 18, 18, 18, 18, 16, 16,
# 14 and 14, the layout that reproduces the plan sweep
# (probes/fused_stages --every, PERF.md): 30 clusters of 4 and 14 of 8 at
# once, where 128 SMs would hold 32 and 16.
H100_GPC_SMS = (18, 18, 18, 18, 16, 16, 14, 14)


def resident_clusters(q: int) -> int:
    return sum(n // q for n in H100_GPC_SMS)


@functools.lru_cache(maxsize=4096)  # a wrapper plans every call; the engines repeat a few shapes
def block_plan(kind: str, n: int, h: int, w: int, c: int, cm: int, cout: int, stride: int, ds: bool) -> BlockPlan:
    """The launch plan of B3 (``kind`` "bottleneck") or B4 ("basic") on an
    (n, h, w, c) input; ``ds``: the block has the shortcut conv.

    Of every cluster size q (Cm/q and Cout/q multiples of 16), every band
    height (bands of equal height) and, where an image takes at most half a
    128-row tile, every count nb of whole images a cluster, whose shared
    memory fits a block: the one whose busiest block runs the fewest ring
    stages times waves of clusters (``resident_clusters`` at once), the
    fewer blocks on a tie (less halo recompute and weight traffic). Raises
    where none fits. On the H100 the sweep (``probes/fused_stages
    --every``) finds the plan within 3% of the best plan it times over
    every engine shape at batches 32 and 128."""
    if kind not in BLOCK_KINDS:
        raise ValueError(f"kind {kind!r} is not one of {BLOCK_KINDS}")
    ho, wo = h // stride, w // stride
    plans = []
    bands = sorted({-(-ho // k) for k in range(1, ho + 1)})
    shapes = [(1, r) for r in bands]
    if 2 * ho * wo <= BLOCK_TILE_M:
        shapes += [(nb, ho) for nb in range(2, min(n, BLOCK_TILE_M // (ho * wo)) + 1)]
    for q in BLOCK_QS:
        if cm % q or cout % q or (cm // q) % 16 or (cout // q) % 16:
            continue
        bn = next(b for b in BLOCK_BNS if (cm // q) % b == 0 and (cout // q) % b == 0)
        for nb, r in shapes:
            stages = next((s for s in range(BLOCK_STAGES, 1, -1)
                           if block_smem_bytes(kind, bn, s, nb, r, w, cm, stride) <= SMEM_PER_BLOCK), 0)
            if not stages:
                continue
            smem = block_smem_bytes(kind, bn, stages, nb, r, w, cm, stride)
            steps = max(block_steps(block_gemms(kind, min(nb, n), r0, min(r, ho - r0), h, w, c, cm, cout, stride, ds),
                                    q, bn) for r0 in range(0, ho, r))
            clusters = -(-ho // r) * -(-n // nb)
            cost = -(-clusters // resident_clusters(q)) * steps
            plans.append((cost, q * clusters, -r, BlockPlan(q, nb, r, bn, stages, smem, q * clusters, steps)))
    if not plans:
        raise ValueError(f"a fused {kind} block over W={w}, Cm={cm} does not fit in shared memory")
    return min(plans)[3]


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


def fused_stage_plain(x_q, w1_nk, w2_ck, a, stop: int) -> torch.Tensor:
    """Plain version of the stage probes (``k_conv1``, ``k_conv12`` of
    ``bench/fused_probe.py``): h1 = clip(round(acc1 * a), -128, 127) over
    the 1x1 conv1; with ``stop`` 2, h2 the same over the 3x3 conv2 on h1
    padded with 0; the stage's output tiled C / Cm times across channels."""
    n, h, w, c = x_q.shape
    cm = w1_nk.shape[0]
    a = a.reshape(-1)
    zero = torch.zeros_like(a)
    y = _requant(exact_int_matmul(x_q.reshape(-1, c), w1_nk), a, zero, -128.0).reshape(n, h, w, cm)
    if stop == 2:
        y = _requant(int8_conv_acc(y, w2_ck, (3, 3), 1, 1, 0), a, zero, -128.0).reshape(n, h, w, cm)
    return y.repeat(1, 1, 1, c // cm)


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
    plan = block_plan("bottleneck", n, h, w, c, cm, c, 1, False)
    out = torch.empty_like(x_q)
    FUSED_S1(dev, x_q.data_ptr(), w1_nk.data_ptr(), w2_ck.data_ptr(), w3_nk.data_ptr(),
             a1.data_ptr(), b1.data_ptr(), a2.data_ptr(), b2.data_ptr(), a3.data_ptr(), b3.data_ptr(),
             out.data_ptr(), n, h, w, c, cm, plan.r, int(zp2_stored),
             f32(lo1), f32(lo2), f32(shift), f32(id_k), f32(id_c), *plan.args(), route="sm90")
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
    # the kernel's output slices are whole 16-channel jobs: another Cout runs
    # on weights and constants padded to a multiple of 16, the pad sliced off
    cpad = -(-cout // 16) * 16
    if cpad != cout:
        w3_nk, wd_nk, a3, b3, ad, bd = (torch.nn.functional.pad(t, (0, 0, 0, cpad - cout)) if t.ndim == 2
                                        else torch.nn.functional.pad(t, (0, cpad - cout))
                                        for t in (w3_nk, wd_nk, a3, b3, ad, bd))
    plan = block_plan("bottleneck", n, h, w, c, cm, cpad, s, True)
    out = torch.empty((n, h // s, w // s, cpad), dtype=torch.int8, device=dev)
    inv_fine = f32(1.0 / ds_fine) if ds_fine else 0.0
    FUSED_DS(dev, x_q.data_ptr(), w1_nk.data_ptr(), w2_ck.data_ptr(), w3_nk.data_ptr(),
             wd_nk.data_ptr(), a1.data_ptr(), b1.data_ptr(), a2.data_ptr(), b2.data_ptr(),
             a3.data_ptr(), b3.data_ptr(), ad.data_ptr(), bd.data_ptr(), out.data_ptr(),
             n, h, w, c, cm, cpad, s, plan.r, int(zp2_stored),
             f32(lo1), f32(lo2), f32(shift), f32(ds_fine), inv_fine, *plan.args(), route="sm90")
    return out if cpad == cout else out[..., :cout].contiguous()


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
    plan = block_plan("basic", n, h, w, c, c, c, 1, False)
    out = torch.empty_like(x_q)
    BASIC_S1(dev, x_q.data_ptr(), w1_ck.data_ptr(), w2_ck.data_ptr(), a1.data_ptr(), b1.data_ptr(),
             a2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, h, w, c, c, plan.r, int(zp1_stored),
             int(zp2_stored), f32(lo1), f32(shift), f32(id_k), f32(id_c), *plan.args(), route="sm90")
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
    plan = block_plan("basic", n, h, w, c, cm, cm, s, True)
    out = torch.empty((n, h // s, w // s, cm), dtype=torch.int8, device=dev)
    inv_fine = f32(1.0 / ds_fine) if ds_fine else 0.0
    BASIC_DS(dev, x_q.data_ptr(), w1_ck.data_ptr(), w2_ck.data_ptr(), wd_nk.data_ptr(), a1.data_ptr(),
             b1.data_ptr(), a2.data_ptr(), b2.data_ptr(), ad.data_ptr(), bd.data_ptr(), out.data_ptr(),
             n, h, w, c, cm, s, plan.r, int(zp1_stored), int(zp2_stored),
             f32(lo1), f32(shift), f32(ds_fine), inv_fine, *plan.args(), route="sm90")
    return out


def fused_stage_ck(x_q, w1_nk, w2_ck, a, stop: int) -> torch.Tensor:
    """The stage probes on K-major weights: w1 (Cm, C), w2 (Cm, 9*Cm), a
    (Cm,); ``stop`` 1 runs conv1 (``fused_stages_conv1``), 2 conv1 and
    conv2 (``fused_stages_conv12``). (N, H, W, C) in and out, C % Cm == 0."""
    n, h, w, c = x_q.shape
    cm = w1_nk.shape[0]
    a = a.reshape(-1)
    if stop not in (1, 2):
        raise ValueError(f"stop must be 1 (conv1) or 2 (conv1 and conv2), got {stop}")
    _check(x_q, [(w1_nk, (cm, c), "w1"), (w2_ck, (cm, 9 * cm), "w2")], [(a, cm, "a")])
    if c % cm:
        raise ValueError(f"the stage output tiles Cm={cm} channels across C={c}: C must be a multiple")
    if x_q.device.type == "cpu":
        return fused_stage_plain(x_q, w1_nk, w2_ck, a, stop)
    dev = _cuda.require_cuda_tensors(x_q, w1_nk, w2_ck, a)
    _check_widths(c, cm)
    plan = block_plan("bottleneck", n, h, w, c, cm, c, 1, False)
    zero = torch.zeros_like(a)
    out = torch.empty_like(x_q)
    (STAGE_CONV1 if stop == 1 else STAGE_CONV12)(
        dev, x_q.data_ptr(), w1_nk.data_ptr(), w2_ck.data_ptr(), a.data_ptr(), zero.data_ptr(), out.data_ptr(),
        n, h, w, c, cm, stop, plan.r, *plan.args(), route="sm90")
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


def fused_stage(x_q, w1, w2, a, stop: int) -> torch.Tensor:
    """JAX-layout entry of the stage probes: w1 (C, Cm), w2 (3, 3, Cm, Cm)
    HWIO, a (1, Cm), as ``bench/fused_probe.py`` passes them."""
    return fused_stage_ck(x_q, _nk(w1), pack_conv_weight(w2), a.reshape(-1).contiguous(), stop)


def fused_dw_pw(x_q, wdw, wpw, a1, b1, a2, b2, stride, lo1, lo2, zp1_stored) -> torch.Tensor:
    """JAX-layout entry: wdw (3, 3, C), wpw (C, Cout)."""
    return fused_dw_pw_ck(x_q, wdw.reshape(9, -1).T.contiguous(), _nk(wpw), a1, b1, a2, b2, stride,
                          lo1, lo2, zp1_stored)
