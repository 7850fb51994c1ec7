"""Direct int8 convolution with the fused epilogue (kernel K2), its
fused-residual form (B8) and the flat-row conv (B7).

Counterparts of the JAX package's ``int8_conv_direct`` and
``int8_conv_flat``: NHWC int8 in, the conv as an implicit GEMM with int32
accumulation, then ``y = acc * alpha + beta``, with a residual ``y = y + (r
+ (128 - r_zp)) * r_scale`` (B8), ReLU if asked, and either f32 out or the
requant ``clip(rint(y * f32(1/s) + (zp - 128)), -128, 127)`` onto the
consumer's grid.

K2 is one C entry (``csrc/int8_conv.cu``), counted under three names that
stand for the Pallas bodies, chosen like them: per-tap, gather-K for small
Cin (``cin <= 32`` with more than one tap) and the residual form (always
per-tap in JAX). Its per-tap and residual forms over Cin % 16 == 0 with
16-byte-aligned operands run the Hopper conv mainloop
(``csrc/conv_sm90.cuh``: wgmma, a TMA ring, persistent blocks; the residual
on kernel instances of its own) under the launch plan of :func:`conv_plan`;
the mainloop reads the padding as zeros, so it adds back ``stored_zp *
tapsum`` over each pixel's outside taps (:func:`conv_tapsum`; the kernel
reads them from their summed-area table, :func:`conv_border_sums`, computed
once per weight by :class:`~quantized_tpu_torch.engine.int_layers.IntConv2d`;
:func:`int8_conv_zero_filled_plain` is that arithmetic in PyTorch). A 1x1
stride-1 unpadded conv over Cin % 16 != 0 but Cin % 4 == 0 runs the same
mainloop on pixel groups (:func:`pixel_group`: four pixels a row of 4 * Cin
bytes, ``diag(W, W, W, W)``, the epilogue's vectors tiled four times;
:func:`pixel_group_operands`, built once per layer by ``IntConv2d``;
:func:`int8_conv_pixel_groups_plain` is that product in PyTorch). Its
gather-K form over Cout <= 64 with a 16-byte-aligned input runs a Hopper
route of its own (``csrc/gatherk_sm90.cuh``: each tile's input window in
shared memory by cp.async, the zero point in its padding, the weights
resident, A built from the window as Kh runs of Kw * Cin bytes a pixel,
wgmma, a bulk-copied epilogue; :func:`gatherk_a_plain` is that K layout in
PyTorch). Every other call runs the general tile, which takes any Cin,
gathering 16-byte chunks where Cin is a multiple of 16, 4-byte chunks where
it is a multiple of 4 and single bytes otherwise (Cin 9). B7
(``csrc/int8_conv_flat.cu``) runs stride-1 convs over the zero-point-padded
image's flattened rows, every tap one read at a constant offset, on the
same mainloop where Cin % 16 == 0 and on its own tile elsewhere. Each kernel counts its launches by route
(``KERNELS[name].routes``: ``"sm90"`` or ``"tile"``). The kernels take the weights packed (Cout,
Kh*Kw*Cin), which :class:`~quantized_tpu_torch.engine.int_layers.IntConv2d`
stores once at build time; :func:`int8_conv_direct` and
:func:`int8_conv_flat` keep the JAX signatures (HWIO), without the TPU
tiling arguments (``nb``, ``block_h``/``block_m``, ``block_n``,
``interpret``).

K2 takes the RangeBN flavor's observer clamp (the clamp of
``int8_conv_xla(y_clip=)``, which the JAX package sends to XLA rather than
to its kernel): :func:`int8_conv_direct` as ``y_clip``, the packed-weight
wrapper and the plain version once, as ``clip``, in the form the kernel
reads (``ops.int8_matmul.kernel_clip``): the f32 output is clamped to
``y_clip`` before ReLU, the s8 output's rounded value to the integer bounds
of ``ops.int8_matmul.requant_clip_bounds`` alone, whose lo holds the ReLU
floor. Every route has CLIP instances of its own, counted under
``"<route>+clip"``; the residual form takes no clamp.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernel or raises. The whole-block kernels are in
``ops/fused_block.py``.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.int8_conv import Ints, _pair, int8_conv_acc, pack_conv_weight, pad_stored_zp
from quantized_tpu_torch.ops.int8_matmul import (
    CLIP_ARGS,
    H100_SMS,
    SMEM_LIMIT,
    Clip,
    activate,
    clip_args,
    clip_minmax,
    clip_pair,
    exact_int_matmul,
    exp_act,
    f32,
    kernel_clip,
)

CONV_PLAN_ARGS = ["int"] * 9  # the C entries' trailing plan arguments: ConvPlan.args()
# one C entry (qt_int8_conv) behind the three counted forms: x, w, alpha,
# beta, residual (None but for B8), border sums, out; the shape; the epilogue's
# scalars; the plan; the clamp's bounds (None but for a clamped conv)
_CONV_ARGS = ["ptr"] * 7 + ["int"] * 16 + ["float"] * 4 + CONV_PLAN_ARGS + CLIP_ARGS
CONV_TAP = _cuda.CudaKernel("int8_conv_direct", "int8_conv.cu", "qt_int8_conv", _CONV_ARGS)
CONV_GATHERK = _cuda.CudaKernel("int8_conv_direct_gatherk", "int8_conv.cu", "qt_int8_conv", _CONV_ARGS)
CONV_RESIDUAL = _cuda.CudaKernel("int8_conv_direct_residual", "int8_conv.cu", "qt_int8_conv", _CONV_ARGS)
CONV_FLAT = _cuda.CudaKernel("int8_conv_flat", "int8_conv_flat.cu", "qt_int8_conv_flat",
                             ["ptr"] * 5 + ["int"] * 11 + ["float"] * 2 + CONV_PLAN_ARGS)

# The launch plan of the Hopper conv mainloop (csrc/conv_sm90.cuh); the
# constants mirror the header's.
CONV_TILE_M = 128  # output pixels (GEMM rows) per tile: two warpgroups of 64
CONV_KCS = (128, 64, 32)  # K bytes per ring stage: one swizzle row
CONV_MAX_STAGES = 8
CONV_DEEP_STAGES = 4  # ring slots where a tile takes more stages: deeper rings timed slower on an H100
CONV_PASS = 32  # channels the epilogue stages at a time
CONV_ROW_INFO = 24  # bytes of a row of the epilogue's row table (RowInfo)
CONV_BLOCKS_PER_SM = 2  # the kernel's __launch_bounds__ and the plan's shared memory allow two
CONV_SMEM_PER_BLOCK = 228 * 1024 // CONV_BLOCKS_PER_SM - 1024  # an SM's 228 KB, less 1 KB a block for the system
CONV_FORMS = ("tap", "gatherk", "residual", "flat")


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


class ConvPlan(NamedTuple):
    route: str  # "sm90": a Hopper route; "tile": the general mma.sync tile (every field below 0)
    kc: int  # K bytes per ring stage (128, 64 or 32: the widest that divides Cin, else 32); gather-K: the swizzle row
    bn: int  # output channels per tile (wgmma's N: 32, 64 or 128; gather-K: 16, 32 or 64)
    two: int  # K2: output columns x rows x images per tile (two * tho * nb <= 128); B7: 128, 1, 1
    tho: int
    nb: int
    stages: int  # ring slots (gather-K: its two input windows)
    smem: int  # dynamic shared memory per block, bytes (gather-K: with s8 out)
    k_stages: int  # ring stages per tile: Kh * Kw * ceil(Cin / kc); gather-K: wgmma steps, ceil(K / 32)
    tiles: int  # output tiles: pixel tiles x ceil(Cout / bn)
    blocks: int  # persistent blocks: min(tiles, 2 x SMs)
    mode: int = 1  # the C entry's Hopper route: 1 the conv mainloop, 2 the gather-K route
    pixels: int = 1  # pixels a GEMM row: 4 on the pixel-group route (the other fields are then the groups' GEMM's)

    @property
    def tma_shape(self) -> bool:
        """The shape suits the Hopper route; the C entry also needs 16-byte-aligned bases."""
        return self.route == "sm90"

    def args(self, sm90: bool) -> List[int]:
        """The C entry's plan arguments: the Hopper route's, or all 0 for the tile."""
        if not sm90:
            return [0] * len(CONV_PLAN_ARGS)
        return [self.mode, self.kc, self.bn, self.two, self.tho, self.nb, self.stages, self.blocks, self.smem]


def conv_epilogue_bytes() -> int:
    """Shared memory of the epilogue: each of the 8 consumer warps' 16
    staged rows of 32 int32 channels (+16 bytes) and its row table."""
    return 8 * 16 * (CONV_PASS * 4 + 16 + CONV_ROW_INFO)


def conv_smem_bytes(kc: int, bn: int, stages: int) -> int:
    """``smem_bytes`` of conv_sm90.cuh: 1024 bytes of alignment slack, the
    ring of (128 + bn) x kc-byte stages, two 8-byte mbarriers a slot, the
    epilogue's staging."""
    return 1024 + stages * (CONV_TILE_M + bn) * kc + 16 * stages + conv_epilogue_bytes()


_TILE_PLAN = ConvPlan("tile", *([0] * 10))
# pixels a GEMM row where a 1x1's Cin is not a multiple of 16 but four times it is: four, not two, as the
# wider rows halve the tiles (24 -> 48 at batch 32 on an H100: 0.056 ms against 0.059 for pairs, PERF.md)
PIXEL_GROUP = 4


def pixel_group(cin: int, kernel_size, stride=1, padding=0) -> int:
    """Pixels a GEMM row of K2's mainloop: ``PIXEL_GROUP`` for a 1x1
    stride-1 unpadded conv whose Cin is not a multiple of 16 (TMA's row
    pitch) but whose groups of four pixels are (Cin 24 and 8: MobileNet-v1's
    first pointwise conv at widths 0.75 and 0.25), else 1. Such a conv is a
    product of its input's rows, and g consecutive rows of Cin bytes are one
    row of g * Cin bytes times ``diag(W, ..., W)``."""
    plain_1x1 = (_pair(kernel_size), _pair(stride), _pair(padding)) == ((1, 1), (1, 1), (0, 0))
    return PIXEL_GROUP if plain_1x1 and cin % 16 and (PIXEL_GROUP * cin) % 16 == 0 else 1


def pixel_group_operands(w_ck: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                         g: int = PIXEL_GROUP) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pixel-group route's operands: the block-diagonal ``diag(W, ..., W)``
    (g * Cout, g * Cin) int8 and alpha, beta tiled g times."""
    return torch.block_diag(*[w_ck] * g).contiguous(), alpha.repeat(g), beta.repeat(g)


GATHERK_MAX_COUT = 64  # the gather-K route keeps every output channel in one wgmma tile
GATHERK_THREADS = 256
GATHERK_SLACK = 15 + 8  # a window row's left margin (up to 15 bytes) and the funnel shifts' over-read
GATHERK_BLOCKS_PER_SM = 3  # as many as shared memory allows, up to the kernel's __launch_bounds__ (three)


def _align16(v: int) -> int:
    return -(-v // 16) * 16


def gatherk_smem_bytes(kb: int, kp: int, bn: int, cout: int, nb: int, wr: int, rp: int, out_bytes: int = 1) -> int:
    """``gk_layout(...).total`` of gatherk_sm90.cuh: A (128 rows) and the
    weights (bn rows) in ceil(kp / kb) swizzled blocks of kb-byte rows, the
    staging tile (128 pixels, a row of Cout outputs rounded up to 16 bytes
    and 16 more), two input windows of nb x wr rows at a pitch of rp bytes,
    the epilogue constants (2 x 64 floats), the row tables (3 x 128 ints)
    and 1024 bytes of alignment slack."""
    nkb = -(-kp // kb)
    return (CONV_TILE_M * kb * nkb + bn * kb * nkb + CONV_TILE_M * (_align16(cout * out_bytes) + 16)
            + 2 * nb * wr * rp + 2 * GATHERK_MAX_COUT * 4 + 3 * CONV_TILE_M * 4 + 1024)


def _tile_box(n: int, ho: int, wo: int, max_two: int, max_rows: int):
    """Whole output rows (up to max_two columns), as many as make up to 128
    pixels, balanced over the image; whole images, several a tile, where one
    takes less than half."""
    two = min(wo, CONV_TILE_M, max_two)
    tho = min(ho, CONV_TILE_M // two, max_rows)
    tho = -(-ho // -(-ho // tho))  # the same number of bands, evened out
    nb = min(n, CONV_TILE_M // (two * tho), 256) if (two, tho) == (wo, ho) else 1
    return two, tho, nb


def _gatherk_plan(n, h, w, cin, cout, kh, kw, sh, sw, ho, wo, sms) -> ConvPlan:
    """The gather-K form's Hopper route (gatherk_sm90.cuh), or the tile
    where it cannot take the shape: Cout past 64, a K row of more than 256
    copy units, Cin 1-3 with a run of fewer than 4 bytes, or shared memory
    past a block's. The tile is K2's box, halved (images first, then rows)
    while there are fewer tiles than SMs; blocks persist, up to three an SM
    as their shared memory allows."""
    k = kh * kw * cin
    kp = -(-k // 32) * 32
    unit = 16 if cin % 16 == 0 else 4
    if cout > GATHERK_MAX_COUT or kp // unit > GATHERK_THREADS or (cin % 4 and kw * cin < 4):
        return _TILE_PLAN
    kb = 32 if kp <= 32 else 64 if kp <= 64 else 128
    bn = 16 if cout <= 16 else 32 if cout <= 32 else 64
    two, tho, nb = _tile_box(n, ho, wo, CONV_TILE_M, CONV_TILE_M)

    def tiles_of(tho, nb):
        return -(-wo // two) * -(-ho // tho) * -(-n // nb)

    while tiles_of(tho, nb) < sms and (nb > 1 or tho > 1):  # fewer tiles than SMs: smaller tiles
        if nb > 1:
            nb = -(-nb // 2)
        else:
            tho = -(-ho // -(-ho // -(-tho // 2)))  # half the rows, bands evened out
    wr, wc = (tho - 1) * sh + kh, (two - 1) * sw + kw
    rp = _align16(wc * cin + GATHERK_SLACK)
    smem = gatherk_smem_bytes(kb, kp, bn, cout, nb, wr, rp)
    if smem > SMEM_LIMIT:
        return _TILE_PLAN
    per_sm = min(GATHERK_BLOCKS_PER_SM, 228 * 1024 // (smem + 1024))
    tiles = tiles_of(tho, nb)
    return ConvPlan("sm90", kb, bn, two, tho, nb, 2, smem, kp // 32, tiles, min(tiles, per_sm * sms), mode=2)


@functools.lru_cache(maxsize=4096)  # a wrapper plans every call; the engines repeat a few shapes
def conv_plan(n: int, h: int, w: int, cin: int, cout: int, kernel_size: Tuple[int, int],
              stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0), form: str = "tap",
              sms: int = H100_SMS) -> ConvPlan:
    """The launch plan of K2 (``form`` "tap", "gatherk" or "residual") or B7
    ("flat") on an (n, h, w, cin) input, before padding.

    - route: the mainloop for the per-tap and residual forms (one plan for
      both) and B7 where Cin % 16 == 0 (TMA's 16-byte row pitch) and, for
      K2, strides up to 8 (TMA's traversal stride); for K2's 1x1 stride-1
      unpadded convs where :func:`pixel_group` groups the pixels and N * H *
      W is a multiple of the group, the plan of the groups' product
      (``pixels`` 4: N * H * W / 4 rows of 4 * Cin bytes, 4 * Cout
      channels, one ring stage a tile where 4 * Cin <= 128: the stage
      reaches past the row, zero-filled); for gather-K its own route
      (:func:`_gatherk_plan`: kc is the swizzle row, 32, 64 or 128 bytes, bn
      the Cout tile, stages its two input windows, up to three blocks an SM
      where they fit); the general tile for the rest;
    - kc: 128, 64 or 32 K bytes a stage, the widest dividing Cin (32 for Cin
      16 or 48: the chunk past Cin arrives as zeros);
    - K2's tile: whole output rows (up to 128 columns), as many as make up to
      128 pixels, balanced over the image; whole images, several a tile,
      where one takes less than half (7x7: 2 images, 98 rows). B7's, and
      K2's at a 1x1 stride-1 conv without padding (the C entry reads its
      input as the rows of a matrix then): 128 consecutive flat rows;
    - bn: 32, 64 or 128 channels, the smallest that holds Cout, and 64 in
      place of 128 where the tiles would not cover the SMs;
    - stages: 2 where a tile takes one or two stages (1x1 convs), else up
      to 4, as many as fit in half an SM's shared memory beside the
      epilogue's staging; blocks: two an SM (one block's epilogue runs
      beside the other's loads and products), persistent over the tiles."""
    if form not in CONV_FORMS:
        raise ValueError(f"form {form!r} is not one of {CONV_FORMS}")
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel_size), _pair(stride), _pair(padding)
    hp, wp = h + 2 * ph, w + 2 * pw
    if form == "flat":
        ho, wo = hp - kh + 1, wp - kw + 1
    else:
        ho, wo = conv_out_hw(h, w, (kh, kw), (sh, sw), (ph, pw))
    if form == "gatherk":
        return _gatherk_plan(n, h, w, cin, cout, kh, kw, sh, sw, ho, wo, sms)
    g = 1 if form == "flat" else pixel_group(cin, (kh, kw), (sh, sw), (ph, pw))
    if g > 1 and (n * h * w) % g == 0:
        plan = conv_plan(1, 1, n * h * w // g, g * cin, g * cout, (1, 1), form=form, sms=sms)
        # one stage a tile, reaching past the row: pairs at 24 -> 48 took 0.067 ms in two stages and 0.059 in
        # one on an H100 (PERF.md)
        if plan.k_stages > 1 and g * cin <= CONV_KCS[0]:
            kc = min(k for k in CONV_KCS if k >= g * cin)
            plan = plan._replace(kc=kc, k_stages=1, stages=2, smem=conv_smem_bytes(kc, plan.bn, 2))
        return plan._replace(pixels=g)
    if cin % 16 or not (form == "flat" or (sh <= 8 and sw <= 8)):
        return _TILE_PLAN
    kc = next(k for k in CONV_KCS if cin % k == 0 or k == CONV_KCS[-1])
    k_stages = kh * kw * -(-cin // kc)
    if form == "flat" or (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0):  # flat rows: B7, and K2's plain 1x1s
        two, tho, nb = CONV_TILE_M, 1, 1
        m_tiles = -(-((n - 1) * hp * wp + ho * wp) // CONV_TILE_M)
    else:
        two, tho, nb = _tile_box(n, ho, wo, 256 // sw, 256 // sh)
        m_tiles = -(-wo // two) * -(-ho // tho) * -(-n // nb)
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128
    if bn == 128 and m_tiles * -(-cout // 128) < CONV_BLOCKS_PER_SM * sms:
        bn = 64
    tiles = m_tiles * -(-cout // bn)
    ring = CONV_SMEM_PER_BLOCK - 1024 - 16 * CONV_MAX_STAGES - conv_epilogue_bytes()
    deep = 2 if k_stages <= 2 else CONV_DEEP_STAGES  # a tile of one or two stages needs no deeper ring
    stages = max(2, min(deep, ring // ((CONV_TILE_M + bn) * kc)))
    smem = conv_smem_bytes(kc, bn, stages)
    assert smem <= CONV_SMEM_PER_BLOCK
    return ConvPlan("sm90", kc, bn, two, tho, nb, stages, smem, k_stages, tiles, min(tiles, CONV_BLOCKS_PER_SM * sms))


def conv_tapsum(w_ck: torch.Tensor, taps: int) -> torch.Tensor:
    """(taps, Cout) int32: ``tapsum[tap][n] = sum_c w[n, tap * Cin + c]``,
    the weight sum that a tap reading the stored zero point multiplies."""
    cout = w_ck.shape[0]
    return w_ck.reshape(cout, taps, -1).sum(-1, dtype=torch.int32).T.contiguous()


def conv_border_sums(w_ck: torch.Tensor, kernel_size) -> torch.Tensor:
    """((Kh + 1) * (Kw + 1), Cout) int32, the summed-area table of
    :func:`conv_tapsum`: entry (i, j) sums the tap sums of the taps (kh, kw)
    with kh < i and kw < j. K2's Hopper route reads five of its entries for a
    border pixel: the window's total less its rectangle of inside taps."""
    kh, kw = _pair(kernel_size)
    sums = conv_tapsum(w_ck, kh * kw).reshape(kh, kw, -1)
    sat = torch.zeros((kh + 1, kw + 1, sums.shape[-1]), dtype=torch.int32, device=w_ck.device)
    sat[1:, 1:] = sums.cumsum(0, dtype=torch.int32).cumsum(1, dtype=torch.int32)
    return sat.reshape((kh + 1) * (kw + 1), -1)


def outside_taps(h: int, w: int, kernel_size, stride, padding, device=None) -> torch.Tensor:
    """(Ho, Wo, Kh * Kw) bool: which taps of each output pixel's window fall
    outside the (h, w) image (the static border map of the JAX package's
    strict engine, ``engine/strict.py`` ``_border_map``)."""
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel_size), _pair(stride), _pair(padding)
    ho, wo = conv_out_hw(h, w, (kh, kw), (sh, sw), (ph, pw))
    rows = torch.arange(ho, device=device)[:, None] * sh - ph + torch.arange(kh, device=device)
    cols = torch.arange(wo, device=device)[:, None] * sw - pw + torch.arange(kw, device=device)
    hin, win = (rows >= 0) & (rows < h), (cols >= 0) & (cols < w)
    inside = hin[:, None, :, None] & win[None, :, None, :]
    return ~inside.reshape(ho, wo, kh * kw)


def _epilogue(acc: torch.Tensor, alpha, beta, relu: bool, out_requant: Optional[Grid],
              residual: Optional[torch.Tensor] = None, res_grid: Optional[Grid] = None,
              clip: Optional[Clip] = None) -> torch.Tensor:
    """``int8_conv_direct``'s epilogue on an int32 accumulator, one float32
    rounding per operation: ``acc * alpha + beta``, the dequantized residual
    ``(r + (128 - r_zp)) * r_scale``, the activation (``relu``: a code of
    ``ops.int8_matmul.activate``: ReLU, SiLU or the sigmoid), then f32 out
    or the requant.
    ``clip`` (the RangeBN observer clamp, ``ops.int8_matmul.kernel_clip``)
    clips the f32 value before ReLU, or the requant's rounded value to its
    integer bounds in place of ReLU and [-128, 127]."""
    y = acc.to(torch.float32) * alpha + beta
    if residual is not None:
        r_scale, r_zp = res_grid
        y = y + (residual.to(torch.float32) + f32(128 - r_zp)) * f32(r_scale)
    if clip is not None and out_requant is None:
        y = clip_minmax(y, *clip)
    if not (clip is not None and out_requant is not None):
        y = activate(y, relu)
    if out_requant is None:
        return y
    q = torch.round(y * f32(1.0 / out_requant[0]) + f32(out_requant[1] - 128))
    if clip is not None:
        return clip_minmax(q, *clip).to(torch.int8)
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
    clip=None,
) -> torch.Tensor:
    """Plain version of K2 (and of B8, given ``residual``): exact int32
    accumulator, then the epilogue in ``int8_conv_direct``'s order, with the
    clamp ``clip`` (the kernel's form) where given."""
    acc = int8_conv_acc(x_q, w_ck, kernel_size, stride, padding, stored_zp)
    return _epilogue(acc, alpha, beta, relu, out_requant, residual, res_grid, clip_pair(clip, w_ck.shape[0]))


def int8_conv_zero_filled_plain(
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
    tapsum: Optional[torch.Tensor] = None,
    *,
    residual: Optional[torch.Tensor] = None,
    res_grid: Optional[Grid] = None,
) -> torch.Tensor:
    """K2 (B8 given ``residual``) in the Hopper mainloop's arithmetic: the
    padded taps read 0 (as TMA fills them), then ``stored_zp * sum of
    tapsum`` over each pixel's outside taps is added to the int32
    accumulator, then K2's epilogue with the residual. It equals
    :func:`int8_conv_direct_plain` exactly."""
    kh, kw = _pair(kernel_size)
    n, h, w, _ = x_q.shape
    acc = int8_conv_acc(x_q, w_ck, (kh, kw), stride, padding, 0)
    if tapsum is None:
        tapsum = conv_tapsum(w_ck, kh * kw)
    outside = outside_taps(h, w, (kh, kw), stride, padding, x_q.device)
    border = (outside.to(torch.float64) @ tapsum.to(torch.float64)).to(torch.int32)  # exact: |sum| < 2**31
    return _epilogue(acc + int(stored_zp) * border, alpha, beta, relu, out_requant, residual, res_grid)


def int8_conv_pixel_groups_plain(
    x_q: torch.Tensor,
    w_g: torch.Tensor,
    alpha_g: torch.Tensor,
    beta_g: torch.Tensor,
    relu: bool = False,
    out_requant: Optional[Grid] = None,
    *,
    residual: Optional[torch.Tensor] = None,
    res_grid: Optional[Grid] = None,
) -> torch.Tensor:
    """A 1x1 stride-1 unpadded conv (K2, or B8 given ``residual``) in the
    pixel-group route's arithmetic: the (N, H, W, Cin) input read as N * H *
    W / g rows of g * Cin bytes, times :func:`pixel_group_operands`' ``w_g``
    (g * Cout, g * Cin) with exact int32 accumulation, K2's epilogue on the
    tiled ``alpha_g``, ``beta_g``, and the (rows, g * Cout) result read back
    as (N, H, W, Cout). It equals :func:`int8_conv_direct_plain` exactly."""
    n, h, w, cin = x_q.shape
    g = w_g.shape[1] // cin
    rows = n * h * w // g
    acc = exact_int_matmul(x_q.reshape(rows, g * cin), w_g)
    r = None if residual is None else residual.reshape(rows, -1)
    y = _epilogue(acc, alpha_g, beta_g, relu, out_requant, r, res_grid)
    return y.reshape(n, h, w, -1)


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
    border_sums: Optional[torch.Tensor] = None,
    pixel_groups: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    clip=None,
) -> torch.Tensor:
    """K2 on packed (Cout, Kh*Kw*Cin) weights. NHWC f32 out, or int8 on
    ``out_requant``'s grid. ``residual`` (N, Ho, Wo, Cout) int8 on
    ``res_grid`` = (scale, zero point) is added before ReLU (B8).
    ``clip=(lo, hi)`` (a pair of (Cout,) f32 tensors or a (2, Cout)
    tensor: the RangeBN observer clamp in the kernel's form,
    ``ops.int8_matmul.kernel_clip``) clamps the epilogue as
    :func:`_epilogue` does, on the kernel's CLIP instances (not with
    ``residual``: no engine needs both).
    ``border_sums``: :func:`conv_border_sums` of the weights, which the
    Hopper route needs where a padded tap reads a nonzero stored zero point;
    ``pixel_groups``: :func:`pixel_group_operands` of the weights and of
    these alpha and beta, which the pixel-group route takes."""
    kh, kw = _pair(kernel_size)
    n, h, w, cin = x_q.shape
    cout = w_ck.shape[0]
    _check_conv(x_q, w_ck, kh, kw, alpha, beta)
    ho, wo = conv_out_hw(h, w, (kh, kw), stride, padding)
    clip = clip_pair(clip, cout)
    if clip is not None and exp_act(relu):
        raise ValueError("the clamp (y_clip) combines with ReLU alone")
    if residual is not None:
        if res_grid is None:
            raise ValueError("residual requires res_grid=(scale, zero_point)")
        if residual.shape != (n, ho, wo, cout):
            raise ValueError(f"residual {tuple(residual.shape)} is not the output's shape {(n, ho, wo, cout)}")
        if clip is not None:
            raise ValueError("the clamp (y_clip) does not combine with residual")
        _cuda.check_dtype(residual, torch.int8, "residual")
    if x_q.device.type == "cpu":
        return int8_conv_direct_plain(x_q, w_ck, (kh, kw), alpha, beta, stride, padding, stored_zp, relu,
                                      out_requant, residual=residual, res_grid=res_grid, clip=clip)
    tensors = (x_q, w_ck, alpha, beta) + (() if residual is None else (residual,))
    dev = _cuda.require_cuda_tensors(*tensors)
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    out, out_int8, inv, zps = _requant_args(out_requant, (n, ho, wo, cout), dev)
    if residual is None:
        form = "gatherk" if use_gather_k(cin, (kh, kw)) else "tap"
        kernel, r_ptr, r_off, r_scale = CONV_GATHERK if form == "gatherk" else CONV_TAP, None, 0.0, 0.0
    else:
        form = "residual"
        kernel, r_ptr, r_off, r_scale = CONV_RESIDUAL, residual.data_ptr(), f32(128 - res_grid[1]), f32(res_grid[0])
    plan = conv_plan(n, h, w, cin, cout, (kh, kw), (sh, sw), (ph, pw), form, _cuda.sm_count(dev))
    sm90 = plan.tma_shape and x_q.data_ptr() % 16 == 0 and w_ck.data_ptr() % 16 == 0
    shape = (n, h, w, cin, cout, kh, kw, sh, sw, ph, pw, ho, wo)
    bounds = clip
    if sm90 and plan.pixels > 1:  # the same product on pixel groups: rows of g pixels, diag(W, ..., W)
        g = plan.pixels
        if bounds is not None:
            bounds = (bounds[0].repeat(g), bounds[1].repeat(g))
        if pixel_groups is None:
            pixel_groups = pixel_group_operands(w_ck, alpha, beta, g)
        w_ck, alpha, beta = pixel_groups
        if w_ck.shape != (g * cout, g * cin) or alpha.shape != (g * cout,) or beta.shape != (g * cout,):
            raise ValueError(f"pixel_groups {[tuple(t.shape) for t in pixel_groups]} are not the operands of "
                             f"{g} pixels a row over ({cout}, {cin})")
        _cuda.require_cuda_tensors(x_q, w_ck, alpha, beta)
        if w_ck.data_ptr() % 16:
            raise ValueError("pixel_groups' weight must start on a 16-byte boundary")
        rows = n * h * w // g
        shape = (1, 1, rows, g * cin, g * cout, 1, 1, 1, 1, 0, 0, 1, rows)
    t_ptr = None
    if sm90 and plan.mode == 1 and (ph or pw) and stored_zp != 0:
        if border_sums is None:
            border_sums = conv_border_sums(w_ck, (kh, kw))
        elif border_sums.shape != ((kh + 1) * (kw + 1), cout):
            raise ValueError(f"border_sums {tuple(border_sums.shape)} is not ({(kh + 1) * (kw + 1)}, {cout})")
        _cuda.check_dtype(border_sums, torch.int32, "border_sums")
        _cuda.require_cuda_tensors(x_q, border_sums)
        t_ptr = border_sums.data_ptr()
    kernel(dev, x_q.data_ptr(), w_ck.data_ptr(), alpha.data_ptr(), beta.data_ptr(), r_ptr, t_ptr, out.data_ptr(),
           *shape, int(stored_zp), int(relu), out_int8, inv, zps, r_off, r_scale, *plan.args(sm90),
           *clip_args(bounds, w_ck.shape[0], dev),
           route=("sm90" if sm90 else "tile") + ("" if bounds is None else "+clip"))
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
    y_clip=None,
) -> torch.Tensor:
    """JAX-layout entry (``w_q`` HWIO); packs the weights on each call. JAX
    takes ``residual`` fifth; here it and ``res_grid`` are keywords, so the
    port's callers keep their positional ``stride``. ``y_clip`` is the
    clamp of ``int8_conv_xla(y_clip=)``, which JAX's kernel does not take."""
    return int8_conv_direct_ck(x_q, pack_conv_weight(w_q), tuple(w_q.shape[:2]), alpha, beta,
                               stride, padding, stored_zp, relu, out_requant, residual=residual,
                               res_grid=res_grid, clip=kernel_clip(y_clip, w_q.shape[3], out_requant, relu))


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
    of tap by tap on the general tile; both compute the same function, and
    the Hopper mainloop walks tap by tap for either."""
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
    plan = conv_plan(n, h, w, cin, cout, (kh, kw), (1, 1), _pair(padding), "flat", _cuda.sm_count(dev))
    xp = pad_stored_zp(x_q, padding, stored_zp)
    _, hp, wp, _ = xp.shape
    sm90 = plan.tma_shape and xp.data_ptr() % 16 == 0 and w_ck.data_ptr() % 16 == 0
    out, out_int8, inv, zps = _requant_args(out_requant, (n, hp - kh + 1, wp - kw + 1, cout), dev)
    CONV_FLAT(dev, xp.data_ptr(), w_ck.data_ptr(), alpha.data_ptr(), beta.data_ptr(), out.data_ptr(),
              n, hp, wp, cin, cout, kh, kw, int(stored_zp), int(relu), out_int8, int(gather_k), inv, zps,
              *plan.args(sm90), route="sm90" if sm90 else "tile")
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
