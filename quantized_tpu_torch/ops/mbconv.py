"""The MBConv kernels of the EfficientNet engine (``csrc/mbconv.cu``), port
only (the JAX package has no EfficientNet): the depthwise conv with its
activation, requant and the squeeze's exact sums (:func:`dw_conv`), the
squeeze's mean onto the SE reduce conv's grid (:func:`se_squeeze`) and the
gate pass (:func:`se_gate`).

Activations are stored int8 (logical uint8 - 128) on per-tensor grids
``(scale, zero_point)``. The depthwise conv over NHWC int8 with C % 16 ==
0 takes a (k, k, C) int8 kernel (k 3 or 5) at stride 1 or 2, padded ``k //
2`` with the stored zero point:

- ``y = act(acc * alpha + beta)`` (``act``: a code of
  ``ops.int8_matmul.activate``), ``q = clip(round(y * f32(1/s) + f32(zp -
  128)), -128, 127)`` onto the output grid, as K2's requant;
- ``sums[n, c]``: the int32 sum of ``q`` over the image.

The squeeze is ``mean = f32(sums + HW * (128 - zp)) * f32(s) / f32(HW)``,
the mean of the depthwise output on its grid, quantized onto the reduce
conv's grid. The gate pass is ``quantize(((x + f32(128 - zp)) * f32(s)) *
g, out_grid)``: the depthwise output scaled by the SE's gate ``g`` (N, C)
onto the project conv's grid.

A wrapper given CPU tensors runs the plain PyTorch version (``*_plain``),
which computes every float32 operation in the kernels' order; given CUDA
tensors it launches the kernel or raises. Each kernel counts its launches
under the route ``"sm90"`` (``route_counts()``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.int8_conv import pad_stored_zp
from quantized_tpu_torch.ops.int8_matmul import H100_SMS, activate, f32

Grid = Tuple[float, int]

DW_CONV = _cuda.CudaKernel("dw_conv", "mbconv.cu", "qt_dw_conv",
                           ["ptr"] * 6 + ["int"] * 11 + ["float"] * 2 + ["int"] * 4)
SE_SQUEEZE = _cuda.CudaKernel("se_squeeze", "mbconv.cu", "qt_se_squeeze",
                              ["ptr"] * 2 + ["int"] * 2 + ["float"] * 4)
SE_GATE = _cuda.CudaKernel("se_gate", "mbconv.cu", "qt_se_gate", ["ptr"] * 3 + ["int"] * 3 + ["float"] * 4)

VEC = 16  # the kernels take C % 16 == 0 (the gate pass carries 16 channels a thread)
CPT = 4  # channels a thread of the depthwise kernel carries (one 4-byte word)
DW_THREADS = 256
DW_MAX_WORDS = 128  # channel words a block, at most: wider convs split into even chunks
DW_BLOCKS_PER_SM = 8  # the bands aim for this many blocks an SM
DW_KERNELS = (3, 5)
DW_STRIDES = (1, 2)


class DwPlan(NamedTuple):
    bx: int  # channel words a block
    by: int  # lanes of output pixel pairs a block
    bands: int  # blocks along an image's pairs of output pixels
    chunks: int  # blocks along the channel words

    def args(self):
        return [self.bx, self.by, self.bands, self.chunks]


@functools.lru_cache(maxsize=1024)
def dw_plan(n: int, ho: int, wo: int, c: int, sms: int = H100_SMS) -> DwPlan:
    """The depthwise kernel's launch: the C / 4 channel words in even chunks
    of at most :data:`DW_MAX_WORDS`, as many lanes as make up to 256
    threads, and each image's pairs of output pixels (two neighbours of a
    row, the last of an odd row alone) cut into bands so that the grid
    holds about :data:`DW_BLOCKS_PER_SM` blocks an SM, with at least one
    pair a lane."""
    words = c // CPT
    chunks = -(-words // DW_MAX_WORDS)
    bx = -(-words // chunks)
    by = max(1, DW_THREADS // bx)
    pairs = ho * -(-wo // 2)
    want = -(-DW_BLOCKS_PER_SM * sms // (n * chunks))
    bands = max(1, min(-(-pairs // by), want))
    return DwPlan(bx, by, bands, chunks)


def dw_tap_groups(k: int):
    """The taps (dy, dx) that the depthwise kernel multiplies four at a time,
    None for a zero weight: for k 3 one group a row (its three taps and a
    zero); for k 5 one a row of its first four taps, then column 4 of rows
    0-3, then tap (4, 4) with three zeros. A thread reads an input row once
    for two output pixels (``csrc/mbconv.cu``), so no group spans rows but
    the column-4 one, which keeps four words from the rows before."""
    if k == 3:
        return [[(r, 0), (r, 1), (r, 2), None] for r in range(3)]
    return [[(r, x) for x in range(4)] for r in range(5)] + [[(r, 4) for r in range(4)], [(4, 4), None, None, None]]


def dw_weight_words(w: torch.Tensor) -> torch.Tensor:
    """A (k, k, C) int8 depthwise kernel as the kernel reads it: (groups, C)
    int32 words, word [j, c] holding the four taps of group j of
    :func:`dw_tap_groups` for channel c in its bytes 0..3 (0 for None)."""
    k, c = w.shape[0], w.shape[2]
    groups = dw_tap_groups(k)
    taps = torch.zeros((len(groups), 4, c), dtype=torch.int8, device=w.device)
    for j, group in enumerate(groups):
        for i, tap in enumerate(group):
            if tap is not None:
                taps[j, i] = w[tap]
    return taps.permute(0, 2, 1).contiguous().view(torch.int32).reshape(len(groups), c)


def _requant(y: torch.Tensor, out_grid: Grid) -> torch.Tensor:
    q = torch.round(y * f32(1.0 / out_grid[0]) + f32(out_grid[1] - 128))
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def dw_conv_plain(x_q: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, stride: int,
                  stored_zp: int, act: int, out_grid: Grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depthwise conv in plain PyTorch: the exact int32 accumulator of
    the zero-point-padded input (a sum over the taps of shifted slices
    times the tap's weights), the epilogue in the kernel's order, and the
    int32 sums of the output over each image. Returns (q, sums)."""
    k = w.shape[0]
    xp = pad_stored_zp(x_q, k // 2, stored_zp).to(torch.int32)
    ho, wo = (xp.shape[1] - k) // stride + 1, (xp.shape[2] - k) // stride + 1
    acc = torch.zeros((x_q.shape[0], ho, wo, x_q.shape[3]), dtype=torch.int32, device=x_q.device)
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, dy:dy + (ho - 1) * stride + 1:stride, dx:dx + (wo - 1) * stride + 1:stride]
            acc += tap * w[dy, dx].to(torch.int32)
    q = _requant(activate(acc.to(torch.float32) * alpha + beta, act), out_grid)
    return q, q.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32)


def _check_dw(x_q, w, alpha, beta, stride):
    k, c = w.shape[0], w.shape[2]
    if w.shape != (k, k, c) or k not in DW_KERNELS or stride not in DW_STRIDES:
        raise ValueError(f"depthwise kernel {tuple(w.shape)} at stride {stride}: (k, k, C) with k in "
                         f"{DW_KERNELS} and stride in {DW_STRIDES} expected")
    if x_q.ndim != 4 or x_q.shape[3] != c or c % VEC:
        raise ValueError(f"input {tuple(x_q.shape)}: NHWC over the kernel's {c} channels, a multiple of {VEC}")
    if alpha.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"alpha/beta must have shape ({c},)")
    _cuda.check_dtype(x_q, torch.int8, "x_q")
    _cuda.check_dtype(w, torch.int8, "w")
    _cuda.check_dtype(alpha, torch.float32, "alpha")
    _cuda.check_dtype(beta, torch.float32, "beta")


def dw_conv(x_q: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, stride: int,
            stored_zp: int, act: int, out_grid: Grid, *,
            words: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depthwise conv (see the module docstring): NHWC int8 ``x_q`` on
    the grid of stored zero point ``stored_zp``, ``w`` (k, k, C) int8;
    returns the int8 output on ``out_grid`` and its (N, C) int32 sums.
    ``words``: :func:`dw_weight_words` of ``w``, built once by the caller
    (else on each call)."""
    _check_dw(x_q, w, alpha, beta, stride)
    if x_q.device.type == "cpu":
        return dw_conv_plain(x_q, w, alpha, beta, stride, stored_zp, act, out_grid)
    if words is None:
        words = dw_weight_words(w)
    dev = _cuda.require_cuda_tensors(x_q, words, alpha, beta)
    n, h, wd, c = x_q.shape
    k = w.shape[0]
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, (wd + 2 * (k // 2) - k) // stride + 1
    out = torch.empty((n, ho, wo, c), dtype=torch.int8, device=dev)
    s = torch.empty((n, c), dtype=torch.int32, device=dev)
    plan = dw_plan(n, ho, wo, c, _cuda.sm_count(dev))
    DW_CONV(dev, x_q.data_ptr(), words.data_ptr(), alpha.data_ptr(), beta.data_ptr(), out.data_ptr(),
            s.data_ptr(), n, h, wd, c, k, stride, k // 2, ho, wo, int(stored_zp), int(act),
            f32(1.0 / out_grid[0]), f32(out_grid[1] - 128), *plan.args(), route="sm90")
    return out, s


def se_squeeze_plain(sums: torch.Tensor, hw: int, in_grid: Grid, out_grid: Grid) -> torch.Tensor:
    """The squeeze in plain PyTorch: the image means of a tensor on
    ``in_grid`` from its int32 sums over ``hw`` pixels, onto ``out_grid``."""
    total = sums + hw * (128 - int(in_grid[1]))
    mean = total.to(torch.float32) * f32(in_grid[0])
    return _requant(mean / torch.full_like(mean, float(hw)), out_grid)  # a true division on every device


def se_squeeze(sums: torch.Tensor, hw: int, in_grid: Grid, out_grid: Grid) -> torch.Tensor:
    """(N, C) int32 sums of stored int8 over ``hw`` pixels on ``in_grid`` ->
    (N, C) int8 means on ``out_grid``."""
    _cuda.check_dtype(sums, torch.int32, "sums")
    if sums.device.type == "cpu":
        return se_squeeze_plain(sums, hw, in_grid, out_grid)
    dev = _cuda.require_cuda_tensors(sums)
    out = torch.empty(sums.shape, dtype=torch.int8, device=dev)
    SE_SQUEEZE(dev, sums.data_ptr(), out.data_ptr(), sums.numel(), hw * (128 - int(in_grid[1])), f32(in_grid[0]),
               float(hw), f32(1.0 / out_grid[0]), f32(out_grid[1] - 128), route="sm90")
    return out


def se_gate_plain(x_q: torch.Tensor, g: torch.Tensor, in_grid: Grid, out_grid: Grid) -> torch.Tensor:
    """The gate pass in plain PyTorch: NHWC ``x_q`` on ``in_grid``, dequantized,
    times the (N, C) gate, onto ``out_grid``."""
    x = (x_q.to(torch.float32) + f32(128 - in_grid[1])) * f32(in_grid[0])
    return _requant(x * g[:, None, None, :], out_grid)


def se_gate(x_q: torch.Tensor, g: torch.Tensor, in_grid: Grid, out_grid: Grid) -> torch.Tensor:
    """NHWC int8 ``x_q`` on ``in_grid`` scaled by the f32 gate ``g`` (N, C)
    onto ``out_grid`` (C % 16 == 0)."""
    n, h, w, c = x_q.shape
    if g.shape != (n, c) or c % VEC:
        raise ValueError(f"gate {tuple(g.shape)} for input {tuple(x_q.shape)}: (N, C) over C % {VEC} == 0")
    _cuda.check_dtype(x_q, torch.int8, "x_q")
    _cuda.check_dtype(g, torch.float32, "g")
    if x_q.device.type == "cpu":
        return se_gate_plain(x_q, g, in_grid, out_grid)
    dev = _cuda.require_cuda_tensors(x_q, g)
    out = torch.empty_like(x_q)
    SE_GATE(dev, x_q.data_ptr(), g.data_ptr(), out.data_ptr(), n, h * w, c, f32(128 - in_grid[1]), f32(in_grid[0]),
            f32(1.0 / out_grid[0]), f32(out_grid[1] - 128), route="sm90")
    return out
