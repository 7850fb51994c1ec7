"""The int8 arithmetic of the served engines, written out plainly.

Activations are logical uint8 ``u`` on a per-tensor grid ``(scale, zp)``
taken from an observed range, stored as int8 ``u - 128``. Weights are the
conv's float weights with the following BatchNorm folded in, quantized
symmetrically per output channel to ``bits`` bits. A conv accumulates
exactly in integers over the input padded with the stored zero point, and
its epilogue is the per-channel affine ``acc * alpha + beta`` in float32,
then ReLU, then rounded onto the next grid or left in float32 (the form of
the program's default conv kernel). A grouped (depthwise) conv rounds in
the form of the program's grouped path: ``1/s`` folded into alpha and beta
and ReLU as the clip floor. Other kernels of the program round the same
values in yet another order, and may land one step away.

The BN fold and the weights' quantization run in float32 numpy, whose
square root is correctly rounded; every scalar is formed in float32 at the
same points as the engine forms it, so the same inputs give the same
integers. Only ``torch`` and ``numpy``: no kernel, no module of the
program under test.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Grid = Tuple[float, int]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def f32(v: float) -> float:
    """The float32 value of a Python scalar."""
    return float(np.float32(v))


def grid_from_range(lo: float, hi: float, bits: int = 8) -> Grid:
    """Asymmetric uint8 grid of an observed range, widened to hold 0 so that
    padding quantizes exactly: ``scale = (max - min) / 255`` in float64, the
    zero point rounded half to even and held to [0, 255]."""
    rmin, rmax = min(float(lo), 0.0), max(float(hi), 0.0)
    qmax = 2.0 ** bits - 1.0
    scale = max((rmax - rmin) / qmax, 1e-8)
    zp = int(min(max(round(-rmin / scale), 0.0), qmax))
    return float(scale), zp


def fold_bn(w_hwio: np.ndarray, gamma, beta, mean, var, eps: float) -> Tuple[np.ndarray, np.ndarray]:
    """Float BN folded into a bias-free HWIO conv, in float32 numpy (whose
    square root is correctly rounded): ``f = gamma / sqrt(var + eps)``,
    ``W' = W * f``, ``b' = beta + (0 - mean) * f``."""
    factor = gamma / np.sqrt(var + np.float32(eps))
    return w_hwio * factor[None, None, None, :], beta + (np.zeros_like(mean) - mean) * factor


def quantize_weights(w: np.ndarray, bits: int, out_axis_last: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel quantization in float32 numpy:
    ``s = max(max|W_c| / q, 1e-12)`` with ``q = 2**(bits-1) - 1``,
    ``W_q = clip(round(W / s), -q, q)``. Returns (W_q as float32 integers, s)."""
    q = np.float32(2.0 ** (bits - 1) - 1.0)
    if out_axis_last:
        absmax = np.max(np.abs(w.reshape(-1, w.shape[-1])), axis=0)
        s = np.maximum(absmax / q, np.float32(1e-12))
        return np.clip(np.round(w / s), -q, q), s
    absmax = np.max(np.abs(w), axis=1)
    s = np.maximum(absmax / q, np.float32(1e-12))
    return np.clip(np.round(w / s[:, None]), -q, q), s


def epilogue_params(grid: Grid, s_w: np.ndarray, colsum: np.ndarray,
                    bias: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """``alpha = s_a * s_w``; ``beta = alpha * (128 - zp) * colsum + bias``."""
    scale, zp = grid
    alpha = torch.tensor(f32(scale), dtype=torch.float32) * torch.from_numpy(s_w)
    beta = alpha * torch.tensor(f32(128 - zp), dtype=torch.float32) * torch.from_numpy(colsum)
    return alpha, beta + torch.from_numpy(bias)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


class QConv:
    """One conv with its BN folded: integer weights (float64, OIHW for
    ``F.conv2d``), the epilogue and the grid its input arrives on."""

    def __init__(self, w_hwio: torch.Tensor, bn: Optional[tuple], eps: float, grid: Grid, bits: int,
                 stride: int, padding: int, groups: int, device):
        w = _np(w_hwio)
        if bn is None:
            bias = np.zeros(w.shape[-1], np.float32)
        else:
            w, bias = fold_bn(w, *(_np(t) for t in bn), eps)
        w_q, s_w = quantize_weights(w, bits)
        colsum = w_q.reshape(-1, w_q.shape[-1]).sum(axis=0, dtype=np.float64).astype(np.float32)
        self.alpha, self.beta = (t.to(device) for t in epilogue_params(grid, s_w, colsum, bias))
        self.weight = torch.from_numpy(w_q).permute(3, 2, 0, 1).to(device, torch.float64).contiguous()
        self.grid, self.stride, self.padding, self.groups = grid, stride, padding, groups

    def acc(self, x_s: torch.Tensor) -> torch.Tensor:
        """Exact accumulator of NHWC stored int8 ``x_s``, as float32 (NHWC).
        The conv runs in float64, where every partial sum of these integers
        is exact; the rounding only guards against a conv algorithm that
        works through transforms."""
        zp_stored = float(self.grid[1] - 128)
        x = x_s.permute(0, 3, 1, 2).to(torch.float64)
        if self.padding:
            p = self.padding
            x = F.pad(x, (p, p, p, p), value=zp_stored)
        acc = F.conv2d(x, self.weight, stride=self.stride, groups=self.groups)
        return torch.round(acc).to(torch.float32).permute(0, 2, 3, 1)

    def requant(self, x_s: torch.Tensor, out: Grid, relu: bool) -> torch.Tensor:
        """Stored int8 on ``out``: ``y = relu?(acc * alpha + beta)``, then
        ``clip(round(y * f32(1/s) + f32(zp - 128)), -128, 127)``; a grouped
        conv ``clip(round(acc * (alpha * inv) + (beta * inv + zps)), lo, 127)``
        with ``inv = f32(1/s)``, ``zps = f32(zp - 128)`` and ``lo = zps`` under ReLU."""
        inv, zps = f32(1.0 / out[0]), f32(out[1] - 128)
        if self.groups > 1:
            q = torch.round(self.acc(x_s) * (self.alpha * inv) + (self.beta * inv + zps))
            return torch.clamp(q, zps if relu else -128.0, 127.0).to(torch.int8)
        q = torch.round(self.real(x_s, relu) * inv + zps)
        return torch.clamp(q, -128.0, 127.0).to(torch.int8)

    def prescaled(self, x_s: torch.Tensor, out_scale: float, shift: float) -> torch.Tensor:
        """Float32 ``y / out_scale + shift``, the division folded into the epilogue."""
        inv = f32(1.0 / out_scale)
        return self.acc(x_s) * (self.alpha * inv) + (self.beta * inv + f32(shift))

    def real(self, x_s: torch.Tensor, relu: bool) -> torch.Tensor:
        y = self.acc(x_s) * self.alpha + self.beta
        return torch.clamp_min(y, 0.0) if relu else y


class QLinear:
    """The fc head: input quantized on its grid, integer weights per output
    row, float32 logits."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, grid: Grid, bits: int, device):
        w_q, s_w = quantize_weights(_np(weight), bits, out_axis_last=False)
        colsum = w_q.sum(axis=1, dtype=np.float64).astype(np.float32)
        self.alpha, self.beta = (t.to(device) for t in epilogue_params(grid, s_w, colsum, _np(bias)))
        self.weight = torch.from_numpy(w_q).to(device, torch.float64)  # (out, in)
        self.grid = grid

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x_s = quantize(x, self.grid)
        acc = torch.round(x_s.to(torch.float64) @ self.weight.T).to(torch.float32)
        return acc * self.alpha + self.beta


def quantize(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Float32 -> stored int8: ``clip(round(x * f32(1/s) + f32(zp - 128)), -128, 127)``."""
    q = torch.round(x * f32(1.0 / grid[0]) + f32(grid[1] - 128))
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def dequantize(x_s: torch.Tensor, grid: Grid) -> torch.Tensor:
    return (x_s.to(torch.float32) + f32(128 - grid[1])) * f32(grid[0])


def ingest_u8(u8: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Raw uint8 NHWC images -> stored int8 on the first conv's grid, the
    ImageNet normalisation folded into one per-channel affine."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=u8.device)
    scale, zp = grid
    a = 1.0 / (255.0 * std * f32(scale))
    b = f32(zp - 128) - mean / (std * f32(scale))
    q = torch.round(u8.to(torch.float32) * a + b)
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def normalize_u8(u8: torch.Tensor) -> torch.Tensor:
    """Raw uint8 NHWC images -> float32 ImageNet-normalised images."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=u8.device)
    return (u8.to(torch.float32) / 255.0 - mean) / std


def maxpool_3x3_s2(x_s: torch.Tensor) -> torch.Tensor:
    """3x3/s2/p1 max pool of stored int8 NHWC, padded with -128 (max
    commutes with the monotone map from stored to real values)."""
    x = F.pad(x_s.to(torch.float32).permute(0, 3, 1, 2), (1, 1, 1, 1), value=-128.0)
    return F.max_pool2d(x, 3, 2).permute(0, 2, 3, 1).to(torch.int8)
