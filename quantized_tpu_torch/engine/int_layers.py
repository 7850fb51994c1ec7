"""Integer-executing layers (counterparts of ``quantized_tpu/engine/int_layers.py``).

Each layer owns its input grid (from the source model's frozen observer),
per-channel int8 weights with BN folded in, and the fused epilogue
(alpha, beta). Activations are stored int8 (logical uint8 - 128).

The weights are kept in the layout the kernels take, packed once when the
layer is built: a conv holds (Cout, Kh*Kw*Cin) and a dense layer (N, K).
:meth:`IntConv2d.weights` and :attr:`IntLinear.w_q` give them back in the
JAX package's layouts (HWIO and (K, N)).

Int4 weights (``int4_shape`` / ``int4=True``) keep their packed bytes, half
the int8 size (``ops/int4.py``): a conv holds (Cout, Kh*Kw, Cin/2)
channel-split bytes and unpacks them on every call into the (Cout,
Kh*Kw*Cin) int8 operand, as the JAX package's ``weights()`` does (no int8
copy is kept); a dense layer holds (N, K/2) split-half bytes and runs them
on kernel B6.

Backends of :class:`IntConv2d`: ``"pallas"`` runs the direct conv (kernel
K2, ``ops/int8_conv_pallas.py``), ``"gemm"`` runs im2col + the int8 GEMM
(kernel K1). A grouped (depthwise) conv takes the exact grouped path of
``int8_conv_xla`` on every backend, as in the JAX package, which routes
only ``groups == 1`` to Pallas or gemm. :class:`IntLinear` runs K1, or B6
on int4 weights. The XLA, bf16 and native-S4 forms of the JAX package,
``y_clip`` and the int16 residual leg of the unfused blocks
(``prescale_s16``) are not ported yet; the fused downsample block
(``engine/fused.py``) carries that leg in its kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from quantized_tpu_torch.ops.int4 import int4_matmul_nk, unpack_int4_conv_channels
from quantized_tpu_torch.ops.int8_conv import int8_conv_gemm_ck, int8_conv_xla_ck, pack_conv_weight
from quantized_tpu_torch.ops.int8_conv_pallas import (
    conv_border_sums,
    int8_conv_direct_ck,
    pixel_group,
    pixel_group_operands,
    use_gather_k,
)
from quantized_tpu_torch.ops.int8_matmul import f32, int8_matmul_nk

Grid = Tuple[float, int]
CONV_BACKENDS = ("pallas", "gemm")
# Fine grain of the int16 shortcut leg: one count is 1/S16_FINE of the
# consumer's output step. Only the fused downsample block carries the leg so
# far; the unfused "pallas" downsample leg stays f32, as in the JAX package.
S16_FINE = 32.0


def quantize_input_stored(x: torch.Tensor, scale: float, zero_point: int) -> torch.Tensor:
    """f32 -> stored int8 (logical uint8 - 128) on the layer's activation
    grid: ``clip(round(x * f32(1/s) + f32(zp - 128)), -128, 127)``."""
    q = torch.round(x * f32(1.0 / scale) + f32(zero_point - 128))
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def dequantize_stored(x_q: torch.Tensor, scale: float, zero_point: int) -> torch.Tensor:
    """Stored int8 -> f32: ``(u - zp) * scale`` with ``u = stored + 128``."""
    return (x_q.to(torch.float32) + f32(128 - zero_point)) * f32(scale)


def requantize_stored(x_q: torch.Tensor, from_grid: Grid, to_grid: Grid) -> torch.Tensor:
    """Regrid a stored-int8 tensor onto another uint8 grid."""
    return quantize_input_stored(dequantize_stored(x_q, *from_grid), *to_grid)


class IntConv2d(nn.Module):
    """Integer conv with folded BN and the fused epilogue."""

    def __init__(
        self,
        w_q: torch.Tensor,  # (Kh, Kw, Cin/groups, Cout) int8, or (Kh, Kw, Cin/2, Cout) packed int4
        alpha: torch.Tensor,  # (Cout,) f32
        beta: torch.Tensor,  # (Cout,) f32
        act_scale: float,
        act_zero_point: int,
        stride=(1, 1),
        padding=(0, 0),
        groups: int = 1,
        relu: bool = False,
        backend: str = "pallas",
        int4_shape: Optional[Tuple[int, int, int, int]] = None,
    ):
        super().__init__()
        if groups != 1 and (int4_shape is not None or tuple(w_q.shape[2:]) != (1, groups)):
            raise ValueError(f"only depthwise grouped convs are ported (one input and one output channel "
                             f"per group, int8 weights), got groups={groups} over a {tuple(w_q.shape)} kernel")
        if backend not in CONV_BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {CONV_BACKENDS}")
        self.kernel_size = tuple(w_q.shape[:2])
        # int4 weight-only: the channel-split packed bytes, (Cout, Kh*Kw, Cin/2)
        self.int4_shape = None if int4_shape is None else tuple(int(d) for d in int4_shape)
        if self.int4_shape is None:
            self.register_buffer("w_ck", pack_conv_weight(w_q))
        else:
            kh, kw, cin, cout = self.int4_shape
            if tuple(w_q.shape) != (kh, kw, cin // 2, cout) or cin % 2:
                raise ValueError(f"packed int4 kernel {tuple(w_q.shape)} does not hold shape {self.int4_shape}")
            self.register_buffer("w_int4", w_q.permute(3, 0, 1, 2).reshape(cout, kh * kw, cin // 2).contiguous())
        self.register_buffer("alpha", alpha.to(torch.float32).contiguous())
        self.register_buffer("beta", beta.to(torch.float32).contiguous())
        self.act_scale = float(act_scale)
        self.act_zero_point = int(act_zero_point)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.groups = groups
        self.relu = relu
        self.backend = backend
        # K2's Hopper route reads padded taps as zeros and adds back stored_zp
        # times the weights' tap sums (ops.conv_border_sums), computed here once
        kh, kw = self.kernel_size
        cin = w_q.shape[2] if self.int4_shape is None else self.int4_shape[2]
        uses_sums = (groups == 1 and backend == "pallas" and any(self.padding) and cin % 16 == 0
                     and not use_gather_k(cin, (kh, kw)))
        self.register_buffer("border_sums", conv_border_sums(self.weights_ck(), (kh, kw)) if uses_sums else None,
                             persistent=False)
        # and runs a 1x1 over Cin % 16 != 0 on pixel groups: diag(W, ..., W)
        # and the tiled alpha, beta (ops.pixel_group_operands), built here once
        g = pixel_group(cin, (kh, kw), self.stride, self.padding)
        groups_op = (groups == 1 and backend == "pallas" and g > 1 and self.int4_shape is None)
        operands = pixel_group_operands(self.w_ck, self.alpha, self.beta, g) if groups_op else (None,) * 3
        for name, t in zip(("pg_w_ck", "pg_alpha", "pg_beta"), operands):
            self.register_buffer(name, t, persistent=False)

    def weights_ck(self) -> torch.Tensor:
        """The int8 kernel as the kernels take it, (Cout, Kh*Kw*Cin/groups);
        int4 weights are unpacked on each call."""
        if self.int4_shape is None:
            return self.w_ck
        return unpack_int4_conv_channels(self.w_int4, dim=-1).reshape(self.w_int4.shape[0], -1)

    def weights(self) -> torch.Tensor:
        """The int8 kernel in HWIO: (Kh, Kw, Cin/groups, Cout)."""
        kh, kw = self.kernel_size
        w_ck = self.weights_ck()
        return w_ck.reshape(w_ck.shape[0], kh, kw, -1).permute(1, 2, 3, 0)

    @property
    def stored_zp(self) -> int:
        return self.act_zero_point - 128

    @property
    def grid(self) -> Grid:
        """(scale, zero_point) of the uint8 grid this conv expects its input on."""
        return (self.act_scale, self.act_zero_point)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_q = quantize_input_stored(x, self.act_scale, self.act_zero_point)
        return self.run_q(x_q, relu=self.relu)

    def run_q(
        self,
        x_q: torch.Tensor,
        relu: Optional[bool] = None,
        out_requant: Optional[Grid] = None,
        out_prescale: Optional[Tuple[float, float]] = None,
    ) -> torch.Tensor:
        """Quantized-input entry: ``x_q`` stored int8 on ``self.grid``.
        Returns f32, or int8 on ``out_requant``'s grid with ReLU applied
        before the requant.

        ``out_prescale=(scale, shift)`` returns f32 ``y / scale + shift`` (no
        ReLU, no requant), the division folded into alpha/beta as the JAX
        package folds it."""
        relu = self.relu if relu is None else relu
        alpha, beta = self.alpha, self.beta
        if out_prescale is not None:
            if out_requant is not None or relu:
                raise ValueError("out_prescale excludes out_requant and relu")
            scale, shift = out_prescale
            inv = f32(1.0 / scale)
            alpha = alpha * inv
            beta = beta * inv + f32(shift)
        if self.groups != 1:
            return int8_conv_xla_ck(x_q, self.w_ck, self.kernel_size, alpha, beta, self.stride,
                                    self.padding, self.stored_zp, relu, out_requant, self.groups)
        if self.backend == "pallas":
            pixel_groups = None  # with out_prescale, the call tiles its own alpha and beta
            if self.pg_w_ck is not None and out_prescale is None:
                pixel_groups = (self.pg_w_ck, self.pg_alpha, self.pg_beta)
            return int8_conv_direct_ck(x_q, self.weights_ck(), self.kernel_size, alpha, beta, stride=self.stride,
                                       padding=self.padding, stored_zp=self.stored_zp, relu=relu,
                                       out_requant=out_requant, border_sums=self.border_sums,
                                       pixel_groups=pixel_groups)
        return int8_conv_gemm_ck(x_q, self.weights_ck(), self.kernel_size, alpha, beta, stride=self.stride,
                                 padding=self.padding, stored_zp=self.stored_zp, relu=relu,
                                 out_requant=out_requant)


class IntLinear(nn.Module):
    """Integer dense layer; weights (K, N) = (in, out) int8 on kernel K1, or
    (K/2, N) split-half packed int4 on kernel B6 when ``int4=True``; held
    K-major as (N, K) or (N, K/2)."""

    def __init__(
        self,
        w_q_kn: torch.Tensor,
        alpha: torch.Tensor,
        beta: torch.Tensor,
        act_scale: float,
        act_zero_point: int,
        relu: bool = False,
        int4: bool = False,
    ):
        super().__init__()
        self.register_buffer("w_nk", w_q_kn.T.contiguous())
        self.register_buffer("alpha", alpha.to(torch.float32).contiguous())
        self.register_buffer("beta", beta.to(torch.float32).contiguous())
        self.act_scale = float(act_scale)
        self.act_zero_point = int(act_zero_point)
        self.relu = relu
        self.int4 = int4

    @property
    def w_q(self) -> torch.Tensor:
        """The weights in the JAX layout: (K, N) int8, or (K/2, N) packed int4."""
        return self.w_nk.T

    @property
    def grid(self) -> Grid:
        return (self.act_scale, self.act_zero_point)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run_q(quantize_input_stored(x, self.act_scale, self.act_zero_point))

    def run_q(self, x_q: torch.Tensor, relu: Optional[bool] = None,
              out_requant: Optional[Grid] = None) -> torch.Tensor:
        """Quantized-input entry: f32 out, or int8 on ``out_requant``'s grid
        (a separate quantize pass, as in the JAX package, on int4 weights too)."""
        relu = self.relu if relu is None else relu
        matmul = int4_matmul_nk if self.int4 else int8_matmul_nk
        y = matmul(x_q, self.w_nk, self.alpha, self.beta, relu=relu)
        if out_requant is not None:
            return quantize_input_stored(y, *out_requant)
        return y
