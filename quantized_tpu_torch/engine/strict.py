"""Strict-parity integer engine (counterpart of
``quantized_tpu/engine/strict.py``): the exact twin of the reference's eval
semantics in integer arithmetic, with none of the production engine's
upgrades.

- activations: the frozen observer's affine uint8 grid, ``x_hat = u * s_a +
  rmin`` (the zero point ``-rmin / s_a`` left fractional);
- weights: the per-tensor affine uint8 grid of the weight's own min/max,
  ``w_hat = q_w * s_w + wmin``;
- bias: fake-quantized on its own min/max at ``num_bits_weight``;
- BN (float or RangeBN) is not folded: it stays its own f32 module.

Per output position p and channel c, over the window's taps k (``u`` the
uint8 activation, ``q`` the uint8 weight):

    sum_k x_hat_k * w_hat_kc = s_a*s_w * sum_k u_k q_kc      (int32 conv + colsum)
                             + s_a*wmin * sum_k u_k          (int32 window sums)
                             + rmin * sum_{k inside} w_hat_kc   (the border map)

Padded taps hold u = 0 (stored -128), so they add 0 to the first two sums
(the reference zero-pads the dequantized input) and drop out of the third,
whose per-position sum over the inside taps is taken from
``ops.int8_conv_pallas.outside_taps``. The integer terms are exact in int32
(255 * 255 * K < 2^31 at every reference shape); the int32 conv is
``ops.int8_conv.int8_conv_acc`` (``grouped_conv_acc`` for groups), an exact
product on the CPU and on a GPU. One f32 epilogue follows, so the output
differs from the reference's f32 fake-quant forward by f32 summation order
only. No kernel: the JAX module has no Pallas call either.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.models.layers import QConv2d, QLinear
from quantized_tpu_torch.ops.int8_conv import grouped_conv_acc, int8_conv_acc, pack_conv_weight
from quantized_tpu_torch.ops.int8_conv_pallas import outside_taps
from quantized_tpu_torch.ops.int8_matmul import exact_int_matmul, f32
from quantized_tpu_torch.quantcore.affine import SCALE_FLOOR, fake_quant_array


def strict_act_qparams(running_min: float, running_max: float, num_bits: int = 8) -> Tuple[float, float]:
    """(scale, rmin) of the reference's eval grid: the scale floored, the
    range not extended to hold 0, the zero point left fractional."""
    qmax = 2.0 ** num_bits - 1.0
    scale = max((float(running_max) - float(running_min)) / qmax, SCALE_FLOOR)
    return float(scale), float(running_min)


def quantize_strict_stored(x: torch.Tensor, scale: float, rmin: float) -> torch.Tensor:
    """f32 -> stored int8 (uint8 - 128) on the reference grid, in the
    reference's order (subtract min, divide, clip, round), so the integers
    equal the fake-quant path's. The divisor is a tensor on x's device: a
    GPU divides by a Python scalar through its reciprocal, which rounds
    differently from the division the CPU and the fake-quant path make."""
    t = (x - f32(rmin)) / torch.tensor(f32(scale), dtype=torch.float32, device=x.device)
    return (torch.round(torch.clamp(t, 0.0, 255.0)) - 128.0).to(torch.int8)


def _strict_weight_grid(w: torch.Tensor, num_bits: int) -> Tuple[torch.Tensor, float, float]:
    """The reference's per-tensor affine weight grid (``fake_quant_array``'s
    order on the global extrema): (stored int8 ``q - 128``, s_w, wmin)."""
    w = w.detach().to("cpu", torch.float32)
    wmin, wmax = w.min(), w.max()
    qmax = 2.0 ** num_bits - 1.0
    scale = torch.clamp_min((wmax - wmin) / qmax, f32(SCALE_FLOOR))
    q = torch.round(torch.clamp((w - wmin) / scale, 0.0, qmax))
    return (q - 128.0).to(torch.int8), float(scale), float(wmin)


def _window_sum(x_i32: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int]) -> torch.Tensor:
    """Sum of an (already padded) int32 NHWC tensor over each VALID conv
    window, per channel: the tap slices added in int32."""
    (kh, kw), (sh, sw) = kernel, stride
    _, hp, wp, _ = x_i32.shape
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    out = torch.zeros((x_i32.shape[0], ho, wo, x_i32.shape[3]), dtype=torch.int32, device=x_i32.device)
    for i in range(kh):
        for j in range(kw):
            out += x_i32[:, i: i + (ho - 1) * sh + 1: sh, j: j + (wo - 1) * sw + 1: sw]
    return out


def _bias_hat(layer) -> torch.Tensor:
    """The reference's bias: fake-quant on its own min/max grid."""
    return fake_quant_array(layer.bias.detach().to("cpu", torch.float32), num_bits=layer.num_bits_weight)


class StrictIntConv2d(nn.Module):
    """Integer conv on the reference's per-tensor affine grids (see the
    module docstring). Output f32; BN, ReLU and pooling run around it."""

    def __init__(self, conv: QConv2d):
        super().__init__()
        if not isinstance(conv, QConv2d):
            raise TypeError(type(conv).__name__)
        w_s, self.s_w, self.wmin = _strict_weight_grid(conv.kernel, conv.num_bits_weight)  # HWIO
        kh, kw, cg, cout = w_s.shape
        self.register_buffer("w_ck", pack_conv_weight(w_s))
        obs = conv.quantize_input
        self.act_scale, self.act_rmin = strict_act_qparams(float(obs.running_min[0]), float(obs.running_max[0]),
                                                           conv.num_bits)
        self.kernel_size = (kh, kw)
        self.stride = tuple(conv.stride)
        self.padding = tuple(conv.padding)
        self.groups = conv.groups
        self.taps = kh * kw * cg  # the taps an output channel reads (in its group)
        self.register_buffer("colsum", w_s.to(torch.int64).reshape(-1, cout).sum(0).to(torch.int32))
        # (Kh*Kw, Cout) float64: each tap's sum of the dequantized weights over its input channels
        w_hat = (w_s.to(torch.float32) + 128.0) * f32(self.s_w) + f32(self.wmin)
        self.register_buffer("tap_w_hat", w_hat.to(torch.float64).reshape(kh * kw, cg, cout).sum(1))
        self.register_buffer("bias_hat", None if conv.bias is None else _bias_hat(conv))
        self._border = {}  # (H, W, device) -> the border map

    @property
    def w_q(self) -> torch.Tensor:
        """The stored int8 weights in HWIO."""
        kh, kw = self.kernel_size
        return self.w_ck.reshape(self.w_ck.shape[0], kh, kw, -1).permute(1, 2, 3, 0)

    def _border_map(self, h: int, w: int) -> torch.Tensor:
        """``rmin * sum_{k inside} w_hat_kc`` per output position, (Ho, Wo,
        Cout) f32, formed once per input size."""
        key = (h, w, self.tap_w_hat.device)
        if key not in self._border:
            inside = ~outside_taps(h, w, self.kernel_size, self.stride, self.padding, self.tap_w_hat.device)
            b = (inside.to(torch.float64) @ self.tap_w_hat).to(torch.float32)
            self._border[key] = f32(self.act_rmin) * b
        return self._border[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run_q(quantize_strict_stored(x, self.act_scale, self.act_rmin))

    def run_q(self, a_s: torch.Tensor) -> torch.Tensor:
        """``a_s``: stored int8 on this layer's strict grid."""
        n, h, w, cin = a_s.shape
        cout, g = self.w_ck.shape[0], self.groups
        if g == 1:
            acc = int8_conv_acc(a_s, self.w_ck, self.kernel_size, self.stride, self.padding, -128)
        else:
            acc = grouped_conv_acc(a_s, self.w_ck, self.kernel_size, self.stride, self.padding, -128, g)
        ph, pw = self.padding
        a_p = torch.nn.functional.pad(a_s, (0, 0, pw, pw, ph, ph), value=-128).to(torch.int32)
        a_i = a_p.reshape(*a_p.shape[:3], g, cin // g).sum(-1, dtype=torch.int32)
        r = _window_sum(a_i, self.kernel_size, self.stride)  # (N, Ho, Wo, g)
        if g > 1:
            r = r.repeat_interleave(cout // g, dim=-1)
        k = self.taps
        sum_uq = acc + 128 * r + (128 * self.colsum + 128 * 128 * k)
        sum_u = r + 128 * k
        y = (f32(self.act_scale * self.s_w) * sum_uq.to(torch.float32)
             + f32(self.act_scale * self.wmin) * sum_u.to(torch.float32)
             + self._border_map(h, w))
        return y if self.bias_hat is None else y + self.bias_hat


class StrictIntLinear(nn.Module):
    """Integer dense layer on the reference's per-tensor affine grids."""

    def __init__(self, lin: QLinear):
        super().__init__()
        if not isinstance(lin, QLinear):
            raise TypeError(type(lin).__name__)
        w_s, self.s_w, self.wmin = _strict_weight_grid(lin.weight, lin.num_bits_weight)  # (out, in)
        self.register_buffer("w_nk", w_s.contiguous())
        obs = lin.quantize_input
        self.act_scale, self.act_rmin = strict_act_qparams(float(obs.running_min[0]), float(obs.running_max[0]),
                                                           lin.num_bits)
        self.taps = w_s.shape[1]
        self.register_buffer("colsum", w_s.to(torch.int64).sum(1).to(torch.int32))
        self.register_buffer("bias_hat", None if lin.bias is None else _bias_hat(lin))

    @property
    def w_q(self) -> torch.Tensor:
        """The stored int8 weights as (in, out)."""
        return self.w_nk.T

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a_s = quantize_strict_stored(x, self.act_scale, self.act_rmin)
        acc = exact_int_matmul(a_s, self.w_nk)
        k = self.taps
        r = a_s.to(torch.int32).sum(-1, keepdim=True, dtype=torch.int32)
        sum_uq = acc + 128 * r + (128 * self.colsum + 128 * 128 * k)
        sum_u = r + 128 * k
        # no padding: the border term is the constant rmin * sum_k w_hat_kc
        colsum_q = (self.colsum + 128 * k).to(torch.float32)
        const = f32(self.act_rmin) * (f32(self.s_w) * colsum_q + f32(k * self.wmin))
        y = (f32(self.act_scale * self.s_w) * sum_uq.to(torch.float32)
             + f32(self.act_scale * self.wmin) * sum_u.to(torch.float32)
             + const)
        return y if self.bias_hat is None else y + self.bias_hat


def convert_to_int_strict(model: nn.Module, device: DeviceLike = "cuda") -> nn.Module:
    """In place: every QConv2d and QLinear becomes its strict integer twin on
    the reference's own grids; BN and RangeBN modules stay as they are and
    run in f32, as the reference composes them. This is
    ``convert_to_int(weight_quant="per_tensor")``. Returns the model on
    ``device``, wherever it was (the twins' grids are formed on the CPU)."""
    dev = resolve_device(device)
    for module in list(model.modules()):
        for name, child in list(module.named_children()):
            if isinstance(child, QConv2d):
                setattr(module, name, StrictIntConv2d(child))
            elif isinstance(child, QLinear):
                setattr(module, name, StrictIntLinear(child))
    return model.to(dev)
