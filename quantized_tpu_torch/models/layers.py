"""Quantized layers of the port (counterparts of ``quantized_tpu/models/layers.py``).

Layouts and parameter names follow the JAX package so that its state maps
onto these modules key for key: NHWC activations, HWIO conv kernels
(``kernel``), (out, in) linear weights (``weight``), observer buffers
``quantize_input.running_min`` / ``running_max`` of shape (1,), and float BN
with ``scale`` / ``bias`` / ``mean`` / ``var`` (flax ``nnx.BatchNorm``'s
names).

The float ``Conv2d`` and ``Linear`` are the fp32 twins of ``QConv2d`` and
``QLinear`` (the float ResNet, ``models/resnet.py``): plain convs and
products, on cuDNN and cuBLAS on the GPU.

``module.train()`` is the observer-update mode: each observer quantizes
with the current batch statistic and folds it into its running range;
``module.eval()`` quantizes on the frozen range; :class:`RangeBN` folds the
batch's range statistics into its running buffers there. The gradient paths
(grad quantization, bi-precision) wait for the training slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from quantized_tpu_torch.quantcore import observers, rangebn
from quantized_tpu_torch.quantcore.ste import fake_quant

Ints = Union[int, Tuple[int, int]]


def _pair(v: Ints) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d_nhwc(x: torch.Tensor, kernel_hwio: torch.Tensor, stride: Ints = 1, padding: Ints = 0,
                dilation: Ints = 1, groups: int = 1) -> torch.Tensor:
    """Float conv, NHWC x HWIO -> NHWC with symmetric integer padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel_hwio.permute(3, 2, 0, 1), stride=_pair(stride),
                 padding=_pair(padding), dilation=_pair(dilation), groups=groups)
    return y.permute(0, 2, 3, 1)


def he_fan_out_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``variance_scaling(2.0, "fan_out", "truncated_normal")`` on an HWIO
    kernel: a normal truncated at two standard deviations, rescaled so the
    truncated distribution has variance 2 / (Kh*Kw*Cout)."""
    kh, kw, _, cout = t.shape
    # std of a unit normal truncated to [-2, 2]
    std = math.sqrt(2.0 / (kh * kw * cout)) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class Conv2d(nn.Module):
    """Float conv, NHWC/HWIO (JAX ``Conv2d``): ``kernel`` (Kh, Kw, Cin/groups,
    Cout) and an optional ``bias``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Ints, stride: Ints = 1,
                 padding: Ints = 0, dilation: Ints = 1, groups: int = 1, use_bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = (kh, kw)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.kernel = nn.Parameter(
            he_fan_out_(torch.empty(kh, kw, in_channels // groups, out_channels), generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_nhwc(x, self.kernel, self.stride, self.padding, self.dilation, self.groups)
        return y if self.bias is None else y + self.bias


class Linear(nn.Module):
    """Float dense layer (JAX ``Linear``); ``weight`` is (out, in)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        bound = 1.0 / (in_features ** 0.5)
        self.weight = nn.Parameter(_uniform((out_features, in_features), bound, generator))
        self.bias = nn.Parameter(_uniform((out_features,), bound, generator)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight.T
        return y if self.bias is None else y + self.bias


class QuantMeasure(nn.Module):
    """Running-range observer (JAX ``QuantMeasure``)."""

    def __init__(self, num_bits: int = 8, momentum: float = observers.DEFAULT_MOMENTUM):
        super().__init__()
        self.num_bits = num_bits
        self.momentum = momentum
        self.register_buffer("running_min", torch.zeros(1))
        self.register_buffer("running_max", torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        state = observers.QuantMeasureState(self.running_min, self.running_max)
        y, new = observers.quant_measure(x, state, training=self.training, num_bits=self.num_bits,
                                         momentum=self.momentum)
        if self.training:
            self.running_min.copy_(new.running_min)
            self.running_max.copy_(new.running_max)
        return y

    @property
    def range(self) -> Tuple[float, float]:
        return float(self.running_min[0]), float(self.running_max[0])


class BatchNorm(nn.Module):
    """Float BN over the last axis with flax ``nnx.BatchNorm`` semantics and
    names: ``momentum`` weighs the running value (0.9 keeps 90 %), the
    variance is the biased batch variance."""

    def __init__(self, num_features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.ndim - 1))
            mean = x.mean(dims)
            var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        # flax's association: (x - mean) * (rsqrt(var + eps) * scale) + bias
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias


def _quant_weight(w: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Per-tensor weight fake-quant on the range recomputed every forward."""
    return fake_quant(w, num_bits=num_bits, min_value=w.min(), max_value=w.max())


class QConv2d(nn.Module):
    """Fake-quant conv (JAX ``QConv2d``), forward only."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Ints, stride: Ints = 1,
                 padding: Ints = 0, dilation: Ints = 1, groups: int = 1, use_bias: bool = True,
                 num_bits: int = 8, num_bits_weight: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = (kh, kw)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.num_bits = num_bits
        self.num_bits_weight = num_bits_weight or num_bits
        self.kernel = nn.Parameter(
            he_fan_out_(torch.empty(kh, kw, in_channels // groups, out_channels), generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None
        self.quantize_input = QuantMeasure(num_bits)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qinput = self.quantize_input(x)
        qweight = _quant_weight(self.kernel, self.num_bits_weight)
        y = conv2d_nhwc(qinput, qweight, self.stride, self.padding, self.dilation, self.groups)
        if self.bias is not None:
            y = y + fake_quant(self.bias, num_bits=self.num_bits_weight)
        return y


class QLinear(nn.Module):
    """Fake-quant dense layer (JAX ``QLinear``), forward only; ``weight`` is
    (out, in)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 num_bits: int = 8, num_bits_weight: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.num_bits = num_bits
        self.num_bits_weight = num_bits_weight or num_bits
        bound = 1.0 / (in_features ** 0.5)
        self.weight = nn.Parameter(_uniform((out_features, in_features), bound, generator))
        self.bias = nn.Parameter(_uniform((out_features,), bound, generator)) if use_bias else None
        self.quantize_input = QuantMeasure(num_bits)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qinput = self.quantize_input(x)
        y = qinput @ _quant_weight(self.weight, self.num_bits_weight).T
        if self.bias is not None:
            y = y + fake_quant(self.bias, num_bits=self.num_bits_weight)
        return y


class RangeBN(nn.Module):
    """Range batch-norm over the last axis (JAX ``RangeBN``), forward only.

    Names as in the JAX model's state: ``running_mean``, ``running_var``
    (which holds the range-derived *scale*, not a variance), ``weight``
    (gamma, drawn from U[0, 1) with ``generator``), ``bias`` (beta, zeros)
    and the input observer ``quantize_input``. The input is quantized on the
    observer first; in train mode the batch's statistic normalizes it and
    folds into the running buffers (the inverted EMA, the new value weighted
    ``1 - momentum``), in eval mode the running buffers normalize it. 2-D
    inputs are treated as (B, 1, 1, C)."""

    def __init__(self, num_features: int, momentum: float = 0.1, affine: bool = True,
                 num_chunks: int = rangebn.RANGE_BN_NUM_CHUNKS, eps: float = 1e-5, num_bits: int = 8, *,
                 generator: torch.Generator):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.num_chunks = num_chunks
        self.eps = eps
        self.num_bits = num_bits
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.zeros(num_features))
        if affine:
            self.weight = nn.Parameter(torch.rand(num_features, generator=generator))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None
        self.quantize_input = QuantMeasure(num_bits)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.quantize_input(x)
        squeeze_2d = x.ndim == 2
        if squeeze_2d:
            x = x[:, None, None, :]
        if self.training:
            mean, scale = rangebn.range_bn_stats(x, self.num_chunks)
            with torch.no_grad():
                self.running_mean.copy_(observers.ema_update(self.running_mean, mean.detach(), self.momentum))
                self.running_var.copy_(observers.ema_update(self.running_var, scale.detach(), self.momentum))
        else:
            mean, scale = self.running_mean, self.running_var
        out = rangebn.range_bn_apply(x, mean, scale, self.weight, self.bias, eps=self.eps, num_bits=self.num_bits)
        return out[:, 0, 0, :] if squeeze_2d else out
