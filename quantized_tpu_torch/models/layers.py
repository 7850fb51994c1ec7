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
batch's range statistics into its running buffers there.

Training (QAT): every quantizer is straight-through (``quantcore.ste``).
``QConv2d`` and ``QLinear`` take ``num_bits_grad`` (quantize the output's
cotangent) and ``biprecision`` (the two-path recombination), ``RangeBN``
quantizes its output's cotangent at ``num_bits_grad`` (8 by default), all
in train mode with autograd on; without autograd (a calibration pass under
``torch.no_grad()``) the forward is the plain one. Each such layer draws its
stochastic rounding from a :class:`RandomStream` of its own, seeded from the
init generator's state and advanced once per training forward; neither the
seed nor the count is a buffer, so the state dict keeps JAX's keys. The
conv and dense layers run their product in ``compute_dtype`` when it is set
(``training.qat.set_compute_dtype``), the result cast back to f32.
"""

from __future__ import annotations

import hashlib
import math
import struct
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from quantized_tpu_torch.quantcore import observers, rangebn
from quantized_tpu_torch.quantcore.ste import biprec, fake_quant, quantize_grad

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


def _seed_of(generator: torch.Generator, tag: str) -> int:
    """A 63-bit seed from the init generator's state, taking no draw from it
    (so a layer's parameters are those it would have without a stream). The
    state differs after every layer's parameter draws; ``tag`` separates
    layers that drew nothing."""
    digest = hashlib.blake2b(generator.get_state().numpy().tobytes() + tag.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class RandomStream:
    """The port's ``nnx.RngStream``: draw ``count`` is a fresh
    ``torch.Generator`` on the asked device, seeded from ``(seed, count)``.
    A generator belongs to one device, so each draw makes one where the
    tensor lives; ``model.to(device)`` needs nothing moved."""

    def __init__(self, seed: int):
        self.seed = seed
        self.count = 0

    def __call__(self, device) -> torch.Generator:
        digest = hashlib.blake2b(struct.pack("<QQ", self.seed, self.count), digest_size=8).digest()
        self.count += 1
        return torch.Generator(device=device).manual_seed(int.from_bytes(digest, "little") >> 1)


def _cast_op(module: nn.Module, op, *tensors: torch.Tensor) -> torch.Tensor:
    """``op(*tensors)`` in the module's ``compute_dtype`` (when set), the
    result cast back to f32; the fake-quant boundaries, observers, BN
    statistics, loss, gradients and optimizer stay f32."""
    cd = module.compute_dtype
    if cd is None:
        return op(*tensors)
    return op(*(t.to(cd) for t in tensors)).to(torch.float32)


def _grad_paths(layer: nn.Module, op, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """JAX's three-way branch of ``QConv2d``/``QLinear``: the plain op,
    with the output's cotangent quantized when ``num_bits_grad`` is set, or
    the bi-precision recombination; the gradient paths only while training
    with autograd on."""
    training = layer.training and torch.is_grad_enabled()
    if not layer.biprecision or layer.num_bits_grad is None:
        out = op(x, w, b)
        if layer.num_bits_grad is not None and training:
            out = quantize_grad(out, layer.grad_quant_rng(out.device), num_bits=layer.num_bits_grad)
        return out
    if training:
        return biprec(op, x, w, b, layer.grad_quant_rng(x.device), layer.num_bits_grad)
    return op(x, w, b)


class Dropout(nn.Dropout):
    """Dropout drawing its mask from a :class:`RandomStream` (nnx.Dropout's
    arithmetic: keep with probability ``1 - p``, kept values divided by it),
    never from the global RNG."""

    def __init__(self, p: float = 0.5, *, generator: torch.Generator):
        super().__init__(p)
        self.rng = RandomStream(_seed_of(generator, "dropout"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.rng(x.device), device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


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
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _cast_op(self, lambda xx, ww: conv2d_nhwc(xx, ww, self.stride, self.padding, self.dilation,
                                                      self.groups), x, self.kernel)
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
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _cast_op(self, lambda xx, ww: xx @ ww.T, x, self.weight)
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
    """Fake-quant conv (JAX ``QConv2d``): the input through its observer,
    the weight quantized per tensor on its range recomputed every forward,
    the bias at ``num_bits_weight`` on its global range, an f32 conv;
    ``num_bits_grad`` and ``biprecision`` select the gradient paths."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Ints, stride: Ints = 1,
                 padding: Ints = 0, dilation: Ints = 1, groups: int = 1, use_bias: bool = True,
                 num_bits: int = 8, num_bits_weight: Optional[int] = None, num_bits_grad: Optional[int] = None,
                 biprecision: bool = False, *, generator: torch.Generator):
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
        self.num_bits_grad = num_bits_grad
        self.biprecision = biprecision
        self.kernel = nn.Parameter(
            he_fan_out_(torch.empty(kh, kw, in_channels // groups, out_channels), generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None
        self.quantize_input = QuantMeasure(num_bits)
        self.grad_quant_rng = RandomStream(_seed_of(generator, "qconv"))
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qinput = self.quantize_input(x)
        qweight = _quant_weight(self.kernel, self.num_bits_weight)
        qbias = None if self.bias is None else fake_quant(self.bias, num_bits=self.num_bits_weight)

        def conv_op(xx, ww, bb):
            y = _cast_op(self, lambda a, k: conv2d_nhwc(a, k, self.stride, self.padding, self.dilation,
                                                        self.groups), xx, ww)
            return y if bb is None else y + bb

        return _grad_paths(self, conv_op, qinput, qweight, qbias)


class QLinear(nn.Module):
    """Fake-quant dense layer (JAX ``QLinear``); ``weight`` is (out, in)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 num_bits: int = 8, num_bits_weight: Optional[int] = None, num_bits_grad: Optional[int] = None,
                 biprecision: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.num_bits = num_bits
        self.num_bits_weight = num_bits_weight or num_bits
        self.num_bits_grad = num_bits_grad
        self.biprecision = biprecision
        bound = 1.0 / (in_features ** 0.5)
        self.weight = nn.Parameter(_uniform((out_features, in_features), bound, generator))
        self.bias = nn.Parameter(_uniform((out_features,), bound, generator)) if use_bias else None
        self.quantize_input = QuantMeasure(num_bits)
        self.grad_quant_rng = RandomStream(_seed_of(generator, "qlinear"))
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qinput = self.quantize_input(x)
        qweight = _quant_weight(self.weight, self.num_bits_weight)
        qbias = None if self.bias is None else fake_quant(self.bias, num_bits=self.num_bits_weight)

        def linear_op(xx, ww, bb):
            y = _cast_op(self, lambda a, k: a @ k.T, xx, ww)
            return y if bb is None else y + bb

        return _grad_paths(self, linear_op, qinput, qweight, qbias)


class RangeBN(nn.Module):
    """Range batch-norm over the last axis (JAX ``RangeBN``).

    Names as in the JAX model's state: ``running_mean``, ``running_var``
    (which holds the range-derived *scale*, not a variance), ``weight``
    (gamma, drawn from U[0, 1) with ``generator``), ``bias`` (beta, zeros)
    and the input observer ``quantize_input``. The input is quantized on the
    observer first; in train mode the batch's statistic normalizes it (the
    gradient flowing through it) and folds into the running buffers (the
    inverted EMA, the new value weighted ``1 - momentum``), and the output's
    cotangent is quantized at ``num_bits_grad``; in eval mode the running
    buffers normalize it. 2-D inputs are treated as (B, 1, 1, C)."""

    def __init__(self, num_features: int, momentum: float = 0.1, affine: bool = True,
                 num_chunks: int = rangebn.RANGE_BN_NUM_CHUNKS, eps: float = 1e-5, num_bits: int = 8,
                 num_bits_grad: Optional[int] = 8, *, generator: torch.Generator):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.num_chunks = num_chunks
        self.eps = eps
        self.num_bits = num_bits
        self.num_bits_grad = num_bits_grad
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.zeros(num_features))
        if affine:
            self.weight = nn.Parameter(torch.rand(num_features, generator=generator))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None
        self.quantize_input = QuantMeasure(num_bits)
        self.grad_quant_rng = RandomStream(_seed_of(generator, "rangebn"))

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
        if self.num_bits_grad is not None and self.training and torch.is_grad_enabled():
            out = quantize_grad(out, self.grad_quant_rng(out.device), num_bits=self.num_bits_grad)
        return out[:, 0, 0, :] if squeeze_2d else out
