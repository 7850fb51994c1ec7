"""Straight-through estimators, gradient quantization and bi-precision
(PyTorch port of ``quantized_tpu/quantcore/ste.py``).

- :func:`fake_quant` is the quantize-dequantize of ``fake_quant_array``
  with a straight-through gradient: the backward is the identity for ``x``
  and nothing for the range (the reference's ``UniformQuantize.backward``;
  JAX ``_fake_quant_bwd``). A range computed from ``x`` (``w.min()``) so
  gets no gradient through the quantizer, as in JAX.
- :func:`quantize_grad` is the identity forward; its backward
  fake-quantizes the incoming cotangent on its own per-tensor min and max,
  with stochastic rounding by default (the reference's
  ``UniformQuantizeGrad``).
- :func:`biprec` runs an op twice on complementary detached arguments and
  recombines ``out1 + out2 - out2.detach()``: the value is ``out1``'s (up
  to the rounding of that sum, computed in JAX's order), the weight and bias
  gradients come at full precision through ``out1`` and the input gradient
  through ``out2``'s quantized cotangent.

Random draws come from an explicit ``torch.Generator`` on the tensor's
device (a layer makes one per training forward, ``layers.RandomStream``);
stochastic results agree with JAX's in distribution, not bit for bit.

On a mesh (``place``, a ``parallel.sharding.MeshPlace``) the cotangent is
this rank's block of the global one: its range is reduced over both axes,
and its noise is this rank's block of the draw one device makes for the
whole tensor, so the quantized block equals the one-device values there.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quantized_tpu_torch.quantcore.affine import fake_quant_array


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, min_value, max_value, generator, num_bits, num_chunks, stochastic, enforce_true_zero,
                out_half):
        ctx.x_dtype = x.dtype
        return fake_quant_array(x, num_bits=num_bits, min_value=min_value, max_value=max_value,
                                num_chunks=num_chunks, stochastic=stochastic, enforce_true_zero=enforce_true_zero,
                                generator=generator, out_half=out_half)

    @staticmethod
    def backward(ctx, g):
        # straight-through: dx = g; no gradient to the range or the generator
        return g.to(ctx.x_dtype), None, None, None, None, None, None, None, None


def fake_quant(
    x: torch.Tensor,
    min_value=None,
    max_value=None,
    generator: Optional[torch.Generator] = None,
    num_bits: int = 8,
    num_chunks: Optional[int] = None,
    stochastic: bool = False,
    enforce_true_zero: bool = False,
    out_half: bool = False,
) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (the reference's
    ``quantize()``)."""
    return _FakeQuant.apply(torch.as_tensor(x), min_value, max_value, generator, num_bits, num_chunks, stochastic,
                            enforce_true_zero, out_half)


class _QuantizeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, generator, num_bits, stochastic, place):
        ctx.generator, ctx.num_bits, ctx.stochastic, ctx.place = generator, num_bits, stochastic, place
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        lo, hi, noise, place = g.min(), g.max(), None, ctx.place
        if place is not None:
            lo, hi = place.global_min_max(lo, hi)
            if ctx.stochastic:
                noise = place.uniform(g.shape, ctx.generator, g.device, channels_sharded=place.sharded)
        gq = fake_quant_array(g, num_bits=ctx.num_bits, min_value=lo, max_value=hi,
                              stochastic=ctx.stochastic, generator=ctx.generator, noise=noise)
        return gq, None, None, None, None


def quantize_grad(x: torch.Tensor, generator: Optional[torch.Generator], num_bits: int = 8,
                  stochastic: bool = True, place=None) -> torch.Tensor:
    """Identity forward; the backward quantizes the incoming cotangent on its
    own min and max, stochastically from ``generator`` unless
    ``stochastic=False`` (on a mesh, as one device would: module
    docstring)."""
    if stochastic and generator is None:
        raise ValueError("stochastic gradient rounding requires a torch.Generator")
    return _QuantizeGrad.apply(x, generator, num_bits, stochastic, place)


def biprec(
    op: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    num_bits_grad: int = 8,
    place=None,
) -> torch.Tensor:
    """Bi-precision recombination (the reference's ``conv2d_biprec`` /
    ``linear_biprec``): ``out1`` carries the weight and bias gradients at
    full precision, ``out2`` the input gradient through ``quantize_grad``."""
    out1 = op(x.detach(), w, b)
    out2 = op(x, w.detach(), None if b is None else b.detach())
    out2 = quantize_grad(out2, generator, num_bits=num_bits_grad, place=place)
    return out1 + out2 - out2.detach()


def conv_biprec(conv_fn, x, w, b, generator, num_bits_grad: int = 8):
    """Bi-precision conv; ``conv_fn(x, w, b)`` performs the convolution."""
    return biprec(conv_fn, x, w, b, generator, num_bits_grad)


def linear_biprec(x, w, b, generator, num_bits_grad: int = 8):
    """Bi-precision dense layer: ``y = x @ w.T + b``."""

    def op(xx, ww, bb):
        y = xx @ ww.T
        return y if bb is None else y + bb

    return biprec(op, x, w, b, generator, num_bits_grad)
