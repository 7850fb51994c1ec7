"""Affine uniform quantization math (PyTorch port of
``quantized_tpu/quantcore/affine.py``).

Same semantics and the same float32 order of operations as the JAX module,
so eager results agree bit for bit:

- ``qmin = 0``, ``qmax = 2**num_bits - 1``; ``scale = (max - min) / (qmax -
  qmin)`` floored at ``1e-8``;
- ``x -> (x - min) / scale + qmin``, clamp, round half to even, dequantize
  ``(q - qmin) * scale + min``; ``enforce_true_zero`` uses the truncated
  zero-point instead;
- a missing min/max comes from the mean-of-chunk-extrema estimator;
- stochastic rounding adds U[-0.5, 0.5) noise after the affine map, before
  the clamp and the round. The noise is drawn from an explicit
  ``torch.Generator`` on the tensor's device (JAX draws it from a PRNG key;
  the two streams differ, so stochastic results agree in distribution,
  not bit for bit).
"""

from __future__ import annotations

import numbers
from typing import Optional, Tuple

import torch

SCALE_FLOOR = 1e-8

_F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


def _const(v, device) -> torch.Tensor:
    """``v`` as f32 on ``device``. A number is filled there rather than
    copied from the host, so a forward on a GPU (a RangeBN's fake-quant of
    its statistics, in the strict engine) copies nothing from the host and
    a CUDA graph can capture it; the value is the same f32 either way."""
    if isinstance(v, numbers.Real):
        return torch.full((), float(v), dtype=_F32, device=device)
    return _f32(v).to(device)


def chunked_min_max(x: torch.Tensor, num_chunks: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean over ``num_chunks`` row chunks of the per-chunk min and max
    (one chunk when ``num_chunks`` is None: the global range)."""
    num_chunks = 1 if num_chunks is None else num_chunks
    chunk = x.numel() // num_chunks
    y = x.reshape(-1)[: chunk * num_chunks].reshape(num_chunks, chunk)
    return y.amin(dim=-1).mean(), y.amax(dim=-1).mean()


def fake_quant_array(
    x: torch.Tensor,
    num_bits: int = 8,
    min_value=None,
    max_value=None,
    num_chunks: Optional[int] = None,
    stochastic: bool = False,
    enforce_true_zero: bool = False,
    generator: Optional[torch.Generator] = None,
    out_half: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Quantize-dequantize ``x`` on the affine grid (no gradient semantics:
    ``ste.fake_quant`` is the straight-through wrapper). ``stochastic``
    rounding draws its noise from ``generator``, which must live on ``x``'s
    device, or takes ``noise``, a U[0, 1) draw of ``x``'s shape made for it
    (a block of the global draw on a mesh)."""
    x = torch.as_tensor(x)
    compute = x.to(_F32)
    if min_value is None or max_value is None:
        est_min, est_max = chunked_min_max(compute, num_chunks)
        min_value = est_min if min_value is None else min_value
        max_value = est_max if max_value is None else max_value
    min_value = _const(min_value, compute.device)
    max_value = _const(max_value, compute.device)

    qmin = _const(0.0, compute.device)
    qmax = _const(2.0**num_bits - 1.0, compute.device)
    scale = (max_value - min_value) / (qmax - qmin)
    scale = torch.maximum(scale, _const(SCALE_FLOOR, compute.device))

    if enforce_true_zero:
        zero_point = torch.trunc(torch.clamp(qmin - min_value / scale, qmin, qmax))
        out = compute / scale + zero_point
    else:
        out = (compute - min_value) / scale + qmin

    if stochastic:
        if noise is None and generator is None:
            raise ValueError("stochastic rounding requires a torch.Generator")
        if noise is None:
            noise = torch.rand(out.shape, generator=generator, dtype=out.dtype, device=out.device)
        out = out + (noise - 0.5)

    out = torch.round(torch.clamp(out, qmin, qmax))

    if enforce_true_zero:
        out = (out - zero_point) * scale
    else:
        out = (out - qmin) * scale + min_value

    if out_half and num_bits <= 16:
        return out.to(torch.float16)
    return out if x.dtype == _F32 else out.to(x.dtype)


def qparams_from_range(min_value, max_value, num_bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, fractional zero_point): ``scale = (max-min)/(2^b-1)``
    (floored), ``zp = -min/scale`` (not rounded)."""
    qmax = 2.0**num_bits - 1.0
    scale = (_f32(max_value) - _f32(min_value)) / qmax
    scale = torch.clamp_min(scale, SCALE_FLOOR)
    return scale, -_f32(min_value) / scale


def nudged_qparams(min_value, max_value, num_bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nudged (scale, integer zero_point): the range is extended to contain
    0, then zp is rounded onto [0, 2^b - 1]."""
    min_value = torch.clamp_max(_f32(min_value), 0.0)
    max_value = torch.clamp_min(_f32(max_value), 0.0)
    qmax = 2.0**num_bits - 1.0
    scale = torch.clamp_min((max_value - min_value) / qmax, SCALE_FLOOR)
    zero_point = torch.clamp(torch.round(-min_value / scale), 0.0, qmax)
    return scale, zero_point.to(torch.int32)


def quantize_int(
    x: torch.Tensor,
    scale,
    zero_point,
    num_bits: int = 8,
    dtype: torch.dtype = torch.int8,
    channel_axis: Optional[int] = None,
) -> torch.Tensor:
    """Real -> integer: ``q = clamp(round(x/scale) + zp, 0, 2^b-1)``, stored
    shifted by ``-2^(b-1)`` when ``dtype`` is int8."""
    qmax = 2.0**num_bits - 1.0
    scale = _f32(scale).to(x.device)
    zero_point = torch.as_tensor(zero_point).to(x.device)
    if channel_axis is not None:
        shape = [1] * x.ndim
        shape[channel_axis] = -1
        scale = scale.reshape(shape)
        zero_point = zero_point.reshape(shape)
    q = torch.round(x.to(_F32) / scale) + zero_point.to(_F32)
    q = torch.clamp(q, 0.0, qmax)
    if dtype == torch.int8:
        q = q - 2.0 ** (num_bits - 1)
    return q.to(dtype)


def storage_shift(num_bits: int, dtype: torch.dtype) -> int:
    """Offset between the logical unsigned grid and the stored signed values."""
    return int(2 ** (num_bits - 1)) if dtype == torch.int8 else 0


def dequantize(q: torch.Tensor, scale, zero_point, num_bits: int = 8,
               channel_axis: Optional[int] = None) -> torch.Tensor:
    """Integer -> real: ``x_hat = (u - zp) * scale`` with ``u`` the logical
    unsigned value (signed storage un-shifted first)."""
    u = q.to(_F32) + float(storage_shift(num_bits, q.dtype))
    scale = _f32(scale).to(q.device)
    zero_point = _f32(zero_point).to(q.device)
    if channel_axis is not None:
        shape = [1] * q.ndim
        shape[channel_axis] = -1
        scale = scale.reshape(shape)
        zero_point = zero_point.reshape(shape)
    return (u - zero_point) * scale
