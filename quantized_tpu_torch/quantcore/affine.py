"""Affine uniform quantization math (PyTorch port of
``quantized_tpu/quantcore/affine.py``).

Same semantics and the same float32 order of operations as the JAX module,
so eager results agree bit for bit:

- ``qmin = 0``, ``qmax = 2**num_bits - 1``; ``scale = (max - min) / (qmax -
  qmin)`` floored at ``1e-8``;
- ``x -> (x - min) / scale + qmin``, clamp, round half to even, dequantize
  ``(q - qmin) * scale + min``; ``enforce_true_zero`` uses the truncated
  zero-point instead;
- a missing min/max comes from the mean-of-chunk-extrema estimator.

Stochastic rounding waits for the training slice of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SCALE_FLOOR = 1e-8

_F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


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
    enforce_true_zero: bool = False,
    out_half: bool = False,
) -> torch.Tensor:
    """Quantize-dequantize ``x`` on the affine grid (forward only)."""
    x = torch.as_tensor(x)
    compute = x.to(_F32)
    if min_value is None or max_value is None:
        est_min, est_max = chunked_min_max(compute, num_chunks)
        min_value = est_min if min_value is None else min_value
        max_value = est_max if max_value is None else max_value
    min_value = _f32(min_value).to(compute.device)
    max_value = _f32(max_value).to(compute.device)

    qmin = _f32(0.0).to(compute.device)
    qmax = _f32(2.0**num_bits - 1.0).to(compute.device)
    scale = (max_value - min_value) / (qmax - qmin)
    scale = torch.maximum(scale, _f32(SCALE_FLOOR).to(compute.device))

    if enforce_true_zero:
        zero_point = torch.trunc(torch.clamp(qmin - min_value / scale, qmin, qmax))
        out = compute / scale + zero_point
    else:
        out = (compute - min_value) / scale + qmin

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
