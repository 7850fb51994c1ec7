"""RangeBN, range-based batch normalization (PyTorch port of
``quantized_tpu/quantcore/rangebn.py``).

- statistic, per channel C of an NHWC batch: the (B, H, W) values of a
  channel in NCHW memory order, cut into ``num_chunks`` chunks of
  ``n = B*H*W // num_chunks``; the mean over chunks of each chunk's max
  (min) gives ``mean_max`` (``mean_min``); the tail past ``n * num_chunks``
  is left out of them but kept in the channel mean;
- ``scale = (mean_max - mean_min) * scale_fix(n)``, the Gaussian range to
  std correction ``(0.5*0.35) * (1 + (pi*ln4)**0.5) / (2*ln(n))**0.5``;
- normalization ``(x - mean) / (q(scale) + eps) * q(gamma) + q(beta)``, the
  scale and gamma vectors fake-quantized on their own min/max, beta on the
  chunk estimator's default (global) range.

The statistics carry the gradient through ``x``: ``amax``/``amin`` split a
tie's gradient evenly, as JAX's ``max``/``min`` do, and the quantizers are
straight-through, so the scale's gradient reaches ``x`` through the chunk
extrema.

The running buffers (``models.layers.RangeBN``) keep the *scale* in
``running_var``, as the reference checkpoints do.

On a mesh (``place``, a ``parallel.sharding.MeshPlace``) ``x`` is this
rank's rows and its block of the channels. The statistics are the global
batch's: the chunks are cut from the global (B, H, W) rows, so a chunk may
straddle two data ranks (``MeshPlace.chunk_extrema``), and the
channel mean is the data ranks' means averaged with the gradient summed
back. The scale, gamma and beta vectors are gathered to full width,
quantized as one device quantizes them and sliced again.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from quantized_tpu_torch.quantcore.ste import fake_quant

RANGE_BN_NUM_CHUNKS = 16


def range_bn_scale_fix(n: int) -> float:
    """The Gaussian range-to-std correction factor for chunk length ``n``."""
    return (0.5 * 0.35) * (1 + (math.pi * math.log(4)) ** 0.5) / ((2 * math.log(n)) ** 0.5)


def range_bn_stats(x_nhwc: torch.Tensor, num_chunks: int = RANGE_BN_NUM_CHUNKS, place=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, range scale) of an NHWC batch (on a mesh, of the
    global batch: module docstring)."""
    b, h, w, c = x_nhwc.shape
    y = x_nhwc.permute(3, 0, 1, 2).reshape(c, -1)
    if place is None:
        chunk = (b * h * w) // num_chunks
        yc = y[:, : chunk * num_chunks].reshape(c, num_chunks, chunk)
        mean_max = yc.amax(dim=-1).mean(dim=-1)
        mean_min = yc.amin(dim=-1).mean(dim=-1)
        return y.mean(dim=-1), (mean_max - mean_min) * range_bn_scale_fix(chunk)
    chunk = (b * h * w * place.data_size) // num_chunks
    chunk_max, chunk_min = place.chunk_extrema(y, chunk, num_chunks)
    scale = (chunk_max.mean(dim=-1) - chunk_min.mean(dim=-1)) * range_bn_scale_fix(chunk)
    return place.data_mean(y.mean(dim=-1)), scale


def _whole(v: torch.Tensor, quantize, place) -> torch.Tensor:
    """``quantize(v)`` of a per-channel vector; on a mesh where ``v`` is a
    block, of the gathered vector, sliced again."""
    if place is None or not place.sharded:
        return quantize(v)
    return place.block(quantize(place.gather_channels(v)))


def _on_own_range(num_bits: int):
    return lambda v: fake_quant(v, num_bits=num_bits, min_value=v.min(), max_value=v.max())


def range_bn_apply(x_nhwc: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                   gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor], eps: float = 1e-5,
                   num_bits: int = 8, place=None) -> torch.Tensor:
    """Normalize with the quantized scale, gamma and beta vectors."""
    qscale = _whole(scale, _on_own_range(num_bits), place)
    out = (x_nhwc - mean) / (qscale + eps)
    if gamma is not None:
        out = out * _whole(gamma, _on_own_range(num_bits), place)
    if beta is not None:
        out = out + _whole(beta, lambda v: fake_quant(v, num_bits=num_bits), place)
    return out
