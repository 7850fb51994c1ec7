"""Calibration: observer buffers -> integer-execution qparams (counterpart of
``quantized_tpu/ingest/calibrate.py``).

The engine derives ``scale_a = (max - min) / 255`` and an integer (nudged)
zero-point from a frozen observer range, in Python float64 exactly as the
JAX module does: the scalars are cast to float32 only where the kernels'
epilogue parameters are formed, at the same points as in the JAX package.
Weights take symmetric int8 scales, per output channel (the production
engines) or per tensor (:class:`WeightQParams`), in float32 numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ActQParams:
    """Asymmetric uint8 activation quantization (stored values 0..255)."""

    scale: float
    zero_point: int  # integer, on [0, 255]


@dataclasses.dataclass(frozen=True)
class WeightQParams:
    """Symmetric int8 weights, per-channel (a (Cout,) scale over an HWIO
    kernel's last axis) or per-tensor (a scalar array)."""

    scale: np.ndarray
    per_channel: bool

    def _scale(self) -> np.ndarray:
        return self.scale[None, None, None, :] if self.per_channel else self.scale

    def quantize(self, w_hwio: np.ndarray) -> np.ndarray:
        return np.clip(np.round(w_hwio / self._scale()), -127, 127).astype(np.int8)

    def dequantize(self, q: np.ndarray) -> np.ndarray:
        return q.astype(np.float32) * self._scale()


def activation_qparams_from_observer(
    running_min: float, running_max: float, num_bits: int = 8
) -> ActQParams:
    """Nudged (scale, int zp) from frozen QuantMeasure buffers. The range is
    extended to contain 0 so padding quantizes exactly."""
    rmin = min(float(running_min), 0.0)
    rmax = max(float(running_max), 0.0)
    qmax = 2.0**num_bits - 1.0
    scale = max((rmax - rmin) / qmax, 1e-8)
    zp = int(np.clip(round(-rmin / scale), 0, qmax))
    return ActQParams(scale=float(scale), zero_point=zp)


def weight_qparams_per_channel(w_hwio: np.ndarray, num_bits: int = 8) -> WeightQParams:
    """Symmetric per-output-channel scales of an HWIO kernel:
    ``max|W_c| / (2^(b-1) - 1)``, floored at 1e-12."""
    qmax = 2.0 ** (num_bits - 1) - 1.0
    absmax = np.max(np.abs(w_hwio.reshape(-1, w_hwio.shape[-1])), axis=0)
    return WeightQParams(scale=np.maximum(absmax / qmax, 1e-12).astype(np.float32), per_channel=True)


def weight_qparams_per_tensor(w: np.ndarray, num_bits: int = 8) -> WeightQParams:
    """One symmetric scale for the whole tensor."""
    qmax = 2.0 ** (num_bits - 1) - 1.0
    scale = np.float32(max(np.max(np.abs(w)) / qmax, 1e-12))
    return WeightQParams(scale=np.asarray(scale), per_channel=False)


def linear_weight_qparams_per_channel(w_oi: np.ndarray, num_bits: int = 8) -> WeightQParams:
    """(out, in) dense weights: one scale per output row."""
    qmax = 2.0 ** (num_bits - 1) - 1.0
    absmax = np.max(np.abs(w_oi), axis=1)
    return WeightQParams(scale=np.maximum(absmax / qmax, 1e-12).astype(np.float32), per_channel=True)
