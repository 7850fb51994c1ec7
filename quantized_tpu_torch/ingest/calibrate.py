"""Calibration: observer buffers -> integer-execution qparams (counterpart of
``quantized_tpu/ingest/calibrate.py``).

The engine derives ``scale_a = (max - min) / 255`` and an integer (nudged)
zero-point from a frozen observer range, in Python float64 exactly as the
JAX module does: the scalars are cast to float32 only where the kernels'
epilogue parameters are formed, at the same points as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ActQParams:
    """Asymmetric uint8 activation quantization (stored values 0..255)."""

    scale: float
    zero_point: int  # integer, on [0, 255]


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
