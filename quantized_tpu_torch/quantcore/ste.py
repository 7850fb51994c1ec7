"""Straight-through fake quantization, forward only (PyTorch port of
``quantized_tpu/quantcore/ste.py:33``).

The port serves a calibrated model, so only the forward value is needed
here: ``fake_quant`` is the quantize-dequantize of ``fake_quant_array``.
The straight-through gradient, ``quantize_grad`` and the bi-precision
recombination wait for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from quantized_tpu_torch.quantcore.affine import fake_quant_array


def fake_quant(
    x: torch.Tensor,
    min_value=None,
    max_value=None,
    num_bits: int = 8,
    num_chunks: Optional[int] = None,
    enforce_true_zero: bool = False,
    out_half: bool = False,
) -> torch.Tensor:
    """Quantize-dequantize (the reference's ``quantize()``), forward value."""
    return fake_quant_array(
        x,
        num_bits=num_bits,
        min_value=min_value,
        max_value=max_value,
        num_chunks=num_chunks,
        enforce_true_zero=enforce_true_zero,
        out_half=out_half,
    )
