"""Fake-quant layer -> integer layer conversion (counterpart of
``quantized_tpu/engine/convert.py``, the pieces that ``build_int8_resident``
uses).

For a (QConv2d/QLinear, following float BN) pair: fold the BN into the
weights, derive the activation grid from the frozen observer and
per-channel symmetric int8 weight scales, and precompute the fused epilogue
(alpha, beta). The arithmetic is float32 numpy in the JAX module's order, so
the int8 weights and alpha/beta come out equal. The module-surgery
``convert_to_int``, RangeBN folding and int4 packing are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear
from quantized_tpu_torch.ingest.bn_fold import fold_bn_into_conv
from quantized_tpu_torch.ingest.calibrate import ActQParams, activation_qparams_from_observer
from quantized_tpu_torch.models.layers import BatchNorm, QConv2d, QLinear
from quantized_tpu_torch.ops.int8_matmul import matmul_epilogue_params


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _observer_qparams(q_module) -> ActQParams:
    obs = q_module.quantize_input
    return activation_qparams_from_observer(float(obs.running_min[0]), float(obs.running_max[0]))


def observer_grid(q_module) -> Tuple[float, int]:
    """(scale, zero_point) of the uint8 grid derived from a QConv2d/QLinear's
    frozen observer."""
    qp = _observer_qparams(q_module)
    return (qp.scale, qp.zero_point)


def _fold(conv_or_lin, bn: Optional[BatchNorm]) -> Tuple[np.ndarray, np.ndarray]:
    """Folded (weight, bias) in f32 numpy. Conv weights HWIO; linear weights
    (out, in)."""
    is_conv = isinstance(conv_or_lin, QConv2d)
    w = _np(conv_or_lin.kernel if is_conv else conv_or_lin.weight)
    b = None if conv_or_lin.bias is None else _np(conv_or_lin.bias)
    if bn is None:
        bias = np.zeros(w.shape[-1] if is_conv else w.shape[0], np.float32) if b is None else b
        return w, bias
    if not isinstance(bn, BatchNorm):
        raise TypeError(f"only float BN folds in the port so far, got {type(bn).__name__}")
    args = (_np(bn.scale), _np(bn.bias), _np(bn.mean), _np(bn.var), float(bn.epsilon))
    if is_conv:
        return fold_bn_into_conv(w, b, *args)
    wt, bt = fold_bn_into_conv(w.T[None, None], b, *args)
    return wt[0, 0].T, bt


def _weight_scales(w: np.ndarray, cout_axis_last: bool, num_bits: int) -> np.ndarray:
    qmax = 2.0 ** (num_bits - 1) - 1.0
    if cout_axis_last:
        absmax = np.max(np.abs(w.reshape(-1, w.shape[-1])), axis=0)
    else:
        absmax = np.max(np.abs(w), axis=1)
    return np.maximum(absmax / qmax, 1e-12).astype(np.float32)


def _check_bits(weight_bits: int) -> None:
    if weight_bits != 8:
        raise ValueError("the port converts int8 weights only so far (int4 is not ported yet)")


def _convert_conv(conv: QConv2d, bn: Optional[BatchNorm], weight_bits: int, backend: str,
                  act_grid: Optional[Tuple[float, int]] = None) -> IntConv2d:
    """``act_grid=(scale, zero_point)`` overrides the conv's own observer
    grid: the epilogue is exact for whatever grid the input arrives on."""
    _check_bits(weight_bits)
    if act_grid is not None:
        qp = ActQParams(scale=float(act_grid[0]), zero_point=int(act_grid[1]))
    else:
        qp = _observer_qparams(conv)
    w_f, b_f = _fold(conv, bn)
    s_w = _weight_scales(w_f, True, weight_bits)
    lim = 2.0 ** (weight_bits - 1) - 1.0
    w_q = np.clip(np.round(w_f / s_w[None, None, None, :]), -lim, lim).astype(np.int8)
    colsum = w_q.astype(np.int32).reshape(-1, w_q.shape[-1]).sum(axis=0)
    alpha, beta = matmul_epilogue_params(
        qp.scale, qp.zero_point, torch.from_numpy(s_w), torch.from_numpy(colsum), torch.from_numpy(b_f)
    )
    return IntConv2d(torch.from_numpy(w_q), alpha, beta, qp.scale, qp.zero_point,
                     stride=conv.stride, padding=conv.padding, groups=conv.groups, relu=False,
                     backend=backend)


def _convert_linear(lin: QLinear, bn: Optional[BatchNorm], weight_bits: int) -> IntLinear:
    _check_bits(weight_bits)
    qp = _observer_qparams(lin)
    w_f, b_f = _fold(lin, bn)  # (out, in)
    s_w = _weight_scales(w_f, False, weight_bits)
    lim = 2.0 ** (weight_bits - 1) - 1.0
    w_q_oi = np.clip(np.round(w_f / s_w[:, None]), -lim, lim).astype(np.int8)
    w_q_kn = np.ascontiguousarray(w_q_oi.T)  # (in, out)
    colsum = w_q_kn.astype(np.int32).sum(axis=0)
    alpha, beta = matmul_epilogue_params(
        qp.scale, qp.zero_point, torch.from_numpy(s_w), torch.from_numpy(colsum), torch.from_numpy(b_f)
    )
    return IntLinear(torch.from_numpy(w_q_kn), alpha, beta, qp.scale, qp.zero_point, relu=False)
