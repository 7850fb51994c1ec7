"""Fake-quant layer -> integer layer conversion (counterpart of
``quantized_tpu/engine/convert.py``, the pieces that ``build_int8_resident``
uses).

For a (QConv2d/QLinear, following float BN) pair: fold the BN into the
weights, derive the activation grid from the frozen observer and
per-channel symmetric int8 (or int4) weight scales, and precompute the
fused epilogue (alpha, beta). The arithmetic is float32 numpy in the JAX
module's order, so the int8 weights and alpha/beta come out equal. At
``weight_bits=4`` with ``int4_pack`` a conv packs its weights channel-split
(where its Cin per group is even) and a dense layer split-half, the JAX
package's bytes. The module-surgery ``convert_to_int`` and RangeBN folding
are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear
from quantized_tpu_torch.ingest.bn_fold import fold_bn_into_conv
from quantized_tpu_torch.ingest.calibrate import ActQParams, activation_qparams_from_observer
from quantized_tpu_torch.models.layers import BatchNorm, QConv2d, QLinear
from quantized_tpu_torch.ops.int4 import pack_int4, pack_int4_conv_channels
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


def bn_factor(bn: BatchNorm) -> np.ndarray:
    """Per-channel folded BN factor ``gamma / sqrt(var + eps)``. Its sign
    decides max- against min-pool where a model pools between a conv and its
    BN (AlexNet, ``build_int8_alexnet``)."""
    return _np(bn.scale) / np.sqrt(_np(bn.var) + float(bn.epsilon))


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


def _convert_conv(conv: QConv2d, bn: Optional[BatchNorm], weight_bits: int, backend: str,
                  int4_pack: bool = False, act_grid: Optional[Tuple[float, int]] = None) -> IntConv2d:
    """``act_grid=(scale, zero_point)`` overrides the conv's own observer
    grid: the epilogue is exact for whatever grid the input arrives on.
    ``int4_pack`` at ``weight_bits=4`` stores the weights channel-split
    packed where the Cin per group is even; otherwise (the stem's Cin = 3, a
    depthwise conv) they stay int8 storage on the int4 grid."""
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
    int4_shape = None
    w_store = torch.from_numpy(w_q)
    if int4_pack and weight_bits == 4 and w_q.shape[2] % 2 == 0:
        int4_shape = w_q.shape
        w_store = pack_int4_conv_channels(w_store)
    return IntConv2d(w_store, alpha, beta, qp.scale, qp.zero_point,
                     stride=conv.stride, padding=conv.padding, groups=conv.groups, relu=False,
                     backend=backend, int4_shape=int4_shape)


def _convert_linear(lin: QLinear, bn: Optional[BatchNorm], weight_bits: int,
                    int4_pack: bool = False) -> IntLinear:
    """``int4_pack`` at ``weight_bits=4`` stores the weights split-half
    packed, (K/2, N), odd K padded with a zero weight first."""
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
    use_int4 = int4_pack and weight_bits == 4
    w_store = torch.from_numpy(w_q_kn)
    if use_int4:
        if w_q_kn.shape[0] % 2:
            w_store = torch.from_numpy(np.pad(w_q_kn, ((0, 1), (0, 0))))
        w_store = pack_int4(w_store)
    return IntLinear(w_store, alpha, beta, qp.scale, qp.zero_point, relu=False, int4=use_int4)
