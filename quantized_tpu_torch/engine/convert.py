"""Fake-quant model -> integer model conversion (counterpart of
``quantized_tpu/engine/convert.py``).

For a (QConv2d/QLinear, following BN) pair: fold the BN (float or RangeBN)
into the weights, derive the activation grid from the frozen observer and
per-channel symmetric int8 (or int4) weight scales, and precompute the
fused epilogue (alpha, beta). The arithmetic is float32 numpy in the JAX
module's order, so the int8 weights and alpha/beta come out equal. At
``weight_bits=4`` with ``int4_pack`` a conv packs its weights channel-split
(where its Cin per group is even) and a dense layer split-half, the JAX
package's bytes. A RangeBN fold carries the RangeBN input observer's range
clip as the conv's ``y_clip`` (:func:`_rangebn_y_clip`).

:func:`convert_to_int` is the module surgery: it walks a calibrated model
and replaces each (conv or linear, BN) attribute pair of the name pairs in
``_PAIRS`` with ``IntConv2d`` / ``IntLinear`` and :class:`Identity` in place,
so the model's own forward (residual adds, ReLU, pooling in f32) runs
unchanged around the integer layers. ``weight_quant="per_tensor"`` is the
strict engine (``engine/strict.py``).

AlexNet pools between a conv and its BN; folding is exact for any sign, but
this surgery pools after the folded conv, which turns a max into a min for
a channel with a negative BN factor. ``convert_to_int`` warns then;
``build_int8_alexnet`` handles both signs exactly.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.engine.int_layers import Identity, IntConv2d, IntLinear
from quantized_tpu_torch.ingest.bn_fold import fold_bn_into_conv, fold_rangebn_into_conv, rangebn_fold_params
from quantized_tpu_torch.ingest.calibrate import ActQParams, activation_qparams_from_observer
from quantized_tpu_torch.models.layers import BatchNorm, QConv2d, QLinear, QuantMeasure, RangeBN
from quantized_tpu_torch.ops.int4 import pack_int4, pack_int4_conv_channels
from quantized_tpu_torch.ops.int8_matmul import matmul_epilogue_params

logger = logging.getLogger(__name__)

# the (conv or linear, BN) attribute pairs of the zoo: ResNet blocks and stems
# conv1..3/bn1..3, Downsample conv/bn, AlexNet conv1..5/bn1..5 and
# fc1/bnf1, fc2/bnf2, MobileNet dw/bn1 and pw/bn2
_PAIRS = [
    ("conv1", "bn1"),
    ("conv2", "bn2"),
    ("conv3", "bn3"),
    ("conv4", "bn4"),
    ("conv5", "bn5"),
    ("conv", "bn"),
    ("dw", "bn1"),
    ("pw", "bn2"),
    ("fc1", "bnf1"),
    ("fc2", "bnf2"),
    ("fc", None),
    ("fc3", None),
]
AnyBN = Union[BatchNorm, RangeBN]


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


def _fold(conv_or_lin, bn: Optional[AnyBN]) -> Tuple[np.ndarray, np.ndarray]:
    """Folded (weight, bias) in f32 numpy. Conv weights HWIO; linear weights
    (out, in)."""
    is_conv = isinstance(conv_or_lin, QConv2d)
    w = _np(conv_or_lin.kernel if is_conv else conv_or_lin.weight)
    b = None if conv_or_lin.bias is None else _np(conv_or_lin.bias)
    if bn is None:
        bias = np.zeros(w.shape[-1] if is_conv else w.shape[0], np.float32) if b is None else b
        return w, bias
    if isinstance(bn, RangeBN):
        fold = fold_rangebn_into_conv
        args = (None if bn.weight is None else _np(bn.weight), None if bn.bias is None else _np(bn.bias),
                _np(bn.running_mean), _np(bn.running_var), bn.eps)
    elif isinstance(bn, BatchNorm):
        fold = fold_bn_into_conv
        args = (_np(bn.scale), _np(bn.bias), _np(bn.mean), _np(bn.var), float(bn.epsilon))
    else:
        raise TypeError(f"cannot fold {type(bn).__name__}: BatchNorm or RangeBN expected")
    if is_conv:
        return fold(w, b, *args)
    wt, bt = fold(w.T[None, None], b, *args)
    return wt[0, 0].T, bt


def _weight_scales(w: np.ndarray, cout_axis_last: bool, num_bits: int) -> np.ndarray:
    qmax = 2.0 ** (num_bits - 1) - 1.0
    if cout_axis_last:
        absmax = np.max(np.abs(w.reshape(-1, w.shape[-1])), axis=0)
    else:
        absmax = np.max(np.abs(w), axis=1)
    return np.maximum(absmax / qmax, 1e-12).astype(np.float32)


def _rangebn_y_clip(conv: QConv2d, bn: RangeBN, b_f: np.ndarray) -> Optional[np.ndarray]:
    """(2, Cout) bounds that carry the RangeBN input observer's range clip
    into the folded engine.

    RangeBN quantizes its input on the observer's range before it
    normalizes; folding the BN into the conv drops that step, and its clip
    is a saturating nonlinearity a trained network relies on (the JAX
    package measured 17.2 top-1 points lost at its trained flagship without
    it). The clip commutes through the monotone per-channel affine
    ``f_c * z + c_c`` into bounds of the conv's output:
    ``[min(f*mn, f*mx) + c, max(f*mn, f*mx) + c]``, with ``c = b_f - f * b0``
    from the folded bias. The factors come from ``rangebn_fold_params``, the
    fold's own. None where the observer holds no range (uncalibrated)."""
    obs = getattr(bn, "quantize_input", None)
    if not isinstance(obs, QuantMeasure):
        return None
    mn, mx = float(obs.running_min[0]), float(obs.running_max[0])
    if not mx > mn:
        return None
    factor, _ = rangebn_fold_params(None if bn.weight is None else _np(bn.weight), None, _np(bn.running_var),
                                    eps=bn.eps)
    b0 = 0.0 if conv.bias is None else _np(conv.bias)
    c = np.asarray(b_f, np.float32) - factor * b0
    lo = np.minimum(factor * mn, factor * mx) + c
    hi = np.maximum(factor * mn, factor * mx) + c
    return np.stack([lo, hi]).astype(np.float32)


def _convert_conv(conv: QConv2d, bn: Optional[AnyBN], weight_bits: int, backend: str,
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
    y_clip = _rangebn_y_clip(conv, bn, b_f) if isinstance(bn, RangeBN) else None
    return IntConv2d(w_store, alpha, beta, qp.scale, qp.zero_point,
                     stride=conv.stride, padding=conv.padding, groups=conv.groups, relu=False,
                     backend=backend, int4_shape=int4_shape,
                     y_clip=None if y_clip is None else torch.from_numpy(y_clip))


def _convert_linear(lin: QLinear, bn: Optional[AnyBN], weight_bits: int,
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


def convert_to_int(model: nn.Module, weight_bits: int = 8, backend: str = "pallas", int4_pack_linear: bool = True,
                   int4_pack_conv: bool = True, weight_quant: str = "per_channel",
                   device: DeviceLike = "cuda") -> nn.Module:
    """Convert a calibrated fake-quant model in place and return it, on
    ``device``.

    ``weight_bits``: 8, or 4 for int4 weight-only (activations stay uint8);
    ``backend``: any of ``int_layers.CONV_BACKENDS`` for the convs:
    ``"pallas"`` (the default, as ``build_int8_resident``'s) runs K2,
    ``"gemm"`` im2col and K1; the JAX package's default, ``"xla"``, is an
    exact plain reference here, not a fast path; ``int4_pack_*``: at ``weight_bits=4``,
    two nibbles a byte. ``weight_quant="per_channel"`` is the production
    grid (symmetric per output channel, BN folded); ``"per_tensor"`` is the
    strict engine, ``engine.strict.convert_to_int_strict`` (the reference's
    own grids, BN left unfolded; ``weight_bits`` and ``backend`` unused)."""
    dev = resolve_device(device)
    if weight_quant == "per_tensor":
        from quantized_tpu_torch.engine.strict import convert_to_int_strict

        return convert_to_int_strict(model, device=dev)
    if weight_quant != "per_channel":
        raise ValueError("weight_quant must be 'per_channel' or 'per_tensor'")
    if weight_bits not in (4, 8):
        raise ValueError("weight_bits must be 4 or 8")
    from quantized_tpu_torch.models.alexnet import AlexNetOWTBN

    if isinstance(model, AlexNetOWTBN):
        for bn_name in ("bn1", "bn2", "bn5"):
            bn = getattr(model, bn_name, None)
            if isinstance(bn, BatchNorm) and np.any(bn_factor(bn) < 0):
                logger.warning("%s has negative-scale channels; folding it across the following maxpool is "
                               "unsound here: use build_int8_alexnet for exact semantics", bn_name)
    for module in list(model.modules()):
        for conv_name, bn_name in _PAIRS:
            target = getattr(module, conv_name, None)
            bn = getattr(module, bn_name, None) if bn_name else None
            if isinstance(target, QConv2d):
                setattr(module, conv_name, _convert_conv(target, bn, weight_bits, backend, int4_pack=int4_pack_conv))
            elif isinstance(target, QLinear):
                setattr(module, conv_name, _convert_linear(target, bn, weight_bits, int4_pack_linear))
            else:
                continue
            if bn is not None:
                setattr(module, bn_name, Identity())
    return model.to(dev)
