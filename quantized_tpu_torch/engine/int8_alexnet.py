"""Int8-resident AlexNet-OWT-BN execution (counterpart of
``quantized_tpu/engine/int8_alexnet.py``; BASELINE config #2's model, and
with ``weight_bits=4`` config #4's int4 weight-only form).

Activations stay stored int8 from the input quantize to fc3, as in
:class:`~quantized_tpu_torch.engine.int8_resident.Int8ResNet`. The
reference order is ``conv -> maxpool -> BN -> ReLU``: the pool comes BEFORE
the BN that the conv's epilogue folds in. Folding moves the per-channel map
``requant(relu(bn(.)))`` to the other side of the pool, which is exact where
that map is non-decreasing, i.e. where the BN factor gamma/sqrt(var+eps) is
>= 0. For a negative factor the map is non-increasing, so ``h(max(x)) ==
min(h(x))``: those channels take a MIN-pool of the epilogue output. The
factor's sign moves into the quantized weights when BN folds (the
epilogue's alpha stays positive), so ``build_int8_alexnet`` reads the mask
off the BN module (``convert.bn_factor``); a conv with no negative channel
keeps the mask None and runs the max-pool alone.

On backend ``"pallas"`` conv1 (11x11/s4 over Cin = 3) runs on kernel K2's
gather-K form, conv2-5 on K2's per-tap form, fc1-3 on K1, or with
``weight_bits=4`` on kernel B6 (``ops/int4.py``) from their packed bytes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.engine.convert import _convert_conv, _convert_linear, bn_factor, observer_grid
from quantized_tpu_torch.engine.int8_resident import u8_to_stored
from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear, quantize_input_stored
from quantized_tpu_torch.models.layers import QConv2d, QLinear

Grid = Tuple[float, int]


def pool_3x3_s2_valid_int8(x_q: torch.Tensor, reduce: str = "max") -> torch.Tensor:
    """3x3/stride-2 VALID pool on stored int8, NHWC (AlexNet: 55 -> 27,
    27 -> 13, 13 -> 6), as 9 strided slices and an elementwise max (or, for
    ``reduce="min"``, min), with no pooling op."""
    if reduce not in ("max", "min"):
        raise ValueError(f"reduce must be 'max' or 'min', got {reduce!r}")
    fn = torch.maximum if reduce == "max" else torch.minimum
    _, h, w, _ = x_q.shape
    ho, wo = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    out = None
    for i in range(3):
        for j in range(3):
            tap = x_q[:, i: i + 2 * (ho - 1) + 1: 2, j: j + 2 * (wo - 1) + 1: 2, :]
            out = tap if out is None else fn(out, tap)
    return out


def _pool_dual(x_q: torch.Tensor, neg_channels: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-channel max/min pool: the channels whose folded BN factor is
    negative take the min-pool (module docstring). ``None``: no such
    channel, the max-pool alone."""
    pooled = pool_3x3_s2_valid_int8(x_q, "max")
    if neg_channels is None:
        return pooled
    return torch.where(neg_channels, pool_3x3_s2_valid_int8(x_q, "min"), pooled)


class Int8AlexNet(nn.Module):
    """Int8-resident AlexNet-OWT-BN: f32 NHWC images (``forward``) or raw
    uint8 NHWC images (:meth:`run_u8`) in, f32 logits out. Built by
    :func:`build_int8_alexnet`."""

    def __init__(self, convs: List[IntConv2d], fcs: List[IntLinear], requant_grids: List[Grid],
                 neg_masks: List[Optional[torch.Tensor]]):
        super().__init__()
        if len(convs) != 5 or len(fcs) != 3 or len(requant_grids) != 7 or len(neg_masks) != 3:
            raise ValueError("AlexNet has 5 convs, 3 dense layers, 7 requant grids and 3 pool masks")
        self.conv1, self.conv2, self.conv3, self.conv4, self.conv5 = convs
        self.fc1, self.fc2, self.fc3 = fcs
        # requant_grids[i]: the next consumer's observer grid at each requant point
        self.requant_grids = requant_grids
        for name, mask in zip(("neg1", "neg2", "neg5"), neg_masks):
            self.register_buffer(name, mask)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward_q(quantize_input_stored(x, *self.conv1.grid))

    def run_u8(self, u8: torch.Tensor, mean=None, std=None) -> torch.Tensor:
        """Forward from raw uint8 NHWC images (values 0..255), the normalize
        folded into the input quantize."""
        return self._forward_q(u8_to_stored(u8, self.conv1.grid, mean, std))

    def _forward_q(self, x_q: torch.Tensor) -> torch.Tensor:
        g = self.requant_grids
        h = self.conv1.run_q(x_q, relu=True, out_requant=g[0])
        h = _pool_dual(h, self.neg1)
        h = self.conv2.run_q(h, relu=True, out_requant=g[1])
        h = _pool_dual(h, self.neg2)
        h = self.conv3.run_q(h, relu=True, out_requant=g[2])
        h = self.conv4.run_q(h, relu=True, out_requant=g[3])
        h = self.conv5.run_q(h, relu=True, out_requant=g[4])
        h = _pool_dual(h, self.neg5)
        h = h.reshape(h.shape[0], -1)  # NHWC 6x6x256 flatten, int8
        h = self.fc1.run_q(h, relu=True, out_requant=g[5])
        h = self.fc2.run_q(h, relu=True, out_requant=g[6])
        return self.fc3.run_q(h)  # f32 logits


def _neg_mask(bn) -> Optional[torch.Tensor]:
    factor = bn_factor(bn)
    return torch.from_numpy(factor < 0) if (factor < 0).any() else None


def build_int8_alexnet(model: nn.Module, weight_bits: int = 8, backend: str = "pallas",
                       device: DeviceLike = "cuda") -> Int8AlexNet:
    """Convert a calibrated ``alexnet_quantized`` (frozen observers) into an
    :class:`Int8AlexNet` on ``device``. ``weight_bits`` is 8, or 4 for int4
    weight-only (conv2-5 packed channel-split, conv1's Cin = 3 unpacked, the
    three dense layers packed split-half). ``backend`` is any of
    ``int_layers.CONV_BACKENDS`` for the convs (``"pallas"``, the port's
    default; the JAX package's default ``"xla"`` is an exact plain
    reference here)."""
    dev = resolve_device(device)
    int4 = weight_bits == 4
    convs: List[IntConv2d] = []
    for cn, bn in [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"), ("conv4", "bn4"), ("conv5", "bn5")]:
        conv = getattr(model, cn)
        if not isinstance(conv, QConv2d):
            raise TypeError(f"{cn} is {type(conv).__name__}, expected QConv2d "
                            "(build_int8_alexnet needs the quantized flavor)")
        convs.append(_convert_conv(conv, getattr(model, bn), weight_bits, backend, int4_pack=int4))
    for fn in ("fc1", "fc2", "fc3"):
        if not isinstance(getattr(model, fn), QLinear):
            raise TypeError(f"{fn} must be QLinear")
    fcs = [
        _convert_linear(model.fc1, model.bnf1, weight_bits, int4_pack=int4),
        _convert_linear(model.fc2, model.bnf2, weight_bits, int4_pack=int4),
        _convert_linear(model.fc3, None, weight_bits, int4_pack=int4),
    ]
    # each layer requantizes onto its next consumer's grid
    grids = [observer_grid(getattr(model, name)) for name in ("conv2", "conv3", "conv4", "conv5", "fc1",
                                                               "fc2", "fc3")]
    neg_masks = [_neg_mask(model.bn1), _neg_mask(model.bn2), _neg_mask(model.bn5)]
    eng = Int8AlexNet(convs, fcs, grids, neg_masks)
    eng.input_size = getattr(model, "input_size", 224)
    return eng.to(dev)
