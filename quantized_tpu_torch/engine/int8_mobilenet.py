"""Int8-resident MobileNet-v1 execution (counterpart of
``quantized_tpu/engine/int8_mobilenet.py``).

The net is a pure conv -> BN -> ReLU chain (stem + 13 depthwise-separable
blocks), so the resident form is the simple one: every conv's epilogue
folds its BN, applies ReLU and requantizes onto the next conv's frozen
observer grid; activations stay stored int8 from the input quantize to the
global average pool, which takes the last conv's f32 output (mean does not
commute with rounding).

On backend ``"pallas"`` the stem (3x3/s2 over Cin = 3) runs on kernel K2's
gather-K form, the 13 pointwise convs on K2's per-tap form, the 13
depthwise convs (``groups = C``) on the exact grouped path of
``int8_conv_xla`` (plain PyTorch, as the JAX package leaves them to XLA)
and the fc on K1. ``engine/fused.fuse_mobilenet_blocks`` rebuilds the chain
as stages, 12 of the 13 depthwise -> pointwise pairs on kernel B5. With
``weight_bits=4`` the pointwise convs keep packed int4 weights (the stem and
the depthwise convs have an odd Cin per group and stay int8 storage), and
no pair fuses.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.engine.convert import _convert_conv, _convert_linear, observer_grid
from quantized_tpu_torch.engine.int8_resident import u8_to_stored
from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear, quantize_input_stored
from quantized_tpu_torch.models.layers import QConv2d, QLinear

Grid = Tuple[float, int]


class Int8MobileNet(nn.Module):
    """Int8-resident MobileNet-v1: f32 NHWC images (``forward``) or raw
    uint8 NHWC images (:meth:`run_u8`) in, f32 logits out. Built by
    :func:`build_int8_mobilenet`."""

    def __init__(self, convs: List[IntConv2d], grids: List[Optional[Grid]], fc: IntLinear):
        super().__init__()
        if len(grids) != len(convs):
            raise ValueError(f"{len(convs)} convs but {len(grids)} output grids")
        for i, c in enumerate(convs):
            self.add_module(f"conv{i}", c)
        self.num_convs = len(convs)
        self.requant_grids = grids  # grids[i]: conv i's output grid (None: f32)
        self.input_grid = convs[0].grid  # survives fuse_mobilenet_blocks
        self.fc = fc
        self.fused_stages = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward_q(quantize_input_stored(x, *self.input_grid))

    def run_u8(self, u8: torch.Tensor, mean=None, std=None) -> torch.Tensor:
        """Forward from raw uint8 NHWC images (values 0..255)."""
        return self._forward_q(u8_to_stored(u8, self.input_grid, mean, std))

    def _forward_q(self, x_q: torch.Tensor) -> torch.Tensor:
        h = x_q
        if self.fused_stages:
            # the plan of engine/fused.fuse_mobilenet_blocks: each stage is a
            # FusedInt8DwPw pair or one conv
            for j in range(self.num_fused_stages):
                h = getattr(self, f"stage{j}")(h)
        else:
            for i in range(self.num_convs):
                h = getattr(self, f"conv{i}").run_q(h, relu=True, out_requant=self.requant_grids[i])
        return self.fc(h.mean(dim=(1, 2)))  # f32 from the last conv


def build_int8_mobilenet(model: nn.Module, weight_bits: int = 8, backend: str = "pallas",
                         device: DeviceLike = "cuda") -> Int8MobileNet:
    """Convert a calibrated ``mobilenet_quantized`` (frozen observers) into
    an :class:`Int8MobileNet` on ``device``, with int8 weights or, at
    ``weight_bits=4``, int4 (packed where the Cin per group is even; the fc
    stays unpacked). ``backend`` is any of ``int_layers.CONV_BACKENDS``:
    ``"pallas"`` (the port's default) or ``"gemm"`` run the stem and the
    pointwise convs on the kernels and the depthwise convs on the exact
    grouped path; ``"xla"``, ``"bf16"`` and their split forms run every
    conv, the depthwise ones included, on that plain path (the JAX
    package's default, ``"xla"``, is an exact reference here)."""
    dev = resolve_device(device)
    seq = [(model.conv1, model.bn1)]
    for i in range(model.num_blocks):
        b = getattr(model, f"block{i}")
        seq += [(b.dw, b.bn1), (b.pw, b.bn2)]

    convs: List[IntConv2d] = []
    for conv, bn in seq:
        if not isinstance(conv, QConv2d):
            raise TypeError(f"{type(conv).__name__}: build_int8_mobilenet needs the quantized flavor "
                            "(mobilenet_quantized)")
        convs.append(_convert_conv(conv, bn, weight_bits, backend, int4_pack=weight_bits == 4))
    # conv i requantizes onto conv i+1's observer grid; the last conv emits f32
    grids: List[Optional[Grid]] = [observer_grid(c) for c, _ in seq[1:]] + [None]

    if not isinstance(model.fc, QLinear):
        raise TypeError("model.fc must be QLinear")
    fc = _convert_linear(model.fc, None, weight_bits, int4_pack=False)
    eng = Int8MobileNet(convs, grids, fc)
    eng.input_size = getattr(model, "input_size", 224)
    return eng.to(dev)
