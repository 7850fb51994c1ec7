"""Int8-resident EfficientNet-B0 execution. Port only: the JAX package has
no EfficientNet, so the engine is held against the plain reference
(``portbench/reference/efficientnet_b0.py``), which computes the same
integer scheme in plain PyTorch.

The integer scheme. Every conv and linear takes its input on its own uint8
observer grid (stored int8, ``u - 128``), int8 weights symmetric per output
channel with the BN folded, an int32 accumulator and the f32 epilogue ``y =
acc * alpha + beta``, then its activation in f32, then the requant
``clip(round(y * f32(1/s) + f32(zp - 128)), -128, 127)`` onto its
consumer's grid. By part, all on backend ``"pallas"`` (no other route; the
tuner does not touch the engine):

- stem: K2's gather-K form, SiLU, onto block 0's grid;
- ``block<k>.expand``: K2 per tap (pixel groups where Cin % 16 != 0), SiLU,
  onto the depthwise conv's grid; block 0 has none;
- ``block<k>.dw``: the depthwise kernel (``ops.mbconv.dw_conv``), SiLU, onto
  ``dw_quant``'s grid, with the exact int32 sums of its output a (image,
  channel) in the same pass;
- ``block<k>.se``: the squeeze (``ops.mbconv.se_squeeze``: the means from
  the sums onto the reduce conv's grid), reduce on K1 with SiLU onto the
  expand conv's grid, expand on K1 with the sigmoid (f32, the gate ``g``),
  and the gate pass (``ops.mbconv.se_gate``: the depthwise output times
  ``g`` onto the project conv's grid);
- ``block<k>.project``: K2 per tap with no activation onto the next block's
  grid; where the block has a skip, K2's residual form (B8), which adds the
  dequantized block input before the requant;
- head: K2 per tap with SiLU, f32 out; the global mean; the fc on K1.

K1's route follows its K (``ops.int8_matmul.gemm_route``): the reduce
(K the expanded width), the fc and the expand over a squeeze width that is
a multiple of 16 (B0's last four blocks, 48) take its Hopper route; the
expands over squeeze widths 4-28 (B0's other twelve) its general tile
kernel. On the H100 the tile is the faster of the two there: the Hopper
route on a squeeze width padded to 16 cost about 0.15 ms a batch of 128.

With ``weight_bits=4`` the expand, project and head convs keep packed int4
weights (K2 unpacks them on each call), as MobileNet's pointwise convs do;
the stem, the depthwise and SE convs and the fc hold int4-grid weights in
int8 storage.

Each block is a submodule ``block<k>`` whose parts ``expand``, ``dw``,
``se`` and ``project`` are submodules too, so module hooks time a block and
its parts. With the span recorder on (``utils.profiling``), a block records
the span ``efficientnet.block`` cut into the phases ``efficientnet.expand``,
``efficientnet.dw``, ``efficientnet.se`` and ``efficientnet.project``.
:meth:`Int8EfficientNet.routes` gives the last forward's count of each new
part by route (``"sm90"``: the kernel; ``"plain"``: the plain PyTorch
version, on the CPU).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.engine.convert import _convert_conv, _convert_linear, observer_grid
from quantized_tpu_torch.engine.int8_resident import u8_to_stored
from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear, quantize_input_stored
from quantized_tpu_torch.ingest.calibrate import activation_qparams_from_observer
from quantized_tpu_torch.models.efficientnet import EfficientNet
from quantized_tpu_torch.models.layers import QConv2d
from quantized_tpu_torch.ops.int8_conv_pallas import int8_conv_direct_ck
from quantized_tpu_torch.ops.int8_matmul import ACT_SIGMOID, ACT_SILU, int8_matmul_nk, int8_matmul_requant_nk
from quantized_tpu_torch.ops.mbconv import dw_conv, dw_weight_words, se_gate, se_squeeze
from quantized_tpu_torch.utils import profiling

Grid = Tuple[float, int]
PARTS = ("dw", "squeeze", "gate")  # the parts on the MBConv kernels, counted by route
ROUTES = ("sm90", "plain")


def _route(x: torch.Tensor) -> str:
    return "sm90" if x.is_cuda else "plain"


class IntDepthwise(nn.Module):
    """The depthwise conv with SiLU onto ``out_grid``; returns the int8
    output and its (N, C) int32 sums."""

    def __init__(self, conv: IntConv2d, out_grid: Grid):
        super().__init__()
        k = conv.kernel_size[0]
        c = conv.alpha.shape[0]
        w = conv.weights().reshape(k, k, c).contiguous()  # HWIO (k, k, 1, C)
        self.register_buffer("w", w)
        self.register_buffer("words", dw_weight_words(w))
        self.register_buffer("alpha", conv.alpha)
        self.register_buffer("beta", conv.beta)
        self.grid, self.out_grid, self.stride = conv.grid, out_grid, conv.stride[0]
        self.route: Optional[str] = None

    def forward(self, x_q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        self.route = _route(x_q)
        return dw_conv(x_q, self.w, self.alpha, self.beta, self.stride, self.grid[1] - 128, ACT_SILU, self.out_grid,
                       words=self.words)


class IntSqueezeExcite(nn.Module):
    """The squeeze from the depthwise sums, reduce (K1, SiLU), expand (K1,
    the sigmoid) and the gate pass onto ``out_grid``."""

    def __init__(self, reduce: IntLinear, expand: IntLinear, in_grid: Grid, out_grid: Grid):
        super().__init__()
        self.reduce, self.expand = reduce, expand
        self.in_grid, self.out_grid = in_grid, out_grid
        self.route: Optional[str] = None

    def forward(self, x_q: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
        self.route = _route(x_q)
        r, e = self.reduce, self.expand
        pooled = se_squeeze(sums, x_q.shape[1] * x_q.shape[2], self.in_grid, r.grid)
        h = int8_matmul_requant_nk(pooled, r.w_nk, r.alpha, r.beta, *e.grid, relu=ACT_SILU)
        gate = int8_matmul_nk(h, e.w_nk, e.alpha, e.beta, relu=ACT_SIGMOID)
        return se_gate(x_q, gate, self.in_grid, self.out_grid)


class Int8MBConv(nn.Module):
    """One block: ``expand`` (None where the expansion is 1), ``dw``,
    ``se`` and ``project``; the input arrives on ``in_grid``, the output
    leaves on ``out_grid``."""

    def __init__(self, expand: Optional[IntConv2d], dw: IntDepthwise, se: IntSqueezeExcite, project: IntConv2d,
                 in_grid: Grid, out_grid: Grid, skip: bool):
        super().__init__()
        self.expand, self.dw, self.se, self.project = expand, dw, se, project
        self.in_grid, self.out_grid, self.skip = in_grid, out_grid, skip

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        with profiling.span("efficientnet.block") as span:
            phase = profiling.phases(span, "efficientnet.expand")
            h = x_q if self.expand is None else self.expand.run_q(x_q, relu=ACT_SILU, out_requant=self.dw.grid)
            phase.next("efficientnet.dw")
            d, sums = self.dw(h)
            phase.next("efficientnet.se")
            g = self.se(d, sums)
            phase.next("efficientnet.project")
            if not self.skip:
                return self.project.run_q(g, relu=False, out_requant=self.out_grid)
            p = self.project
            return int8_conv_direct_ck(g, p.weights_ck(), (1, 1), p.alpha, p.beta, stored_zp=p.stored_zp,
                                       out_requant=self.out_grid, residual=x_q, res_grid=self.in_grid)


class Int8EfficientNet(nn.Module):
    """Int8-resident EfficientNet: f32 NHWC images (``forward``) or raw
    uint8 NHWC images (:meth:`run_u8`) in, f32 logits out. Built by
    :func:`build_int8_efficientnet`."""

    def __init__(self, stem: IntConv2d, blocks: List[Int8MBConv], head: IntConv2d, fc: IntLinear):
        super().__init__()
        self.stem = stem
        for i, b in enumerate(blocks):
            self.add_module(f"block{i}", b)
        self.num_blocks = len(blocks)
        self.head, self.fc = head, fc
        self.input_grid = stem.grid
        self.stem_out_grid = blocks[0].in_grid

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward_q(quantize_input_stored(x, *self.input_grid))

    def run_u8(self, u8: torch.Tensor, mean=None, std=None) -> torch.Tensor:
        """Forward from raw uint8 NHWC images (values 0..255)."""
        return self._forward_q(u8_to_stored(u8, self.input_grid, mean, std))

    def blocks(self) -> List[Int8MBConv]:
        return [getattr(self, f"block{i}") for i in range(self.num_blocks)]

    def block_outputs(self, x_q: torch.Tensor) -> List[torch.Tensor]:
        """The stored int8 activations at each block boundary: the stem's
        output, then each block's."""
        h = self.stem.run_q(x_q, relu=ACT_SILU, out_requant=self.stem_out_grid)
        out = [h]
        for b in self.blocks():
            h = b(h)
            out.append(h)
        return out

    def _forward_q(self, x_q: torch.Tensor) -> torch.Tensor:
        h = self.block_outputs(x_q)[-1]
        return self.fc(self.head.run_q(h, relu=ACT_SILU).mean(dim=(1, 2)))  # f32 from the head

    def routes(self) -> Dict[str, int]:
        """The last forward's launches of the depthwise conv, the squeeze and
        the gate pass, by route: ``{"dw.sm90": 16, "dw.plain": 0, ...}``."""
        seen = Counter()
        for b in self.blocks():
            seen[f"dw.{b.dw.route}"] += 1
            seen[f"squeeze.{b.se.route}"] += 1
            seen[f"gate.{b.se.route}"] += 1
        return {f"{part}.{route}": seen[f"{part}.{route}"] for part in PARTS for route in ROUTES}


def _grid(observer) -> Grid:
    """(scale, zero_point) of a frozen ``QuantMeasure``."""
    qp = activation_qparams_from_observer(float(observer.running_min[0]), float(observer.running_max[0]))
    return (qp.scale, qp.zero_point)


def _linear_1x1(conv: QConv2d, weight_bits: int) -> IntLinear:
    """A 1x1 conv with bias on a 1x1 input (the SE's) as a K1 product."""
    c = _convert_conv(conv, None, weight_bits, "pallas")
    return IntLinear(c.w_ck.T.contiguous(), c.alpha, c.beta, c.act_scale, c.act_zero_point)


def build_int8_efficientnet(model: nn.Module, weight_bits: int = 8, backend: str = "pallas",
                            device: DeviceLike = "cuda") -> Int8EfficientNet:
    """Convert a calibrated ``efficientnet_quantized`` (frozen observers)
    into an :class:`Int8EfficientNet` on ``device``, with int8 weights or,
    at ``weight_bits=4``, int4 (packed for the expand, project and head
    convs). ``backend`` must be ``"pallas"``, the engine's one route: the
    other conv backends compute ReLU alone, not SiLU."""
    if not isinstance(model, EfficientNet) or not isinstance(model.conv1, QConv2d):
        raise TypeError(f"{type(model).__name__}: build_int8_efficientnet needs the quantized flavor "
                        "(efficientnet_quantized)")
    if backend != "pallas":
        raise ValueError(f"build_int8_efficientnet runs on backend 'pallas' alone, not {backend!r}")
    dev = resolve_device(device)
    packed = weight_bits == 4

    def conv(q, bn, pack=False):
        return _convert_conv(q, bn, weight_bits, backend, int4_pack=pack and packed)

    src = [getattr(model, f"block{i}") for i in range(model.num_blocks)]
    firsts = [b.expand if b.expand is not None else b.dw for b in src]
    outs = [observer_grid(q) for q in firsts[1:]] + [observer_grid(model.head)]
    blocks = []
    for b, first, out_grid in zip(src, firsts, outs):
        dw_out = _grid(b.dw_quant)
        project = conv(b.project, b.bn2, pack=True)
        se = IntSqueezeExcite(_linear_1x1(b.se.reduce, weight_bits), _linear_1x1(b.se.expand, weight_bits), dw_out,
                              project.grid)
        expand = None if b.expand is None else conv(b.expand, b.bn0, pack=True)
        blocks.append(Int8MBConv(expand, IntDepthwise(conv(b.dw, b.bn1), dw_out), se, project,
                                 observer_grid(first), out_grid, b.skip))
    fc = _convert_linear(model.fc, None, weight_bits, int4_pack=False)
    eng = Int8EfficientNet(conv(model.conv1, model.bn1), blocks, conv(model.head, model.bn_head, pack=True), fc)
    eng.input_size = getattr(model, "input_size", 224)
    return eng.to(dev)
