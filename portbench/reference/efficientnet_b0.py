"""Plain reference of EfficientNet-B0 (Tan & Le 2019, arXiv:1905.11946,
Table 1; the block arguments of the authors' ``efficientnet_builder.py``):
the float network that the benchmark draws and calibrates, and its int8
forward in the integer scheme of the program's engine.

Geometry (the configuration's ``blocks``, ``stem_width``, ``head_width``):
a 3x3/2 stem with BN and SiLU; MBConv blocks, each a 1x1 expand conv with
BN and SiLU (none at expansion 1), a kxk depthwise conv with BN and SiLU,
squeeze-excitation (the global mean, a 1x1 reduce conv with bias to
``max(1, int(0.25 * block_in))`` channels and SiLU, a 1x1 expand conv with
bias and the sigmoid, the product), a 1x1 project conv with BN and the
identity skip where the stride is 1 and the width is kept; a 1x1 head conv
with BN and SiLU, the global mean, an fc. Tensors are NHWC, kernels HWIO;
parameter names are the program's model's (``block3.dw.kernel``,
``block3.se.reduce.bias``, ``block3.dw_quant.running_min``...).

Departures from the paper: the padding is a symmetric ``k // 2`` (the
release pads "same", asymmetric at stride 2); BN eps is 1e-3 (the
release's); the weights are random from the seed; and the int8 forward
stores each depthwise output on a grid of its own, observed after its SiLU
(``dw_quant``), a point the float network does not round at.

The int8 forward: every conv and linear takes its input on its own uint8
observer grid, int8 weights symmetric per output channel with the BN folded
(``quant.QConv``, ``quant.QLinear``), the exact integer accumulator, ``y =
acc * alpha + beta`` in float32, its activation (SiLU ``y / (1 + exp(-y))``,
the sigmoid ``1 / (1 + exp(-y))``, each operation rounded once, divisions
tensor by tensor), then ``quant.quantize`` onto the consumer's grid. The
squeeze is the exact int32 sum of the stored depthwise output over an
image, its mean ``f32(sum + HW * (128 - zp)) * f32(s) / f32(HW)`` quantized
onto the reduce conv's grid; the gate pass ``quantize(dequantize(d) * g)``
onto the project conv's grid; a skip adds the dequantized block input to the
project conv's ``y`` before its requant; the head's f32 output is pooled
and the fc takes the mean on its own grid. Only ``torch`` and ``numpy``: no
kernel, no module of the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import quant
from portbench.reference.common import ConvSpec, draw_params, generator, no_tf32, observe, range_of

Params = Dict[str, torch.Tensor]
SE_STREAM = 7  # the seed's stream of the SE convs' weights and biases


def block_specs(cfg) -> List[dict]:
    """Each block's convs (``expand`` None at expansion 1, ``dw``,
    ``reduce``, ``se_expand``, ``project``), its input and output sides,
    and whether it has the skip."""
    out, cin, side = [], cfg["stem_width"], (cfg["image_size"] + 2 - 3) // 2 + 1
    i = 0
    for expand, k, stride, cout, repeats in cfg["blocks"]:
        for r in range(repeats):
            s = stride if r == 0 else 1
            mid, sq, p = cin * expand, max(1, int(0.25 * cin)), f"block{i}"
            so = (side + 2 * (k // 2) - k) // s + 1
            out.append({
                "name": p, "in_side": side, "out_side": so, "cin": cin, "cout": cout, "skip": s == 1 and cin == cout,
                "expand": ConvSpec(f"{p}.expand", f"{p}.bn0", cin, mid, 1, 1, 0) if expand != 1 else None,
                "dw": ConvSpec(f"{p}.dw", f"{p}.bn1", mid, mid, k, s, k // 2, groups=mid),
                "reduce": ConvSpec(f"{p}.se.reduce", "", mid, sq, 1, 1, 0),
                "se_expand": ConvSpec(f"{p}.se.expand", "", sq, mid, 1, 1, 0),
                "project": ConvSpec(f"{p}.project", f"{p}.bn2", mid, cout, 1, 1, 0),
            })
            cin, side, i = cout, so, i + 1
    return out


def stem_spec(cfg) -> ConvSpec:
    return ConvSpec("conv1", "bn1", 3, cfg["stem_width"], 3, 2, 1)


def head_spec(cfg) -> ConvSpec:
    return ConvSpec("head", "bn_head", cfg["blocks"][-1][3], cfg["head_width"], 1, 1, 0)


def fc_features(cfg) -> int:
    return cfg["head_width"]


def make_params(cfg, seed: int, calib_u8: torch.Tensor) -> Params:
    """Weights drawn on ``calib_u8``'s device from ``seed``; BN statistics
    and observer ranges measured by a float forward over ``calib_u8``. The
    BN'd convs and the fc as the other references draw them; the SE convs'
    kernels (normal, fan-in scaled) and biases (uniform on
    ``init.se_bias``) from a stream of their own."""
    blocks = block_specs(cfg)
    bn_convs = [stem_spec(cfg)]
    for b in blocks:
        bn_convs += [s for s in (b["expand"], b["dw"], b["project"]) if s is not None]
    bn_convs.append(head_spec(cfg))
    device = calib_u8.device
    params = draw_params(cfg, bn_convs, fc_features(cfg), seed, device)
    se = [s for b in blocks for s in (b["reduce"], b["se_expand"])]
    g = generator(seed, SE_STREAM, device)
    normal = torch.randn(sum(s.cin * s.cout for s in se), generator=g, device=device)
    uniform = torch.rand(sum(s.cout for s in se), generator=g, device=device)
    lo, hi = cfg["init"]["se_bias"]
    kn = bn = 0
    for s in se:
        n = s.cin * s.cout
        params[f"{s.name}.kernel"] = normal[kn:kn + n].view(1, 1, s.cin, s.cout) * (2.0 / s.cin) ** 0.5
        params[f"{s.name}.bias"] = lo + (hi - lo) * uniform[bn:bn + s.cout]
        kn, bn = kn + n, bn + s.cout
    for name in [s.name for s in se] + [f"{b['name']}.dw_quant" for b in blocks]:
        key = name if name.endswith("dw_quant") else f"{name}.quantize_input"
        params[f"{key}.running_min"] = torch.zeros(1, device=device)
        params[f"{key}.running_max"] = torch.zeros(1, device=device)
    with torch.no_grad():
        float_forward(cfg, params, calib_u8, calibrate=True)
    return params


def _dw_range(params: Params, name: str, x: torch.Tensor) -> None:
    params[f"{name}.dw_quant.running_min"].fill_(float(x.min()))
    params[f"{name}.dw_quant.running_max"].fill_(float(x.max()))


def float_forward(cfg, params: Params, u8: torch.Tensor, calibrate: bool = False) -> torch.Tensor:
    """The float network (float32, NHWC); ``calibrate`` as in the ResNet
    reference, and each block's depthwise output range into ``dw_quant``."""
    cb = observe(params, cfg["bn_eps"], calibrate)

    def se_conv(spec, x):
        if calibrate:
            range_of(params, spec.name, x)
        w = params[f"{spec.name}.kernel"].reshape(spec.cin, spec.cout)
        with no_tf32():
            return x @ w + params[f"{spec.name}.bias"]

    x = F.silu(cb(stem_spec(cfg), quant.normalize_u8(u8)))
    for b in block_specs(cfg):
        h = x if b["expand"] is None else F.silu(cb(b["expand"], x))
        h = F.silu(cb(b["dw"], h))
        if calibrate:
            _dw_range(params, b["name"], h)
        s = F.silu(se_conv(b["reduce"], h.mean(dim=(1, 2))))
        h = h * torch.sigmoid(se_conv(b["se_expand"], s))[:, None, None, :]
        h = cb(b["project"], h)
        x = x + h if b["skip"] else h
    pooled = F.silu(cb(head_spec(cfg), x)).mean(dim=(1, 2))
    if calibrate:
        range_of(params, "fc", pooled)
    with no_tf32():
        return pooled @ params["fc.weight"].T + params["fc.bias"]


def silu(y: torch.Tensor) -> torch.Tensor:
    return y / (1.0 + torch.exp(-y))


def sigmoid(y: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(y) / (1.0 + torch.exp(-y))


class _Block:
    def __init__(self, spec: dict, params: Params, grid, eps: float, bits: int, device):
        def conv(s: Optional[ConvSpec]):
            if s is None:
                return None
            bn = tuple(params[f"{s.bn}.{k}"] for k in ("scale", "bias", "mean", "var"))
            return quant.QConv(params[f"{s.name}.kernel"], bn, eps, grid(s.name), bits, s.stride, s.pad, s.groups,
                               device)

        def linear(s: ConvSpec):
            w = params[f"{s.name}.kernel"].reshape(s.cin, s.cout).T
            return quant.QLinear(w, params[f"{s.name}.bias"], grid(s.name), bits, device)

        self.expand, self.dw, self.project = conv(spec["expand"]), conv(spec["dw"]), conv(spec["project"])
        self.reduce, self.se_expand = linear(spec["reduce"]), linear(spec["se_expand"])
        name = spec["name"]
        self.dw_grid = quant.grid_from_range(float(params[f"{name}.dw_quant.running_min"][0]),
                                             float(params[f"{name}.dw_quant.running_max"][0]))
        self.skip = spec["skip"]
        self.in_grid = (self.expand or self.dw).grid

    @staticmethod
    def _linear(lin: quant.QLinear, x_s: torch.Tensor) -> torch.Tensor:
        acc = torch.round(x_s.to(torch.float64) @ lin.weight.T).to(torch.float32)
        return acc * lin.alpha + lin.beta

    def __call__(self, x: torch.Tensor, out_grid) -> torch.Tensor:
        h = x if self.expand is None else quant.quantize(silu(self.expand.real(x, False)), self.dw.grid)
        d = quant.quantize(silu(self.dw.real(h, False)), self.dw_grid)
        hw = d.shape[1] * d.shape[2]
        total = d.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32) + hw * (128 - self.dw_grid[1])
        mean = total.to(torch.float32) * quant.f32(self.dw_grid[0])
        pooled = quant.quantize(mean / torch.full_like(mean, float(hw)), self.reduce.grid)
        r = quant.quantize(silu(self._linear(self.reduce, pooled)), self.se_expand.grid)
        g = sigmoid(self._linear(self.se_expand, r))
        gated = quant.quantize(quant.dequantize(d, self.dw_grid) * g[:, None, None, :], self.project.grid)
        y = self.project.real(gated, False)
        if self.skip:
            y = y + quant.dequantize(x, self.in_grid)
        return quant.quantize(y, out_grid)


class Int8EfficientNet:
    def __init__(self, cfg, params: Params, device, bits: int = 8):
        def grid(name):
            return quant.grid_from_range(float(params[f"{name}.quantize_input.running_min"][0]),
                                         float(params[f"{name}.quantize_input.running_max"][0]))

        eps = cfg["bn_eps"]

        def conv(s: ConvSpec):
            bn = tuple(params[f"{s.bn}.{k}"] for k in ("scale", "bias", "mean", "var"))
            return quant.QConv(params[f"{s.name}.kernel"], bn, eps, grid(s.name), bits, s.stride, s.pad, s.groups,
                               device)

        self.stem, self.head = conv(stem_spec(cfg)), conv(head_spec(cfg))
        self.blocks = [_Block(b, params, grid, eps, bits, device) for b in block_specs(cfg)]
        self.fc = quant.QLinear(params["fc.weight"], params["fc.bias"], grid("fc"), bits, device)

    def block_outputs(self, u8: torch.Tensor) -> List[torch.Tensor]:
        """The stored int8 activations at each block boundary: the stem's
        output, then each block's."""
        x = quant.ingest_u8(u8, self.stem.grid)
        x = quant.quantize(silu(self.stem.real(x, False)), self.blocks[0].in_grid)
        out = [x]
        grids = [b.in_grid for b in self.blocks[1:]] + [self.head.grid]
        for b, g in zip(self.blocks, grids):
            x = b(x, g)
            out.append(x)
        return out

    def __call__(self, u8: torch.Tensor) -> torch.Tensor:
        x = self.block_outputs(u8)[-1]
        return self.fc(silu(self.head.real(x, False)).mean(dim=(1, 2)))


def int8_forward(cfg, params: Params, device, bits: int = 8):
    return Int8EfficientNet(cfg, params, device, bits)


def units(cfg) -> List[dict]:
    """The MBConv blocks as units of work (see the ResNet reference's
    ``units``): each block's convs, the SE's two at side 1; its input,
    weights and int8 output."""
    out = []
    for b in block_specs(cfg):
        side, so = b["in_side"], b["out_side"]
        layers = [(b["expand"], side)] if b["expand"] is not None else []
        layers += [(b["dw"], side), (b["reduce"], 1), (b["se_expand"], 1), (b["project"], so)]
        out.append({"name": b["name"], "layers": layers, "in_side": side, "cin": b["cin"], "out_side": so,
                    "cout": b["cout"], "out_bytes": 1})
    return out


def layer_shapes(cfg) -> List[Tuple[ConvSpec, int]]:
    """Every conv with its input side: the stem, each block's (the SE convs
    at side 1) and the head."""
    out = [(stem_spec(cfg), cfg["image_size"])]
    for u in units(cfg):
        out += u["layers"]
    return out + [(head_spec(cfg), units(cfg)[-1]["out_side"])]
