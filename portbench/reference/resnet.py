"""Plain reference of the ImageNet ResNets (He et al. 2015, arXiv:1512.03385):
the float network that the benchmark draws and calibrates, and its int8
forward as the served engines compute it.

Geometry: 7x7/2 stem, 3x3/2 max pool, four stages of bottleneck (1x1, 3x3
with the stage's stride, 1x1 at four times the width) or basic (3x3, 3x3)
blocks with a 1x1 strided projection where the shape changes, global
average pool, fc. Tensors are NHWC, kernels HWIO, and parameters carry the
names of the flax model this repository ports (``layer1.0.conv1.kernel``,
``layer1.0.bn1.scale``, ``layer1.0.conv1.quantize_input.running_min``...).

The int8 forward quantizes each activation once, onto the grid of the conv
that consumes it; a block adds its shortcut in float32 after dividing both
legs by the output step and rounds once onto the next block's grid; the
last block stays float32 for the pool.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import quant
from portbench.reference.common import ConvSpec, draw_params, no_tf32, observe, range_of

Params = Dict[str, torch.Tensor]


def _stage_strides(cfg) -> List[int]:
    return [1] + [2] * (len(cfg["layers"]) - 1)


def blocks(cfg) -> List[dict]:
    """Per block: its name, its convs (name, cin, cout, k, stride, pad) and
    its projection, in forward order."""
    expansion = 4 if cfg["block"] == "bottleneck" else 1
    out: List[dict] = []
    cin = cfg["stem_width"]
    for si, (n, width, stride) in enumerate(zip(cfg["layers"], cfg["widths"], _stage_strides(cfg))):
        for bi in range(n):
            s = stride if bi == 0 else 1
            p = f"layer{si + 1}.{bi}"
            cout = width * expansion
            if cfg["block"] == "bottleneck":
                convs = [ConvSpec(f"{p}.conv1", f"{p}.bn1", cin, width, 1, 1, 0),
                         ConvSpec(f"{p}.conv2", f"{p}.bn2", width, width, 3, s, 1),
                         ConvSpec(f"{p}.conv3", f"{p}.bn3", width, cout, 1, 1, 0)]
            else:
                convs = [ConvSpec(f"{p}.conv1", f"{p}.bn1", cin, width, 3, s, 1),
                         ConvSpec(f"{p}.conv2", f"{p}.bn2", width, cout, 3, 1, 1)]
            proj = None
            if s != 1 or cin != cout:
                proj = ConvSpec(f"{p}.downsample.conv", f"{p}.downsample.bn", cin, cout, 1, s, 0)
            out.append({"name": p, "convs": convs, "proj": proj, "cin": cin, "cout": cout, "stride": s})
            cin = cout
    return out


def conv_specs(cfg) -> List[ConvSpec]:
    specs = [ConvSpec("conv1", "bn1", 3, cfg["stem_width"], 7, 2, 3)]
    for b in blocks(cfg):
        specs += b["convs"] + ([b["proj"]] if b["proj"] else [])
    return specs


def fc_features(cfg) -> int:
    return cfg["widths"][-1] * (4 if cfg["block"] == "bottleneck" else 1)


def make_params(cfg, seed: int, calib_u8: torch.Tensor) -> Params:
    """Weights drawn on ``calib_u8``'s device from ``seed``; BN statistics
    and observer ranges measured by a float forward over ``calib_u8``."""
    params = draw_params(cfg, conv_specs(cfg), fc_features(cfg), seed, calib_u8.device)
    with torch.no_grad():
        float_forward(cfg, params, calib_u8, calibrate=True)
    return params


def float_forward(cfg, params: Params, u8: torch.Tensor, calibrate: bool = False) -> torch.Tensor:
    """The float network (float32, NHWC). With ``calibrate`` each BN takes
    the batch's mean and biased variance as its statistics and each
    observer the range of the input it sees."""
    eps = cfg["bn_eps"]
    x = quant.normalize_u8(u8)
    cb = observe(params, eps, calibrate)
    x = torch.relu(cb(ConvSpec("conv1", "bn1", 3, cfg["stem_width"], 7, 2, 3), x))
    x = torch.nn.functional.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    for b in blocks(cfg):
        convs = b["convs"]
        h = x
        for c in convs[:-1]:
            h = torch.relu(cb(c, h))
        h = cb(convs[-1], h)
        short = cb(b["proj"], x) if b["proj"] else x
        x = torch.relu(h + short)
    pooled = x.mean(dim=(1, 2))
    if calibrate:
        range_of(params, "fc", pooled)
    with no_tf32():
        return pooled @ params["fc.weight"].T + params["fc.bias"]


class Int8ResNet:
    """The int8 forward, built from float parameters and observer ranges."""

    def __init__(self, cfg, params: Params, device, bits: int = 8):
        eps = cfg["bn_eps"]

        def grid(name):
            return quant.grid_from_range(float(params[f"{name}.quantize_input.running_min"][0]),
                                         float(params[f"{name}.quantize_input.running_max"][0]))

        def qconv(spec: ConvSpec, g) -> quant.QConv:
            bn = tuple(params[f"{spec.bn}.{k}"] for k in ("scale", "bias", "mean", "var"))
            return quant.QConv(params[f"{spec.name}.kernel"], bn, eps, g, bits, spec.stride, spec.pad, 1, device)

        self.blocks = []
        bl = blocks(cfg)
        self.stem = qconv(ConvSpec("conv1", "bn1", 3, cfg["stem_width"], 7, 2, 3), grid("conv1"))
        self.stem_out = grid(bl[0]["convs"][0].name)
        for i, b in enumerate(bl):
            convs = [qconv(c, grid(c.name)) for c in b["convs"]]
            proj = qconv(b["proj"], convs[0].grid) if b["proj"] else None
            out = grid(bl[i + 1]["convs"][0].name) if i + 1 < len(bl) else None
            self.blocks.append((convs, proj, out))
        self.fc = quant.QLinear(params["fc.weight"], params["fc.bias"], grid("fc"), bits, device)

    @staticmethod
    def _block(convs, proj, out, x: torch.Tensor) -> torch.Tensor:
        h = x
        for c, nxt in zip(convs[:-1], convs[1:]):
            h = c.requant(h, nxt.grid, relu=True)
        last = convs[-1]
        in_scale, in_zp = convs[0].grid
        if out is None:
            y = last.real(h, relu=False)
            short = proj.real(x, relu=False) if proj else quant.dequantize(x, convs[0].grid)
            return torch.clamp_min(y + short, 0.0)
        s_out, zp_out = out
        shift = zp_out - 128
        y = last.prescaled(h, s_out, float(shift))
        if proj:
            short = proj.prescaled(x, s_out, 0.0)
        else:
            k = quant.f32(in_scale / s_out)
            short = x.to(torch.float32) * k + quant.f32((128 - in_zp) * (in_scale / s_out))
        return torch.clamp(torch.round(y + short), float(shift), 127.0).to(torch.int8)

    def __call__(self, u8: torch.Tensor) -> torch.Tensor:
        x = quant.ingest_u8(u8, self.stem.grid)
        x = quant.maxpool_3x3_s2(self.stem.requant(x, self.stem_out, relu=True))
        for convs, proj, out in self.blocks:
            x = self._block(convs, proj, out, x)
        return self.fc(x.mean(dim=(1, 2)))


def int8_forward(cfg, params: Params, device, bits: int = 8):
    return Int8ResNet(cfg, params, device, bits)


def stem_spatial(cfg) -> int:
    """Side of the first block's input: after the 7x7/2 stem and the 3x3/2 pool."""
    side = (cfg["image_size"] + 2 * 3 - 7) // 2 + 1
    return (side + 2 * 1 - 3) // 2 + 1


def units(cfg) -> List[dict]:
    """The residual blocks as units of work: each conv with the side of its
    input, the block's input and output (int8, or float32 for the last
    block, which feeds the pool)."""
    out = []
    side = stem_spatial(cfg)
    bl = blocks(cfg)
    for i, b in enumerate(bl):
        layers, hs = [], side
        for c in b["convs"]:
            layers.append((c, hs))
            hs = (hs + 2 * c.pad - c.k) // c.stride + 1
        if b["proj"]:
            layers.append((b["proj"], side))
        out.append({"name": b["name"], "layers": layers, "in_side": side, "cin": b["cin"], "out_side": hs,
                    "cout": b["cout"], "out_bytes": 1 if i + 1 < len(bl) else 4})
        side = hs
    return out


def layer_shapes(cfg) -> List[Tuple[ConvSpec, int]]:
    """Every conv with the side of its input (square images); the fc is apart."""
    out = [(conv_specs(cfg)[0], cfg["image_size"])]
    for u in units(cfg):
        out += u["layers"]
    return out
