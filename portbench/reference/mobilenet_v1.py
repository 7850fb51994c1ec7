"""Plain reference of MobileNet-v1 (Howard et al. 2017, arXiv:1704.04861,
Table 1): the float network that the benchmark draws and calibrates, and
its int8 forward as the served engines compute it.

Geometry: 3x3/2 stem, 13 depthwise-separable blocks (3x3 depthwise conv,
BN, ReLU, 1x1 pointwise conv, BN, ReLU), global average pool, fc. Tensors
are NHWC, kernels HWIO (a depthwise kernel is (3, 3, 1, C)); parameter
names are the flax model's (``block0.dw.kernel``, ``block0.bn1.scale``...).

The int8 forward is a chain: each conv folds its BN, applies ReLU and
rounds onto the grid of the next conv; the last pointwise conv stays
float32 for the pool.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import quant
from portbench.reference.common import ConvSpec, draw_params, no_tf32, observe, range_of

Params = Dict[str, torch.Tensor]


def conv_specs(cfg) -> List[ConvSpec]:
    """Stem, then each block's depthwise and pointwise conv, in order."""
    wm = cfg["width_multiplier"]
    c = int(cfg["stem_width"] * wm)
    specs = [ConvSpec("conv1", "bn1", 3, c, 3, 2, 1)]
    for i, (cout_base, stride) in enumerate(cfg["blocks"]):
        cout = int(cout_base * wm)
        specs.append(ConvSpec(f"block{i}.dw", f"block{i}.bn1", c, c, 3, stride, 1, groups=c))
        specs.append(ConvSpec(f"block{i}.pw", f"block{i}.bn2", c, cout, 1, 1, 0))
        c = cout
    return specs


def fc_features(cfg) -> int:
    return conv_specs(cfg)[-1].cout


def make_params(cfg, seed: int, calib_u8: torch.Tensor) -> Params:
    """Weights drawn on ``calib_u8``'s device from ``seed``; BN statistics
    and observer ranges measured by a float forward over ``calib_u8``."""
    params = draw_params(cfg, conv_specs(cfg), fc_features(cfg), seed, calib_u8.device)
    with torch.no_grad():
        float_forward(cfg, params, calib_u8, calibrate=True)
    return params


def float_forward(cfg, params: Params, u8: torch.Tensor, calibrate: bool = False) -> torch.Tensor:
    """The float network (float32, NHWC); ``calibrate`` as in the ResNet
    reference."""
    cb = observe(params, cfg["bn_eps"], calibrate)
    x = quant.normalize_u8(u8)
    for spec in conv_specs(cfg):
        x = torch.relu(cb(spec, x))
    pooled = x.mean(dim=(1, 2))
    if calibrate:
        range_of(params, "fc", pooled)
    with no_tf32():
        return pooled @ params["fc.weight"].T + params["fc.bias"]


class Int8MobileNet:
    def __init__(self, cfg, params: Params, device, bits: int = 8):
        def grid(name):
            return quant.grid_from_range(float(params[f"{name}.quantize_input.running_min"][0]),
                                         float(params[f"{name}.quantize_input.running_max"][0]))

        specs = conv_specs(cfg)
        self.convs = []
        for s in specs:
            bn = tuple(params[f"{s.bn}.{k}"] for k in ("scale", "bias", "mean", "var"))
            self.convs.append(quant.QConv(params[f"{s.name}.kernel"], bn, cfg["bn_eps"], grid(s.name), bits,
                                          s.stride, s.pad, s.groups, device))
        self.fc = quant.QLinear(params["fc.weight"], params["fc.bias"], grid("fc"), bits, device)

    def __call__(self, u8: torch.Tensor) -> torch.Tensor:
        x = quant.ingest_u8(u8, self.convs[0].grid)
        for conv, nxt in zip(self.convs[:-1], self.convs[1:]):
            x = conv.requant(x, nxt.grid, relu=True)
        return self.fc(self.convs[-1].real(x, relu=True).mean(dim=(1, 2)))


def int8_forward(cfg, params: Params, device, bits: int = 8):
    return Int8MobileNet(cfg, params, device, bits)


def units(cfg) -> List[dict]:
    """The depthwise/pointwise pairs as units of work (see the ResNet
    reference's ``units``); the last pair's output is float32."""
    specs = conv_specs(cfg)
    side = (cfg["image_size"] + 2 * 1 - 3) // 2 + 1
    out = []
    n = len(cfg["blocks"])
    for i in range(n):
        dw, pw = specs[1 + 2 * i], specs[2 + 2 * i]
        so = (side + 2 * dw.pad - dw.k) // dw.stride + 1
        out.append({"name": f"block{i}", "layers": [(dw, side), (pw, so)], "in_side": side, "cin": dw.cin,
                    "out_side": so, "cout": pw.cout, "out_bytes": 1 if i + 1 < n else 4})
        side = so
    return out


def layer_shapes(cfg) -> List[Tuple[ConvSpec, int]]:
    out = [(conv_specs(cfg)[0], cfg["image_size"])]
    for u in units(cfg):
        out += u["layers"]
    return out
