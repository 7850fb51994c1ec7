"""What the references share: conv descriptors, the seeded drawing of the
float parameters on the device, and the calibrating conv + BN of the float
forward."""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


class ConvSpec(NamedTuple):
    name: str  # the conv's parameter prefix
    bn: str  # its BN's parameter prefix
    cin: int
    cout: int
    k: int
    stride: int
    pad: int
    groups: int = 1


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


PARAM_STREAM = 1


def draw_params(cfg, specs: List[ConvSpec], features: int, seed: int, device) -> Params:
    """Every weight in two calls on ``device``: the kernels and the fc
    weight from one normal draw (fan-in scaled), the BN affines and the fc
    bias from one uniform draw. BN statistics start at (0, 1) and every
    observer range at (0, 0); the calibration fills both."""
    init = cfg["init"]
    classes = cfg["num_classes"]
    g = generator(seed, PARAM_STREAM, device)
    shapes = [(s.k, s.k, s.cin // s.groups, s.cout) for s in specs]
    sizes = [a * b * c * d for a, b, c, d in shapes] + [classes * features]
    normal = torch.randn(sum(sizes), generator=g, device=device)
    couts = [s.cout for s in specs]
    uniform = torch.rand(2 * sum(couts) + classes, generator=g, device=device)
    params: Params = {}
    off = 0
    for s, shape, n in zip(specs, shapes, sizes):
        fan_in = s.k * s.k * s.cin // s.groups
        params[f"{s.name}.kernel"] = normal[off:off + n].view(shape) * (2.0 / fan_in) ** 0.5
        off += n
    params["fc.weight"] = normal[off:].view(classes, features) * features ** -0.5
    glo, ghi = init["bn_gamma"]
    blo, bhi = init["bn_beta"]
    off = 0
    for s in specs:
        u = uniform[off:off + 2 * s.cout]
        off += 2 * s.cout
        params[f"{s.bn}.scale"] = glo + (ghi - glo) * u[:s.cout]
        params[f"{s.bn}.bias"] = blo + (bhi - blo) * u[s.cout:]
        params[f"{s.bn}.mean"] = torch.zeros(s.cout, device=device)
        params[f"{s.bn}.var"] = torch.ones(s.cout, device=device)
    params["fc.bias"] = (2.0 * uniform[off:] - 1.0) * features ** -0.5
    for name in [s.name for s in specs] + ["fc"]:
        params[f"{name}.quantize_input.running_min"] = torch.zeros(1, device=device)
        params[f"{name}.quantize_input.running_max"] = torch.zeros(1, device=device)
    return params


def range_of(params: Params, name: str, x: torch.Tensor) -> None:
    params[f"{name}.quantize_input.running_min"].fill_(float(x.min()))
    params[f"{name}.quantize_input.running_max"].fill_(float(x.max()))


def observe(params: Params, eps: float, calibrate: bool):
    """``cb(spec, x)``: conv then BN of NHWC float32 ``x``. With
    ``calibrate`` it first records the range of ``x`` as the conv's
    observer range, and sets the BN's statistics to the conv output's
    mean and biased variance over the batch."""

    def cb(spec: ConvSpec, x: torch.Tensor) -> torch.Tensor:
        if calibrate:
            range_of(params, spec.name, x)
        w = params[f"{spec.name}.kernel"].permute(3, 2, 0, 1)
        with no_tf32():
            y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=spec.stride, padding=spec.pad, groups=spec.groups)
        y = y.permute(0, 2, 3, 1)
        mean, var = params[f"{spec.bn}.mean"], params[f"{spec.bn}.var"]
        if calibrate:
            mean.copy_(y.mean(dim=(0, 1, 2)))
            var.copy_(((y - mean) ** 2).mean(dim=(0, 1, 2)))
        return (y - mean) * (torch.rsqrt(var + eps) * params[f"{spec.bn}.scale"]) + params[f"{spec.bn}.bias"]

    return cb
