"""The (M, N, K) products that the engines give K1 and B6, for the tests of
``gemm_plan`` (CPU) and of the GEMM kernels (GPU): the fc heads of the
ResNets and MobileNet and AlexNet's fc1-3 at serving batches 1, 8, 32 and
128, and the "gemm" backend's im2col products of ResNet-50's 24 conv shapes
(``probes/sweep_conv.SHAPES``) at the same batches; and the calls that the
engines make to K2 (``engine_conv_calls``), for the tests of ``conv_plan``."""

import functools
from typing import NamedTuple, Optional

import torch

from quantized_tpu_torch.ops.int8_matmul import gemm_plan
from quantized_tpu_torch.probes.gemm_sweep import BATCHES, FC, INT4_FC
from quantized_tpu_torch.probes.sweep_conv import SHAPES

# (m, k, n, packed): products whose K split ends in a partial 128-byte stage
# at a K that TMA takes (K % 16 == 0; B6: Kh % 16 == 0, Kh % 128 != 0).
# B6's last low-half activation box then reaches past Kh into the high
# half's columns, which meet zero-filled weight bytes.
RAGGED_SPLIT = [(32, 1184, 1000, False), (9, 416, 70, True), (33, 1184, 1000, True)]


def fc_products():
    """(label, m, n, k) of every fc head at every batch."""
    return [(f"{name} batch {b}", b, n, k) for name, (n, k) in FC.items() for b in BATCHES]


def conv_products():
    """(label, m, n, k) of the im2col GEMM of each ResNet-50 conv shape."""
    out = []
    for name, h, cin, cout, k, stride, _ in SHAPES:
        pad = k // 2 if k > 1 else 0
        ho = (h + 2 * pad - k) // stride + 1
        out += [(f"{name} batch {b}", b * ho * ho, cout, k * k * cin) for b in BATCHES]
    return out


def distinct_plans(packed: bool):
    """One product per distinct (tile, split, stages) of the plans that the
    engines' products get (B6: AlexNet's fc1-3), the cheapest of each; the
    TMA path's products only (the general path has no plan)."""
    products = ([p for p in fc_products() if p[0].rsplit(" batch", 1)[0] in INT4_FC] if packed
                else fc_products() + conv_products())
    chosen = {}
    for label, m, n, k in sorted(products, key=lambda p: p[1] * p[2] * p[3]):
        plan = gemm_plan(m, n, k, packed=packed)
        if plan.tma_shape:
            chosen.setdefault((plan.tile, plan.split, plan.stages), (label, m, n, k))
    return sorted(chosen.values())


class ConvCall(NamedTuple):
    """One call of an engine to K2's wrapper, at batch 1."""
    engine: str
    h: int
    w: int
    cin: int
    cout: int
    kernel_size: tuple
    stride: tuple
    padding: tuple
    stored_zp: int
    w_ck: torch.Tensor  # the packed weights
    border_sums: Optional[torch.Tensor]  # what the layer passes (IntConv2d.border_sums)
    alpha: Optional[torch.Tensor] = None
    beta: Optional[torch.Tensor] = None
    pixel_groups: Optional[tuple] = None  # what the layer passes (IntConv2d.pg_w_ck, pg_alpha, pg_beta)


# name: (registered model, its config); each served at 224x224
CONV_ENGINES = {
    "resnet50": ("resnet_quantized_float_bn", dict(dataset="imagenet", depth=50)),
    "resnet18": ("resnet_quantized_float_bn", dict(dataset="imagenet", depth=18)),
    "mobilenet": ("mobilenet_quantized", dict(num_classes=1000, width_mult=1.0)),
    "alexnet": ("alexnet_quantized", dict(num_classes=1000)),
}
# the engines whose gather-K calls the tests check: the four above, MobileNet
# at width 0.75 (its stem's Cout 24) and CIFAR ResNet-20 at 32x32 (14
# gather-K convs: the stem and the block convs over Cin 16 and 32)
GATHERK_ENGINES = {
    **CONV_ENGINES,
    "mobilenet w0.75": ("mobilenet_quantized", dict(num_classes=1000, width_mult=0.75)),
    "cifar20": ("resnet_quantized_float_bn", dict(dataset="cifar10", depth=20)),
}
ENGINE_SIDES = {"cifar20": 32}  # the others: 224


@functools.lru_cache(maxsize=None)
def engine_conv_calls(name: str):
    """Every K2 call (per-tap and gather-K) of one batch-1 forward (224x224;
    CIFAR: 32x32) of an int8 engine built on the CPU from seed 0; the convs
    themselves are not computed (each call returns zeros of its output's
    shape and type)."""
    from quantized_tpu_torch.engine import build_int8_alexnet, build_int8_mobilenet, build_int8_resident
    from quantized_tpu_torch.engine import int_layers
    from quantized_tpu_torch.entry import _calibrated_model
    from quantized_tpu_torch.ops.int8_conv_pallas import conv_out_hw

    model_name, cfg = GATHERK_ENGINES[name]
    side = ENGINE_SIDES.get(name, 224)
    model = _calibrated_model(model_name, device="cpu", generator=torch.Generator().manual_seed(0), **cfg)
    build = {"resnet_quantized_float_bn": build_int8_resident, "mobilenet_quantized": build_int8_mobilenet,
             "alexnet_quantized": build_int8_alexnet}[model_name]
    engine = build(model, backend="pallas", device="cpu")
    calls = []

    def record(x_q, w_ck, kernel_size, alpha, beta, stride, padding, stored_zp, relu, out_requant,
               border_sums=None, pixel_groups=None, **_):
        n, h, w, cin = x_q.shape
        ho, wo = conv_out_hw(h, w, kernel_size, stride, padding)
        calls.append(ConvCall(name, h, w, cin, w_ck.shape[0], tuple(kernel_size), tuple(stride), tuple(padding),
                              int(stored_zp), w_ck, border_sums, alpha, beta, pixel_groups))
        dtype = torch.float32 if out_requant is None else torch.int8
        return torch.zeros((n, ho, wo, w_ck.shape[0]), dtype=dtype)

    real = int_layers.int8_conv_direct_ck
    int_layers.int8_conv_direct_ck = record
    try:
        with torch.inference_mode():
            engine.run_u8(torch.zeros((1, side, side, 3), dtype=torch.uint8))
    finally:
        int_layers.int8_conv_direct_ck = real
    return tuple(calls)
