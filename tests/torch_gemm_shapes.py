"""The (M, N, K) products that the engines give K1 and B6, for the tests of
``gemm_plan`` (CPU) and of the GEMM kernels (GPU): the fc heads of the
ResNets and MobileNet and AlexNet's fc1-3 at serving batches 1, 8, 32 and
128, and the "gemm" backend's im2col products of ResNet-50's 24 conv shapes
(``probes/sweep_conv.SHAPES``) at the same batches."""

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
