"""The launch plan of the Hopper GEMM (``gemm_plan``, shared by K1 and B6)
over every product the engines give those kernels, and the plain K1 and B6
against the JAX package's ``int8_matmul``, ``int8_matmul_requant`` and
``int4_matmul`` (Pallas, interpret mode) at the edges of the plan's K split.

The plan is plain Python, so its bounds are checked here: the splits cover
K exactly once in whole 32-byte wgmma steps, none empty; a block's shared
memory stays within the H100's 232,448 bytes; the tile width (wgmma's N) is
a multiple of 8 up to 256 and holds the batch; a cluster has at most 8
blocks; every fc head fills at least 64 of the 132 SMs.

The plain versions compute the same function whatever the plan, so the
JAX comparisons hold the kernels' function at K = the split's full width
and one byte either side. f32 outputs agree within F32_ATOL (the JAX
suite's bound between its kernels and references); int8 outputs are equal,
except where XLA on the CPU contracts ``acc * a2 + b2`` into one fused
multiply-add and so breaks a .5 tie of the port's separately rounded value
the other way: each such element is checked to be that tie, 1 step apart
(ROADMAP C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu.ops import int4 as jint4
from quantized_tpu.ops.int8_matmul import int8_matmul as j_int8_matmul
from quantized_tpu.ops.int8_matmul import int8_matmul_requant as j_int8_matmul_requant
from quantized_tpu_torch import ops
from quantized_tpu_torch.ops.int8_matmul import (
    GEMM_BK,
    SMEM_LIMIT,
    exact_int_matmul,
    gemm_plan,
    gemm_smem_bytes,
    requant_scalars,
)
from torch_gemm_shapes import FC, INT4_FC, RAGGED_SPLIT, conv_products, fc_products

F32_ATOL = 1e-3
WGMMA_K = 32  # K bytes of one s8 wgmma step


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_plan(label, m, n, k, packed):
    plan = gemm_plan(m, n, k, packed=packed)
    kspan = (k + 1) // 2 if packed else k
    ranges = plan.k_ranges(kspan)
    assert len(ranges) == plan.split and ranges[0][0] == 0 and ranges[-1][1] == kspan, (label, plan)
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1 and e0 % WGMMA_K == 0, (label, plan)
    assert all(e > b and b % WGMMA_K == 0 for b, e in ranges), (label, plan)
    assert plan.steps * GEMM_BK * (plan.split - 1) < kspan <= plan.steps * GEMM_BK * plan.split
    assert plan.smem == gemm_smem_bytes(plan.tile, packed, plan.split, plan.stages) <= SMEM_LIMIT, (label, plan)
    assert plan.tile % 8 == 0 and plan.tile <= 256 and plan.tile >= min(m, 128), (label, plan)
    assert 1 <= plan.split <= 8, (label, plan)
    assert min(3, plan.steps) <= plan.stages <= min(8, plan.steps), (label, plan)
    assert plan.blocks == plan.split * -(-n // 64) * -(-m // plan.tile)
    return plan


@pytest.mark.parametrize("name", sorted(FC))
def test_plan_bounds_at_the_fc_heads(name):
    for label, m, n, k in fc_products():
        if label.startswith(name):
            for packed in (False, True) if name in INT4_FC else (False,):
                plan = _check_plan(label, m, n, k, packed)
                assert plan.tma_shape, (label, packed)
                assert plan.blocks >= 64, (label, packed, plan)


@pytest.mark.parametrize("layer", ["stem", "l1", "l2", "l3", "l4"])
def test_plan_bounds_at_the_gemm_backend_convs(layer):
    products = [p for p in conv_products() if p[0].startswith(layer)]
    assert products
    for label, m, n, k in products:
        plan = _check_plan(label, m, n, k, False)
        assert plan.tma_shape == (k % 16 == 0), label  # the stem's K = 147 takes the general tile
        tiles, nk = plan.blocks // plan.split, -(-k // GEMM_BK)
        assert (plan.split > 1) == (tiles < 66 and nk > 1), (label, plan)  # split only to reach half the SMs


def test_plan_fills_the_card_at_serving_batches():
    """M = 1, N = 1000, K = 2048 (the ResNet fc at batch 1) runs at least 64
    blocks; a large im2col product runs unsplit, 3 stages a block; at most
    GEMM_INFLIGHT_STAGES ring slots are in flight at once."""
    assert gemm_plan(1, 1000, 2048).blocks >= 64
    big = gemm_plan(32 * 56 * 56, 64, 576)
    assert (big.split, big.tile, big.blocks, big.stages) == (1, 128, 784, 3)
    for _, m, n, k in fc_products():
        plan = gemm_plan(m, n, k)
        assert plan.stages * min(plan.blocks, 264) <= max(1024, 3 * min(plan.blocks, 264))
    assert gemm_plan(32, 4096, 9216, packed=True).split > 1


@pytest.mark.parametrize("m,k,n,packed", RAGGED_SPLIT)
def test_ragged_split_cases_reach_a_partial_last_stage(m, k, n, packed):
    """The cuda tests' RAGGED_SPLIT products take the TMA path under a split
    whose last 128-byte stage is partial (B6: its last low-half activation
    box reaches past Kh into the high half)."""
    plan = _check_plan(f"ragged {m}x{k}x{n}", m, n, k, packed)
    kspan = k // 2 if packed else k
    assert plan.tma_shape and plan.split > 1 and kspan % GEMM_BK != 0, plan
    assert plan.k_ranges(kspan)[-1][1] == kspan


def _edge_ks(m, n, packed):
    """K at the split's full width (every split whole) and 1 either side."""
    plan = gemm_plan(m, n, 2048, packed=packed)
    full = plan.split * plan.steps * GEMM_BK * (2 if packed else 1)
    return [full - 1, full, full + 1]


def _assert_int8_equal_but_fma_ties(got, want, pre, what):
    diff = np.argwhere(got != want)
    for idx in map(tuple, diff):
        assert abs(float(pre[idx]) - round(float(pre[idx]))) == 0.5, (what, idx)
        assert abs(int(got[idx]) - int(want[idx])) == 1, (what, idx)
    assert len(diff) <= 2, f"{what}: {len(diff)} ties"


EDGES = [(1, 1000, i) for i in range(3)] + [(17, 1, i) for i in range(3)]


@pytest.mark.parametrize("m,n,edge", EDGES)
def test_k1_plain_matches_jax_at_the_split_edges(rng, m, n, edge):
    k = _edge_ks(m, n, False)[edge]
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    alpha = (rng.uniform(0.5, 1.5, n) * 1e-4 / np.sqrt(k)).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(alpha), jnp.asarray(beta))
    want = np.asarray(j_int8_matmul(*args, relu=True, interpret=True))
    got = ops.int8_matmul(_t(a), _t(b), _t(alpha), _t(beta), relu=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    want = np.asarray(j_int8_matmul_requant(*args, 0.05, 113, relu=True, interpret=True))
    got = ops.int8_matmul_requant(_t(a), _t(b), _t(alpha), _t(beta), 0.05, 113, relu=True).numpy()
    inv, zps, _ = requant_scalars(0.05, 113, True)
    acc = exact_int_matmul(_t(a), _t(b.T.copy()))
    pre = (acc.float() * (_t(alpha) * inv) + (_t(beta) * inv + zps)).numpy()
    _assert_int8_equal_but_fma_ties(got, want, pre, f"K1 {m}x{k}x{n}")
    assert got.dtype == np.int8 and got.shape == (m, n)


@pytest.mark.parametrize("m,n,edge", EDGES)
def test_b6_plain_matches_jax_at_the_split_edges(rng, m, n, edge):
    k = _edge_ks(m, n, True)[edge]
    kh = (k + 1) // 2
    q = rng.integers(-7, 8, (2 * kh, n)).astype(np.int8)
    q[k:] = 0  # the packing pad of an odd K
    packed = ops.pack_int4(_t(q)).numpy()
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    alpha = (rng.uniform(0.5, 1.5, n) * 1.2e-3 / np.sqrt(k)).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    args = (jnp.asarray(a), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(beta))
    targs = (_t(a), _t(packed), _t(alpha), _t(beta))
    want = np.asarray(jint4.int4_matmul(*args, relu=True, interpret=True))
    got = ops.int4_matmul(*targs, relu=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    kw = dict(relu=True, out_scale=0.05, out_zp=113)
    want = np.asarray(jint4.int4_matmul(*args, interpret=True, **kw))
    got = ops.int4_matmul(*targs, **kw).numpy()
    inv, zps, _ = requant_scalars(0.05, 113, True)
    acc = exact_int_matmul(_t(np.pad(a, ((0, 0), (0, k % 2)))), _t(q.T.copy()))
    pre = (acc.float() * (_t(alpha) * inv) + (_t(beta) * inv + zps)).numpy()
    _assert_int8_equal_but_fma_ties(got, want, pre, f"B6 {m}x{k}x{n}")
    assert got.dtype == np.int8 and got.shape == (m, n)
