"""The launch plan of the Hopper conv mainloop (``conv_plan``: K2's per-tap
form and B7) over every call that the engines make to K2, and the
mainloop's arithmetic in plain PyTorch (``int8_conv_zero_filled_plain``:
padded taps read as zeros, as TMA fills them, then ``stored_zp * tapsum``
added back over each pixel's outside taps) against K2's plain version and
against the JAX package's ``int8_conv_direct`` (Pallas, interpret mode).

The plan is plain Python, so its bounds are checked here: a block's shared
memory stays within the H100's 232,448 bytes; each tap's ring stages cover
its Cin bytes exactly once in whole 32-byte wgmma steps; a tile holds at
most 128 output pixels and the tiles cover the output; TMA's box limits
(256 elements a dimension, a traversal stride up to 8) hold; the route is
the mainloop exactly where Cin % 16 == 0, and the layer carries the tap
sums exactly where the mainloop needs them.

The twin equals K2's plain version bit for bit (int32 sums are exact, and
the epilogue is the same code). Against JAX, the bounds of
``tests/test_pallas_conv.py``: int8 outputs equal, f32 within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu.ops.int8_conv_pallas import int8_conv_direct as j_int8_conv_direct
from quantized_tpu_torch import ops
from quantized_tpu_torch.ops.int8_conv_pallas import (
    CONV_TILE_M,
    conv_out_hw,
    conv_plan,
    conv_smem_bytes,
    outside_taps,
    use_gather_k,
)
from quantized_tpu_torch.ops.int8_matmul import SMEM_LIMIT
from quantized_tpu_torch.probes.gemm_sweep import BATCHES
from quantized_tpu_torch.probes.sweep_conv import SHAPES
from torch_gemm_shapes import CONV_ENGINES, engine_conv_calls

F32_ATOL = 1e-3
WGMMA_K = 32  # K bytes of one s8 wgmma step


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_plan(label, n, h, w, cin, cout, ks, stride, pad, form):
    plan = conv_plan(n, h, w, cin, cout, ks, stride, pad, form)
    assert plan.tma_shape == (cin % 16 == 0), (label, plan)
    if not plan.tma_shape:
        return plan
    (kh, kw), (sh, sw) = ks, stride
    chunks = -(-cin // plan.kc)
    assert plan.kc in (32, 64, 128) and plan.kc % WGMMA_K == 0, (label, plan)
    assert (chunks - 1) * plan.kc < cin <= chunks * plan.kc, (label, plan)  # each tap's K once, whole steps
    assert plan.k_stages == kh * kw * chunks, (label, plan)
    assert plan.smem == conv_smem_bytes(plan.kc, plan.bn, plan.stages) <= SMEM_LIMIT, (label, plan)
    assert 2 * (plan.smem + 1024) <= 228 * 1024, (label, plan)  # two blocks share an SM
    assert 2 <= plan.stages <= (2 if plan.k_stages <= 2 else 4) and plan.bn in (32, 64, 128), (label, plan)
    assert plan.bn >= min(cout, 64), (label, plan)  # Cout 32 takes a tile of 32 columns, more take 64 or 128
    n_tiles = -(-cout // plan.bn)
    if form == "flat" or (ks, stride, pad) == ((1, 1), (1, 1), (0, 0)):  # K2's plain 1x1s read flat rows too
        hp, wp = h + 2 * pad[0], w + 2 * pad[1]
        rows = (n - 1) * hp * wp + (hp - kh + 1) * wp  # up to the last image's last output row
        assert (plan.two, plan.tho, plan.nb) == (CONV_TILE_M, 1, 1)
        assert plan.tiles == -(-rows // CONV_TILE_M) * n_tiles, (label, plan)
    else:
        ho, wo = conv_out_hw(h, w, ks, stride, pad)
        assert plan.two * plan.tho * plan.nb <= CONV_TILE_M, (label, plan)
        assert plan.two * sw <= 256 and plan.tho * sh <= 256 and plan.nb <= 256, (label, plan)
        assert plan.nb == 1 or (plan.two, plan.tho) == (wo, ho), (label, plan)  # several images: whole ones
        m_tiles = -(-wo // plan.two) * -(-ho // plan.tho) * -(-n // plan.nb)
        assert plan.tiles == m_tiles * n_tiles, (label, plan)
        assert plan.two * plan.tho * plan.nb >= min(CONV_TILE_M // 2, ho * wo), (label, plan)  # half full
    assert plan.blocks == min(plan.tiles, 2 * 132), (label, plan)
    return plan


@pytest.mark.parametrize("engine", sorted(CONV_ENGINES))
def test_plan_bounds_at_every_engine_conv(engine):
    """Every per-tap K2 call of the engine at batches 1, 8, 32 and 128; the
    gather-K stems take the general tile."""
    calls = engine_conv_calls(engine)
    per_tap = [c for c in calls if not use_gather_k(c.cin, c.kernel_size)]
    assert len(calls) - len(per_tap) == 1  # the stem
    assert per_tap
    for c in per_tap:
        for b in BATCHES:
            label = f"{engine} {c.h}x{c.w}x{c.cin}->{c.cout} {c.kernel_size}/{c.stride} batch {b}"
            plan = _check_plan(label, b, c.h, c.w, c.cin, c.cout, c.kernel_size, c.stride, c.padding, "tap")
            assert plan.tma_shape, label  # every per-tap conv of these engines has Cin % 16 == 0
        assert (c.border_sums is not None) == any(c.padding), label  # built once, where a tap can fall outside
        if c.border_sums is not None:
            assert torch.equal(c.border_sums, ops.conv_border_sums(c.w_ck, c.kernel_size)), label
    stem = next(c for c in calls if use_gather_k(c.cin, c.kernel_size))
    assert conv_plan(1, stem.h, stem.w, stem.cin, stem.cout, stem.kernel_size, stem.stride, stem.padding,
                     "gatherk").route == "tile"


@pytest.mark.parametrize("name,h,cin,cout,k,stride", [s[:6] for s in SHAPES[1:]])
def test_plan_bounds_at_the_conv_sweep_shapes(name, h, cin, cout, k, stride):
    """ResNet-50's sweep shapes on K2 and, at stride 1, on B7, at every batch."""
    pad = (k // 2, k // 2)
    for b in BATCHES:
        _check_plan(f"{name} batch {b}", b, h, h, cin, cout, (k, k), (stride, stride), pad, "tap")
        if stride == 1:
            _check_plan(f"{name} flat batch {b}", b, h, h, cin, cout, (k, k), (1, 1), pad, "flat")


def test_plan_routes():
    """The general tile for gather-K, the residual form and Cin % 16 != 0
    (MobileNet at width 0.75: Cin 24, and Cin 9); the mainloop for Cin 16
    and 48 (a chunk of 32 bytes, zero-filled past Cin); a stride past TMA's
    8 takes the tile."""
    assert conv_plan(2, 56, 56, 64, 64, (3, 3), (1, 1), (1, 1), "residual").route == "tile"
    assert conv_plan(2, 112, 112, 24, 48, (1, 1)).route == "tile"
    assert conv_plan(2, 14, 14, 9, 40, (1, 1)).route == "tile"
    assert conv_plan(2, 9, 9, 24, 40, (3, 3), (1, 1), (1, 1), "flat").route == "tile"
    for cin in (16, 48):
        plan = conv_plan(2, 14, 14, cin, 40, (1, 1))
        assert (plan.route, plan.kc) == ("sm90", 32)
    assert conv_plan(2, 64, 64, 16, 16, (9, 9), (9, 9)).route == "tile"
    assert conv_plan(2, 64, 64, 16, 16, (9, 9), (8, 8)).route == "sm90"
    # a 7x7 layer packs two whole images a tile; a 56-wide one two rows; a plain 1x1 flat rows
    late = conv_plan(32, 7, 7, 512, 512, (3, 3), (1, 1), (1, 1))
    assert (late.two, late.tho, late.nb) == (7, 7, 2)
    early = conv_plan(32, 56, 56, 64, 256, (3, 3), (1, 1), (1, 1))
    assert (early.two, early.tho, early.nb, early.bn) == (56, 2, 1, 128)
    one = conv_plan(32, 56, 56, 64, 256, (1, 1))  # a plain 1x1: 128 flat rows a tile
    assert (one.two, one.tho, one.nb, one.tiles) == (128, 1, 1, 32 * 56 * 56 // 128 * 2)


def test_outside_taps_is_the_border_map():
    """A 3x3 pad-1 window: the corner pixel has 5 outside taps, an edge pixel
    3, an interior one none; stride 2 over an even image has no bottom or
    right border."""
    m = outside_taps(6, 6, (3, 3), (1, 1), (1, 1))
    assert m.shape == (6, 6, 9)
    assert m[0, 0].sum() == 5 and m[0, 3].sum() == 3 and m[3, 3].sum() == 0
    m2 = outside_taps(6, 6, (3, 3), (2, 2), (1, 1))
    assert m2.shape == (3, 3, 9) and m2[2, 2].sum() == 0 and m2[0, 0].sum() == 5


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (5, 1, 2), (5, 2, 2), (3, 2, 0), (1, 1, 1)])
def test_border_sums_give_each_pixels_outside_taps(rng, k, stride, pad):
    """The kernel's five reads of the summed-area table (the window's total
    less its rectangle of inside taps, the rectangle's corners clamped as in
    conv_sm90.cuh) equal the sum of tapsum over each pixel's outside taps."""
    h, cin, cout = 9, 16, 24
    w_ck = _t(rng.integers(-127, 128, (cout, k * k * cin)).astype(np.int8))
    sat = ops.conv_border_sums(w_ck, (k, k)).reshape(k + 1, k + 1, cout)
    want = outside_taps(h, h, (k, k), stride, pad).to(torch.int64) @ ops.conv_tapsum(w_ck, k * k).to(torch.int64)
    ho, wo = conv_out_hw(h, h, (k, k), stride, pad)
    for oh in range(ho):
        for ow in range(wo):
            hi0, wi0 = oh * stride - pad, ow * stride - pad
            i0, j0 = max(0, -hi0), max(0, -wi0)
            i1, j1 = max(i0, min(k, h - hi0)), max(j0, min(k, h - wi0))
            got = sat[k, k] - sat[i1, j1] + sat[i0, j1] + sat[i1, j0] - sat[i0, j0]
            assert torch.equal(got.to(torch.int64), want[oh, ow]), (oh, ow)


def _case(rng, n, h, cin, cout, k):
    x = rng.integers(-128, 128, (n, h, h, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    alpha = rng.uniform(1e-4, 3e-4, (cout,)).astype(np.float32)
    beta = rng.uniform(-0.1, 0.1, (cout,)).astype(np.float32)
    return x, w, alpha, beta


@pytest.mark.parametrize("stored_zp", [-128, -5, 0, 127])
@pytest.mark.parametrize("k,stride,pad", [(k, s, p) for k in (1, 3, 5) for s in (1, 2) for p in (0, 1, 2)])
def test_zero_filled_twin_equals_k2_plain(rng, k, stride, pad, stored_zp):
    """f32 and s8 out, bit for bit, with the tap sums given or computed."""
    x, w, alpha, beta = _case(rng, 2, 9, 16, 24, k)
    w_ck = ops.pack_conv_weight(_t(w))
    for req in (None, (0.05, 113)):
        args = ((k, k), _t(alpha), _t(beta), stride, pad, stored_zp, True, req)
        want = ops.int8_conv_direct_plain(_t(x), w_ck, *args)
        got = ops.int8_conv_zero_filled_plain(_t(x), w_ck, *args)
        assert got.dtype == want.dtype and torch.equal(got, want), (req, stored_zp)
        given = ops.int8_conv_zero_filled_plain(_t(x), w_ck, *args, tapsum=ops.conv_tapsum(w_ck, k * k))
        assert torch.equal(given, want)
        if req is not None:
            assert len(torch.unique(want)) > 20  # not stuck on a clip


# the cases of tests/test_pallas_conv.py (n, h, cin, cout, k, stride, out_requant)
# and AlexNet's 5x5 pad-2 conv2, at the stored zero points of the border cases
JAX_CASES = [
    (4, 14, 256, 256, 3, 1, None, -5),
    (4, 14, 256, 256, 3, 1, (0.07, 113), -5),
    (2, 28, 128, 128, 3, 2, (0.05, 120), 127),
    (4, 8, 64, 96, 1, 1, (0.05, 128), -5),
    (2, 15, 32, 64, 3, 2, None, -128),
    (2, 9, 512, 512, 3, 1, (0.04, 99), -5),
    (1, 13, 64, 48, 5, 1, (0.05, 113), -128),
]


@pytest.mark.parametrize("n,h,cin,cout,k,s,req,stored_zp", JAX_CASES)
def test_zero_filled_twin_matches_jax_pallas(rng, n, h, cin, cout, k, s, req, stored_zp):
    x, w, alpha, beta = _case(rng, n, h, cin, cout, k)
    pad = k // 2
    want = np.asarray(j_int8_conv_direct(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta),
                                         stride=s, padding=pad, stored_zp=stored_zp, relu=True, out_requant=req,
                                         interpret=True))
    got = ops.int8_conv_zero_filled_plain(_t(x), ops.pack_conv_weight(_t(w)), (k, k), _t(alpha), _t(beta), s, pad,
                                          stored_zp, True, req)
    assert tuple(got.shape) == want.shape
    if req is not None:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
