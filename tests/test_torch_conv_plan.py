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
the mainloop exactly where Cin % 16 == 0 or a 1x1's pixel groups are, the
residual form (B8) takes the per-tap form's plan, and the layer carries
the tap sums and the pixel groups' operands exactly where the mainloop
needs them. The pixel-group route's arithmetic
(``int8_conv_pixel_groups_plain``: four pixels a row times
``diag(W, W, W, W)``) equals K2's plain version and JAX bit for bit.

The twin equals K2's plain version bit for bit (int32 sums are exact, and
the epilogue is the same code). Against JAX, the bounds of
``tests/test_pallas_conv.py``: int8 outputs equal, f32 within 1e-3.

The gather-K form's Hopper route (``csrc/gatherk_sm90.cuh``): its plan over
every gather-K call of the engines (the stems of ResNet-50/18, MobileNet at
widths 1.0 and 0.75, AlexNet, and CIFAR ResNet-20's 14) at batches 1-128,
and a NumPy twin of the kernel's K layout, tile by tile: the input window
with the stored zero point in its padding and the 16-byte left margin, the
row table of window corners, A built unit by unit as the kernel copies it
(16- or 4-byte units, or for Cin 3 a 4-byte word that may cross into the
next run of Kw * Cin bytes), the weights zero past K, the staging tile's
rows copied out to their pixels; it equals K2's plain version bit for bit, and JAX's
``int8_conv_direct`` at small sizes of the four stems.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu.ops.int8_conv_pallas import int8_conv_direct as j_int8_conv_direct
from quantized_tpu_torch import ops
from quantized_tpu_torch.ops.int8_conv_pallas import (
    CONV_TILE_M,
    _epilogue,
    conv_out_hw,
    conv_plan,
    conv_smem_bytes,
    gatherk_smem_bytes,
    outside_taps,
    pixel_group,
    use_gather_k,
)
from quantized_tpu_torch.ops.int8_matmul import SMEM_LIMIT
from quantized_tpu_torch.probes.gemm_sweep import BATCHES
from quantized_tpu_torch.probes.sweep_conv import SHAPES
from torch_gemm_shapes import CONV_ENGINES, GATHERK_ENGINES, engine_conv_calls

F32_ATOL = 1e-3
WGMMA_K = 32  # K bytes of one s8 wgmma step


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_plan(label, n, h, w, cin, cout, ks, stride, pad, form):
    plan = conv_plan(n, h, w, cin, cout, ks, stride, pad, form)
    g = 1 if form == "flat" else pixel_group(cin, ks, stride, pad)
    grouped = g > 1 and (n * h * w) % g == 0
    assert plan.tma_shape == (cin % 16 == 0 or grouped), (label, plan)
    if form == "tap":
        assert conv_plan(n, h, w, cin, cout, ks, stride, pad, "residual") == plan, label  # B8: the same plan
    if grouped:  # the groups' product: N * H * W / g flat rows of g * Cin bytes, g * Cout channels
        assert plan.pixels == g and ks == (1, 1), (label, plan)
        rows, k = n * h * w // g, g * cin
        wide = _check_plan(label, 1, 1, rows, k, g * cout, (1, 1), (1, 1), (0, 0), form)
        if k <= 128:  # one stage a tile, reaching past the row (zero-filled)
            assert plan.k_stages == 1 and plan.kc == min(kc for kc in (32, 64, 128) if kc >= k), (label, plan)
            assert plan.stages == 2 and plan.smem == conv_smem_bytes(plan.kc, plan.bn, 2), (label, plan)
            assert plan._replace(kc=wide.kc, k_stages=wide.k_stages, stages=wide.stages, smem=wide.smem,
                                 pixels=1) == wide, (label, plan)
        else:
            assert plan == wide._replace(pixels=g), (label, plan)
        return plan
    assert plan.pixels == 1, (label, plan)
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
                     "gatherk").route == "sm90"


@pytest.mark.parametrize("name,h,cin,cout,k,stride", [s[:6] for s in SHAPES[1:]])
def test_plan_bounds_at_the_conv_sweep_shapes(name, h, cin, cout, k, stride):
    """ResNet-50's sweep shapes on K2 and, at stride 1, on B7, at every batch."""
    pad = (k // 2, k // 2)
    for b in BATCHES:
        _check_plan(f"{name} batch {b}", b, h, h, cin, cout, (k, k), (stride, stride), pad, "tap")
        if stride == 1:
            _check_plan(f"{name} flat batch {b}", b, h, h, cin, cout, (k, k), (1, 1), pad, "flat")


def test_plan_routes():
    """The mainloop for the residual form (the per-tap form's plan) and for
    a 1x1 over Cin 24 on pixel groups (MobileNet at width 0.75); the general
    tile for Cin 9; the mainloop for Cin 16 and 48 (a chunk of 32 bytes,
    zero-filled past Cin); a stride past TMA's 8 takes the tile."""
    residual = conv_plan(2, 56, 56, 64, 64, (3, 3), (1, 1), (1, 1), "residual")
    assert residual.route == "sm90" and residual == conv_plan(2, 56, 56, 64, 64, (3, 3), (1, 1), (1, 1))
    assert (conv_plan(2, 112, 112, 24, 48, (1, 1)).route, conv_plan(2, 112, 112, 24, 48, (1, 1)).pixels) == ("sm90", 4)
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


@pytest.mark.parametrize("engine", ["resnet50", "resnet18"])
def test_residual_plan_is_the_tap_plan_at_every_resnet_conv(engine):
    """B8 on the mainloop under the per-tap form's plan at every per-tap
    conv geometry of the engine, at batches 1, 8, 32 and 128 (JAX's
    residual form is per-tap at every Cin)."""
    calls = [c for c in engine_conv_calls(engine) if not use_gather_k(c.cin, c.kernel_size)]
    assert len(calls) == (52 if engine == "resnet50" else 19)
    for c in calls:
        for b in BATCHES:
            args = (b, c.h, c.w, c.cin, c.cout, c.kernel_size, c.stride, c.padding)
            plan = conv_plan(*args, "residual")
            assert plan.route == "sm90" and plan == conv_plan(*args, "tap"), (engine, c.h, c.cin, c.cout, b)


@pytest.mark.parametrize("cin,cout", [(24, 48), (8, 16)])
def test_pixel_group_plans(cin, cout):
    """MobileNet-v1's first pointwise conv at widths 0.75 and 0.25 (1x1
    over Cin 24 and 8 at 112x112) at batches 1-128, f32 or s8 alike: the
    mainloop on groups of four pixels, 4 * Cin bytes a row in one stage of
    128 or 32 bytes (zero past 4 * Cin), the residual form on the same plan."""
    for b in BATCHES:
        plan = _check_plan(f"{cin}->{cout} batch {b}", b, 112, 112, cin, cout, (1, 1), (1, 1), (0, 0), "tap")
        assert (plan.route, plan.pixels, plan.kc, plan.k_stages) == ("sm90", 4, 4 * cin + 32 * (cin == 24), 1), plan
        assert plan.tiles == -(-b * 112 * 112 // 4 // CONV_TILE_M) * -(-4 * cout // plan.bn), plan


def test_pixel_groups_only_where_the_conv_is_a_product_of_rows():
    """The tile for Cin 9 (no group of four pixels is a multiple of 16
    bytes), a count of pixels not a multiple of 4, a 3x3 over Cin 40 or 24,
    a padded or strided 1x1, and B7 (its padded rows are read as they
    are); Cin 40 in groups of 160 bytes takes five stages of 32."""
    assert pixel_group(24, (1, 1)) == pixel_group(8, (1, 1)) == pixel_group(40, (1, 1)) == 4
    assert pixel_group(9, (1, 1)) == pixel_group(16, (1, 1)) == pixel_group(24, (3, 3)) == 1
    assert pixel_group(24, (1, 1), 2) == pixel_group(24, (1, 1), 1, 1) == 1
    wide = _check_plan("40->48", 2, 14, 14, 40, 48, (1, 1), (1, 1), (0, 0), "tap")
    assert (wide.pixels, wide.kc, wide.k_stages) == (4, 32, 5)
    for args in [(2, 14, 14, 9, 40, (1, 1)), (1, 5, 5, 24, 48, (1, 1)), (2, 7, 7, 8, 16, (1, 1)),
                 (2, 9, 9, 40, 40, (3, 3), (1, 1), (1, 1)), (2, 9, 9, 24, 40, (3, 3), (1, 1), (1, 1)),
                 (2, 14, 14, 24, 48, (1, 1), (2, 2)), (2, 14, 14, 24, 48, (1, 1), (1, 1), (1, 1))]:
        for form in ("tap", "residual"):
            assert conv_plan(*args, form=form).route == "tile", (args, form)
    assert conv_plan(2, 14, 14, 24, 48, (1, 1), form="flat").route == "tile"


def test_pixel_groups_at_every_narrow_mobilenet_conv():
    """MobileNet-v1 at width 0.75: every per-tap call on the mainloop at
    every batch, the 1x1 over Cin 24 on pixel groups, with the layer passing
    its group operands (``diag(W, W, W, W)`` and alpha, beta tiled four
    times), built once."""
    calls = [c for c in engine_conv_calls("mobilenet w0.75") if not use_gather_k(c.cin, c.kernel_size)]
    narrow = [c for c in calls if c.cin % 16]
    assert len(calls) == 13 and [(c.cin, c.cout, c.h) for c in narrow] == [(24, 48, 112)]
    for c in calls:
        for b in BATCHES:
            plan = _check_plan(f"w0.75 {c.cin}->{c.cout} batch {b}", b, c.h, c.w, c.cin, c.cout, c.kernel_size,
                               c.stride, c.padding, "tap")
            assert plan.route == "sm90" and plan.pixels == (4 if c.cin % 16 else 1), (c.cin, b, plan)
        assert (c.pixel_groups is not None) == (c.cin % 16 != 0), c.cin
    w_g, a_g, b_g = narrow[0].pixel_groups
    want = ops.pixel_group_operands(narrow[0].w_ck, narrow[0].alpha, narrow[0].beta)
    assert all(torch.equal(got, ref) for got, ref in zip((w_g, a_g, b_g), want))
    assert tuple(w_g.shape) == (192, 96) and torch.equal(a_g, narrow[0].alpha.repeat(4))
    for i in range(4):  # W on the diagonal, zeros elsewhere
        blocks = w_g[48 * i:48 * (i + 1)].reshape(48, 4, 24)
        assert torch.equal(blocks[:, i], narrow[0].w_ck) and not blocks[:, [j for j in range(4) if j != i]].any()


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


@pytest.mark.parametrize("cin,cout", [(24, 48), (8, 16)])
def test_pixel_groups_plain_equals_k2_plain_and_jax(rng, cin, cout):
    """The pixel-group product (four pixels a row of 4 * Cin bytes times
    ``diag(W, W, W, W)``, alpha and beta tiled four times) against K2's plain version
    and JAX's ``int8_conv_direct`` (Pallas, interpret mode): against K2's
    plain version bit for bit, f32 and s8, also with a residual (B8);
    against JAX s8 bit for bit and f32 within F32_ATOL (XLA's CPU backend
    contracts ``acc * alpha + beta`` into one FMA: 1 ulp apart)."""
    x, w, alpha, beta = _case(rng, 2, 6, cin, cout, 1)
    w_ck = ops.pack_conv_weight(_t(w))
    operands = ops.pixel_group_operands(w_ck, _t(alpha), _t(beta))
    r = _t(rng.integers(-128, 128, (2, 6, 6, cout)).astype(np.int8))
    for req in (None, (0.05, 113)):
        got = ops.int8_conv_pixel_groups_plain(_t(x), *operands, True, req)
        want = ops.int8_conv_direct_plain(_t(x), w_ck, (1, 1), _t(alpha), _t(beta), 1, 0, -5, True, req)
        assert got.dtype == want.dtype and torch.equal(got, want), req
        jax_out = np.asarray(j_int8_conv_direct(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha),
                                                jnp.asarray(beta), stride=1, padding=0, stored_zp=-5, relu=True,
                                                out_requant=req, interpret=True))
        if req is not None:
            np.testing.assert_array_equal(got.numpy(), jax_out)
            assert len(np.unique(jax_out)) > 20
        else:
            np.testing.assert_allclose(got.numpy(), jax_out, atol=F32_ATOL, rtol=0)
        kw = dict(residual=r, res_grid=(0.03, 117))
        got_r = ops.int8_conv_pixel_groups_plain(_t(x), *operands, True, req, **kw)
        assert torch.equal(got_r, ops.int8_conv_direct_plain(_t(x), w_ck, (1, 1), _t(alpha), _t(beta), 1, 0, -5,
                                                             True, req, **kw)), req


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


# ----------------------------------------------------------------- the gather-K route


def _check_gatherk_plan(label, n, h, w, cin, cout, ks, stride, pad):
    plan = conv_plan(n, h, w, cin, cout, ks, stride, pad, "gatherk")
    assert plan.route == "sm90" and plan.mode == 2, (label, plan)
    (kh, kw), (sh, sw) = ks, stride
    ho, wo = conv_out_hw(h, w, ks, stride, pad)
    k = kh * kw * cin
    kp = -(-k // WGMMA_K) * WGMMA_K
    assert plan.k_stages == kp // WGMMA_K and plan.kc == (32 if kp <= 32 else 64 if kp <= 64 else 128), (label, plan)
    assert plan.bn == (16 if cout <= 16 else 32 if cout <= 32 else 64) and cout <= plan.bn, (label, plan)
    unit = 16 if cin % 16 == 0 else 4
    assert kp // unit <= 256, (label, plan)  # a thread a K unit of a row
    assert plan.two == min(wo, CONV_TILE_M) and plan.two * plan.tho * plan.nb <= CONV_TILE_M, (label, plan)
    assert plan.nb == 1 or (plan.two, plan.tho) == (wo, ho), (label, plan)
    bands = -(-ho // plan.tho)
    assert (bands - 1) * plan.tho < ho <= bands * plan.tho, (label, plan)  # bands of equal height cover the rows
    assert plan.tiles == -(-wo // plan.two) * bands * -(-n // plan.nb), (label, plan)
    if plan.two * plan.tho * plan.nb < min(CONV_TILE_M // 2, ho * wo):  # a small tile: only to fill the SMs
        assert plan.tiles < 2 * 132 and (plan.tiles >= 132 or plan.tho * plan.nb == 1), (label, plan)
    wr, wc = (plan.tho - 1) * sh + kh, (plan.two - 1) * sw + kw
    rp = -(-(wc * cin + 23) // 16) * 16
    assert plan.smem == gatherk_smem_bytes(plan.kc, kp, plan.bn, cout, plan.nb, wr, rp) <= SMEM_LIMIT, (label, plan)
    per_sm = min(3, 228 * 1024 // (plan.smem + 1024))
    assert plan.blocks == min(plan.tiles, per_sm * 132), (label, plan)
    assert plan.args(True) == [2, plan.kc, plan.bn, plan.two, plan.tho, plan.nb, 2, plan.blocks, plan.smem]
    return plan


@pytest.mark.parametrize("engine", sorted(GATHERK_ENGINES))
def test_gatherk_plan_at_every_engine_call(engine):
    """Every gather-K call of the engine, at batches 1, 8, 32 and 128, on the
    Hopper route; CIFAR ResNet-20 makes 14 (the stem and the block convs over
    Cin 16 and 32), the ImageNet engines one (the stem)."""
    calls = [c for c in engine_conv_calls(engine) if use_gather_k(c.cin, c.kernel_size)]
    assert len(calls) == (14 if engine == "cifar20" else 1)
    for c in calls:
        assert c.border_sums is None  # the window holds the zero point: no border correction
        for b in BATCHES:
            _check_gatherk_plan(f"{engine} {c.h}x{c.w}x{c.cin}->{c.cout} {c.kernel_size}/{c.stride} batch {b}",
                                b, c.h, c.w, c.cin, c.cout, c.kernel_size, c.stride, c.padding)


def test_gatherk_plan_routes():
    """The tile where the route cannot take the shape: Cout past 64, a run of
    fewer than 4 bytes (a 3x1 kernel over Cin 1), K rows of more than 256
    units."""
    assert conv_plan(2, 9, 9, 16, 96, (3, 3), (1, 1), (1, 1), "gatherk").route == "tile"
    assert conv_plan(2, 9, 9, 1, 8, (3, 1), (1, 1), (1, 0), "gatherk").route == "tile"
    assert conv_plan(2, 40, 40, 3, 8, (19, 19), (1, 1), (9, 9), "gatherk").route == "tile"
    assert conv_plan(2, 9, 9, 2, 8, (1, 3), (1, 1), (0, 1), "gatherk").route == "sm90"  # a run of 6 bytes


def _sw_offset(row, c, kb):
    o = row * kb + c
    return o ^ (((o >> 7) & (kb // 16 - 1)) << 4)


def gatherk_twin(x, w_ck, ks, alpha, beta, stride, pad, stored_zp, relu, out_requant, plan):
    """gatherk_sm90.cuh on the CPU under ``plan``: NumPy x and weights, the
    epilogue through K2's own (torch) code."""
    n, h, w, cin = x.shape
    cout = w_ck.shape[0]
    (kh, kw), (sh, sw), (ph, pw) = ks, (stride, stride), (pad, pad)
    ho, wo = conv_out_hw(h, w, ks, sh, ph)
    two, tho, nb, kb, bn = plan.two, plan.tho, plan.nb, plan.kc, plan.bn
    k_all = kh * kw * cin
    kp = -(-k_all // 32) * 32
    nkb = -(-kp // kb)
    wr, wc = (tho - 1) * sh + kh, (two - 1) * sw + kw
    rp = -(-(wc * cin + 23) // 16) * 16
    w_tiles, h_tiles = -(-wo // two), -(-ho // tho)
    rng = np.random.default_rng(1)
    # the resident weights: zero past K and Cout, through the swizzle and back
    wbuf = np.zeros(nkb * bn * kb, dtype=np.int8)
    for nn_ in range(bn):
        for k in range(kp):
            blk = k // kb
            wbuf[blk * bn * kb + _sw_offset(nn_, k - blk * kb, kb)] = w_ck[nn_, k] if nn_ < cout and k < k_all else 0
    wmat = np.zeros((bn, kp), dtype=np.int64)
    for k in range(kp):
        blk = k // kb
        wmat[:, k] = wbuf[blk * bn * kb + _sw_offset(np.arange(bn), k - blk * kb, kb)]
    rb = cout * (1 if out_requant is not None else 4)
    out = np.full(n * ho * wo * rb, 7, dtype=np.uint8)
    written = np.zeros(n * ho * wo * rb, dtype=np.int32)
    unit = 16 if cin % 16 == 0 else 4
    run = kw * cin
    for t in range(plan.tiles):
        wi_, rest = t % w_tiles, t // w_tiles
        n0, ho0, wo0 = (rest // h_tiles) * nb, (rest % h_tiles) * tho, wi_ * two
        wi0, hi0 = wo0 * sw - pw, ho0 * sh - ph
        c_lo = min(max(0, -wi0), wc)
        c_hi = min(max(c_lo, w - wi0), wc)
        lp = (16 - (c_lo * cin) % 16) % 16
        win = rng.integers(-128, 128, nb * wr * rp + 16).astype(np.int8)  # bytes never written hold anything
        for rr in range(nb * wr):
            img, r = divmod(rr, wr)
            nn_, hi = n0 + img, hi0 + r
            row = rr * rp + lp
            inside = nn_ < n and 0 <= hi < h and c_hi > c_lo
            b0, b1 = (c_lo * cin, c_hi * cin) if inside else (wc * cin, wc * cin)
            win[row:row + b0] = stored_zp
            win[row + b1:row + wc * cin] = stored_zp
            if inside:
                win[row + b0:row + b1] = x[nn_, hi, wi0 + c_lo:wi0 + c_hi].reshape(-1)
        m = np.arange(CONV_TILE_M)
        m = np.where(m < two * tho * nb, m, 0)
        img, rem = m // (two * tho), m % (two * tho)
        corner = (img * wr + (rem // two) * sh) * rp + lp + (rem % two) * sw * cin
        a = np.zeros((CONV_TILE_M, kp), dtype=np.int64)
        for k in range(0, kp, unit):  # one thread's K unit, for every row
            if k >= k_all:
                continue  # a unit past K: zeros
            khh, j = divmod(k, run)
            src = corner + khh * rp + j
            v = win[src[:, None] + np.arange(unit)]
            p_left = run - j
            if unit == 4 and cin % 4 and p_left < 4 and khh + 1 < kh:  # Cin 3: the word crosses into run kh + 1
                v2 = win[(corner + (khh + 1) * rp - p_left)[:, None] + np.arange(4)]
                v = np.concatenate([v[:, :p_left], v2[:, p_left:]], axis=1)
            a[:, k:k + unit] = v
        acc = torch.from_numpy((a @ wmat.T)[:, :cout].astype(np.int32))
        y = _epilogue(acc, torch.from_numpy(alpha), torch.from_numpy(beta), relu, out_requant).numpy()
        stage = y.view(np.uint8).reshape(CONV_TILE_M, rb)  # a staging row a pixel
        for mm in range(two * tho * nb):  # each stored row out to its pixel
            img_, rem_ = divmod(mm, two * tho)
            nn_, hoo, woo = n0 + img_, ho0 + rem_ // two, wo0 + rem_ % two
            if nn_ < n and hoo < ho and woo < wo:
                pix = (nn_ * ho + hoo) * wo + woo
                out[pix * rb:(pix + 1) * rb] = stage[mm]
                written[pix * rb:(pix + 1) * rb] += 1
    assert (written == 1).all()
    dtype = np.int8 if out_requant is not None else np.float32
    return out.view(dtype).reshape(n, ho, wo, cout)


# (n, h, cin, cout, k, stride, pad): the five shape families at small sizes
# (the s2d stem; MobileNet's stem at widths 1.0 and 0.75; AlexNet's conv1;
# the CIFAR stem; CIFAR's Cin-16 and Cin-32 3x3 convs at strides 1 and 2),
# then a tile narrower than the output (Wo > 128: row segments), a ragged
# last band and several images a tile with an odd batch
GATHERK_CASES = [
    (2, 15, 12, 64, 4, 1, 0),
    (2, 16, 3, 32, 3, 2, 1),
    (2, 16, 3, 24, 3, 2, 1),
    (1, 35, 3, 64, 11, 4, 2),
    (2, 12, 3, 16, 3, 1, 1),
    (2, 12, 16, 16, 3, 1, 1),
    (3, 12, 16, 32, 3, 2, 1),
    (2, 8, 32, 32, 3, 1, 1),
    (3, 8, 32, 64, 3, 2, 1),
    (1, 131, 3, 8, 3, 1, 1),
    (2, 27, 12, 16, 4, 1, 0),
]


@pytest.mark.parametrize("stored_zp", [-128, -5, 127])
@pytest.mark.parametrize("n,h,cin,cout,k,stride,pad", GATHERK_CASES)
def test_gatherk_twin_equals_k2_plain(rng, n, h, cin, cout, k, stride, pad, stored_zp):
    """f32 and s8 out, bit for bit (f32: the same float32 operations)."""
    x, w, alpha, beta = _case(rng, n, h, cin, cout, k)
    w_ck = ops.pack_conv_weight(_t(w))
    # a few SMs, so these small inputs keep the tiles of the serving batches
    plan = conv_plan(n, h, h, cin, cout, (k, k), (stride, stride), (pad, pad), "gatherk", sms=1)
    assert plan.route == "sm90"
    for req in (None, (0.05, 113)):
        args = ((k, k), _t(alpha), _t(beta), stride, pad, stored_zp, True, req)
        want = ops.int8_conv_direct_plain(_t(x), w_ck, *args).numpy()
        got = gatherk_twin(x, w_ck.numpy(), (k, k), alpha, beta, stride, pad, stored_zp, True, req, plan)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_gatherk_twin_cases_cover_the_tile_shapes():
    """The cases above reach a tile of row segments, a ragged band, several
    images a tile and a word crossing runs (Cin 3, Kw * Cin = 9 and 33); at
    batch 32, CIFAR's 8x8 outputs take tiles of one row to fill the SMs."""
    wide = conv_plan(1, 131, 131, 3, 8, (3, 3), (1, 1), (1, 1), "gatherk", sms=4)
    assert wide.two < 131
    ragged = conv_plan(2, 27, 27, 12, 16, (4, 4), (1, 1), (0, 0), "gatherk", sms=4)
    assert 24 % ragged.tho
    assert conv_plan(3, 8, 8, 32, 64, (3, 3), (2, 2), (1, 1), "gatherk", sms=1).nb == 3
    small = conv_plan(32, 16, 16, 32, 64, (3, 3), (2, 2), (1, 1), "gatherk")
    assert (small.two, small.tho, small.nb, small.tiles) == (8, 1, 1, 256)


# the four stems at small sizes, against JAX (its gather-K body in interpret mode)
JAX_STEMS = [(2, 15, 12, 64, 4, 1, 0), (2, 16, 3, 32, 3, 2, 1), (1, 35, 3, 64, 11, 4, 2), (2, 12, 3, 16, 3, 1, 1)]


@pytest.mark.parametrize("stored_zp", [-128, -5, 127])
@pytest.mark.parametrize("n,h,cin,cout,k,s,pad", JAX_STEMS)
def test_gatherk_twin_matches_jax_pallas(rng, n, h, cin, cout, k, s, pad, stored_zp):
    x, w, alpha, beta = _case(rng, n, h, cin, cout, k)
    w_ck = ops.pack_conv_weight(_t(w)).numpy()
    plan = conv_plan(n, h, h, cin, cout, (k, k), (s, s), (pad, pad), "gatherk", sms=1)
    for req in (None, (0.05, 113)):
        want = np.asarray(j_int8_conv_direct(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta),
                                             stride=s, padding=pad, stored_zp=stored_zp, relu=True, out_requant=req,
                                             interpret=True))
        got = gatherk_twin(x, w_ck, (k, k), alpha, beta, s, pad, stored_zp, True, req, plan)
        assert got.shape == want.shape
        if req is not None:
            np.testing.assert_array_equal(got, want)
            assert len(np.unique(want)) > 20
        else:
            np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
