"""The launch plan of B5 (``dw_pw_plan``) over every fused pair of the
MobileNet-v1 engines, a NumPy rehearsal of the Hopper route's split, and
B5's plain version against the JAX package's Pallas kernel.

- The plan is plain Python, so its bounds are checked here at every B5 call
  of the fused MobileNet engines at widths 1.0, 0.75 and 0.25 and batches
  1, 32 and 128: the Hopper route at every pair, at C and Cout rounded up
  to multiples of 16 (the first pair of widths 0.75 and 0.25, C 24 and 8,
  runs padded); a block's shared memory within the H100's 232,448 bytes and equal to the
  header's layout; the smallest cluster size q splitting C into slices of
  a multiple of 16 up to 128 and Cout into a wgmma width; tiles of whole output rows
  (or whole images) covering the output once; the persistent clusters
  counted as resident at once (``resident_clusters``).
- The rehearsal runs dw_pw_sm90.cuh's arithmetic on the CPU, tile by tile:
  each block's window as TMA delivers it (zeros outside the tensor) with
  the halo then overwritten by the stored zero point, its slice of the
  depthwise conv written into every block's h1 in wgmma's swizzled byte
  layout (the distributed-shared-memory broadcast), the pointwise product
  of its Cout slice read back through the same swizzle, and the output box
  stored with rows past the image or the batch left unwritten. Integer sums
  are exact, so it must equal ``fused_dw_pw_plain`` to the bit. At C or
  Cout % 16 != 0 (multiples of 8) it computes at both rounded up to 16 as
  the kernel does: where C is not one, x's rows arrive whole into row
  slots (pixels C bytes apart, so a word of an added channel reads the
  next pixel's bytes, and bytes nothing writes hold garbage), the depthwise
  weights and constants past C and the pointwise weights past C or Cout
  read as 0, and only the first Cout channels are stored; it must equal the
  plain version and JAX's ``fused_dw_pw`` (interpret mode).
- ``fused_dw_pw_plain`` against ``fused_dw_pw`` of the JAX package
  (Pallas, interpret mode) where C is not a multiple of 32, int8 equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu.ops import fused_block as jfb
from quantized_tpu_torch import ops
from quantized_tpu_torch.ops import fused_block as fb
from quantized_tpu_torch.ops.int8_matmul import SMEM_LIMIT

WIDTHS = (1.0, 0.75, 0.25)
PLAN_BATCHES = (1, 32, 128)
SCALARS = dict(lo1=-21.0, lo2=-9.0, zp1_stored=-17)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def engine_pair_calls(width: float):
    """(h, w, c, cout, stride) of every B5 call of one batch-1 224x224
    forward of the fused int8 MobileNet-v1 built on the CPU from seed 0; the
    pairs are not computed (each call returns zeros of its output's shape)."""
    from quantized_tpu_torch.engine import build_int8_mobilenet, fuse_mobilenet_blocks
    from quantized_tpu_torch.engine import fused
    from quantized_tpu_torch.entry import _calibrated_model

    model = _calibrated_model("mobilenet_quantized", device="cpu", generator=torch.Generator().manual_seed(0),
                              num_classes=1000, width_mult=width)
    engine = build_int8_mobilenet(model, backend="pallas", device="cpu")
    assert fuse_mobilenet_blocks(engine) == 12
    calls = []

    def record(x_q, wdw, wpw, a1, b1, a2, b2, stride, lo1, lo2, zp1_stored):
        n, h, w, c = x_q.shape
        calls.append((h, w, c, wpw.shape[0], int(stride)))
        return torch.zeros((n, h // stride, w // stride, wpw.shape[0]), dtype=torch.int8)

    real = fused.fused_dw_pw_ck
    fused.fused_dw_pw_ck = record
    try:
        with torch.inference_mode():
            engine.run_u8(torch.zeros((1, 224, 224, 3), dtype=torch.uint8))
    finally:
        fused.fused_dw_pw_ck = real
    return tuple(calls)


def _check_plan(label, n, h, w, c, cout, s):
    plan = fb.dw_pw_plan(n, h, w, c, cout, s)
    ho, wo = h // s, w // s
    assert plan.route == "sm90", (label, plan)  # C and Cout % 16 != 0 too: the wrapper pads them
    assert (plan.c, plan.cout) == (-(-c // 16) * 16, -(-cout // 16) * 16), (label, plan)
    c_true, c, cout = c, plan.c, plan.cout
    assert c_true == c or (plan.q == 1 and w * c_true % 16 == 0), (label, plan)
    assert plan.smem <= SMEM_LIMIT, (label, plan)
    if plan.route == "tile":
        assert plan.tho == fb.dw_pw_band_rows(n, ho, w, c, cout, s), (label, plan)
        assert plan.args() == [0] * 6
        return plan
    q = plan.q
    assert q in (1, 2, 4, 8) and c % q == 0 and cout % q == 0, (label, plan)
    cx = c_true  # x's width: rows by bulk copies, unclustered, where it is not C
    assert (c // q) % 16 == 0 and c // q <= fb.DW_PW_MAX_CS and cout // q in fb.DW_PW_NS, (label, plan)
    for smaller in (1, 2, 4):  # no smaller cluster takes the shape
        if smaller < q and c % smaller == 0 and cout % smaller == 0:
            assert (c // smaller > fb.DW_PW_MAX_CS or cout // smaller not in fb.DW_PW_NS or
                    fb.dw_pw_sm90_smem_bytes(c, cout, smaller, w, s, plan.tho, plan.nb, cx) > fb.SMEM_PER_BLOCK), \
                (label, plan, smaller)
    assert plan.smem == fb.dw_pw_sm90_smem_bytes(c, cout, q, w, s, plan.tho, plan.nb, cx), (label, plan)
    assert plan.per_sm * (plan.smem + 1024) <= fb.SMEM_PER_SM, (label, plan)
    assert 1 <= plan.per_sm <= (3 if cout // q <= 64 else 2), (label, plan)  # the kernel's register bound
    # tiles of whole output rows: one band of tho rows, or nb whole images, at most 128 pixels
    assert wo * plan.tho * plan.nb <= fb.DW_PW_TILE_M, (label, plan)
    assert plan.nb == 1 or plan.tho == ho, (label, plan)
    bands = -(-ho // plan.tho)
    assert (bands - 1) * plan.tho < ho <= bands * plan.tho, (label, plan)
    assert plan.tiles == bands * -(-n // plan.nb), (label, plan)
    assert wo * plan.tho * plan.nb >= min(fb.DW_PW_TILE_M // 2, ho * wo), (label, plan)  # at least half full
    resident = fb.resident_clusters(q, plan.per_sm)
    assert resident == sum(g * plan.per_sm // q for g in fb.H100_GPC_SMS) > 0
    assert plan.clusters == min(plan.tiles, resident) and plan.blocks == q * plan.clusters, (label, plan)
    assert plan.args() == [1, q, plan.tho, plan.nb, plan.clusters, plan.smem]
    return plan


@pytest.mark.parametrize("width", WIDTHS)
def test_plan_bounds_at_every_engine_pair(width):
    calls = engine_pair_calls(width)
    assert len(calls) == 12
    routes = []
    for h, w, c, cout, s in calls:
        for b in PLAN_BATCHES:
            plan = _check_plan(f"w{width} {h}x{w}x{c}->{cout}/{s} batch {b}", b, h, w, c, cout, s)
            routes.append(plan.route)
    # every pair on the Hopper route, width 0.75's and 0.25's first (C 24, 8) padded to C 32 and 16
    want_tile = 0
    assert routes.count("tile") == want_tile, routes


def test_plan_choices_at_the_wide_pairs():
    """The smallest cluster whose slices fit: C/q <= 128 and Cout/q <= 128
    (pairs 6-10 on 4 blocks, pair 11 on 8), and a 7x7 output packs two whole
    images a tile; pair 0 runs unclustered."""
    p6 = fb.dw_pw_plan(32, 14, 14, 512, 512, 1)
    assert (p6.q, p6.tho, p6.nb, p6.tiles) == (4, 7, 1, 64)
    p11 = fb.dw_pw_plan(32, 14, 14, 512, 1024, 2)
    assert (p11.q, p11.tho, p11.nb, p11.tiles) == (8, 7, 2, 16)
    p0 = fb.dw_pw_plan(32, 112, 112, 32, 64, 1)
    assert (p0.q, p0.tho, p0.nb, p0.tiles) == (1, 1, 1, 32 * 112)
    narrow = fb.dw_pw_plan(2, 8, 8, 24, 16, 1)
    assert (narrow.route, narrow.c, narrow.cout) == ("sm90", 32, 16)  # C 24 runs as 32
    narrow = fb.dw_pw_plan(2, 8, 8, 32, 40, 1)
    assert (narrow.route, narrow.c, narrow.cout) == ("sm90", 32, 48)  # Cout 40 as 48


# ----------------------------------------------------------------- the rehearsal


def _sw_offset(row, c, kb):
    """sm90.cuh ``sw_offset``: (row, byte c) of a K-major tile of kb-byte rows, swizzled."""
    o = row * kb + c
    return o ^ (((o >> 7) & (kb // 16 - 1)) << 4)


def _requant(acc, a, b, lo):
    return fb._requant(torch.from_numpy(acc.astype(np.int32)), torch.from_numpy(a), torch.from_numpy(b), lo).numpy()


def _zero_pad(a, rows):
    """``a`` with zero rows appended up to ``rows``: what the kernel reads past a true width."""
    return np.concatenate([a, np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)])


def _narrow_window(x, n0, ho0, s, nb, wr, cs, zp1_stored, rng):
    """The window of a tile where x's width cx is less than C (= cs, one
    block): each image row by one bulk copy into a row slot of 2 C + (W +
    1) cx bytes rounded up to 16, its first pixel at byte C; the halo (the
    first C bytes, the C bytes from the right halo pixel on, whole rows
    outside the image) the stored zero point; bytes nothing writes hold
    garbage. Returned as the depthwise pass reads it: pixel p's C/q
    channels are the C bytes from C + (p - 1) cx on, the added ones the
    next pixel's first bytes."""
    n, h, w, cx = x.shape
    rp = -(-(2 * cs + (w + 1) * cx) // 16) * 16
    slots = rng.integers(-128, 128, (nb, wr, rp)).astype(np.int8)
    for i in range(min(nb, n - n0)):  # images past the batch: not loaded, computed, never stored
        for r in range(wr):
            hi = ho0 * s - 1 + r
            if 0 <= hi < h:
                slots[i, r, cs:cs + w * cx] = x[n0 + i, hi].reshape(-1)
                slots[i, r, :cs] = slots[i, r, cs + w * cx:2 * cs + w * cx] = zp1_stored
            else:
                slots[i, r] = zp1_stored
    return np.stack([slots[:, :, cs + (px - 1) * cx:2 * cs + (px - 1) * cx] for px in range(w + 2)], axis=2)


def dw_pw_sm90_rehearsal(x, wdw_ck, wpw_nk, a1, b1, a2, b2, stride, lo1, lo2, zp1_stored, plan):
    """dw_pw_sm90.cuh on the CPU under ``plan``, NumPy arrays in and out, at
    the true widths (the kernel computes at ``plan.c`` and ``plan.cout``)."""
    n, h, w, cx = x.shape
    co, s = wpw_nk.shape[0], stride
    c, cout = plan.c, plan.cout
    narrow = cx != c  # x's rows by bulk copies, unclustered
    assert not narrow or plan.q == 1
    wdw_ck, a1, b1 = _zero_pad(wdw_ck, c), _zero_pad(a1, c), _zero_pad(b1, c)
    a2, b2 = _zero_pad(a2, cout), _zero_pad(b2, cout)
    ho, wo = h // s, w // s
    q, tho, nb = plan.q, plan.tho, plan.nb
    cs, no = c // q, cout // q
    kp = -(-c // 32) * 32
    kb = 32 if kp <= 32 else 64 if kp <= 64 else 128
    nkb = -(-kp // kb)
    wr, wp = (tho - 1) * s + 3, w + 2
    p = wo * tho * nb
    rng = np.random.default_rng(0)
    h1 = [rng.integers(-128, 128, 128 * kb * nkb).astype(np.int8) for _ in range(q)]  # never cleared
    out = np.full((n, ho, wo, co), 99, dtype=np.int8)  # every element must be stored once
    written = np.zeros(out.shape, dtype=np.int32)
    rows = np.arange(p)
    img, rem = rows // (wo * tho), rows % (wo * tho)
    oh, ow = rem // wo, rem % wo
    for t in range(plan.tiles):
        n0, ho0 = (t // -(-ho // tho)) * nb, (t % -(-ho // tho)) * tho
        for rank in range(q):
            c0 = rank * cs
            if narrow:
                win = _narrow_window(x, n0, ho0, s, nb, wr, cs, zp1_stored, rng)
            else:
                # the TMA box at (c0, -1, ho0 * s - 1, n0): zeros outside the tensor
                win = np.zeros((nb, wr, wp, cs), dtype=np.int8)
                for i in range(nb):
                    for r in range(wr):
                        hi = ho0 * s - 1 + r
                        if n0 + i < n and 0 <= hi < h:
                            win[i, r, 1:w + 1] = x[n0 + i, hi, :, c0:c0 + cs]
                # the halo of the images in the batch: the stored zero point
                for i in range(min(nb, n - n0)):
                    for r in range(wr):
                        hi = ho0 * s - 1 + r
                        if hi < 0 or hi >= h:
                            win[i, r] = zp1_stored
                        else:
                            win[i, r, 0] = win[i, r, wp - 1] = zp1_stored
            acc = np.zeros((p, cs), dtype=np.int64)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                acc += win[img, oh * s + dy, ow * s + dx].astype(np.int64) * wdw_ck[c0:c0 + cs, tap].astype(np.int64)
            hv = _requant(acc, a1[c0:c0 + cs], b1[c0:c0 + cs], lo1)
            for k0 in range(0, cs, 16):  # 16-byte units into every block's h1
                k = c0 + k0
                blk, cc = k // kb, k % kb
                offs = blk * 128 * kb + _sw_offset(rows, cc, kb)
                for dst in h1:
                    for j in range(16):
                        dst[offs + j] = hv[:, k0 + j]
        for rank in range(q):
            a = np.zeros((128, kp), dtype=np.int64)
            for k in range(kp):
                blk, cc = k // kb, k % kb
                a[:, k] = h1[rank][blk * 128 * kb + _sw_offset(np.arange(128), cc, kb)]
            wpad = np.zeros((no, kp), dtype=np.int64)  # zero past C and Cout
            rows_real = max(0, min(no, co - rank * no))
            wpad[:rows_real, :cx] = wpw_nk[rank * no:rank * no + rows_real]
            acc2 = (a @ wpad.T)[:p]
            stage = _requant(acc2, a2[rank * no:(rank + 1) * no], b2[rank * no:(rank + 1) * no], lo2)
            for m in range(p):  # the output box; rows past the image or the batch, channels past Cout not written
                nn_, hh = n0 + img[m], ho0 + oh[m]
                if nn_ < n and hh < ho:
                    out[nn_, hh, ow[m], rank * no:rank * no + rows_real] = stage[m, :rows_real]
                    written[nn_, hh, ow[m], rank * no:rank * no + rows_real] += 1
    assert (written == 1).all()
    return out


def _dw_pw_case(rng, n, h, c, cout):
    x = rng.integers(-128, 128, (n, h, h, c)).astype(np.int8)
    wdw = rng.integers(-127, 128, (c, 9)).astype(np.int8)
    wpw = rng.integers(-127, 128, (cout, c)).astype(np.int8)
    a1 = (rng.uniform(0.5, 1.5, c) * 4e-2 / 3).astype(np.float32)
    b1 = rng.uniform(-8, 8, c).astype(np.float32)
    a2 = (rng.uniform(0.5, 1.5, cout) * 6e-3 / np.sqrt(c)).astype(np.float32)
    b2 = rng.uniform(-8, 8, cout).astype(np.float32)
    return x, wdw, wpw, (a1, b1, a2, b2)


@pytest.mark.parametrize("n,h,c,cout,stride,q", [
    # the planned split, and forced cluster sizes: C slices of 16-64, Cout
    # slices of 16-128, K blocks of 32, 64 and 128 bytes (C 48: zero columns
    # past C), several images a tile (7x7 and 4x4 outputs) with an odd batch
    # (the last tile's second image is past the batch), a ragged last band
    (2, 14, 32, 64, 1, None), (3, 14, 64, 128, 2, 2), (2, 10, 128, 128, 1, 8), (3, 8, 128, 256, 2, 4),
    (2, 12, 48, 96, 2, 1), (2, 9, 96, 96, 1, 2), (3, 14, 256, 64, 2, 4), (2, 26, 32, 16, 1, 1),
])
def test_sm90_rehearsal_equals_plain(rng, n, h, c, cout, stride, q):
    x, wdw, wpw, vecs = _dw_pw_case(rng, n, h, c, cout)
    plan = fb.dw_pw_plan(n, h, h, c, cout, stride)
    assert plan.route == "sm90"
    if q is not None:
        plan = plan._replace(q=q)
    want = ops.fused_dw_pw_plain(_t(x), _t(wdw), _t(wpw), *(_t(v) for v in vecs), stride, **SCALARS).numpy()
    got = dw_pw_sm90_rehearsal(x, wdw, wpw, *vecs, stride, **SCALARS, plan=plan)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 50  # not stuck on a clip


@pytest.mark.parametrize("c,cout", [(24, 48), (8, 16), (24, 40), (40, 24)])
@pytest.mark.parametrize("stride", [1, 2])
def test_sm90_rehearsal_of_narrow_pairs_equals_plain_and_jax(rng, c, cout, stride):
    """C or Cout % 16 != 0 (MobileNet-v1's first pair at widths 0.75 and
    0.25 among them): the Hopper route computing at both rounded up to 16,
    x staged at its true width, equals the plain version and JAX's
    ``fused_dw_pw`` to the bit."""
    n, h = 3, 10
    x, wdw, wpw, vecs = _dw_pw_case(rng, n, h, c, cout)
    plan = fb.dw_pw_plan(n, h, h, c, cout, stride)
    assert plan.route == "sm90" and (plan.c, plan.cout) == (-(-c // 16) * 16, -(-cout // 16) * 16)
    want = ops.fused_dw_pw_plain(_t(x), _t(wdw), _t(wpw), *(_t(v) for v in vecs), stride, **SCALARS).numpy()
    got = dw_pw_sm90_rehearsal(x, wdw, wpw, *vecs, stride, **SCALARS, plan=plan)
    np.testing.assert_array_equal(got, want)
    jax_out = jfb.fused_dw_pw(jnp.asarray(x), jnp.asarray(wdw.T.reshape(3, 3, c)), jnp.asarray(wpw.T),
                              *(jnp.asarray(v) for v in vecs), stride=stride, **SCALARS, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(jax_out))
    assert len(np.unique(want)) > 50


def test_tile_kernel_keeps_what_the_hopper_route_cannot_take():
    """Wo > 128 (a 258-pixel row), C or Cout not a multiple of 8, a Cout
    that no cluster size splits into wgmma widths once rounded up (200 ->
    208), and a C % 16 != 0 that would need a cluster (248 -> 256) or whose
    image rows are no multiple of 16 bytes (7 pixels of 24) stay on the
    tile kernel, at the true widths."""
    for n, h, w, c, cout, s in [(2, 8, 258, 32, 64, 2), (2, 8, 8, 9, 16, 1), (2, 8, 8, 16, 20, 1),
                                (4, 14, 14, 128, 200, 1), (2, 14, 14, 248, 256, 1), (2, 7, 7, 24, 48, 1)]:
        plan = fb.dw_pw_plan(n, h, w, c, cout, s)
        assert (plan.route, plan.c, plan.cout) == ("tile", c, cout), plan
        assert plan.args() == [0] * 6


def test_rehearsal_bands_and_image_groups():
    """The plans the rehearsal runs above: a ragged last band (26x26 in
    bands of 4 rows: 7 bands, the last of 2) and two images a tile."""
    ragged = fb.dw_pw_plan(2, 26, 26, 32, 16, 1)
    assert ragged.tho * -(-26 // ragged.tho) > 26
    assert fb.dw_pw_plan(3, 14, 14, 64, 128, 2).nb == 2


# ----------------------------------------------------------------- against JAX


@pytest.mark.parametrize("c,cout,stride,zp1", [(48, 96, 2, -17), (16, 32, 1, 127), (96, 48, 1, -128)])
def test_plain_matches_pallas(rng, c, cout, stride, zp1):
    """C not a multiple of 32 (width 0.75's 48 and 96, width 0.25's 16), at
    the extreme stored zero points of the depthwise padding."""
    x, wdw, wpw, vecs = _dw_pw_case(rng, 2, 8, c, cout)
    scalars = dict(SCALARS, zp1_stored=zp1)
    want = np.asarray(jfb.fused_dw_pw(jnp.asarray(x), jnp.asarray(wdw.T.reshape(3, 3, c)), jnp.asarray(wpw.T),
                                      *(jnp.asarray(v) for v in vecs), stride=stride, **scalars, interpret=True))
    got = ops.fused_dw_pw_plain(_t(x), _t(wdw), _t(wpw), *(_t(v) for v in vecs), stride, **scalars)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 50
