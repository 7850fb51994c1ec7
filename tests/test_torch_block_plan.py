"""The launch plan of B3 and B4 on the Hopper mainloop (``block_plan``),
over every fused-block call that the engines make, a rehearsal of the
mainloop's arithmetic in NumPy/PyTorch, and the stage probes' plain
versions against the JAX package's Pallas bodies.

- The plan is plain Python, so its bounds are checked here: a block's
  shared memory stays within the H100's 232,448 bytes and equals the
  header's formula; the cluster size divides Cm and Cout into slices of a
  multiple of 16 that the job width (wgmma's N) divides; bands of equal
  height and image groups cover every output row of every image once, at
  every engine call (ResNet-50, -18, -34 and CIFAR ResNet-20 at batches 1,
  8, 32 and 128).
- The rehearsal runs the kernel's index arithmetic of block_sm90.cuh on the
  CPU: per cluster, each block's slice of conv1 gathered from x through the
  kernel's row mapping into its own h1 buffer (filled with conv2's stored
  zero point, the kernel's byte layout), the slices copied into the peers'
  buffers as the distributed-shared-memory broadcast does, conv2's taps
  gathered from h1 at the kernel's offsets, and so on, with the plain
  versions' epilogues. Integer sums are exact, so it must equal
  ``fused_bottleneck_*_plain`` and ``fused_basicblock_*_plain`` to the bit.
- ``fused_stage_plain`` against ``k_conv1`` and ``k_conv12`` of
  ``bench/fused_probe.py`` (Pallas, interpret mode), int8 equal.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu_torch import ops
from quantized_tpu_torch.ops import fused_block as fb
from quantized_tpu_torch.ops.int8_matmul import SMEM_LIMIT, f32
from quantized_tpu_torch.probes.gemm_sweep import BATCHES

ROOT = Path(__file__).resolve().parent.parent

# name: (registered model, its config, image side)
BLOCK_ENGINES = {
    "resnet50": ("resnet_quantized_float_bn", dict(dataset="imagenet", depth=50), 224),
    "resnet18": ("resnet_quantized_float_bn", dict(dataset="imagenet", depth=18), 224),
    "resnet34": ("resnet_quantized_float_bn", dict(dataset="imagenet", depth=34), 224),
    "cifar20": ("resnet_quantized_float_bn", dict(dataset="cifar10", depth=20), 32),
}
# fused launches per forward: JAX's plan, which fusable() keeps
FUSED_COUNTS = {"resnet50": (11, 4), "resnet18": (4, 3), "resnet34": (12, 3), "cifar20": (6, 2)}


@functools.lru_cache(maxsize=None)
def engine_block_calls(name: str):
    """(kind, h, w, c, cm, cout, stride, ds) of every fused-block call of one
    batch-1 forward of the fused int8 engine built on the CPU from seed 0;
    the blocks and convs themselves are not computed (each call returns
    zeros of its output's shape)."""
    from quantized_tpu_torch.engine import build_int8_resident, fuse_resident_blocks
    from quantized_tpu_torch.engine import fused, int_layers
    from quantized_tpu_torch.entry import _calibrated_model
    from quantized_tpu_torch.ops.int8_conv_pallas import conv_out_hw

    model_name, cfg, side = BLOCK_ENGINES[name]
    model = _calibrated_model(model_name, device="cpu", generator=torch.Generator().manual_seed(0), **cfg)
    engine = build_int8_resident(model, backend="pallas", device="cpu")
    fuse_resident_blocks(engine)
    calls = []

    def block(kind, ds):
        def record(x_q, w1, w2, *rest, **kw):
            n, h, w, c = x_q.shape
            cm = w1.shape[0]
            if kind == "bottleneck":
                cout, stride = rest[0].shape[0], (int(rest[10]) if ds else 1)
            else:
                cout, stride = cm, (int(rest[7]) if ds else 1)
            calls.append((kind, h, w, c, cm, cout, stride, ds))
            return torch.zeros((n, h // stride, w // stride, cout), dtype=torch.int8)
        return record

    def conv(x_q, w_ck, kernel_size, alpha, beta, stride, padding, stored_zp, relu, out_requant, **_):
        n, h, w, _ = x_q.shape
        ho, wo = conv_out_hw(h, w, kernel_size, stride, padding)
        return torch.zeros((n, ho, wo, w_ck.shape[0]), dtype=torch.float32 if out_requant is None else torch.int8)

    patches = {(fused, "fused_bottleneck_s1_ck"): block("bottleneck", False),
               (fused, "fused_bottleneck_ds_ck"): block("bottleneck", True),
               (fused, "fused_basicblock_s1_ck"): block("basic", False),
               (fused, "fused_basicblock_ds_ck"): block("basic", True),
               (int_layers, "int8_conv_direct_ck"): conv}
    real = {key: getattr(*key) for key in patches}
    for (mod, attr), fn in patches.items():
        setattr(mod, attr, fn)
    try:
        with torch.inference_mode():
            engine.run_u8(torch.zeros((1, side, side, 3), dtype=torch.uint8))
    finally:
        for (mod, attr), fn in real.items():
            setattr(mod, attr, fn)
    return tuple(calls)


def check_plan(label, kind, n, h, w, c, cm, cout, stride, ds):
    plan = ops.block_plan(kind, n, h, w, c, cm, cout, stride, ds)
    ho, wo = h // stride, w // stride
    assert plan.q in fb.BLOCK_QS and cm % plan.q == 0 and cout % plan.q == 0, (label, plan)
    for width in (cm // plan.q, cout // plan.q):
        assert width % 16 == 0 and width % plan.bn == 0, (label, plan)  # slices a whole number of jobs
    assert plan.bn in fb.BLOCK_BNS and 2 <= plan.stages <= fb.BLOCK_STAGES, (label, plan)
    assert plan.smem == fb.block_smem_bytes(kind, plan.bn, plan.stages, plan.nb, plan.r, w, cm, stride), (label, plan)
    assert plan.smem <= SMEM_LIMIT, (label, plan)
    # bands of equal height and image groups cover each output row of each image once
    bands, groups = -(-ho // plan.r), -(-n // plan.nb)
    covered = np.zeros((n, ho), dtype=np.int64)
    for g in range(groups):
        for b in range(bands):
            covered[g * plan.nb:(g + 1) * plan.nb, b * plan.r:min(ho, (b + 1) * plan.r)] += 1
    assert (covered == 1).all(), (label, plan)
    assert plan.nb == 1 or (plan.r == ho and plan.nb * ho * wo <= fb.BLOCK_TILE_M), (label, plan)
    assert plan.blocks == plan.q * bands * groups, (label, plan)
    return plan


@pytest.mark.parametrize("engine", sorted(BLOCK_ENGINES))
def test_plan_bounds_at_every_engine_block(engine):
    calls = engine_block_calls(engine)
    kinds = [(kind, ds) for kind, *_, ds in calls]
    s1, ds = FUSED_COUNTS[engine]
    assert sum(not d for _, d in kinds) == s1 and sum(d for _, d in kinds) == ds
    for kind, h, w, c, cm, cout, stride, has_ds in calls:
        for b in BATCHES:
            check_plan(f"{engine} {kind} {h}x{w}x{c}->{cm}->{cout}/{stride} batch {b}",
                       kind, b, h, w, c, cm, cout, stride, has_ds)


def test_plan_choices():
    """A 7x7 layer packs two images a cluster and splits its channels over
    4 blocks at batch 32 (16 clusters of 8 would not all be resident at
    once: 14 are); the plan fills the SMs at batch 32; the narrow CIFAR
    widths take 16-wide jobs."""
    assert [fb.resident_clusters(q) for q in fb.BLOCK_QS] == [132, 66, 30, 14]
    late = ops.block_plan("bottleneck", 32, 7, 7, 2048, 512, 2048, 1, False)
    assert (late.q, late.nb, late.r, late.bn, late.blocks) == (4, 2, 7, 64, 64)
    early = ops.block_plan("bottleneck", 32, 56, 56, 256, 64, 256, 1, False)
    assert early.blocks >= 100 and early.q == 1
    cifar = ops.block_plan("basic", 32, 32, 32, 16, 16, 16, 1, False)
    assert (cifar.q, cifar.bn) == (1, 16)
    with pytest.raises(ValueError):  # Cout % 16 != 0: the wrapper pads it first
        ops.block_plan("bottleneck", 2, 9, 9, 32, 16, 40, 1, True)
    with pytest.raises(ValueError):
        ops.block_plan("pair", 1, 8, 8, 16, 16, 16, 1, False)
    with pytest.raises(ValueError):  # h1 of three 226-pixel rows at a pitch of 528 bytes: no plan fits
        ops.block_plan("bottleneck", 1, 224, 224, 512, 512, 512, 1, False)


# ----------------------------------------------------------------- the rehearsal


def _rows_gather(buf, base, offs):
    """A's rows: buf[base[m] + offs[k]] as int64 (m, k)."""
    return buf[base[:, None] + offs[None, :]].astype(np.int64)


def _requant(acc, a, b, lo):
    return fb._requant(torch.from_numpy(acc), a, b, lo).numpy()


def _idq_shortcut(accd, ad, bd, fine):
    idq = torch.from_numpy(accd).to(torch.float32) * ad + bd
    if fine:
        idq = torch.clamp(torch.round(idq * f32(fine)), -32767.0, 32767.0) * f32(1.0 / fine)
    return idq


def rehearse(kind, x, w1, w2, w3, wd, vecs, stride, sc, plan):
    """The mainloop's arithmetic, cluster by cluster, block by block, in the
    kernel's byte layouts (block_sm90.cuh)."""
    n, h, w, c = x.shape
    cm = w1.shape[0]
    cout = w3.shape[0] if kind == "bottleneck" else cm
    s, q, r, nb = stride, plan.q, plan.r, plan.nb
    ho, wo = h // s, w // s
    hr, wp = fb.block_h1_shape(kind, r, w, s)
    p = cm + 16
    h1_img = hr * wp * p
    xf = x.reshape(-1).numpy()
    out = np.zeros((n, ho, wo, cout), dtype=np.int8)
    a1, b1, a2, b2 = vecs[:4]
    slice1, slice3 = cm // q, cout // q
    taps = np.arange(9 * cm)
    tap_off = (taps // cm // 3) * wp * p + (taps // cm % 3) * p + taps % cm  # gather_taps over h1
    for grp in range(-(-n // nb)):
        img0 = grp * nb
        nbk = min(nb, n - img0)
        for band in range(-(-ho // r)):
            r0 = band * r
            rb = min(r, ho - r0)
            h1 = [np.full(nb * h1_img, sc["zp2_stored"], dtype=np.int8) for _ in range(q)]
            l2 = rb * wo
            m2 = np.arange(nbk * l2)
            im2, i2, j2 = m2 // l2, m2 % l2 // wo, m2 % wo
            if kind == "bottleneck":
                hb = r0 * s - 1
                lr_lo, lr_hi = max(0, -hb), min((rb - 1) * s + 3, h - hb)
                l1 = (lr_hi - lr_lo) * w
                m1 = np.arange(nbk * l1)
                im, lr, col = m1 // l1, lr_lo + m1 % l1 // w, m1 % l1 % w
                a_rows = _rows_gather(xf, (((img0 + im) * h + hb + lr) * w + col) * c, np.arange(c))
                w1_k = w1.numpy().astype(np.int64)
            else:
                i_lo, i_hi = max(0, r0 - 1), min(ho, r0 + rb + 1)
                l1 = (i_hi - i_lo) * wo
                m1 = np.arange(nbk * l1)
                im, i1, j1 = m1 // l1, i_lo + m1 % l1 // wo, m1 % l1 % wo
                lr, col = i1 - r0 + 1, j1
                k = np.arange(9 * c)
                tap, ch = k // c, k % c
                hi = (i1 * s - 1)[:, None] + (tap // 3)[None, :]
                wi = (j1 * s - 1)[:, None] + (tap % 3)[None, :]
                inside = (hi >= 0) & (hi < h) & (wi >= 0) & (wi < w)
                src = (((img0 + im)[:, None] * h + np.clip(hi, 0, h - 1)) * w + np.clip(wi, 0, w - 1)) * c + ch[None, :]
                a_rows = np.where(inside, xf[src], sc["zp1_stored"]).astype(np.int64)
                w1_k = w1.numpy().astype(np.int64)
            dst1 = im * h1_img + (lr * wp + col + 1) * p
            for rank in range(q):  # conv1: each block its slice, into its own h1
                nsl = np.arange(rank * slice1, (rank + 1) * slice1)
                hv = _requant(a_rows @ w1_k[nsl].T, a1[nsl], b1[nsl], sc["lo1"])
                h1[rank][dst1[:, None] + nsl[None, :]] = hv
            for rank in range(q):  # the broadcast: each block's slice into every peer
                nsl = np.arange(rank * slice1, (rank + 1) * slice1)
                for peer in range(q):
                    if peer != rank:
                        h1[peer][dst1[:, None] + nsl[None, :]] = h1[rank][dst1[:, None] + nsl[None, :]]
            pix = ((img0 + im2) * ho + r0 + i2) * wo + j2  # output pixels
            xs = (((img0 + im2) * h + (r0 + i2) * s) * w + j2 * s) * c
            if kind == "bottleneck":
                h2 = [np.zeros(nb * r * wo * p, dtype=np.int8) for _ in range(q)]
                base2 = im2 * h1_img + (i2 * s * wp + j2 * s) * p
                for rank in range(q):
                    nsl = np.arange(rank * slice1, (rank + 1) * slice1)
                    acc = _rows_gather(h1[rank], base2, tap_off) @ w2.numpy().astype(np.int64)[nsl].T
                    h2[rank][(m2 * p)[:, None] + nsl[None, :]] = _requant(acc, a2[nsl], b2[nsl], sc["lo2"])
                for rank in range(q):
                    nsl = np.arange(rank * slice1, (rank + 1) * slice1)
                    for peer in range(q):
                        if peer != rank:
                            h2[peer][(m2 * p)[:, None] + nsl[None, :]] = h2[rank][(m2 * p)[:, None] + nsl[None, :]]
                a3, b3 = vecs[4:6]
                for rank in range(q):
                    nsl = np.arange(rank * slice3, (rank + 1) * slice3)
                    acc = _rows_gather(h2[rank], m2 * p, np.arange(cm)) @ w3.numpy().astype(np.int64)[nsl].T
                    y = torch.from_numpy(acc).to(torch.float32) * a3[nsl] + b3[nsl]
                    out.reshape(-1, cout)[pix[:, None], nsl[None, :]] = _residual(
                        y, xf, xs, nsl, c, wd, vecs, sc, rank, slice3).numpy()
            else:
                base2 = im2 * h1_img + (i2 * wp + j2) * p
                for rank in range(q):
                    nsl = np.arange(rank * slice1, (rank + 1) * slice1)
                    acc = _rows_gather(h1[rank], base2, tap_off) @ w2.numpy().astype(np.int64)[nsl].T
                    y = torch.from_numpy(acc).to(torch.float32) * a2[nsl] + b2[nsl]
                    out.reshape(-1, cout)[pix[:, None], nsl[None, :]] = _residual(
                        y, xf, xs, nsl, c, wd, vecs, sc, rank, slice1).numpy()
    return torch.from_numpy(out)


def _residual(y, xf, xs, nsl, c, wd, vecs, sc, rank, width):
    """The final epilogue of a block's slice: the shortcut conv's leg, or
    the identity x * id_k + id_c."""
    if wd is not None:
        ad, bd = vecs[-2:]
        accd = _rows_gather(xf, xs, np.arange(c)) @ wd.numpy().astype(np.int64)[nsl].T
        idq = _idq_shortcut(accd, ad[nsl], bd[nsl], sc["ds_fine"])
    else:
        xv = torch.from_numpy(xf[xs[:, None] + nsl[None, :]].astype(np.float32))
        idq = xv * f32(sc["id_k"]) + f32(sc["id_c"])
    return fb._final(y, idq, sc["shift"])


def _case(rng, kind, n, h, c, cm, cout, ds):
    def mat(rows, k):
        return torch.from_numpy(rng.integers(-127, 128, (rows, k)).astype(np.int8))

    def vec(k, length, spread):
        return (torch.from_numpy((rng.uniform(0.5, 1.5, length) * spread / np.sqrt(k)).astype(np.float32)),
                torch.from_numpy(rng.uniform(-8, 8, length).astype(np.float32)))

    x = torch.from_numpy(rng.integers(-128, 128, (n, h, h, c)).astype(np.int8))
    if kind == "bottleneck":
        w = [mat(cm, c), mat(cm, 9 * cm), mat(cout, cm), mat(cout, c) if ds else None]
        v = [*vec(c, cm, 4e-3), *vec(9 * cm, cm, 6e-3), *vec(cm, cout, 6e-3)] + ([*vec(c, cout, 6e-3)] if ds else [])
    else:
        w = [mat(cm, 9 * c), mat(cm, 9 * cm), None, mat(cm, c) if ds else None]
        v = [*vec(9 * c, cm, 4e-3), *vec(9 * cm, cm, 6e-3)] + ([*vec(c, cm, 6e-3)] if ds else [])
    return x, w, v


REHEARSALS = [
    # kind, batch, side, C, Cm, Cout, stride, ds: layer4-like (two images a
    # cluster, 8 blocks), a ragged last band, stride 2, the CIFAR widths
    ("bottleneck", 3, 7, 256, 128, 256, 1, False),
    ("bottleneck", 1, 19, 64, 32, 64, 1, False),
    ("bottleneck", 2, 10, 64, 32, 128, 2, True),
    ("bottleneck", 1, 23, 64, 64, 256, 1, True),
    ("basic", 3, 7, 128, 128, 128, 1, False),
    ("basic", 1, 19, 16, 16, 16, 1, False),
    ("basic", 2, 14, 64, 128, 128, 2, True),
    ("basic", 1, 38, 16, 32, 32, 2, True),
]


@pytest.mark.parametrize("kind,n,h,c,cm,cout,stride,ds", REHEARSALS)
def test_rehearsal_equals_plain(rng, kind, n, h, c, cm, cout, stride, ds):
    x, (w1, w2, w3, wd), v = _case(rng, kind, n, h, c, cm, cout, ds)
    plan = ops.block_plan(kind, n, h, h, c, cm, cout, stride, ds)
    if kind == "bottleneck":
        sc = dict(lo1=-21.0, lo2=-9.0, shift=-3.0, zp2_stored=-21)
        if ds:
            sc["ds_fine"] = 32.0
            want = ops.fused_bottleneck_ds_plain(x, w1, w2, w3, wd, *v, stride, **sc)
        else:
            sc.update(id_k=0.8137192, id_c=2.71828)
            want = ops.fused_bottleneck_s1_plain(x, w1, w2, w3, *v, **sc)
    else:
        sc = dict(lo1=-21.0, shift=-3.0, zp1_stored=-17, zp2_stored=-40)
        if ds:
            sc["ds_fine"] = 32.0
            want = ops.fused_basicblock_ds_plain(x, w1, w2, wd, *v, stride, **sc)
        else:
            sc.update(id_k=0.8137192, id_c=2.71828)
            want = ops.fused_basicblock_s1_plain(x, w1, w2, *v, **sc)
    for q in sorted({plan.q, 1, 2}):  # the plan's split, and others, all exact
        if cm % q or (cm // q) % 16 or (cout // q) % 16:
            continue
        got = rehearse(kind, x, w1, w2, w3, wd, v, stride, sc, plan._replace(q=q))
        assert torch.equal(got, want), (q, plan)


# ----------------------------------------------------------------- the stage probes against JAX


@pytest.fixture(scope="module")
def fused_probe():
    """``bench/fused_probe.py`` loaded from the file at batch 2 (it reads
    its batch from argv at import)."""
    argv = sys.argv
    sys.argv = ["fused_probe.py", "2"]
    try:
        spec = importlib.util.spec_from_file_location("fused_probe", ROOT / "bench" / "fused_probe.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.argv = argv
    return module


@pytest.mark.parametrize("stop", [1, 2])
def test_stage_plain_versions_equal_the_pallas_bodies(rng, fused_probe, stop):
    m = fused_probe
    x = rng.integers(-128, 128, (m.B, m.H, m.W, m.C)).astype(np.int8)
    w1 = rng.integers(-127, 128, (m.C, m.CM)).astype(np.int8)
    w2 = rng.integers(-127, 128, (3, 3, m.CM, m.CM)).astype(np.int8)
    a = np.full((1, m.CM), 0.01, np.float32)
    if stop == 1:
        fn = m._mk(m.k_conv1, [], m.B)
    else:
        fn = m._mk(m.k_conv12, [m.pltpu.VMEM((1, m.H + 2, m.W + 2, m.CM), jnp.int8)], m.B)
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(a)))
    _cuda_counts = ops.launch_counts()
    got = ops.fused_stage(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2), torch.from_numpy(a), stop)
    assert ops.launch_counts() == _cuda_counts  # CPU tensors run the plain version
    assert np.array_equal(got.numpy(), want)
