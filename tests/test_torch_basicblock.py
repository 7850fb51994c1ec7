"""The port's BasicBlock ResNets (ResNet-18/34, CIFAR ResNet-20) and their
fused path against the JAX package's.

Kernels: the port's plain fused BasicBlocks (kernel B4) against the JAX
Pallas kernels run in interpret mode on the CPU, on numpy-seeded int8
inputs, weights and epilogue vectors, with conv1's stored zero point (the
padding of x) unlike conv2's (the border of h1), on images small enough
that the border matters. Both sides accumulate exactly and round each
float32 operation once in the same order, so the int8 outputs must be
equal. The same holds for K2's gather-K form over the CIFAR stem's Cin = 3.

Engines: the same calibrated model on both sides (the JAX model's state
carried by the weight bridge), ResNet-18 at 64x64 and CIFAR ResNet-20 at
32x32, two images each. The bounds are those of
``tests/test_torch_resident.py`` and ``tests/test_torch_fused.py``:
- unfused, each block fed the JAX "xla" engine's input to it: within 1 int
  step on under 1% of the elements (the JAX "xla" backend carries the int16
  shortcut leg and folds its requant in another order); the last block's
  f32 output within 1e-3; logits within LOGIT_ATOL = 0.25;
- fused: every fused block's epilogue vectors and scalars equal the JAX
  fused module's bit for bit, and its weights after the layout map; each
  fused block fed the JAX fused engine's input to it equals the JAX fused
  block; the fused engine's logits within LOGIT_ATOL of the JAX fused
  engine's.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from __graft_entry__ import _calibrated_model as j_calibrated_model
from quantized_tpu.engine import fused as jfused
from quantized_tpu.engine import int8_resident as jres
from quantized_tpu.ops import fused_block as jfb
from quantized_tpu.ops.int8_conv_pallas import int8_conv_direct as j_int8_conv_direct
from quantized_tpu_torch import ops
from quantized_tpu_torch.engine import IntExecutor
from quantized_tpu_torch.engine import fused as tfused
from quantized_tpu_torch.engine import int8_resident as tres
from quantized_tpu_torch.engine.int_layers import S16_FINE, IntConv2d
from quantized_tpu_torch.entry import _calibrated_model as t_calibrated_model
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.fused_block import basicblock_band_rows, basicblock_smem_bytes

MAX_STEP = 1
MAX_DIFF_SHARE = 0.01
LOGIT_ATOL = 0.25
# config, input side, fused identity blocks, fused downsample blocks, classes
MODELS = {
    "resnet18": (dict(dataset="imagenet", depth=18), 64, 4, 3, 1000),
    "cifar20": (dict(dataset="cifar10", depth=20), 32, 6, 2, 10),
}
ZPS = dict(zp1_stored=-17, zp2_stored=-40)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat_state(module) -> dict:
    return {
        ".".join(map(str, k)): np.asarray(v.get_value())
        for k, v in nnx.to_flat_state(nnx.state(module))
        if isinstance(v, (nnx.Param, nnx.BatchStat))
    }


def _assert_equal(got: torch.Tensor, want, what):
    want = np.asarray(want)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape, what
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() == 0, f"{what}: {int(diff.max())} steps on {(diff > 0).mean():.4%} of elements"
    # the case is not degenerate: outputs spread over the range, few on a clip
    assert len(np.unique(want)) > 100 and (want == 127).mean() < 0.05, what


def _basic_case(rng, n, h, c, cm, ds):
    """x, HWIO weights (and the (C, Cm) shortcut), epilogue vectors, scaled
    so that the requants land inside the int8 range rather than on a clip."""
    x = rng.integers(-128, 128, (n, h, h, c)).astype(np.int8)
    w = dict(w1=rng.integers(-127, 128, (3, 3, c, cm)).astype(np.int8),
             w2=rng.integers(-127, 128, (3, 3, cm, cm)).astype(np.int8))
    if ds:
        w["wd"] = rng.integers(-127, 128, (c, cm)).astype(np.int8)

    def vec(k, spread):
        a = (rng.uniform(0.5, 1.5, cm) * spread / np.sqrt(k)).astype(np.float32)
        return a, rng.uniform(-8, 8, cm).astype(np.float32)

    v = {}
    v["a1"], v["b1"] = vec(9 * c, 4e-3)
    v["a2"], v["b2"] = vec(9 * cm, 6e-3)
    if ds:
        v["ad"], v["bd"] = vec(c, 6e-3)
    return x, w, v


@pytest.mark.parametrize("n,h,c", [(2, 8, 64), (2, 8, 16)])
def test_fused_basicblock_s1_plain_matches_pallas(rng, n, h, c):
    x, w, v = _basic_case(rng, n, h, c, c, ds=False)
    keys = ("a1", "b1", "a2", "b2")
    sc = dict(lo1=-21.0, shift=-3.0, **ZPS, id_k=0.8137192, id_c=2.71828)
    want = jfb.fused_basicblock_s1(jnp.asarray(x), jnp.asarray(w["w1"]), jnp.asarray(w["w2"]),
                                   *(jnp.asarray(v[k]) for k in keys), **sc, interpret=True)
    got = ops.fused_basicblock_s1(_t(x), _t(w["w1"]), _t(w["w2"]), *(_t(v[k]) for k in keys), **sc)
    _assert_equal(got, want, f"s1 {(n, h, c)}")


@pytest.mark.parametrize("c,cm", [(64, 128), (16, 32)])
@pytest.mark.parametrize("ds_fine", [0.0, S16_FINE])
def test_fused_basicblock_ds_plain_matches_pallas(rng, c, cm, ds_fine):
    x, w, v = _basic_case(rng, 2, 16, c, cm, ds=True)
    keys = ("a1", "b1", "a2", "b2", "ad", "bd")
    sc = dict(stride=2, lo1=-21.0, shift=-3.0, **ZPS, ds_fine=ds_fine)
    want = jfb.fused_basicblock_ds(jnp.asarray(x), *(jnp.asarray(w[k]) for k in ("w1", "w2", "wd")),
                                   *(jnp.asarray(v[k]) for k in keys), **sc, interpret=True)
    got = ops.fused_basicblock_ds(_t(x), *(_t(w[k]) for k in ("w1", "w2", "wd")),
                                  *(_t(v[k]) for k in keys), **sc)
    _assert_equal(got, want, f"ds {(c, cm, ds_fine)}")


def test_fused_basicblock_wrappers_check_their_inputs(rng):
    x, w, v = _basic_case(rng, 1, 4, 32, 16, ds=True)
    t = {k: _t(a) for k, a in {**w, **v}.items()}
    vecs = [t[k] for k in ("a1", "b1", "a2", "b2", "ad", "bd")]
    sc = dict(lo1=-21.0, shift=-3.0, **ZPS)
    with pytest.raises(ValueError):  # odd image under stride 2
        ops.fused_basicblock_ds(_t(x)[:, :3], t["w1"], t["w2"], t["wd"], *vecs, stride=2, **sc)
    with pytest.raises(ValueError):  # stride 3
        ops.fused_basicblock_ds(_t(x), t["w1"], t["w2"], t["wd"], *vecs, stride=3, **sc)
    with pytest.raises(ValueError):  # an identity block maps C onto itself
        ops.fused_basicblock_s1(_t(x), t["w1"], t["w2"], *vecs[:4], **sc, id_k=1.0, id_c=0.0)
    with pytest.raises(TypeError):
        ops.fused_basicblock_ds(_t(x).float(), t["w1"], t["w2"], t["wd"], *vecs, stride=1, **sc)
    _cuda.reset_launches()
    ops.fused_basicblock_ds(_t(x), t["w1"], t["w2"], t["wd"], *vecs, stride=2, **sc)
    assert _cuda.launch_counts()["fused_basicblock_ds"] == 0  # CPU tensors run the plain version


@pytest.mark.parametrize("ho,cm,want_rows", [
    # the fused blocks of ResNet-18 at 224x224 and of CIFAR ResNet-20: (output rows = width, Cm)
    (56, 64, 8), (28, 128, 10), (14, 256, 14), (7, 512, 7), (32, 16, 8), (16, 32, 16), (8, 64, 8),
])
def test_basicblock_band_plan_fits_shared_memory(ho, cm, want_rows):
    r = basicblock_band_rows(ho, ho, cm)
    assert r == want_rows
    assert basicblock_smem_bytes(r, ho, cm) <= 113 * 1024  # two blocks per SM


@pytest.mark.parametrize("n,h,cout,stride,req", [(2, 32, 16, 1, (0.05, 113)), (2, 9, 24, 2, None)])
def test_gather_k_cin3_matches_pallas(rng, n, h, cout, stride, req):
    """K2's gather-K form over Cin = 3 (the CIFAR stem's 3x3): equal to the
    Pallas direct conv."""
    x = rng.integers(-128, 128, (n, h, h, 3)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 3, cout)).astype(np.int8)
    alpha = rng.uniform(1e-4, 3e-4, cout).astype(np.float32)
    beta = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
    want = j_int8_conv_direct(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta),
                              stride=stride, padding=1, stored_zp=-5, relu=True, out_requant=req,
                              interpret=True)
    got = ops.int8_conv_direct(_t(x), _t(w), _t(alpha), _t(beta), stride=stride, padding=1,
                               stored_zp=-5, relu=True, out_requant=req)
    if req is None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cfg", [dict(dataset="imagenet", depth=18), dict(dataset="imagenet", depth=34),
                                 dict(dataset="cifar10", depth=20)])
def test_weight_bridge_keys_equal_jax(cfg):
    jq = j_calibrated_model("resnet_quantized_float_bn", **cfg)
    flat = _flat_state(jq)
    tq = get_model("resnet_quantized_float_bn")(generator=torch.Generator().manual_seed(1), **cfg)
    assert set(flat) == set(tq.state_dict())
    load_jax_arrays(tq, flat)
    assert tq.input_size == jq.input_size and tq.input_transform == jq.input_transform


# ----------------------------------------------------------------- the engines


@pytest.fixture(scope="module", params=sorted(MODELS))
def engines(request):
    cfg, side = MODELS[request.param][:2]
    jq = j_calibrated_model("resnet_quantized_float_bn", **cfg)
    tq = t_calibrated_model("resnet_quantized_float_bn", device="cpu",
                            generator=torch.Generator().manual_seed(1), **cfg)
    load_jax_arrays(tq, _flat_state(jq))
    jeng = jres.build_int8_resident(jq, backend="xla")
    teng = tres.build_int8_resident(tq, backend="pallas", device="cpu")
    jfused_eng, tfused_eng = copy.deepcopy(jeng), copy.deepcopy(teng)
    counts = (jfused.fuse_resident_blocks(jfused_eng), tfused.fuse_resident_blocks(tfused_eng))
    u8 = np.random.default_rng(0).integers(0, 256, (2, side, side, 3), dtype=np.uint8)
    return dict(name=request.param, jeng=jeng, teng=teng, jfused=jfused_eng, tfused=tfused_eng,
                counts=counts, u8=u8)


def _blocks(engine):
    for i in range(1, engine.num_stages + 1):
        stage = getattr(engine, f"layer{i}")
        for k in range(stage.num_blocks):
            yield f"layer{i}.{k}", getattr(stage, str(k))


def _stem_input(jeng, u8):
    """The JAX engine's stem output (pooled in the ImageNet geometry): the
    first block's input."""
    x_j = jres.u8_to_stored(jnp.asarray(u8), jeng.stem.grid)
    h = jeng.stem.run_q(x_j, relu=True, out_requant=jeng.stem_out_grid)
    return jres.maxpool_3x3_s2_int8(h) if jeng.imagenet_pool else h


def _assert_within_one_step(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape, what
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_STEP, f"{what}: max diff {diff.max()}"
    assert (diff > 0).mean() < MAX_DIFF_SHARE, f"{what}: {(diff > 0).mean():.4f} of elements differ"


def test_engine_geometry_matches_jax(engines):
    jeng, teng = engines["jeng"], engines["teng"]
    assert (teng.num_stages, teng.imagenet_pool, teng.input_size) == \
        (jeng.num_stages, jeng.imagenet_pool, jeng.input_size)
    assert [w for w, _ in _blocks(teng)] == [w for w, _ in _blocks(jeng)]
    assert all(isinstance(b, tres.Int8BasicBlock) for _, b in _blocks(teng))
    assert teng.stem.grid == jeng.stem.grid and teng.stem_out_grid == jeng.stem_out_grid
    if teng.imagenet_pool:  # the 7x7/s2 stem runs in the space-to-depth form
        assert isinstance(teng.stem, tres.Int8SpaceToDepthStem)
        assert teng.stem.conv.kernel_size == (4, 4)
    else:  # the CIFAR stem: a plain 3x3 conv over Cin = 3 (K2's gather-K form)
        assert isinstance(teng.stem, IntConv2d) and teng.stem.kernel_size == (3, 3)
        assert teng.stem.weights().shape[2] == 3


def test_unfused_blocks_match_jax(engines):
    jeng, teng, u8 = engines["jeng"], engines["teng"], engines["u8"]
    x_j = jres.u8_to_stored(jnp.asarray(u8), jeng.stem.grid)
    np.testing.assert_array_equal(tres.u8_to_stored(_t(u8), teng.stem.grid).numpy(), np.asarray(x_j))
    with torch.inference_mode():
        stem_j = jeng.stem.run_q(x_j, relu=True, out_requant=jeng.stem_out_grid)
        _assert_within_one_step(teng.stem.run_q(_t(x_j), relu=True, out_requant=teng.stem_out_grid),
                                stem_j, "stem")
        h = _stem_input(jeng, u8)
        tb = dict(_blocks(teng))
        for what, jblk in _blocks(jeng):
            h_next = jblk(h)
            got = tb[what](_t(h))
            if tb[what].out_grid is None:  # the last block emits f32 for the pool and fc
                np.testing.assert_allclose(got.numpy(), np.asarray(h_next), atol=1e-3, rtol=0)
            else:
                _assert_within_one_step(got, h_next, what)
            h = h_next


def test_fuse_resident_blocks_count(engines):
    """ResNet-18 fuses 7 of its 8 blocks, CIFAR ResNet-20 8 of its 9: every
    block but the last, the first block of each later stage on the
    downsample kernel."""
    _, _, n_s1, n_ds, _ = MODELS[engines["name"]]
    assert engines["counts"] == (n_s1 + n_ds, n_s1 + n_ds)
    tf = engines["tfused"]
    kinds = [type(b).__name__ for _, b in _blocks(tf)]
    assert kinds.count("FusedInt8BasicBlock") == n_s1 and kinds.count("FusedInt8BasicBlockDS") == n_ds
    assert kinds[-1] == "Int8BasicBlock"  # the last block emits f32 and stays unfused
    last = list(_blocks(engines["teng"]))[-1][1]
    assert not tfused.fusable(last) and not tfused.fusable(engines["teng"].stem)
    assert tfused.fuse_resident_blocks(copy.deepcopy(tf)) == 0  # nothing left to fuse


def test_fused_constants_equal_jax(engines):
    jb = dict(_blocks(engines["jfused"]))
    checked = 0
    for what, tb in _blocks(engines["tfused"]):
        if isinstance(tb, tres.Int8BasicBlock):
            continue
        jblk = jb[what]
        assert type(jblk).__name__ == type(tb).__name__, what
        vecs = ["a1", "b1", "a2", "b2"]
        scalars = ["lo1", "shift", "zp1_stored", "zp2_stored"]
        if isinstance(tb, tfused.FusedInt8BasicBlockDS):
            vecs += ["ad", "bd"]
            scalars += ["stride"]
            np.testing.assert_array_equal(tb.wd.T.numpy(), np.asarray(jblk.wd.get_value()), what)
        else:
            scalars += ["id_k", "id_c"]
        for k in vecs:
            got, want = getattr(tb, k).numpy(), np.asarray(getattr(jblk, k).get_value())
            assert got.dtype == want.dtype == np.float32, (what, k)
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), f"{what} {k}")
        for k in scalars:
            assert getattr(tb, k) == getattr(jblk, k) and type(getattr(tb, k)) is type(getattr(jblk, k)), \
                (what, k)
        for k in ("w1", "w2"):  # the layout map: K-major (Cm, 9*C) -> HWIO
            w = getattr(tb, k)
            hwio = w.reshape(w.shape[0], 3, 3, -1).permute(1, 2, 3, 0)
            np.testing.assert_array_equal(hwio.numpy(), np.asarray(getattr(jblk, k).get_value()), what)
        assert tb.in_grid == jblk.in_grid and tb.out_grid == jblk.out_grid, what
        checked += 1
    assert checked == sum(MODELS[engines["name"]][2:4])


def test_fused_blocks_match_jax_fused_blocks(engines):
    """Each fused block fed the JAX fused engine's input to it: equal to the
    JAX fused block (the last block, unfused, within 1e-3 in f32)."""
    jf, tf, u8 = engines["jfused"], engines["tfused"], engines["u8"]
    h = _stem_input(jf, u8)
    tb = dict(_blocks(tf))
    with torch.inference_mode():
        for what, jblk in _blocks(jf):
            h_next = jblk(h)
            got = tb[what](_t(h))
            if got.dtype == torch.int8:
                np.testing.assert_array_equal(got.numpy(), np.asarray(h_next), what)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(h_next), atol=1e-3, rtol=0)
            h = h_next


def test_fused_block_within_one_step_of_unfused(engines):
    """Each fused block against the port's unfused block on the same input:
    within 1 int step on under 1% of the elements (the fused constants
    divide where ``run_q`` multiplies, and the fused downsample blocks carry
    the int16 shortcut leg)."""
    teng, tf, u8 = engines["teng"], engines["tfused"], engines["u8"]
    fused = dict(_blocks(tf))
    with torch.inference_mode():
        h = teng.stem.run_q(tres.u8_to_stored(_t(u8), teng.stem.grid), relu=True,
                            out_requant=teng.stem_out_grid)
        if teng.imagenet_pool:
            h = tres.maxpool_3x3_s2_int8(h)
        for what, blk in _blocks(teng):
            h_next = blk(h)
            if tfused.fusable(blk):
                _assert_within_one_step(fused[what](h), h_next.numpy(), what)
            h = h_next


def test_logits_match_jax(engines):
    classes = MODELS[engines["name"]][4]
    u8 = engines["u8"]
    got = IntExecutor(engines["teng"], ingest="u8", device="cpu")(u8).numpy()
    assert got.shape == (2, classes) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(engines["jeng"].run_u8(jnp.asarray(u8))),
                               atol=LOGIT_ATOL, rtol=0)
    fused = IntExecutor(engines["tfused"], ingest="u8", device="cpu")(u8).numpy()
    assert fused.shape == (2, classes) and np.isfinite(fused).all()
    np.testing.assert_allclose(fused, np.asarray(engines["jfused"].run_u8(jnp.asarray(u8))),
                               atol=LOGIT_ATOL, rtol=0)
