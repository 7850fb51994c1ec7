"""The RangeBN flavor's integer engines against the JAX package's, on the
CPU: the observer clamp ``y_clip`` in ``int8_conv_xla`` and in the plain
versions of K2 and K1, ``convert_to_int`` and ``build_int8_resident`` on
every backend that carries the clamp, and the fused path (modelled on
``tests/test_engine.py:371``).

The model is a CIFAR ResNet-20 (``resnet_quantized``), calibrated on the
port's side by three observer-update passes on numpy-seeded images, its
RangeBN input observers then narrowed to 40% of their range so the clamp
binds, and carried to the JAX model key for key. Bounds, and why:
- the integer forms (``int8_conv_xla``, K1's requant, the "xla" and
  "xla-split" engines) accumulate exactly and round each float32 operation
  once in the JAX order: int8 and int16 outputs equal, f32 outputs within
  float32 rounding;
- K2 requantizes ``relu(y)`` where ``int8_conv_xla`` folds 1/s into alpha
  and beta (``tests/test_pallas_conv.py:73-94``): within 1 step; so the
  "pallas" and "gemm" engines, where JAX sends a clamped conv to its XLA
  conv, agree block by block within 1 step on shared inputs, their logits
  within LOGIT_ATOL (``tests/test_torch_resident.py``);
- the bf16 forms: logits within 0.35 (``tests/test_autotune_bf16.py:47``);
- ``convert_to_int``'s layers emit f32, which K2 and K1 compute as
  ``int8_conv_xla`` does: logits within float32 rounding on every integer
  backend.

C5 (a fault of the JAX package that the port does not copy): JAX's
explicit-TP conv never passes the clamp, so its ``apply_explicit_tp``
engine equals its single-device engine with the last stage's clamps
stripped. The port's explicit-TP engine, run by a 4-rank gloo group
(``tests/torch_dist.py``), equals its single-device engine.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from quantized_tpu.engine import convert_to_int as j_convert_to_int
from quantized_tpu.engine import fused as jfused
from quantized_tpu.engine import int8_resident as jres
from quantized_tpu.engine.int_layers import IntConv2d as JIntConv2d
from quantized_tpu.ops.int8_conv import int8_conv_xla as j_int8_conv_xla
from quantized_tpu.parallel import create_mesh as j_create_mesh
from quantized_tpu.parallel.tp_engine import apply_explicit_tp as j_apply_explicit_tp
from quantized_tpu_torch import ops
from quantized_tpu_torch.engine import convert_to_int, fuse_resident_blocks
from quantized_tpu_torch.engine import int8_resident as tres
from quantized_tpu_torch.engine.int_layers import IntConv2d
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.models.layers import RangeBN
from quantized_tpu_torch.ops.int8_matmul import requant_clip_bounds
from torch_dist import Ranks
from torch_jax_twins import jax_model, load_flat_state

LOGIT_ATOL = 0.25
BF16_ATOL = 0.35
F32_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def calibrated():
    """(port model, its state, JAX model factory, test images)."""
    rng = np.random.default_rng(7)
    tq = get_model("resnet_quantized")(dataset="cifar10", depth=20, generator=torch.Generator().manual_seed(0))
    tq.train()
    with torch.no_grad():
        for _ in range(3):
            tq(_t(rng.standard_normal((16, 32, 32, 3)).astype(np.float32)))
    tq.eval()
    for m in tq.modules():
        if isinstance(m, RangeBN):  # the clip now binds on a large share of the activations
            m.quantize_input.running_min.mul_(0.4)
            m.quantize_input.running_max.mul_(0.4)
    state = _port_state(tq)

    def jax_twin():
        return load_flat_state(jax_model("resnet_quantized", dataset="cifar10", depth=20), state)

    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    with torch.no_grad():
        ref = tq(_t(x)).numpy()
    return tq, jax_twin, x, u8, ref


def _rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-9))


# ----------------------------------------------------------------- the ops


def _conv_case(rng, cin=8, cout=16, k=3):
    x = rng.integers(-128, 128, (2, 9, 9, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    alpha = rng.uniform(2e-4, 6e-4, cout).astype(np.float32)
    beta = rng.uniform(-0.3, 0.3, cout).astype(np.float32)
    lo = rng.uniform(-0.8, -0.05, cout).astype(np.float32)
    hi = rng.uniform(0.05, 0.8, cout).astype(np.float32)
    lo[3], hi[3] = 0.3, -0.2  # a channel whose bounds cross: clip takes hi
    return x, w, alpha, beta, np.stack([lo, hi])


FORMS = [
    # relu, out_requant, prescale (scale, shift), round_s16
    (True, (0.004, 100), None, False),
    (False, (0.004, 128), None, False),
    (True, None, None, False),
    (False, None, None, False),
    (False, None, (0.004, -20.0), False),
    (False, None, (0.004, 0.0), True),
]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("relu,req,prescale,s16", FORMS)
def test_int8_conv_xla_clip_equals_jax(rng, stride, relu, req, prescale, s16):
    """The clamped plain ``int8_conv_xla`` against JAX's at s8, f32, a
    prescaled f32 leg and an int16 leg (alpha, beta and the bounds
    prescaled by the caller): equal."""
    x, w, alpha, beta, yc = _conv_case(rng)
    if prescale is not None:
        inv = np.float32(1.0 / prescale[0]) * np.float32(32.0 if s16 else 1.0)
        shift = np.float32(prescale[1] * (32.0 if s16 else 1.0))
        alpha, beta, yc = alpha * inv, beta * inv + shift, yc * inv + shift
    kw = dict(stride=stride, padding=1, stored_zp=-7, relu=relu, out_requant=req, round_s16=s16)
    want = np.asarray(j_int8_conv_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta),
                                      y_clip=(jnp.asarray(yc[0]), jnp.asarray(yc[1])), **kw))
    got = ops.int8_conv_xla(_t(x), _t(w), _t(alpha), _t(beta), y_clip=_t(yc), **kw).numpy()
    unclipped = ops.int8_conv_xla(_t(x), _t(w), _t(alpha), _t(beta), **kw).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    assert (got != unclipped).mean() > 0.05  # the clamp binds
    if req is not None:  # the crossed channel takes hi
        hi_q = np.clip(np.round(yc[1, 3] * np.float32(1.0 / req[0]) + np.float32(req[1] - 128)), -128, 127)
        assert (got[..., 3] == hi_q).all()


@pytest.mark.parametrize("stride,pad", [(1, 1), (2, 1), (1, 0)])
@pytest.mark.parametrize("relu,req", [(True, (0.004, 100)), (False, (0.004, 128)), (True, None), (False, None)])
def test_plain_kernels_clip_within_one_step_of_jax(rng, stride, pad, relu, req):
    """K2's and K1's plain versions with the clamp (the functions their
    CLIP instances compute) against JAX's ``int8_conv_xla(y_clip=)``: K2
    within 1 step at s8 (it requantizes relu(y)), K1 (im2col) equal; both
    equal at f32."""
    x, w, alpha, beta, yc = _conv_case(rng)
    kw = dict(stride=stride, padding=pad, stored_zp=-7, relu=relu, out_requant=req)
    want = np.asarray(j_int8_conv_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta),
                                      y_clip=(jnp.asarray(yc[0]), jnp.asarray(yc[1])), **kw))
    k2 = ops.int8_conv_direct(_t(x), _t(w), _t(alpha), _t(beta), y_clip=_t(yc), **kw).numpy()
    k1 = ops.int8_conv_gemm(_t(x), _t(w), _t(alpha), _t(beta), y_clip=_t(yc), **kw).numpy()
    if req is None:
        np.testing.assert_allclose(k2, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(k1, want, rtol=1e-6, atol=1e-6)
    else:
        assert np.abs(k2.astype(np.int32) - want.astype(np.int32)).max() <= 1
        np.testing.assert_array_equal(k1, want)
    # the CUDA wrappers' bounds: the f32 ones as given, the requant's integer-valued, in [-128, 127]
    if req is not None:
        lo, hi = requant_clip_bounds((_t(yc[0]), _t(yc[1])), req[0], req[1], relu)
        assert (lo == torch.round(lo)).all() and (hi == torch.round(hi)).all()
        assert lo.min() >= -128 and hi.max() <= 127 and hi[3] < lo[3]


@pytest.mark.parametrize("req", [(0.004, 100), (0.004, 128)])
def test_s8_clamp_holds_the_relu_floor(rng, req):
    """With an s8 output the kernels' clamp (``kernel_clip``: the requant's
    integer bounds) stands in for ReLU and [-128, 127] alike: K2's and K1's
    plain versions give the same output whatever ``relu`` says, as the CLIP
    instances do, and the bounds formed with ReLU give JAX's ReLU'd conv."""
    x, w, alpha, beta, yc = _conv_case(rng)
    clip = ops.kernel_clip(_t(yc), 16, req, True)
    w_ck = ops.pack_conv_weight(_t(w))
    args = (_t(x), w_ck, (3, 3), _t(alpha), _t(beta), 1, 1, -7)
    k2 = [ops.int8_conv_direct_plain(*args, relu, req, clip=clip) for relu in (True, False)]
    k1 = [ops.int8_conv_gemm_ck(*args, relu, req, clip=clip) for relu in (True, False)]
    assert torch.equal(k2[0], k2[1]) and torch.equal(k1[0], k1[1])
    want = np.asarray(j_int8_conv_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta),
                                      stride=1, padding=1, stored_zp=-7, relu=True, out_requant=req,
                                      y_clip=(jnp.asarray(yc[0]), jnp.asarray(yc[1]))))
    np.testing.assert_array_equal(k1[0].numpy(), want)
    assert np.abs(k2[0].numpy().astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("change", ["load_state_dict", "mul_", "assign"])
@pytest.mark.parametrize("req", [(0.004, 100), None])
def test_kept_clamp_bounds_follow_y_clip(rng, change, req):
    """A clamped ``IntConv2d`` keeps its kernels' bounds between calls, and
    drops them when ``y_clip`` changes in place or is replaced: the next
    call equals a layer built with the new clamp."""
    x, w, alpha, beta, yc = _conv_case(rng)

    def layer(clamp):
        return IntConv2d(_t(w), _t(alpha), _t(beta), 0.02, 10, padding=(1, 1), relu=True, backend="pallas",
                         y_clip=_t(clamp))

    conv, x_q = layer(yc), _t(x)
    first = conv.run_q(x_q, out_requant=req)
    assert conv._clip_cache  # kept
    narrow = (yc * np.float32(0.3)).astype(np.float32)
    if change == "load_state_dict":
        conv.load_state_dict({**conv.state_dict(), "y_clip": _t(narrow)})
    elif change == "mul_":
        with torch.no_grad():
            conv.y_clip.mul_(0.3)
    else:
        conv.y_clip = _t(narrow)
    got, want = conv.run_q(x_q, out_requant=req), layer(narrow).run_q(x_q, out_requant=req)
    assert torch.equal(got, want) and not torch.equal(got, first)


def test_residual_and_clip_do_not_combine(rng):
    x, w, alpha, beta, yc = _conv_case(rng)
    r = _t(rng.integers(-128, 128, (2, 9, 9, 16)).astype(np.int8))
    with pytest.raises(ValueError, match="y_clip"):
        ops.int8_conv_direct(_t(x), _t(w), _t(alpha), _t(beta), 1, 1, residual=r, res_grid=(0.1, 120),
                             y_clip=_t(yc))


# ----------------------------------------------------------------- the stem


@pytest.mark.parametrize("backend", ["xla", "xla-split", "pallas", "bf16", "raw-xla"])
def test_space_to_depth_stem_clip_matches_jax(rng, backend):
    """The ImageNet stem with the clamp, in both forms: the s2d form and the
    raw 7x7 equal JAX's on the integer forms; K2's gather-K form (JAX's s2d
    stem runs its XLA conv there) within 1 step; bf16 within 1 step on
    under 2% of the outputs (bf16 sums in another order)."""
    w = rng.integers(-127, 128, (7, 7, 3, 16)).astype(np.int8)
    alpha = rng.uniform(1e-4, 3e-4, 16).astype(np.float32)
    beta = rng.uniform(-0.3, 0.3, 16).astype(np.float32)
    yc = np.stack([rng.uniform(-0.6, 0.0, 16), rng.uniform(0.0, 0.6, 16)]).astype(np.float32)
    x = rng.integers(-128, 128, (2, 32, 32, 3)).astype(np.int8)
    grid = (0.004, 120)
    jstem = jres.Int8SpaceToDepthStem(JIntConv2d(jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta), 0.02, 121,
                                                 stride=(2, 2), padding=(3, 3), y_clip=jnp.asarray(yc)))
    tstem = tres.Int8SpaceToDepthStem(IntConv2d(_t(w), _t(alpha), _t(beta), 0.02, 121, stride=(2, 2),
                                                padding=(3, 3), backend="xla", y_clip=_t(yc)))
    jstem.set_backend(backend)
    tstem.set_backend(backend)
    want = np.asarray(jstem.run_q(jnp.asarray(x), relu=True, out_requant=grid)).astype(np.int32)
    with torch.no_grad():
        got = tstem.run_q(_t(x), relu=True, out_requant=grid).numpy().astype(np.int32)
    diff = np.abs(got - want)
    if backend in ("xla", "xla-split", "raw-xla"):
        assert diff.max() == 0
    else:
        assert diff.max() <= 1 and (diff > 0).mean() < 0.02
    with torch.no_grad():  # the clamp binds
        tstem.conv.y_clip = tstem.raw.y_clip = None
        assert (tstem.run_q(_t(x), relu=True, out_requant=grid).numpy() != got).mean() > 0.05


# ----------------------------------------------------------------- the engines


def _blocks_within_one_step(jeng, teng, u8):
    """Each block of the port's engine (and its stem) fed JAX's input to it:
    int8 within 1 step of JAX's; the logits within LOGIT_ATOL."""
    x = jres.u8_to_stored(jnp.asarray(u8), jeng.stem.grid)
    with torch.no_grad():
        h = jeng.stem.run_q(x, relu=True, out_requant=jeng.stem_out_grid)
        got = teng.stem.run_q(_t(x), relu=True, out_requant=teng.stem_out_grid)
        assert np.abs(got.numpy().astype(np.int32) - np.asarray(h).astype(np.int32)).max() <= 1
        for i in range(1, jeng.num_stages + 1):
            jst, tst = getattr(jeng, f"layer{i}"), getattr(teng, f"layer{i}")
            for k in range(jst.num_blocks):
                nxt = getattr(jst, str(k))(h)
                if np.asarray(nxt).dtype == np.int8:
                    g = getattr(tst, str(k))(_t(h)).numpy().astype(np.int32)
                    assert np.abs(g - np.asarray(nxt).astype(np.int32)).max() <= 1, (i, k)
                h = nxt
        got = teng.run_u8(_t(u8)).numpy()
    np.testing.assert_allclose(got, np.asarray(jeng.run_u8(jnp.asarray(u8))), atol=LOGIT_ATOL, rtol=0)


def _stages_equal(jeng, teng, u8):
    """Stage by stage, each engine on its own activations: int8 equal, the
    logits within float32 rounding."""
    x = jres.u8_to_stored(jnp.asarray(u8), jeng.stem.grid)
    with torch.no_grad():
        jh = jeng.stem.run_q(x, relu=True, out_requant=jeng.stem_out_grid)
        th = teng.stem.run_q(_t(x), relu=True, out_requant=teng.stem_out_grid)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        for i in range(1, jeng.num_stages + 1):
            jh, th = getattr(jeng, f"layer{i}")(jh), getattr(teng, f"layer{i}")(th)
            if th.dtype == torch.int8:
                np.testing.assert_array_equal(th.numpy(), np.asarray(jh), err_msg=f"layer{i}")
        np.testing.assert_allclose(teng.run_u8(_t(u8)).numpy(), np.asarray(jeng.run_u8(jnp.asarray(u8))),
                                   atol=F32_ATOL, rtol=F32_ATOL)


@pytest.mark.parametrize("backend", ["xla", "xla-split", "pallas", "gemm", "bf16"])
def test_resident_engine_matches_jax(calibrated, backend):
    """``build_int8_resident`` on each backend: every conv carries the clamp;
    "xla" and "xla-split" equal JAX's same backend stage by stage, "pallas"
    and "gemm" (K2, K1: JAX runs its XLA conv there) within 1 step block by
    block, "bf16" within the bf16 bound; ``fuse_resident_blocks`` fuses none
    of the clamped blocks."""
    tq, jax_twin, _, u8, _ = calibrated
    teng = tres.build_int8_resident(copy.deepcopy(tq), backend=backend, device="cpu")
    convs = [m for m in teng.modules() if isinstance(m, IntConv2d)]
    assert len(convs) == 21 and all(m.y_clip is not None for m in convs)
    assert fuse_resident_blocks(teng) == 0
    jeng = jres.build_int8_resident(jax_twin(), backend="xla" if backend in ("pallas", "gemm") else backend)
    if backend in ("xla", "xla-split"):
        _stages_equal(jeng, teng, u8)
    elif backend == "bf16":
        with torch.no_grad():
            got = teng.run_u8(_t(u8)).numpy()
        want = np.asarray(jeng.run_u8(jnp.asarray(u8)))
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    else:
        _blocks_within_one_step(jeng, teng, u8)


@pytest.mark.parametrize("backend", ["xla", "pallas", "gemm", "xla-split", "bf16"])
def test_convert_to_int_matches_jax(calibrated, backend):
    """``convert_to_int``: the module surgery leaves IntConv2d, IntLinear and
    Identity where JAX's does, every conv clamped, and the logits match
    JAX's engine (on "xla": the function JAX's "pallas" and "gemm" compute
    for a clamped conv) within float32 rounding, bf16 within its bound."""
    tq, jax_twin, x, _, _ = calibrated
    tint = convert_to_int(copy.deepcopy(tq), backend=backend, device="cpu")
    jint = j_convert_to_int(jax_twin(), backend="xla" if backend in ("pallas", "gemm") else backend)
    tnames = {n: type(m).__name__ for n, m in tint.named_modules() if n}
    jnames = {".".join(map(str, p)): type(m).__name__ for p, m in nnx.iter_modules(jint) if p}
    for name, kind in tnames.items():
        if kind in ("IntConv2d", "IntLinear", "Identity"):
            assert jnames.get(name) == kind, name
    assert all(m.y_clip is not None for m in tint.modules() if isinstance(m, IntConv2d))
    with torch.no_grad():
        got = tint(_t(x)).numpy()
    want = np.asarray(jint(jnp.asarray(x)))
    atol = BF16_ATOL if backend == "bf16" else 1e-4
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("build", ["resident", "convert"])
def test_removing_the_clamps_makes_the_engines_diverge(calibrated, build):
    """With the observers narrowed the clamp binds: the engine tracks the
    fake-quant model, and the same engine without its clamps does not (as
    ``tests/test_engine.py:371`` holds the JAX engines)."""
    tq, _, x, _, ref = calibrated

    def make():
        if build == "resident":
            return tres.build_int8_resident(copy.deepcopy(tq), backend="pallas", device="cpu")
        return convert_to_int(copy.deepcopy(tq), backend="pallas", device="cpu")

    eng, stripped = make(), make()
    for m in stripped.modules():
        if isinstance(m, IntConv2d):
            m.y_clip = None
    with torch.no_grad():
        got, got_strip = eng(_t(x)).numpy(), stripped(_t(x)).numpy()
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.75
    assert _rel(got_strip, ref) > 2 * _rel(got, ref), (_rel(got_strip, ref), _rel(got, ref))


def test_jax_fused_blocks_drop_the_clamp(calibrated):
    """C4, a fault of the JAX package that the port does not copy: JAX's
    ``fusable`` takes the clamped blocks and its fused blocks ignore
    ``y_clip``, so its fused logits are the same with the fused blocks'
    clamps removed (while its unfused engine's move), and its fused engine
    lands several times further from the fake-quant model than its unfused
    one (on these inputs 0.166 against 0.019 at most, logits up to 0.60).
    The port leaves those blocks unfused (``test_resident_engine_matches_jax``)."""
    _, jax_twin, x, _, ref = calibrated

    def strip(eng):
        for i in range(1, eng.num_stages + 1):
            stage = getattr(eng, f"layer{i}")
            for k in range(stage.num_blocks):
                blk = getattr(stage, str(k))
                if jfused.fusable(blk):
                    for name in ("conv1", "conv2", "conv3", "downsample"):
                        if getattr(blk, name, None) is not None:
                            getattr(blk, name).y_clip = None
        return eng

    def logits(eng, fuse):
        if fuse:
            assert jfused.fuse_resident_blocks(eng) == 8
        return np.asarray(eng(jnp.asarray(x)))

    fused = logits(jres.build_int8_resident(jax_twin(), backend="xla"), True)
    fused_strip = logits(strip(jres.build_int8_resident(jax_twin(), backend="xla")), True)
    unfused = logits(jres.build_int8_resident(jax_twin(), backend="xla"), False)
    unfused_strip = logits(strip(jres.build_int8_resident(jax_twin(), backend="xla")), False)
    np.testing.assert_array_equal(fused_strip, fused)
    assert np.abs(unfused_strip - unfused).max() > 0
    err_fused, err_unfused = np.abs(fused - ref).max(), np.abs(unfused - ref).max()
    assert err_fused > 4 * err_unfused, (err_fused, err_unfused)


def test_port_explicit_tp_keeps_the_clamp(calibrated, tmp_path):
    """C5, the port's side: ``apply_explicit_tp`` at (1, 4) over four gloo
    ranks slices each clamp with its shard's channels, so the explicit-TP
    RangeBN engine equals the single-device engine on "xla" and "pallas"."""
    tq, _, x, _, _ = calibrated
    spec = ("resnet_quantized", {"dataset": "cifar10", "depth": 20}, _port_state(tq))
    ranks = Ranks(4, {"cases": [("c5", "explicit_tp", dict(tp=4, model=spec, x=x, backends=("xla", "pallas")))]},
                  tmp_path)
    results, codes, outs = ranks.results()
    assert codes == [0] * 4 and all("error" not in r for r in results), (codes, results, outs)
    for res in results:
        for backend in ("xla", "pallas"):
            c = res["c5"][backend]
            assert c["wrapped"] == 7
            np.testing.assert_array_equal(c["tp"], c["single"])


def test_jax_explicit_tp_drops_the_clamp(calibrated):
    """C5, the JAX side: JAX's explicit-TP engine (its last stage's 7 convs
    over a 4-way model axis) equals its single-device engine with layer3's
    clamps stripped, and lands more than 0.05 from its own single-device
    engine (0.081 on these inputs; logits reach about 0.6)."""
    _, jax_twin, x, _, _ = calibrated

    def forward(eng):
        graphdef, state = nnx.split(eng)
        return np.asarray(jax.jit(lambda s, v: nnx.merge(graphdef, s)(v))(state, jnp.asarray(x)))

    eng = jres.build_int8_resident(jax_twin(), backend="xla")
    single = forward(eng)
    tp = copy.deepcopy(eng)
    assert j_apply_explicit_tp(tp, j_create_mesh(num_devices=8, model_parallel=4)) == 7
    got = forward(tp)
    for k in range(eng.layer3.num_blocks):
        blk = getattr(eng.layer3, str(k))
        for name in ("conv1", "conv2", "downsample"):
            if getattr(blk, name, None) is not None:
                getattr(blk, name).y_clip = None
    np.testing.assert_allclose(got, forward(eng), atol=1e-6, rtol=0)
    assert np.abs(got - single).max() > 0.05, np.abs(got - single).max()
