"""The port's MobileNet-v1, its grouped (depthwise) convs and its fused
depthwise-separable path against the JAX package's.

Grouped conv: the port's exact grouped ``int8_conv_xla`` against JAX's
(``feature_group_count``) on numpy-seeded inputs, f32 and requantized
outputs, stride 1 and 2, a stored zero point other than -128: both sides
accumulate exactly and round each float32 operation once in the same
order, so the outputs are equal.

Kernel B5: the port's plain ``fused_dw_pw`` against the JAX Pallas kernel
run in interpret mode on the CPU, with ``zp1_stored``, ``lo1`` and ``lo2``
all different, on 8x8 images: int8 outputs equal.

Engines: the same calibrated model on both sides (the JAX model's state
carried by the weight bridge) at 64x64, two images. A random-init
MobileNet's activations shrink at every depthwise conv, so with observers
frozen at [-4, 4] every conv past the fourth would emit only its clip
floor; two observer-update passes, as the JAX package's own MobileNet
tests run them, give grids that every conv's output spreads over.
- every conv's int8 weights and epilogue vectors equal JAX's bit for bit;
- unfused, each conv fed the JAX "xla" engine's input to it: the depthwise
  convs equal; the stem and the pointwise convs (kernel K2's plain version,
  which rounds its requant in another order than XLA's fused form) within
  1 int step on under 1% of the elements, the last conv's f32 output within
  1e-3; logits within LOGIT_ATOL = 0.25;
- fused: 12 pairs fused, then 0 on a second call; every fused pair's
  constants equal the JAX fused module's bit for bit and its weights after
  the layout map; each stage fed the JAX fused engine's input to it equals
  the JAX fused stage (the stem within 1 step, as above), except where
  XLA's CPU backend fuses the Pallas kernel's ``acc * a2 + b2`` into one
  multiply-add and so breaks a .5 tie of the port's separately rounded
  value the other way: each such element is checked to be that tie; the
  fused engine's logits within LOGIT_ATOL of the JAX fused engine's.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from __graft_entry__ import _calibrated_model as j_calibrated_model
from quantized_tpu.engine import fused as jfused
from quantized_tpu.engine import int8_mobilenet as jmob
from quantized_tpu.engine.int8_resident import u8_to_stored as j_u8_to_stored
from quantized_tpu.ops import fused_block as jfb
from quantized_tpu.ops import int8_conv as jconv
from quantized_tpu.ops.int8_matmul import matmul_epilogue_params as j_epilogue_params
from quantized_tpu_torch import ops
from quantized_tpu_torch.engine import IntExecutor
from quantized_tpu_torch.engine import fused as tfused
from quantized_tpu_torch.engine import int8_mobilenet as tmob
from quantized_tpu_torch.engine.int8_resident import u8_to_stored
from quantized_tpu_torch.engine.int_layers import IntConv2d
from quantized_tpu_torch.entry import _calibrated_model as t_calibrated_model
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models.layers import conv2d_nhwc
from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.fused_block import SMEM_TWO_PER_SM, dw_pw_band_rows, dw_pw_smem_bytes
from quantized_tpu_torch.ops.int8_matmul import exact_int_matmul

MAX_STEP = 1
MAX_DIFF_SHARE = 0.01
LOGIT_ATOL = 0.25
SIDE = 64
SCALARS = dict(lo1=-21.0, lo2=-9.0, zp1_stored=-17)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat_state(module) -> dict:
    return {
        ".".join(map(str, k)): np.asarray(v.get_value())
        for k, v in nnx.to_flat_state(nnx.state(module))
        if isinstance(v, (nnx.Param, nnx.BatchStat))
    }


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype == np.float32
    return a.view(np.int32)


# ----------------------------------------------------------------- grouped conv


def _dw_case(rng, c, zp):
    """A depthwise kernel with per-channel scales, its colsum over the 9 taps
    (the zero-point term) and the epilogue, as _convert_conv derives them."""
    w = rng.standard_normal((3, 3, 1, c)).astype(np.float32) * 0.2
    s_w = (np.max(np.abs(w.reshape(-1, c)), axis=0) / 127.0).astype(np.float32)
    w_q = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
    colsum = w_q.astype(np.int32).reshape(-1, c).sum(0)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    alpha, beta = j_epilogue_params(0.03, zp, jnp.asarray(s_w), jnp.asarray(colsum), jnp.asarray(bias))
    return w_q, s_w, bias, np.asarray(alpha), np.asarray(beta)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("out_requant", [None, (0.02, 37)])
def test_grouped_conv_integer_contract_exact(rng, stride, out_requant):
    """The port's grouped int8_conv_xla equals JAX's bit for bit; its f32
    form equals a float conv on the dequantized grids (the colsum correction
    is group-correct)."""
    c, s_a, zp = 16, 0.03, 21
    w_q, s_w, bias, alpha, beta = _dw_case(rng, c, zp)
    u = rng.integers(0, 256, (2, 8, 8, c))
    x_q = (u - 128).astype(np.int8)
    kw = dict(stride=stride, padding=1, stored_zp=zp - 128, relu=True, out_requant=out_requant, groups=c)
    want = np.asarray(jconv.int8_conv_xla(jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(alpha),
                                          jnp.asarray(beta), **kw))
    got = ops.int8_conv_xla(_t(x_q), _t(w_q), _t(alpha), _t(beta), **kw).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 8 // stride, 8 // stride, c)
    if out_requant is None:
        np.testing.assert_array_equal(_bits(got), _bits(want))
        x_hat = torch.from_numpy((u - zp).astype(np.float32) * s_a)
        w_hat = torch.from_numpy(w_q.astype(np.float32) * s_w)
        ref = conv2d_nhwc(x_hat.double(), w_hat.double(), stride, 1, groups=c).numpy() + bias
        np.testing.assert_allclose(got, np.maximum(ref, 0.0), rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(want)) > 50


def test_grouped_conv_acc_refuses_other_grouped_convs(rng):
    """Other groupings than depthwise (2 inputs a group; a channel
    multiplier of 2) no longer raise in ``grouped_conv_acc``: it computes
    them, equal to an int32 grouped conv (tests/test_torch_grouped_conv.py
    holds them against JAX); a grouping that does not divide C raises. The
    engine's layer still refuses them when it is built: only depthwise convs
    take its grouped path."""
    x = _t(rng.integers(-128, 128, (1, 5, 5, 4)).astype(np.int8))
    xp = torch.nn.functional.pad(x.to(torch.int32).permute(0, 3, 1, 2), (1, 1, 1, 1), value=-3)
    for w_shape, groups in [((3, 3, 2, 4), 2), ((3, 3, 1, 8), 4)]:  # 2 inputs per group; a multiplier of 2
        w_hwio = _t(rng.integers(-127, 128, w_shape).astype(np.int8))
        w = ops.pack_conv_weight(w_hwio)
        want = torch.nn.functional.conv2d(xp, w_hwio.to(torch.int32).permute(3, 2, 0, 1), groups=groups)
        assert torch.equal(ops.grouped_conv_acc(x, w, (3, 3), 1, 1, -3, groups), want.permute(0, 2, 3, 1))
        with pytest.raises(ValueError):  # 3 groups over 4 channels
            ops.grouped_conv_acc(x, w, (3, 3), 1, 1, -3, 3)
        with pytest.raises(ValueError):  # and the layer refuses them when it is built
            IntConv2d(_t(np.zeros(w_shape, np.int8)), torch.zeros(w_shape[3]), torch.zeros(w_shape[3]), 0.03,
                      21, padding=(1, 1), groups=groups)


def test_depthwise_layer_packs_and_unpacks_its_kernel(rng):
    """A (3, 3, 1, C) kernel packs to (C, 9) in (kh, kw) order, and
    ``weights()`` gives the HWIO kernel back."""
    c = 24
    w_q = _t(rng.integers(-127, 128, (3, 3, 1, c)).astype(np.int8))
    ab = torch.zeros(c)
    conv = IntConv2d(w_q, ab, ab, 0.03, 21, stride=(2, 2), padding=(1, 1), groups=c)
    assert tuple(conv.w_ck.shape) == (c, 9)
    np.testing.assert_array_equal(conv.w_ck.numpy(), w_q.numpy().reshape(9, c).T)
    assert torch.equal(conv.weights(), w_q)


# ----------------------------------------------------------------- kernel B5


def _dw_pw_case(rng, n, h, c, cout):
    """x, wdw (3, 3, C), wpw (C, Cout) and epilogue vectors scaled so that
    both requants land inside the int8 range rather than on a clip."""
    x = rng.integers(-128, 128, (n, h, h, c)).astype(np.int8)
    wdw = rng.integers(-127, 128, (3, 3, c)).astype(np.int8)
    wpw = rng.integers(-127, 128, (c, cout)).astype(np.int8)
    a1 = (rng.uniform(0.5, 1.5, c) * 4e-2 / 3).astype(np.float32)
    b1 = rng.uniform(-8, 8, c).astype(np.float32)
    a2 = (rng.uniform(0.5, 1.5, cout) * 6e-3 / np.sqrt(c)).astype(np.float32)
    b2 = rng.uniform(-8, 8, cout).astype(np.float32)
    return x, wdw, wpw, (a1, b1, a2, b2)


@pytest.mark.parametrize("c,cout,stride", [(32, 64, 1), (64, 128, 2), (128, 128, 1)])
def test_fused_dw_pw_plain_matches_pallas(rng, c, cout, stride):
    x, wdw, wpw, vecs = _dw_pw_case(rng, 2, 8, c, cout)
    want = np.asarray(jfb.fused_dw_pw(jnp.asarray(x), jnp.asarray(wdw), jnp.asarray(wpw),
                                      *(jnp.asarray(v) for v in vecs), stride=stride, **SCALARS,
                                      interpret=True))
    got = ops.fused_dw_pw(_t(x), _t(wdw), _t(wpw), *(_t(v) for v in vecs), stride, **SCALARS)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape == (2, 8 // stride, 8 // stride, cout)
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() == 0, f"{int(diff.max())} steps on {(diff > 0).mean():.4%} of elements"
    # the case is not degenerate: outputs spread over the range, few on a clip
    assert len(np.unique(want)) > 100 and (want == 127).mean() < 0.05


def test_fused_dw_pw_wrappers_check_their_inputs(rng):
    x, wdw, wpw, vecs = _dw_pw_case(rng, 1, 6, 32, 16)
    tx, tdw, tpw, tv = _t(x), _t(wdw), _t(wpw), [_t(v) for v in vecs]
    with pytest.raises(ValueError):  # odd image under stride 2
        ops.fused_dw_pw(tx[:, :5, :5], tdw, tpw, *tv, 2, **SCALARS)
    with pytest.raises(ValueError):  # stride 3
        ops.fused_dw_pw(tx, tdw, tpw, *tv, 3, **SCALARS)
    with pytest.raises(ValueError):  # the pointwise weights do not take C inputs
        ops.fused_dw_pw(tx, tdw, tpw[:16], *tv, 1, **SCALARS)
    with pytest.raises(TypeError):
        ops.fused_dw_pw(tx.float(), tdw, tpw, *tv, 1, **SCALARS)
    _cuda.reset_launches()
    out = ops.fused_dw_pw(tx, tdw, tpw, *tv, 2, **SCALARS)
    assert tuple(out.shape) == (1, 3, 3, 16)
    assert _cuda.launch_counts()["fused_dw_pw"] == 0  # CPU tensors run the plain version


@pytest.mark.parametrize("n,h,c,cout,stride,want_rows", [
    # MobileNet-v1's fused pairs at 224x224 (input side, C, Cout, stride) at
    # batch 32, and pair 11 at batch 128 (bounded by shared memory)
    (32, 112, 32, 64, 1, 4), (32, 112, 64, 128, 2, 1), (32, 56, 128, 256, 2, 2), (32, 28, 256, 512, 2, 4),
    (32, 14, 512, 512, 1, 4), (32, 14, 512, 1024, 2, 2), (128, 14, 512, 1024, 2, 3),
])
def test_dw_pw_band_plan_fits_shared_memory(n, h, c, cout, stride, want_rows):
    r = dw_pw_band_rows(n, h // stride, h, c, cout, stride)
    assert r == want_rows
    assert dw_pw_smem_bytes(r, h, c, stride) <= SMEM_TWO_PER_SM  # two blocks per SM


# ----------------------------------------------------------------- model and engines


def test_weight_bridge_keys_equal_jax(engines):
    jq, tq = engines["jq"], engines["tq"]
    assert set(_flat_state(jq)) == set(tq.state_dict())
    assert tq.input_size == jq.input_size and tq.input_transform == jq.input_transform
    assert tuple(tq.block0.dw.kernel.shape) == (3, 3, 1, 32) and tq.block0.dw.groups == 32
    # the stem and the first separable block in float fake-quant agree (deeper
    # layers shrink towards the grid's step, where a rounding flip of either
    # framework's float ops is no longer small)
    x = np.random.default_rng(3).standard_normal((1, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = tq.block0(torch.relu(tq.bn1(tq.conv1(_t(x))))).numpy()
    want = jq.block0(jnp.maximum(jq.bn1(jq.conv1(jnp.asarray(x))), 0.0))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def _jax_stages(jf, x_j):
    """The JAX fused engine's input to each of its stages, each stage's
    output, and its logits."""
    inputs, outputs, h = [], [], x_j
    for j in range(jf.num_fused_stages):
        inputs.append(h)
        h = getattr(jf, f"stage{j}")(h)
        outputs.append(h)
    return inputs, outputs, np.asarray(jf.fc(jnp.mean(h, axis=(1, 2))))


@pytest.fixture(scope="module")
def engines():
    jq = j_calibrated_model("mobilenet_quantized")
    jq.train()  # observer-update mode
    calibrate = nnx.jit(lambda m, v: m(v))
    r = np.random.default_rng(1)
    for _ in range(2):
        calibrate(jq, jnp.asarray(r.standard_normal((2, SIDE, SIDE, 3)), jnp.float32))
    jq.eval()
    tq = t_calibrated_model("mobilenet_quantized", device="cpu", generator=torch.Generator().manual_seed(1))
    load_jax_arrays(tq, _flat_state(jq))
    jeng = jmob.build_int8_mobilenet(jq)
    teng = tmob.build_int8_mobilenet(tq, backend="pallas", device="cpu")
    jf, tf = copy.deepcopy(jeng), copy.deepcopy(teng)
    counts = (jfused.fuse_mobilenet_blocks(jf), tfused.fuse_mobilenet_blocks(tf))
    u8 = np.random.default_rng(0).integers(0, 256, (2, SIDE, SIDE, 3), dtype=np.uint8)
    x_j = j_u8_to_stored(jnp.asarray(u8), jeng.input_grid)
    return dict(jq=jq, tq=tq, jeng=jeng, teng=teng, jf=jf, tf=tf, counts=counts, u8=u8, x_j=x_j,
                jf_stages=_jax_stages(jf, x_j))


def _assert_within_one_step(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape, what
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_STEP, f"{what}: max diff {diff.max()}"
    assert (diff > 0).mean() < MAX_DIFF_SHARE, f"{what}: {(diff > 0).mean():.4f} of elements differ"


def test_engine_convs_equal_jax(engines):
    """27 convs (stem, 13 depthwise, 13 pointwise) with the JAX engine's
    geometry, grids, int8 weights and epilogue vectors, bit for bit."""
    jeng, teng = engines["jeng"], engines["teng"]
    assert teng.num_convs == jeng.num_convs == 27
    assert teng.requant_grids == jeng.requant_grids and teng.input_grid == jeng.input_grid
    assert teng.input_size == jeng.input_size == 224
    for i in range(teng.num_convs):
        tc, jc = getattr(teng, f"conv{i}"), getattr(jeng, f"conv{i}")
        assert (tc.groups, tc.stride, tc.padding, tc.grid) == (jc.groups, jc.stride, jc.padding, jc.grid), i
        assert tc.groups == (tc.w_ck.shape[0] if i % 2 else 1), i  # odd convs are the depthwise ones
        np.testing.assert_array_equal(tc.weights().numpy(), np.asarray(jc.w_q.get_value()), f"conv{i}")
        for k in ("alpha", "beta"):
            np.testing.assert_array_equal(_bits(getattr(tc, k).numpy()), _bits(getattr(jc, k).get_value()))
    np.testing.assert_array_equal(teng.fc.w_q.numpy(), np.asarray(engines["jeng"].fc.w_q.get_value()))


def test_unfused_convs_match_jax(engines):
    jeng, teng, u8, x_j = engines["jeng"], engines["teng"], engines["u8"], engines["x_j"]
    np.testing.assert_array_equal(u8_to_stored(_t(u8), teng.input_grid).numpy(), np.asarray(x_j))
    h = x_j
    with torch.inference_mode():
        for i in range(jeng.num_convs):
            jc, tc, grid = getattr(jeng, f"conv{i}"), getattr(teng, f"conv{i}"), jeng.requant_grids[i]
            h_next = jc.run_q(h, relu=True, out_requant=grid)
            got = tc.run_q(_t(h), relu=True, out_requant=grid)
            assert len(np.unique(np.asarray(h_next))) > 1, f"conv{i} is constant"
            if grid is None:  # the last conv emits f32 for the pool and fc
                np.testing.assert_allclose(got.numpy(), np.asarray(h_next), atol=1e-3, rtol=0)
            elif tc.groups > 1:  # the exact grouped path on both sides
                np.testing.assert_array_equal(got.numpy(), np.asarray(h_next), f"conv{i}")
            else:
                _assert_within_one_step(got, h_next, f"conv{i}")
            h = h_next


def test_fuse_mobilenet_blocks_count(engines):
    """12 of the 13 depthwise -> pointwise pairs fuse; the last pair, whose
    pointwise conv emits f32, stays as two conv stages after the stem."""
    assert engines["counts"] == (12, 12)
    tf = engines["tf"]
    kinds = [type(getattr(tf, f"stage{j}")).__name__ for j in range(tf.num_fused_stages)]
    assert kinds == ["_ConvStage"] + ["FusedInt8DwPw"] * 12 + ["_ConvStage"] * 2
    assert not any(hasattr(tf, f"conv{i}") for i in range(tf.num_convs))  # the flat convs are gone
    assert sum(t.numel() for t in tf.buffers()) == sum(t.numel() for t in engines["teng"].buffers())
    assert tfused.fuse_mobilenet_blocks(tf) == 0  # a second call does nothing
    refused = copy.deepcopy(engines["teng"])  # decide refuses every pair: one stage per conv
    assert tfused.fuse_mobilenet_blocks(refused, decide=lambda dw, pw: False) == 0
    assert refused.num_fused_stages == 27 and refused.fused_stages


def test_fused_constants_equal_jax(engines):
    jf, tf = engines["jf"], engines["tf"]
    checked = 0
    for j in range(tf.num_fused_stages):
        ts, js = getattr(tf, f"stage{j}"), getattr(jf, f"stage{j}")
        assert type(ts).__name__ == type(js).__name__, j
        if not isinstance(ts, tfused.FusedInt8DwPw):
            assert ts.stage_out_grid == js.stage_out_grid, j
            continue
        for k in ("a1", "b1", "a2", "b2"):
            np.testing.assert_array_equal(_bits(getattr(ts, k).numpy()), _bits(getattr(js, k).get_value()),
                                          f"stage{j} {k}")
        for k in ("stride", "lo1", "lo2", "zp1_stored"):
            assert getattr(ts, k) == getattr(js, k) and type(getattr(ts, k)) is type(getattr(js, k)), (j, k)
        # the layout map: depthwise (C, 9) -> (3, 3, C), pointwise (Cout, C) -> (C, Cout)
        np.testing.assert_array_equal(ts.wdw.T.reshape(3, 3, -1).numpy(), np.asarray(js.wdw.get_value()))
        np.testing.assert_array_equal(ts.wpw.T.numpy(), np.asarray(js.wpw.get_value()))
        assert ts.in_grid == js.in_grid and ts.stage_out_grid == js.stage_out_grid, j
        checked += 1
    assert checked == 12


def _pointwise_preactivation(stage, x_q: torch.Tensor):
    """A fused pair's pointwise epilogue value before its rounding, as the
    port computes it (one float32 rounding per operation) and with the
    multiply and add fused into one rounding."""
    c = x_q.shape[-1]
    acc1 = ops.grouped_conv_acc(x_q, stage.wdw, (3, 3), stage.stride, 1, stage.zp1_stored, c)
    h1 = torch.clamp(torch.round(acc1.float() * stage.a1 + stage.b1), stage.lo1, 127.0).to(torch.int8)
    acc2 = exact_int_matmul(h1.reshape(-1, c), stage.wpw).reshape(*acc1.shape[:3], -1)
    fused = (acc2.double() * stage.a2.double() + stage.b2.double()).float()
    return acc2.float() * stage.a2 + stage.b2, fused


def _assert_equal_but_fma_ties(got: torch.Tensor, want: np.ndarray, stage, x_q: torch.Tensor, what: str):
    """Equal, except where XLA's CPU backend contracts the JAX kernel's
    ``acc * a2 + b2`` into one fused multiply-add: there the port's value,
    rounded after each operation, lies exactly on a .5 tie that the fused
    value breaks the other way. Every differing element must be such a tie."""
    diff = np.argwhere(got.numpy() != want)
    if len(diff):
        separate, fused = _pointwise_preactivation(stage, x_q)
        for idx in map(tuple, diff):
            assert abs(float(separate[idx]) - round(float(separate[idx]))) == 0.5, (what, idx)
            expect = min(max(np.round(np.float32(fused[idx])), stage.lo2), 127.0)
            assert want[idx] == expect and abs(int(got[idx]) - int(want[idx])) == 1, (what, idx)
    assert len(diff) <= 4, f"{what}: {len(diff)} ties"


def test_fused_stages_match_jax_fused_stages(engines):
    """Each stage fed the JAX fused engine's input to it: the fused pairs
    equal but for XLA's fused multiply-add ties, the last depthwise conv
    equal, the stem within 1 step, the last pointwise conv's f32 within
    1e-3."""
    tf = engines["tf"]
    inputs, outputs, _ = engines["jf_stages"]
    with torch.inference_mode():
        for j in range(tf.num_fused_stages):
            ts, x_q, want = getattr(tf, f"stage{j}"), _t(inputs[j]), np.asarray(outputs[j])
            got = ts(x_q)
            if got.dtype == torch.float32:  # the last pointwise conv
                np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
            elif isinstance(ts, tfused.FusedInt8DwPw):
                _assert_equal_but_fma_ties(got, want, ts, x_q, f"stage{j}")
            elif ts.conv.groups > 1:
                np.testing.assert_array_equal(got.numpy(), want, f"stage{j}")
            else:
                _assert_within_one_step(got, want, f"stage{j}")


def test_fused_pairs_within_one_step_of_unfused(engines):
    """Each fused pair against the port's two unfused convs on the same
    input: within 1 int step on under 1% of the elements (the fused
    constants divide where ``run_q`` multiplies, and K2 rounds its requant
    in another order)."""
    teng, tf, u8 = engines["teng"], engines["tf"], engines["u8"]
    h = u8_to_stored(_t(u8), teng.input_grid)
    i = 0
    with torch.inference_mode():
        for j in range(tf.num_fused_stages):
            stage = getattr(tf, f"stage{j}")
            span = 2 if isinstance(stage, tfused.FusedInt8DwPw) else 1
            h_next = h
            for k in range(i, i + span):
                h_next = getattr(teng, f"conv{k}").run_q(h_next, relu=True, out_requant=teng.requant_grids[k])
            if span == 2:
                _assert_within_one_step(stage(h), h_next.numpy(), f"stage{j}")
            h, i = h_next, i + span
    assert i == teng.num_convs


def test_logits_match_jax(engines):
    u8 = engines["u8"]
    got = IntExecutor(engines["teng"], ingest="u8", device="cpu")(u8).numpy()
    assert got.shape == (2, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(engines["jeng"].run_u8(jnp.asarray(u8))), atol=LOGIT_ATOL,
                               rtol=0)
    fused = IntExecutor(engines["tf"], ingest="u8", device="cpu")(u8).numpy()
    assert fused.shape == (2, 1000) and np.isfinite(fused).all()
    np.testing.assert_allclose(fused, engines["jf_stages"][2], atol=LOGIT_ATOL, rtol=0)
    f32 = np.random.default_rng(4).standard_normal((2, SIDE, SIDE, 3)).astype(np.float32)
    np.testing.assert_allclose(IntExecutor(engines["teng"], device="cpu")(f32).numpy(),
                               np.asarray(engines["jeng"](jnp.asarray(f32))), atol=LOGIT_ATOL, rtol=0)


def test_entry_points_refuse_a_missing_gpu(engines):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    tq = t_calibrated_model("mobilenet_quantized", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmob.build_int8_mobilenet(tq)
    with pytest.raises(RuntimeError, match="CUDA"):
        IntExecutor(engines["tf"], ingest="u8")
