"""The port's plain backends against the JAX package's, on the CPU.

The same models on both sides: a CIFAR ResNet-20 at 32x32, its JAX
parameters drawn from a seed (``tests/torch_jax_twins.py``, observers
frozen at [-4, 4]) and carried to the port by the weight bridge; single
conv layers, dense layers and ops on numpy-seeded operands. The JAX side
runs eagerly, as its own tests run it. Bounds, and why:
- the integer forms ("xla", "xla-split", and "s4", "s4-split" on int4
  weights) accumulate exactly and round each float32 operation once, in the
  JAX order, so every int8 and int16 output is equal (the int16 shortcut leg
  of the downsample blocks, ``round_s16``, included), and f32 outputs agree
  to float32 rounding;
- the bf16 forms ("bf16", "bf16-split") run the conv on bf16 operands with
  an f32 result, as JAX does, up to summation order
  (``ops.int8_conv.bf16_conv``): the engine's logits within 0.35 of the int8
  engine's and of JAX's bf16 engine's with the argmax equal
  (``tests/test_autotune_bf16.py:47``), "bf16-split" equal to "bf16"
  (:145); a layer's int8 output within 1 step of JAX's on under 1% of its
  elements, its f32 and int16 outputs within f32 rounding of the sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from quantized_tpu.engine import int8_resident as jres
from quantized_tpu.engine.int_layers import IntConv2d as JIntConv2d
from quantized_tpu.engine.int_layers import IntLinear as JIntLinear
from quantized_tpu.ops.int4 import int4_conv_s4 as j_int4_conv_s4
from quantized_tpu.ops.int4 import int4_matmul_s4 as j_int4_matmul_s4
from quantized_tpu.ops.int4 import int4_matmul_unpacked_xla as j_int4_matmul_unpacked_xla
from quantized_tpu.ops.int4 import pack_int4 as j_pack_int4
from quantized_tpu.ops.int4 import pack_int4_conv_channels as j_pack_int4_conv_channels
from quantized_tpu.ops.int8_conv import int8_conv_xla as j_int8_conv_xla
from quantized_tpu.ops.int8_matmul import int8_matmul_xla as j_int8_matmul_xla
from quantized_tpu_torch import ops
from quantized_tpu_torch.engine import int8_resident as tres
from quantized_tpu_torch.engine.int_layers import CONV_BACKENDS, IntConv2d, IntLinear
from quantized_tpu_torch.entry import _calibrated_model as t_calibrated_model
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.ops import int8_conv as tconv
from torch_jax_twins import flat_state, jax_model

BF16_ATOL = 0.35  # tests/test_autotune_bf16.py:47
F32_ATOL = 1e-5
F32_RTOL = 1e-6  # a product rounded once against one contracted into a multiply-add


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def cifar():
    jq = jax_model("resnet_quantized_float_bn", dataset="cifar10", depth=20)
    tq = t_calibrated_model("resnet_quantized_float_bn", device="cpu", dataset="cifar10", depth=20)
    load_jax_arrays(tq, flat_state(jq))
    u8 = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    return jq, tq, u8


def _stages(eng, x_q, jax_side):
    """Each stage's output (the stem's, each layer's) and the logits."""
    outs, h = {}, eng.stem.run_q(x_q, relu=True, out_requant=eng.stem_out_grid)
    outs["stem"] = h
    for i in range(1, eng.num_stages + 1):
        h = outs[f"layer{i}"] = getattr(eng, f"layer{i}")(h)
    outs["logits"] = eng.fc(jnp.mean(h, axis=(1, 2)) if jax_side else h.mean(dim=(1, 2)))
    return outs


def _assert_stages_equal(jeng, teng, u8):
    x_j = jres.u8_to_stored(jnp.asarray(u8), jeng.stem.grid)
    want = _stages(jeng, x_j, True)
    with torch.inference_mode():
        got = _stages(teng, _t(x_j), False)
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g, w, key)
        else:
            np.testing.assert_allclose(g, w, atol=F32_ATOL, rtol=F32_ATOL, err_msg=key)


@pytest.mark.parametrize("backend", ["xla", "xla-split"])
def test_integer_backends_equal_jax(cifar, backend):
    """Every conv of ResNet-20 on "xla" or "xla-split" (the downsample legs
    int16): every stage equal to JAX's same backend."""
    jq, tq, u8 = cifar
    teng = tres.build_int8_resident(tq, backend=backend, device="cpu")
    assert {m.backend for m in teng.modules() if isinstance(m, IntConv2d)} == {backend}
    _assert_stages_equal(jres.build_int8_resident(jq, backend=backend), teng, u8)


def test_s4_backends_equal_jax(cifar):
    """The int4 engine (``weight_bits=4``): its packed convs on "s4" and
    "s4-split" (two half-convs on the packed bytes), the rest on "xla",
    equal to JAX's stage by stage; and the same as the "xla" form, which
    unpacks the bytes."""
    jq, tq, u8 = cifar
    jeng = jres.build_int8_resident(jq, weight_bits=4, backend="xla")
    teng = tres.build_int8_resident(tq, weight_bits=4, backend="xla", device="cpu")
    _assert_stages_equal(jeng, teng, u8)
    jconvs = {".".join(map(str, p)): m for p, m in nnx.iter_modules(jeng) if isinstance(m, JIntConv2d)}
    packed = 0
    for name, tm in teng.named_modules():
        if isinstance(tm, IntConv2d) and tm.int4_shape is not None:
            jm = jconvs[name]
            backend = "s4" if packed % 2 else "s4-split"
            jm.set_backend(backend)
            tm.set_backend(backend)
            packed += 1
    assert packed > 10
    _assert_stages_equal(jeng, teng, u8)


def test_bf16_backends_within_the_jax_bounds(cifar):
    """Every conv on "bf16", then on "bf16-split": logits within 0.35 of the
    int8 ("pallas") engine's and of JAX's bf16 engine's, the argmax equal;
    "bf16-split" equals "bf16"; built with "bf16" equals switched to it."""
    jq, tq, u8 = cifar
    with torch.inference_mode():
        ref = tres.build_int8_resident(tq, device="cpu").run_u8(_t(u8))
        outs = {b: tres.build_int8_resident(tq, backend=b, device="cpu").run_u8(_t(u8)) for b in ("bf16", "bf16-split")}
        switched = tres.build_int8_resident(tq, device="cpu")
        for m in switched.modules():
            if isinstance(m, IntConv2d):
                m.set_backend("bf16")
        np.testing.assert_array_equal(switched.run_u8(_t(u8)).numpy(), outs["bf16"].numpy())
    want = np.asarray(jres.build_int8_resident(jq, backend="bf16").run_u8(jnp.asarray(u8)))
    for backend, got in outs.items():
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=BF16_ATOL, rtol=0, err_msg=backend)
        np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0, err_msg=backend)
        assert (got.argmax(-1) == ref.argmax(-1)).all() and (got.argmax(-1).numpy() == want.argmax(-1)).all()
    np.testing.assert_array_equal(outs["bf16-split"].numpy(), outs["bf16"].numpy())


def test_bf16_conv_forms_agree(rng):
    """The bf16 conv (an f32 conv of the bf16 values, on the CPU exact up to
    summation order), grouped and not, against a float64 conv of the same
    bf16 operands."""
    for groups, cin in ((1, 16), (8, 8)):
        xb = _t(rng.standard_normal((2, 9, 9, cin)).astype(np.float32)).to(torch.bfloat16)
        w = _t(rng.standard_normal((12 if groups == 1 else 8, cin // groups, 3, 3)).astype(np.float32))
        w = w.to(torch.bfloat16)
        ref = torch.nn.functional.conv2d(xb.double().permute(0, 3, 1, 2), w.double(), stride=2, padding=1,
                                         groups=groups).permute(0, 2, 3, 1)
        got = ops.bf16_conv(xb, w, 2, 1, groups)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert ((got.double() - ref).abs() <= 1e-5 * ref.abs().clamp_min(1.0)).all(), groups


def test_backend_names_are_checked(cifar):
    _, tq, _ = cifar
    teng = tres.build_int8_resident(tq, device="cpu")
    conv = getattr(teng.layer1, "0").conv1
    with pytest.raises(ValueError, match="not one of"):
        conv.set_backend("cudnn")
    with pytest.raises(ValueError, match="packed int4"):
        conv.set_backend("s4")
    assert set(CONV_BACKENDS) == {"pallas", "gemm", "xla", "xla-split", "bf16", "bf16-split", "s4", "s4-split"}


def test_set_backend_holds_only_its_operands(cifar):
    """A conv switched away from a backend releases that backend's operands
    (the bf16 weights and bias, K2's border sums), and the two bf16 forms
    share one copy."""
    _, tq, _ = cifar
    conv = getattr(tres.build_int8_resident(tq, device="cpu").layer3, "1").conv1  # padded, Cin 64: border sums
    assert conv.border_sums is not None and conv.w_bf16 is None and conv.bias_f is None
    conv.set_backend("bf16")
    w_bf16 = conv.w_bf16
    assert w_bf16 is not None and conv.bias_f is not None and conv.border_sums is None
    conv.set_backend("bf16-split")
    assert conv.w_bf16 is w_bf16
    conv.set_backend("gemm")
    assert conv.w_bf16 is None and conv.bias_f is None and conv.border_sums is None
    conv.set_backend("pallas")
    assert torch.equal(conv.border_sums, ops.conv_border_sums(conv.w_ck, conv.kernel_size))


@pytest.mark.parametrize("relu", [False, True])
def test_int8_matmul_xla_equals_jax(rng, relu):
    """``int8_matmul_xla`` against JAX's: the same int32 product; JAX's jit
    contracts the epilogue ``acc * alpha + beta`` into one multiply-add on
    the CPU, the port rounds the product first, so the two agree to f32
    rounding. The port's form equals its K1 path bit for bit."""
    m, k, n = 24, 320, 136
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    alpha = rng.uniform(0.01, 0.1, n).astype(np.float32)
    beta = rng.uniform(-1, 1, n).astype(np.float32)
    want = np.asarray(j_int8_matmul_xla(*(jnp.asarray(v) for v in (a, b, alpha, beta)), relu=relu))
    got = ops.int8_matmul_xla(_t(a), _t(b), _t(alpha), _t(beta), relu=relu).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=0)
    np.testing.assert_array_equal(got, ops.int8_matmul(_t(a), _t(b), _t(alpha), _t(beta), relu=relu).numpy())


def test_fc_backends_bit_exact(rng):
    """Every fc form ("pallas", "xla", "pallas:bm,bn,bk") gives the same f32
    output, within f32 rounding of JAX's IntLinear on the same weights; a
    malformed form raises."""
    k, n, m = 320, 136, 48
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    alpha = rng.uniform(0.01, 0.1, n).astype(np.float32)
    beta = rng.uniform(-1, 1, n).astype(np.float32)
    x_q = rng.integers(-128, 128, (m, k)).astype(np.int8)
    jlin = JIntLinear(jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta), 0.05, 100, relu=True)
    lin = IntLinear(_t(w), _t(alpha), _t(beta), 0.05, 100, relu=True)
    ref = lin.run_q(_t(x_q)).numpy()
    for backend in ("xla", "pallas:128,256,512", "pallas:512,512,512"):
        jlin.set_backend(backend)
        lin.set_backend(backend)
        np.testing.assert_array_equal(lin.run_q(_t(x_q)).numpy(), ref, backend)
        np.testing.assert_allclose(np.asarray(jlin.run_q(jnp.asarray(x_q))), ref, rtol=F32_RTOL, atol=0,
                                   err_msg=backend)
    with pytest.raises(ValueError):
        lin.set_backend("pallas:128,256")


@pytest.mark.parametrize("k", [320, 319])
@pytest.mark.parametrize("out_requant", [None, (0.05, 113)])
def test_int4_matmul_forms_equal_jax(rng, k, out_requant):
    """``int4_matmul_s4`` (odd K padded) and ``int4_matmul_unpacked_xla``
    against JAX's, on split-half packed bytes: int8 outputs equal, f32 ones
    within f32 rounding."""
    m, n = 16, 72
    q = rng.integers(-7, 8, (k + k % 2, n)).astype(np.int8)
    q[k:] = 0
    packed = np.asarray(j_pack_int4(jnp.asarray(q)))
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    alpha = rng.uniform(1e-3, 3e-3, n).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    kw = {} if out_requant is None else dict(out_scale=out_requant[0], out_zp=out_requant[1])
    want = np.asarray(j_int4_matmul_s4(*(jnp.asarray(v) for v in (a, packed, alpha, beta)), relu=True, **kw))
    got = ops.int4_matmul_s4(_t(a), _t(packed), _t(alpha), _t(beta), relu=True, **kw).numpy()
    # B6's plain version computes the same function on the K-major bytes
    np.testing.assert_array_equal(got, ops.int4_matmul(_t(a), _t(packed), _t(alpha), _t(beta), relu=True,
                                                       **kw).numpy())
    if out_requant is None:  # JAX's jit contracts the f32 epilogue into a multiply-add
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    if k % 2 == 0 and out_requant is None:
        want = np.asarray(j_int4_matmul_unpacked_xla(*(jnp.asarray(v) for v in (a, packed, alpha, beta)),
                                                     relu=True))
        np.testing.assert_allclose(ops.int4_matmul_unpacked_xla(_t(a), _t(packed), _t(alpha), _t(beta),
                                                                relu=True).numpy(), want, rtol=F32_RTOL, atol=0)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("out_requant", [None, (0.05, 113)])
def test_int4_conv_s4_equals_jax(rng, groups, out_requant):
    cin, cout = 16, 24
    q = rng.integers(-7, 8, (3, 3, cin // groups, cout)).astype(np.int8)
    packed = np.asarray(j_pack_int4_conv_channels(jnp.asarray(q)))
    x = rng.integers(-128, 128, (2, 9, 9, cin)).astype(np.int8)
    alpha = rng.uniform(1e-3, 3e-3, cout).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, cout).astype(np.float32)
    kw = dict(stride=(2, 2), padding=(1, 1), stored_zp=-11, relu=True, out_requant=out_requant, groups=groups)
    want = np.asarray(j_int4_conv_s4(*(jnp.asarray(v) for v in (x, packed, alpha, beta)), **kw))
    got = ops.int4_conv_s4(_t(x), _t(packed), _t(alpha), _t(beta), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ops.int8_conv_xla(_t(x), _t(q), _t(alpha), _t(beta), **kw).numpy(), got)


def test_round_s16_and_its_saturation_count(rng, monkeypatch):
    """``int8_conv_xla(round_s16=True)`` equals JAX's int16 emission; under
    QTPU_DEBUG_S16 every clipped element is counted."""
    x = rng.integers(-128, 128, (2, 8, 8, 16)).astype(np.int8)
    w = rng.integers(-127, 128, (1, 1, 16, 32)).astype(np.int8)
    alpha = rng.uniform(0.5, 2.0, 32).astype(np.float32)
    beta = rng.uniform(-50, 50, 32).astype(np.float32)
    kw = dict(stride=2, padding=0, stored_zp=-20, round_s16=True)
    want = np.asarray(j_int8_conv_xla(*(jnp.asarray(v) for v in (x, w, alpha, beta)), **kw))
    got = ops.int8_conv_xla(_t(x), _t(w), _t(alpha), _t(beta), **kw)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setenv("QTPU_DEBUG_S16", "1")
    before = tconv.s16_saturated_total()
    q = _t(np.array([1.0, -40000.0, 32767.0, 32768.0, 5e5], np.float32))
    np.testing.assert_array_equal(ops.clip_s16_checked(q).numpy(), [1, -32767, 32767, 32767, 32767])
    assert tconv.s16_saturated_total() == before + 3


def _layer_case(rng, groups):
    """A 3x3/s2 conv layer (16 -> 32 channels, or depthwise over 16) with
    per-channel epilogue vectors, on the stored zero point -15."""
    c, cout = 16, 16 if groups > 1 else 32
    w = rng.integers(-127, 128, (3, 3, c // groups, cout)).astype(np.int8)
    alpha = rng.uniform(1e-3, 3e-3, cout).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, cout).astype(np.float32)
    x = rng.integers(-128, 128, (2, 9, 9, c)).astype(np.int8)
    return w, alpha, beta, x


# each output form of run_q: int8 on a grid with ReLU, the prescaled f32
# residual form, the prescaled int16 leg, plain f32 with ReLU
RUN_FORMS = [dict(relu=True, out_requant=(0.07, 101)), dict(relu=False, out_prescale=(0.09, -7.0)),
             dict(relu=False, out_prescale=(0.09, 0.0), prescale_s16=True), dict(relu=True)]


@pytest.mark.parametrize("groups", [1, 16])
@pytest.mark.parametrize("backend", ["xla", "xla-split", "bf16", "bf16-split"])
def test_conv_layer_forms_equal_jax(rng, backend, groups):
    """One IntConv2d, dense or depthwise, on each plain backend in each of
    run_q's output forms, against JAX's IntConv2d on the same operands: the
    integer backends equal (int16 where the leg is asked for); the bf16 ones
    within 1 step on under 1% of the int8 elements, within 1e-5 of the
    value's magnitude for f32 and 1 count for int16."""
    w, alpha, beta, x = _layer_case(rng, groups)
    geo = dict(stride=(2, 2), padding=(1, 1), groups=groups, backend=backend)
    jconv = JIntConv2d(jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta), 0.05, 113, **geo)
    tconv2d = IntConv2d(_t(w), _t(alpha), _t(beta), 0.05, 113, **geo)
    for form in RUN_FORMS:
        want = np.asarray(jconv.run_q(jnp.asarray(x), **form))
        got = tconv2d.run_q(_t(x), **form).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, (backend, form)
        if backend.startswith("xla"):
            np.testing.assert_array_equal(got, want, str(form))
        elif want.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=str(form))
        else:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < (1.0 if want.dtype == np.int16 else 0.01), (form, diff)


@pytest.fixture(scope="module")
def other_builders():
    """MobileNet-v1 w0.25 (two observer-update passes: a random-init
    MobileNet's activations vanish on [-4, 4]) and AlexNet, each with a
    uint8 image and its "pallas" engine's logits."""
    from quantized_tpu_torch.engine import build_int8_alexnet, build_int8_mobilenet

    mob = t_calibrated_model("mobilenet_quantized", device="cpu", width_mult=0.25, num_classes=10)
    mob.train()
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for _ in range(2):
            mob(torch.randn((2, 32, 32, 3), generator=gen))
    cases = []
    for build, model, side in ((build_int8_mobilenet, mob.eval(), 32),
                               (build_int8_alexnet, t_calibrated_model("alexnet_quantized", device="cpu",
                                                                       num_classes=10), 224)):
        u8 = _t(np.random.default_rng(3).integers(0, 256, (1, side, side, 3), dtype=np.uint8))
        with torch.inference_mode():
            cases.append((build, model, u8, build(model, device="cpu").run_u8(u8)))
    return cases


@pytest.mark.parametrize("backend", ["xla", "xla-split", "bf16", "bf16-split"])
def test_mobilenet_and_alexnet_builders_take_the_plain_backends(other_builders, backend):
    """``build_int8_mobilenet`` (every conv, the depthwise ones included) and
    ``build_int8_alexnet`` build on each plain backend; their logits stay
    within 0.35 of the "pallas" engine's."""
    for build, model, u8, want in other_builders:
        engine = build(model, backend=backend, device="cpu")
        assert {m.backend for m in engine.modules() if isinstance(m, IntConv2d)} == {backend}
        with torch.inference_mode():
            got = engine.run_u8(u8)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=BF16_ATOL, rtol=0, err_msg=build.__name__)
