"""The port's int4 weight-only path against the JAX package's: the packing
functions, the plain kernel B6, the conversion at ``weight_bits=4`` and
the int4 engines (BASELINE config #4).

Packing: the port's bytes equal JAX's, split-half (a byte holds ``w[j]``
and ``w[j + K/2]``), never interleaved, for dense, flattened-conv (odd K
included) and channel-split conv weights.

Kernel B6: the port's ``int4_matmul`` on the CPU (its plain version) and
``int4_matmul_plain`` against JAX's Pallas ``int4_matmul`` run in
interpret mode and its native-S4 ``int4_matmul_s4``, f32 and requant forms
with and without ReLU, M in {1, 5, 33}, odd K and N not a multiple of 64.
The integer product is exact on both sides. f32 outputs agree within rtol
1e-6, atol 1e-5 (XLA on the CPU may contract ``acc * alpha + beta`` into
one fused multiply-add, one rounding fewer). int8 outputs are equal except
where that contraction breaks a .5 tie of the port's separately rounded
value the other way: each differing element is checked to be such a tie,
1 step apart.

Conversion: ``_convert_conv``/``_convert_linear`` at ``weight_bits=4``
give JAX's packed bytes (or, for an odd Cin, its int8 storage on the int4
grid), alpha and beta bit for bit.

Engine: CIFAR ResNet-20 at 32x32 with int4 weights against the JAX
engine (``tests/torch_int4_resnets.py`` holds the checks and their bounds;
``tests/test_torch_int4_resnet50.py`` runs them on ResNet-50 and
``tests/test_torch_int4_mobilenet.py`` holds MobileNet-v1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_int4_resnets as checks
from flax import nnx

from quantized_tpu.engine import convert as jconvert
from quantized_tpu.models import layers as jlayers
from quantized_tpu.ops import int4 as jint4
from quantized_tpu_torch import ops
from quantized_tpu_torch.engine import convert as tconvert
from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import layers as tlayers
from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.int8_matmul import exact_int_matmul, requant_scalars

F32_RTOL, F32_ATOL = 1e-6, 1e-5


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


# ----------------------------------------------------------------- packing


@pytest.mark.parametrize("shape", [(128, 32), (10, 7), (2, 1)])
def test_pack_int4_bytes_equal_jax(rng, shape):
    q = rng.integers(-8, 8, shape).astype(np.int8)
    packed = ops.pack_int4(_t(q))
    want = np.asarray(jint4.pack_int4(jnp.asarray(q)))
    assert packed.dtype == torch.int8 and tuple(packed.shape) == (shape[0] // 2, shape[1])
    np.testing.assert_array_equal(packed.numpy(), want)
    # split-half: byte j holds q[j] (low nibble) and q[j + K/2] (high nibble)
    u = want.view(np.uint8).astype(np.int32)
    np.testing.assert_array_equal(u & 15, q[: shape[0] // 2] & 15)
    np.testing.assert_array_equal(u >> 4, q[shape[0] // 2:] & 15)
    np.testing.assert_array_equal(ops.unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(ops.unpack_int4(packed).numpy(), np.asarray(jint4.unpack_int4(jnp.asarray(want))))
    with pytest.raises(ValueError):
        ops.pack_int4(_t(q[:-1]) if shape[0] % 2 == 0 else _t(q))


@pytest.mark.parametrize("shape", [(7, 7, 3, 64), (3, 3, 64, 64), (1, 1, 256, 64)])
def test_pack_int4_conv_bytes_equal_jax(rng, shape):
    """The flattened-contraction form, odd K = 147 included (zero-padded)."""
    q = rng.integers(-7, 8, shape).astype(np.int8)
    packed, s = ops.pack_int4_conv(_t(q))
    want, s_j = jint4.pack_int4_conv(jnp.asarray(q))
    assert s == tuple(s_j) == shape
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    assert packed.shape[0] == (shape[0] * shape[1] * shape[2] + 1) // 2
    np.testing.assert_array_equal(ops.unpack_int4_conv(packed, s).numpy(), q)
    np.testing.assert_array_equal(ops.unpack_int4_conv(packed, s).numpy(),
                                  np.asarray(jint4.unpack_int4_conv(want, s_j)))


@pytest.mark.parametrize("shape", [(3, 3, 64, 64), (1, 1, 256, 64), (5, 5, 2, 8), (11, 11, 4, 3)])
def test_pack_int4_conv_channels_bytes_equal_jax(rng, shape):
    q = rng.integers(-8, 8, shape).astype(np.int8)
    packed = ops.pack_int4_conv_channels(_t(q))
    want = np.asarray(jint4.pack_int4_conv_channels(jnp.asarray(q)))
    assert tuple(packed.shape) == (shape[0], shape[1], shape[2] // 2, shape[3])
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(ops.unpack_int4_conv_channels(packed).numpy(), q)
    np.testing.assert_array_equal(ops.unpack_int4_conv_channels(packed).numpy(),
                                  np.asarray(jint4.unpack_int4_conv_channels(jnp.asarray(want))))
    with pytest.raises(ValueError):  # an odd Cin per group stays unpacked
        ops.pack_int4_conv_channels(_t(q[:, :, :1]))


# ----------------------------------------------------------------- kernel B6


def _b6_case(rng, m, k, n):
    """A (M, K), int4 weights (K, N) on [-7, 7] (odd K: one zero row
    appended before packing, as _convert_linear pads), their (K/2, N)
    packed bytes, and epilogue vectors that spread the requant over the
    int8 range."""
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    q = rng.integers(-7, 8, (k + k % 2, n)).astype(np.int8)
    q[k:] = 0
    packed = np.asarray(jint4.pack_int4(jnp.asarray(q)))
    alpha = (rng.uniform(0.5, 1.5, n) * 1.2e-3 / np.sqrt(k)).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    return a, q, packed, alpha, beta


FORMS = {
    "f32": dict(relu=False),
    "f32 relu": dict(relu=True),
    "s8": dict(relu=False, out_scale=0.0047, out_zp=113),
    "s8 relu": dict(relu=True, out_scale=0.0047, out_zp=113),
}


def _assert_equal_but_fma_ties(got: np.ndarray, want: np.ndarray, pre: np.ndarray, what: str):
    """int8 outputs equal, except where XLA contracts ``acc * a2 + b2`` into
    one fused multiply-add: there the port's separately rounded value
    ``pre`` lies exactly on a .5 tie that the fused value breaks the other
    way, 1 step apart."""
    diff = np.argwhere(got != want)
    for idx in map(tuple, diff):
        assert abs(float(pre[idx]) - round(float(pre[idx]))) == 0.5, (what, idx)
        assert abs(int(got[idx]) - int(want[idx])) == 1, (what, idx)
    assert len(diff) <= 2, f"{what}: {len(diff)} ties"


@pytest.mark.parametrize("m", [1, 5, 33])
@pytest.mark.parametrize("k,n", [(301, 70), (256, 130)])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_int4_matmul_plain_matches_jax(rng, m, k, n, form):
    a, q, packed, alpha, beta = _b6_case(rng, m, k, n)
    kw = FORMS[form]
    args = (jnp.asarray(a), jnp.asarray(packed), jnp.asarray(alpha), jnp.asarray(beta))
    want_pallas = np.asarray(jint4.int4_matmul(*args, interpret=True, **kw))
    want_s4 = np.asarray(jint4.int4_matmul_s4(*args, **kw))
    _cuda.reset_launches()
    got = ops.int4_matmul(_t(a), _t(packed), _t(alpha), _t(beta), **kw)
    assert _cuda.launch_counts()["int4_matmul"] == 0  # CPU tensors run the plain version
    plain = ops.int4_matmul_plain(_t(a), _t(packed).T.contiguous(), _t(alpha), _t(beta), **kw)
    assert torch.equal(got, plain)
    got = got.numpy()
    assert got.shape == want_pallas.shape == want_s4.shape == (m, n)
    if "out_scale" not in kw:
        assert got.dtype == np.float32
        for want in (want_pallas, want_s4):
            np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
        return
    assert got.dtype == np.int8
    inv, zps, _ = requant_scalars(kw["out_scale"], kw["out_zp"], kw["relu"])
    acc = exact_int_matmul(_t(np.pad(a, ((0, 0), (0, k % 2)))), _t(q.T.copy()))
    pre = (acc.float() * (_t(alpha) * inv) + (_t(beta) * inv + zps)).numpy()
    for name, want in (("pallas", want_pallas), ("s4", want_s4)):
        _assert_equal_but_fma_ties(got, want, pre, f"{form} {name}")
    assert len(np.unique(got)) > 20 and (got == 127).mean() < 0.1  # spread over the int8 range


def test_int4_matmul_wrappers_check_their_inputs(rng):
    a, _, packed, alpha, beta = _b6_case(rng, 3, 64, 16)
    ta, tw, tal, tbe = _t(a), _t(packed).T.contiguous(), _t(alpha), _t(beta)
    with pytest.raises(ValueError):  # K = 60 does not match 32 packed bytes
        ops.int4_matmul_nk(ta[:, :60].contiguous(), tw, tal, tbe)
    with pytest.raises(ValueError):  # alpha for another N
        ops.int4_matmul_nk(ta, tw, tal[:8], tbe)
    with pytest.raises(ValueError):  # out_scale without out_zp
        ops.int4_matmul_nk(ta, tw, tal, tbe, out_scale=0.1)
    with pytest.raises(TypeError):
        ops.int4_matmul_nk(ta.float(), tw, tal, tbe)
    with pytest.raises(TypeError):
        ops.unpack_int4(tw.to(torch.uint8))


# ----------------------------------------------------------------- conversion


def _qconv_bn(rng, cin, cout, k, stride):
    jconv = jlayers.QConv2d(cin, cout, k, stride=stride, padding=k // 2, use_bias=False, rngs=nnx.Rngs(1))
    jconv.quantize_input.running_min.set_value(jnp.asarray([-0.3], jnp.float32))
    jconv.quantize_input.running_max.set_value(jnp.asarray([3.7], jnp.float32))
    jbn = nnx.BatchNorm(cout, momentum=0.9, epsilon=1e-5, rngs=nnx.Rngs(2))
    jbn.scale.set_value(jnp.asarray(rng.uniform(-1.5, 1.5, cout), jnp.float32))
    jbn.bias.set_value(jnp.asarray(rng.uniform(-0.5, 0.5, cout), jnp.float32))
    jbn.mean.set_value(jnp.asarray(rng.uniform(-0.2, 0.2, cout), jnp.float32))
    jbn.var.set_value(jnp.asarray(rng.uniform(0.5, 2.0, cout), jnp.float32))
    tconv = load_jax_arrays(tlayers.QConv2d(cin, cout, k, stride=stride, padding=k // 2, use_bias=False,
                                            generator=torch.Generator().manual_seed(0)), _flat_state(jconv))
    tbn = load_jax_arrays(tlayers.BatchNorm(cout), _flat_state(jbn))
    return (jconv, jbn), (tconv, tbn)


@pytest.mark.parametrize("cin,cout,k,stride", [(16, 32, 3, 1), (32, 24, 1, 2), (3, 16, 3, 2)])
def test_convert_conv_int4_equals_jax(rng, cin, cout, k, stride):
    """Packed channel-split bytes (an odd Cin: int8 storage on [-7, 7]),
    alpha and beta bit for bit; ``bn_factor`` equal; the packed conv runs
    like the same conv built from its unpacked weights."""
    (jconv, jbn), (tconv, tbn) = _qconv_bn(rng, cin, cout, k, stride)
    ji = jconvert._convert_conv(jconv, jbn, 4, "pallas", int4_pack=True)
    ti = tconvert._convert_conv(tconv, tbn, 4, "pallas", int4_pack=True)
    assert ti.int4_shape == (None if ji.int4_shape is None else tuple(ji.int4_shape))
    assert (ti.int4_shape is None) == (cin % 2 == 1)
    w_j = np.asarray(ji.w_q.get_value())
    if ti.int4_shape is None:
        np.testing.assert_array_equal(ti.weights().numpy(), w_j)
        assert np.abs(w_j).max() <= 7
    else:
        # the engine's (Cout, Kh*Kw, Cin/2) bytes are JAX's (Kh, Kw, Cin/2, Cout)
        np.testing.assert_array_equal(ti.w_int4.reshape(cout, k, k, cin // 2).permute(1, 2, 3, 0).numpy(), w_j)
        np.testing.assert_array_equal(ti.weights().numpy(), np.asarray(ji.weights()))
        assert not hasattr(ti, "w_ck")  # no int8 copy is kept
    np.testing.assert_array_equal(_bits(ti.alpha.numpy()), _bits(ji.alpha.get_value()))
    np.testing.assert_array_equal(_bits(ti.beta.numpy()), _bits(ji.beta.get_value()))
    np.testing.assert_array_equal(tconvert.bn_factor(tbn), jconvert.bn_factor(jbn))
    x_q = _t(rng.integers(-128, 128, (2, 8, 8, cin)).astype(np.int8))
    twin = IntConv2d(ti.weights(), ti.alpha, ti.beta, *ti.grid, stride=ti.stride, padding=ti.padding)
    for kw in (dict(relu=True, out_requant=(0.05, 119)), dict(relu=False)):
        assert torch.equal(ti.run_q(x_q, **kw), twin.run_q(x_q, **kw))


@pytest.mark.parametrize("cin", [64, 63])
def test_convert_linear_int4_equals_jax(rng, cin):
    """Split-half packed (K/2, N) bytes (odd K padded with a zero weight),
    alpha and beta bit for bit; ``run_q`` (B6's f32 form, then the separate
    quantize pass) against JAX's ``run_q`` (``int4_matmul_s4``)."""
    jlin = jlayers.QLinear(cin, 20, rngs=nnx.Rngs(4))
    jlin.quantize_input.running_min.set_value(jnp.asarray([0.0], jnp.float32))
    jlin.quantize_input.running_max.set_value(jnp.asarray([2.5], jnp.float32))
    tlin = load_jax_arrays(tlayers.QLinear(cin, 20, generator=torch.Generator().manual_seed(0)), _flat_state(jlin))
    ji = jconvert._convert_linear(jlin, None, 4, int4_pack=True)
    ti = tconvert._convert_linear(tlin, None, 4, int4_pack=True)
    assert ti.int4 and ji.int4 and tuple(ti.w_q.shape) == ((cin + 1) // 2, 20)
    np.testing.assert_array_equal(ti.w_q.numpy(), np.asarray(ji.w_q.get_value()))
    np.testing.assert_array_equal(_bits(ti.alpha.numpy()), _bits(ji.alpha.get_value()))
    np.testing.assert_array_equal(_bits(ti.beta.numpy()), _bits(ji.beta.get_value()))
    unpacked = tconvert._convert_linear(tlin, None, 4, int4_pack=False)
    assert not unpacked.int4 and np.abs(unpacked.w_q.numpy()).max() <= 7
    np.testing.assert_array_equal(ops.unpack_int4(ti.w_q.contiguous())[:cin].numpy(), unpacked.w_q.numpy())
    x_q = rng.integers(-128, 128, (3, cin)).astype(np.int8)
    y_j = np.asarray(ji.run_q(jnp.asarray(x_q), relu=True))
    np.testing.assert_allclose(ti.run_q(_t(x_q), relu=True).numpy(), y_j, rtol=F32_RTOL, atol=F32_ATOL)
    assert torch.equal(ti.run_q(_t(x_q), relu=True), unpacked.run_q(_t(x_q), relu=True))
    q_t = ti.run_q(_t(x_q), relu=True, out_requant=(0.02, 17)).numpy()
    q_j = np.asarray(ji.run_q(jnp.asarray(x_q), relu=True, out_requant=(0.02, 17)))
    assert np.abs(q_t.astype(np.int32) - q_j).max() <= 1


def test_int4_layers_refuse_mismatched_storage():
    ab = torch.zeros(8)
    with pytest.raises(ValueError):  # packed bytes of another shape
        IntConv2d(torch.zeros((3, 3, 4, 8), dtype=torch.int8), ab, ab, 0.1, 128, int4_shape=(3, 3, 4, 8))
    with pytest.raises(ValueError):  # a grouped conv does not pack
        IntConv2d(torch.zeros((3, 3, 1, 8), dtype=torch.int8), ab, ab, 0.1, 128, groups=8,
                  int4_shape=(3, 3, 2, 8))
    lin = IntLinear(torch.zeros((4, 8), dtype=torch.int8), ab, ab, 0.1, 128, int4=True)
    with pytest.raises(ValueError):  # 8 columns against 4 packed bytes (K = 8 or 7 only)
        lin.run_q(torch.zeros((2, 6), dtype=torch.int8))


# ----------------------------------------------------------------- engines

# ----------------------------------------------------------------- engines


@pytest.fixture(scope="module")
def engines():
    return checks.build_engines("cifar20")


def test_int4_engine_weights_equal_jax(engines):
    checks.check_weights_equal_jax(engines)


def test_int4_engines_fuse_nothing(engines):
    checks.check_fuse_nothing(engines)


def test_int4_engine_matches_jax(engines):
    checks.check_engine_matches_jax(engines)
