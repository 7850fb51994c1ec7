"""The port's integer-engine pieces against the JAX package's: the stored-int8
quantizers, the int8 maxpool, the uint8 ingest, the space-to-depth stem and
the conversion of a (QConv2d, BN) or QLinear into an int layer.

Everything here is bit-exact: the int8 outputs and the float32 epilogue
parameters must be equal, except where the two sides round in a different
order on purpose (stated at the test, bound: 1 int8 step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from quantized_tpu.engine import convert as jconvert
from quantized_tpu.engine import int8_resident as jres
from quantized_tpu.engine import int_layers as jil
from quantized_tpu.models import layers as jlayers
from quantized_tpu.ops.int8_conv_pallas import int8_conv_direct as j_int8_conv_direct
from quantized_tpu_torch.engine import convert as tconvert
from quantized_tpu_torch.engine import int8_resident as tres
from quantized_tpu_torch.engine import int_layers as til
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import layers as tlayers


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def _flat_state(module) -> dict:
    return {
        ".".join(map(str, k)): np.asarray(v.get_value())
        for k, v in nnx.to_flat_state(nnx.state(module))
        if isinstance(v, (nnx.Param, nnx.BatchStat))
    }


def _t(a):
    return torch.from_numpy(np.array(a))


GRIDS = [(0.03, 120), (6.0 / 255.0, 128), (0.0123, 0), (0.05, 255)]


@pytest.mark.parametrize("grid", GRIDS)
def test_stored_quantizers_bit_exact(rng, grid):
    x = (rng.standard_normal((64, 33)) * 2).astype(np.float32)
    xq_j = jil.quantize_input_stored(jnp.asarray(x), *grid)
    xq_t = til.quantize_input_stored(_t(x), *grid)
    _eq(xq_t, xq_j)
    _eq(til.dequantize_stored(xq_t, *grid), jil.dequantize_stored(xq_j, *grid))
    _eq(til.requantize_stored(xq_t, grid, (0.041, 131)), jil.requantize_stored(xq_j, grid, (0.041, 131)))


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 56, 56, 64), (3, 4, 10, 5)])
def test_maxpool_interleave_bit_exact(rng, shape):
    x = rng.integers(-128, 128, size=shape, dtype=np.int8)
    want = jres.maxpool_3x3_s2_int8(jnp.asarray(x), impl="interleave")
    _eq(tres.maxpool_3x3_s2_int8(_t(x)), want)


@pytest.mark.parametrize("grid", GRIDS[:3])
def test_quantize_u8_stored_bit_exact(rng, grid):
    u8 = rng.integers(0, 256, (2, 9, 7, 3), dtype=np.uint8)
    _eq(tres.u8_to_stored(_t(u8), grid), jres.u8_to_stored(jnp.asarray(u8), grid))
    mean, std = np.float32([0.5, 0.4, 0.3]), np.float32([0.2, 0.25, 0.3])
    _eq(tres.quantize_u8_stored(_t(u8), grid, _t(mean), _t(std)),
        jres.quantize_u8_stored(jnp.asarray(u8), grid, jnp.asarray(mean), jnp.asarray(std)))


def _stem_pair(rng, cout=32):
    w_q = rng.integers(-127, 128, (7, 7, 3, cout)).astype(np.int8)
    alpha = rng.uniform(1e-5, 1e-3, cout).astype(np.float32)
    beta = rng.standard_normal(cout).astype(np.float32)
    jconv = jil.IntConv2d(jnp.asarray(w_q), jnp.asarray(alpha), jnp.asarray(beta),
                          act_scale=0.05, act_zero_point=120, stride=(2, 2), padding=(3, 3))
    tconv = til.IntConv2d(_t(w_q), _t(alpha), _t(beta), act_scale=0.05, act_zero_point=120,
                          stride=(2, 2), padding=(3, 3))
    return jconv, tconv


def test_space_to_depth_stem_bit_exact(rng):
    """The port's stem holds the JAX stem's remapped 4x4x12 kernel and input
    re-indexing, and its gather-K conv equals the Pallas direct conv that it
    ports on that input, bit for bit; it also equals the port's own 7x7/s2
    conv, as the rewrite is exact."""
    jconv, tconv = _stem_pair(rng)
    js2d, ts2d = jres.Int8SpaceToDepthStem(jconv), tres.Int8SpaceToDepthStem(tconv)
    _eq(ts2d.conv.weights(), js2d.w_q.get_value())
    x_q = rng.integers(-128, 128, (2, 32, 32, 3)).astype(np.int8)
    xs_j = js2d._s2d(jnp.asarray(x_q))
    _eq(ts2d._s2d(_t(x_q)), xs_j)
    grid = (0.07, 130)
    got = ts2d.run_q(_t(x_q), relu=True, out_requant=grid)
    want = j_int8_conv_direct(xs_j, js2d.w_q.get_value(), js2d.alpha.get_value(),
                              js2d.beta.get_value(), stride=1, padding=0, stored_zp=120 - 128,
                              relu=True, out_requant=grid, interpret=True)
    _eq(got, want)
    _eq(got, tconv.run_q(_t(x_q), relu=True, out_requant=grid))
    # the JAX stem itself runs XLA's conv with the requant folded into
    # alpha/beta (another rounding order): at most one int8 step apart
    diff = got.int() - _t(np.asarray(js2d.run_q(jnp.asarray(x_q), relu=True, out_requant=grid))).int()
    assert diff.abs().max() <= 1


def _qconv_bn(rng, cin, cout, k, stride):
    jconv = jlayers.QConv2d(cin, cout, k, stride=stride, padding=k // 2, use_bias=False,
                            rngs=nnx.Rngs(1))
    jconv.quantize_input.running_min.set_value(jnp.asarray([-0.3], jnp.float32))
    jconv.quantize_input.running_max.set_value(jnp.asarray([3.7], jnp.float32))
    jbn = nnx.BatchNorm(cout, momentum=0.9, epsilon=1e-5, rngs=nnx.Rngs(2))
    jbn.scale.set_value(jnp.asarray(rng.uniform(0.5, 1.5, cout), jnp.float32))
    jbn.bias.set_value(jnp.asarray(rng.uniform(-0.5, 0.5, cout), jnp.float32))
    jbn.mean.set_value(jnp.asarray(rng.uniform(-0.2, 0.2, cout), jnp.float32))
    jbn.var.set_value(jnp.asarray(rng.uniform(0.5, 2.0, cout), jnp.float32))
    g = torch.Generator().manual_seed(0)
    tconv = load_jax_arrays(tlayers.QConv2d(cin, cout, k, stride=stride, padding=k // 2,
                                            use_bias=False, generator=g), _flat_state(jconv))
    tbn = load_jax_arrays(tlayers.BatchNorm(cout), _flat_state(jbn))
    return (jconv, jbn), (tconv, tbn)


@pytest.mark.parametrize("cin,cout,k,stride,act_grid", [
    (16, 32, 3, 1, None), (32, 64, 1, 2, None), (16, 32, 3, 2, (0.021, 7)),
])
def test_convert_conv_equal(rng, cin, cout, k, stride, act_grid):
    (jconv, jbn), (tconv, tbn) = _qconv_bn(rng, cin, cout, k, stride)
    ji = jconvert._convert_conv(jconv, jbn, 8, "pallas", act_grid=act_grid)
    ti = tconvert._convert_conv(tconv, tbn, 8, "pallas", act_grid=act_grid)
    _eq(ti.weights(), ji.w_q.get_value())
    _eq(ti.alpha, ji.alpha.get_value())
    _eq(ti.beta, ji.beta.get_value())
    assert ti.grid == (ji.act_scale, ji.act_zero_point)
    assert (ti.stride, ti.padding) == (tuple(ji.stride), tuple(ji.padding))
    # and the converted layers agree through run_q with the prescaled epilogue
    x_q = rng.integers(-128, 128, (2, 8, 8, cin)).astype(np.int8)
    want = ji.run_q(jnp.asarray(x_q), relu=False, out_prescale=(0.09, -3.0))
    got = ti.run_q(_t(x_q), relu=False, out_prescale=(0.09, -3.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    _eq(ti.run_q(_t(x_q), relu=True, out_requant=(0.05, 119)),
        ji.run_q(jnp.asarray(x_q), relu=True, out_requant=(0.05, 119)))


def test_convert_linear_equal(rng):
    jlin = jlayers.QLinear(64, 20, rngs=nnx.Rngs(4))
    jlin.quantize_input.running_min.set_value(jnp.asarray([0.0], jnp.float32))
    jlin.quantize_input.running_max.set_value(jnp.asarray([2.5], jnp.float32))
    tlin = load_jax_arrays(tlayers.QLinear(64, 20, generator=torch.Generator().manual_seed(0)),
                           _flat_state(jlin))
    ji, ti = jconvert._convert_linear(jlin, None, 8, int4_pack=False), tconvert._convert_linear(tlin, None, 8)
    _eq(ti.w_q, ji.w_q.get_value())
    _eq(ti.alpha, ji.alpha.get_value())
    _eq(ti.beta, ji.beta.get_value())
    assert ti.grid == (ji.act_scale, ji.act_zero_point)
    x = rng.uniform(0, 2.5, (3, 64)).astype(np.float32)
    np.testing.assert_allclose(ti(_t(x)).numpy(), np.asarray(ji(jnp.asarray(x))), atol=1e-3, rtol=0)


def test_observer_grid_equal():
    for lo, hi in [(-4.0, 4.0), (0.0, 6.1), (-0.02, 1.3), (0.5, 0.7)]:
        jq = jlayers.QLinear(4, 2, rngs=nnx.Rngs(0))
        jq.quantize_input.running_min.set_value(jnp.asarray([lo], jnp.float32))
        jq.quantize_input.running_max.set_value(jnp.asarray([hi], jnp.float32))
        tq = load_jax_arrays(tlayers.QLinear(4, 2, generator=torch.Generator()), _flat_state(jq))
        assert tconvert.observer_grid(tq) == jconvert.observer_grid(jq)


def test_int_layers_refuse_unported_options():
    w = torch.zeros((3, 3, 4, 8), dtype=torch.int8)
    ab = torch.zeros(8)
    with pytest.raises(ValueError):
        til.IntConv2d(w, ab, ab, 0.1, 128, backend="xla")
    with pytest.raises(ValueError):
        til.IntConv2d(w, ab, ab, 0.1, 128, groups=2)
    conv = til.IntConv2d(w, ab, ab, 0.1, 128)
    with pytest.raises(ValueError):
        conv.run_q(torch.zeros((1, 4, 4, 4), dtype=torch.int8), relu=True, out_prescale=(0.1, 0.0))
