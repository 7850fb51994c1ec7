"""The port's quant core and quantized layers against the JAX package's.

Inputs come from numpy with a seed; parameters cross from the JAX module to
the port's through the weight bridge (quantized_tpu_torch.ingest). Outputs
of the quant core must be bit-identical (the JAX package keeps its scalar
qparams in float32 and the port repeats its order of operations). Float
layer outputs (conv, BN) agree within 1e-5 relative: the two frameworks'
float convolutions sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from quantized_tpu.models import layers as jlayers
from quantized_tpu.quantcore import affine as jaffine
from quantized_tpu.quantcore import observers as jobs
from quantized_tpu.quantcore.ste import fake_quant as j_fake_quant
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import layers as tlayers
from quantized_tpu_torch.quantcore import affine as taffine
from quantized_tpu_torch.quantcore import observers as tobs
from quantized_tpu_torch.quantcore.ste import fake_quant as t_fake_quant

FLOAT_RTOL = 1e-5


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def _flat_state(module) -> dict:
    """The JAX module's parameters and statistics keyed by dotted path."""
    return {
        ".".join(map(str, k)): np.asarray(v.get_value())
        for k, v in nnx.to_flat_state(nnx.state(module))
        if isinstance(v, (nnx.Param, nnx.BatchStat))
    }


@pytest.mark.parametrize("num_bits,lo,hi,chunks,true_zero,half", [
    (8, -1.3, 2.1, None, False, False),
    (4, -0.7, 0.9, None, False, False),
    (8, None, None, None, False, False),
    (8, None, None, 16, False, False),
    (8, -1.3, 2.1, None, True, False),
    (8, -1.3, 2.1, None, False, True),
])
def test_fake_quant_array_bit_exact(rng, num_bits, lo, hi, chunks, true_zero, half):
    x = (rng.standard_normal((4, 8, 8)) * 1.5).astype(np.float32)
    kw = dict(num_bits=num_bits, num_chunks=chunks, enforce_true_zero=true_zero, out_half=half)
    want = jaffine.fake_quant_array(jnp.asarray(x), min_value=lo, max_value=hi, **kw)
    got = taffine.fake_quant_array(torch.from_numpy(x), min_value=lo, max_value=hi, **kw)
    assert got.dtype == (torch.float16 if half else torch.float32)
    _eq(got, want)
    _eq(t_fake_quant(torch.from_numpy(x), lo, hi, **kw), j_fake_quant(jnp.asarray(x), lo, hi, **kw))


@pytest.mark.parametrize("lo,hi", [(-0.37, 5.2), (0.4, 3.0), (-2.0, -0.5), (0.0, 0.0)])
def test_qparams_bit_exact(lo, hi):
    for jf, tf in [(jaffine.qparams_from_range, taffine.qparams_from_range),
                   (jaffine.nudged_qparams, taffine.nudged_qparams)]:
        (js, jz), (ts, tz) = jf(lo, hi), tf(lo, hi)
        _eq(ts, js)
        _eq(tz, jz)


@pytest.mark.parametrize("dtype,channel_axis", [("int8", None), ("uint8", None), ("int8", 1)])
def test_quantize_int_bit_exact(rng, dtype, channel_axis):
    x = rng.uniform(-2, 2, (6, 5)).astype(np.float32)
    if channel_axis is None:
        scale, zp = np.float32(0.017), np.int32(120)
    else:
        scale = rng.uniform(0.01, 0.02, 5).astype(np.float32)
        zp = rng.integers(100, 140, 5).astype(np.int32)
    want = jaffine.quantize_int(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(zp),
                                dtype=getattr(jnp, dtype), channel_axis=channel_axis)
    got = taffine.quantize_int(torch.from_numpy(x), torch.as_tensor(scale), torch.as_tensor(zp),
                               dtype=getattr(torch, dtype), channel_axis=channel_axis)
    _eq(got, want)


@pytest.mark.parametrize("training", [True, False])
def test_quant_measure_bit_exact(rng, training):
    x = (rng.standard_normal((4, 6, 6, 3)) * 2).astype(np.float32)
    rmin, rmax = np.float32([-1.5]), np.float32([2.5])
    jy, jst = jobs.quant_measure(jnp.asarray(x), jobs.QuantMeasureState(jnp.asarray(rmin), jnp.asarray(rmax)),
                                 training=training)
    ty, tst = tobs.quant_measure(torch.from_numpy(x),
                                 tobs.QuantMeasureState(torch.from_numpy(rmin), torch.from_numpy(rmax)),
                                 training=training)
    _eq(ty, jy)
    _eq(tst.running_min, jst.running_min)
    _eq(tst.running_max, jst.running_max)
    _eq(tobs.ema_update(torch.tensor([0.3]), torch.tensor(1.7)),
        jobs.ema_update(jnp.asarray([0.3]), jnp.float32(1.7)))


def _port_conv(jconv, **kw):
    g = torch.Generator().manual_seed(0)
    conv = tlayers.QConv2d(jconv.in_channels, jconv.out_channels, jconv.kernel_size,
                           generator=g, **kw)
    return load_jax_arrays(conv, _flat_state(jconv))


@pytest.mark.parametrize("training", [False, True])
def test_qconv2d_matches_jax(rng, training):
    """Eval mode quantizes on the frozen range; observer-update mode on the
    batch statistic, and both frameworks fold it into the same buffers."""
    jconv = jlayers.QConv2d(6, 8, 3, stride=2, padding=1, use_bias=True, rngs=nnx.Rngs(3))
    jconv.bias.set_value(jnp.asarray(rng.uniform(-0.2, 0.2, 8), jnp.float32))
    jconv.quantize_input.running_min.set_value(jnp.asarray([-2.0], jnp.float32))
    jconv.quantize_input.running_max.set_value(jnp.asarray([3.0], jnp.float32))
    tconv = _port_conv(jconv, stride=2, padding=1, use_bias=True)
    jconv.train() if training else jconv.eval()
    tconv.train(training)
    x = rng.standard_normal((2, 9, 9, 6)).astype(np.float32)
    want = np.asarray(jconv(jnp.asarray(x)))
    with torch.no_grad():
        got = tconv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=1e-5)
    _eq(tconv.quantize_input.running_min, jconv.quantize_input.running_min.get_value())
    _eq(tconv.quantize_input.running_max, jconv.quantize_input.running_max.get_value())


def test_qlinear_matches_jax(rng):
    jlin = jlayers.QLinear(32, 10, rngs=nnx.Rngs(5))
    jlin.quantize_input.running_min.set_value(jnp.asarray([-1.0], jnp.float32))
    jlin.quantize_input.running_max.set_value(jnp.asarray([4.0], jnp.float32))
    jlin.eval()
    tlin = load_jax_arrays(tlayers.QLinear(32, 10, generator=torch.Generator().manual_seed(0)),
                           _flat_state(jlin)).eval()
    assert tuple(tlin.weight.shape) == (10, 32)  # (out, in) as in the JAX layer
    x = rng.standard_normal((3, 32)).astype(np.float32)
    with torch.no_grad():
        got = tlin(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlin(jnp.asarray(x))), rtol=FLOAT_RTOL, atol=1e-5)


@pytest.mark.parametrize("training", [False, True])
def test_batchnorm_matches_flax(rng, training):
    jbn = nnx.BatchNorm(8, momentum=0.9, epsilon=1e-5, rngs=nnx.Rngs(0))
    jbn.scale.set_value(jnp.asarray(rng.uniform(0.5, 1.5, 8), jnp.float32))
    jbn.bias.set_value(jnp.asarray(rng.uniform(-0.5, 0.5, 8), jnp.float32))
    jbn.mean.set_value(jnp.asarray(rng.uniform(-0.5, 0.5, 8), jnp.float32))
    jbn.var.set_value(jnp.asarray(rng.uniform(0.5, 2.0, 8), jnp.float32))
    tbn = load_jax_arrays(tlayers.BatchNorm(8), _flat_state(jbn))
    jbn.train() if training else jbn.eval()
    tbn.train(training)
    x = rng.standard_normal((4, 5, 5, 8)).astype(np.float32)
    want = np.asarray(jbn(jnp.asarray(x)))
    with torch.no_grad():
        got = tbn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=1e-5)
    np.testing.assert_allclose(tbn.mean.numpy(), np.asarray(jbn.mean.get_value()), rtol=FLOAT_RTOL, atol=1e-6)
    np.testing.assert_allclose(tbn.var.numpy(), np.asarray(jbn.var.get_value()), rtol=FLOAT_RTOL, atol=1e-6)


def test_bridge_checks_keys_and_shapes_both_ways():
    conv = tlayers.QConv2d(4, 8, 3, use_bias=False, generator=torch.Generator().manual_seed(0))
    good = {k: v.numpy() for k, v in conv.state_dict().items()}
    load_jax_arrays(conv, good)
    with pytest.raises(ValueError, match="missing"):
        load_jax_arrays(conv, {k: v for k, v in good.items() if k != "kernel"})
    with pytest.raises(ValueError, match="unexpected"):
        load_jax_arrays(conv, {**good, "bias": np.zeros(8, np.float32)})
    with pytest.raises(ValueError, match="shapes"):
        load_jax_arrays(conv, {**good, "kernel": np.zeros((3, 3, 8, 4), np.float32)})
