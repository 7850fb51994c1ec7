"""The port's RangeBN flavor against the JAX package's, on the CPU: the
RangeBN statistics and normalization, the ``RangeBN`` module in eval and
train mode, ``resnet_quantized`` (CIFAR ResNet-20) through the weight
bridge, the RangeBN fold, the engine's observer clamp and the weight
qparams.

Inputs are made with numpy from a seed and given to both sides. Bounds, and
why:
- the fold's factors, the folded weights and biases, the clamp's bounds and
  the weight qparams are float32 numpy (the fake-quant of the RangeBN
  vectors float32 on both sides), in the JAX order: equal;
- the statistics are means over the same values summed in another order:
  within float32 rounding (rtol 1e-6, atol 1e-6);
- the module's and the model's fake-quant forwards: within 1e-5 (float32
  sums in another order, as ``tests/test_torch_alexnet.py`` holds AlexNet's
  fake-quant forward), the running buffers within float32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from quantized_tpu.engine import convert as jconvert
from quantized_tpu.ingest import bn_fold as jfold
from quantized_tpu.ingest import calibrate as jcal
from quantized_tpu.models import layers as jlayers
from quantized_tpu.quantcore import rangebn as jrbn
from quantized_tpu_torch.engine import convert as tconvert
from quantized_tpu_torch.ingest import bn_fold as tfold
from quantized_tpu_torch.ingest import calibrate as tcal
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.models import layers as tlayers
from quantized_tpu_torch.models.resnet_quantized import RANGEBN_KIT, resnet_quantized
from quantized_tpu_torch.quantcore import rangebn as trbn
from torch_jax_twins import flat_state, jax_model


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------- quantcore


@pytest.mark.parametrize("n", [2, 70, 1000, 1024])
def test_scale_fix_equal(n):
    assert trbn.range_bn_scale_fix(n) == jrbn.range_bn_scale_fix(n)
    assert trbn.RANGE_BN_NUM_CHUNKS == jrbn.RANGE_BN_NUM_CHUNKS == 16


@pytest.mark.parametrize("shape,chunks", [
    ((4, 8, 8, 16), 16),  # B*H*W = 256: 16 chunks of 16
    ((2, 5, 7, 6), 16),   # 70: chunks of 4, the last 6 values only in the mean
    ((3, 3, 3, 5), 4),    # 27: chunks of 6, a tail of 3
])
def test_range_bn_stats_match_jax(rng, shape, chunks):
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    jm, js = jrbn.range_bn_stats(jnp.asarray(x), chunks)
    tm, ts = trbn.range_bn_stats(_t(x), chunks)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    # the tail past chunk * num_chunks stays out of the range statistic
    b, h, w, c = shape
    tail = x.transpose(3, 0, 1, 2).reshape(c, -1)
    chunk = b * h * w // chunks
    y = tail.copy()
    y[:, chunk * chunks:] = 1e6
    _, ts_tail = trbn.range_bn_stats(_t(y.reshape(c, b, h, w).transpose(1, 2, 3, 0)), chunks)
    if chunk * chunks < b * h * w:
        np.testing.assert_allclose(ts_tail.numpy(), ts.numpy(), rtol=1e-6)


@pytest.mark.parametrize("affine", [True, False])
def test_range_bn_apply_matches_jax(rng, affine):
    c = 12
    x = rng.standard_normal((2, 4, 4, c)).astype(np.float32)
    mean = (rng.standard_normal(c) * 0.2).astype(np.float32)
    scale = rng.uniform(0.3, 2.0, c).astype(np.float32)
    gamma = rng.uniform(0, 1, c).astype(np.float32) if affine else None
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32) if affine else None
    want = jrbn.range_bn_apply(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(scale),
                               None if gamma is None else jnp.asarray(gamma),
                               None if beta is None else jnp.asarray(beta))
    got = trbn.range_bn_apply(_t(x), _t(mean), _t(scale), None if gamma is None else _t(gamma),
                              None if beta is None else _t(beta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ----------------------------------------------------------------- the module


def _module_pair(c, rng):
    jbn = jlayers.RangeBN(c, rngs=nnx.Rngs(0))
    jbn.running_mean.set_value(jnp.asarray((rng.standard_normal(c) * 0.1).astype(np.float32)))
    jbn.running_var.set_value(jnp.asarray(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    jbn.bias.set_value(jnp.asarray((rng.standard_normal(c) * 0.1).astype(np.float32)))
    jbn.quantize_input.running_min.set_value(jnp.asarray([-1.5], jnp.float32))
    jbn.quantize_input.running_max.set_value(jnp.asarray([2.0], jnp.float32))
    tbn = load_jax_arrays(tlayers.RangeBN(c, generator=torch.Generator().manual_seed(0)), flat_state(jbn))
    return jbn, tbn


def test_range_bn_state_names_and_init():
    jbn = jlayers.RangeBN(8, rngs=nnx.Rngs(0))
    tbn = tlayers.RangeBN(8, generator=torch.Generator().manual_seed(0))
    assert set(flat_state(jbn)) == set(tbn.state_dict()) == {
        "running_mean", "running_var", "weight", "bias", "quantize_input.running_min",
        "quantize_input.running_max"}
    w = tbn.weight.detach().numpy()
    assert ((w >= 0) & (w < 1)).all() and (tbn.bias.detach().numpy() == 0).all()
    assert (tbn.running_mean.numpy() == 0).all() and (tbn.running_var.numpy() == 0).all()
    assert (tbn.momentum, tbn.num_chunks, tbn.eps, tbn.num_bits) == (jbn.momentum, jbn.num_chunks, jbn.eps,
                                                                   jbn.num_bits)


@pytest.mark.parametrize("shape", [(4, 6, 6, 10), (16, 10)])
def test_range_bn_eval_matches_jax(rng, shape):
    jbn, tbn = _module_pair(shape[-1], rng)
    jbn.eval()
    tbn.eval()
    x = (rng.standard_normal(shape) * 1.3).astype(np.float32)
    want = np.asarray(jbn(jnp.asarray(x)))
    with torch.no_grad():
        got = tbn(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 6, 6, 10), (3, 5, 7, 4), (64, 10)])
def test_range_bn_train_matches_jax(rng, shape):
    """Train mode: the batch statistic normalizes and folds into the running
    buffers (weight 1 - momentum), the observer updates too; twice, so the
    second pass starts from updated buffers."""
    jbn, tbn = _module_pair(shape[-1], rng)
    jbn.train()
    tbn.train()
    for _ in range(2):
        x = (rng.standard_normal(shape) * 1.3 + 0.2).astype(np.float32)
        want = np.asarray(jbn(jnp.asarray(x)))
        with torch.no_grad():
            got = tbn(_t(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for key, want in flat_state(jbn).items():
        np.testing.assert_allclose(tbn.state_dict()[key].numpy(), want, rtol=1e-6, atol=1e-6, err_msg=key)


# ----------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def cifar_pair():
    jq = jax_model("resnet_quantized", dataset="cifar10", depth=20)
    tq = resnet_quantized(dataset="cifar10", depth=20)
    return jq, load_jax_arrays(tq, flat_state(jq)).eval()


def test_registry_and_weight_bridge(cifar_pair):
    jq, tq = cifar_pair
    assert get_model("resnet_quantized") is resnet_quantized
    assert RANGEBN_KIT.bn(4, generator=torch.Generator()).__class__ is tlayers.RangeBN
    arrays = flat_state(jq)
    assert set(arrays) == set(tq.state_dict())
    assert any(k.endswith("bn1.running_var") for k in arrays)
    for key in arrays:  # carried key for key
        np.testing.assert_array_equal(tq.state_dict()[key].numpy(), arrays[key], err_msg=key)
    # checked both ways: a missing and an unexpected key each refuse the copy
    missing = dict(arrays)
    missing.pop("layer1.0.bn1.running_var")
    with pytest.raises(ValueError, match="missing"):
        load_jax_arrays(resnet_quantized(dataset="cifar10", depth=20), missing)
    with pytest.raises(ValueError, match="unexpected"):
        load_jax_arrays(resnet_quantized(dataset="cifar10", depth=20), {**arrays, "layer1.0.bn9.weight": 0})


def test_fake_quant_forward_matches_jax(cifar_pair, rng):
    """The whole CIFAR ResNet-20 fake-quant forward, and the first block's
    RangeBN fed the JAX model's input to it, within 1e-5."""
    jq, tq = cifar_pair
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jq(jnp.asarray(x)))
    with torch.no_grad():
        got = tq(_t(x)).numpy()
        z = np.asarray(jq.conv1(jnp.asarray(x)))
        np.testing.assert_allclose(tq.bn1(_t(z)).numpy(), np.asarray(jq.bn1(jnp.asarray(z))), rtol=0, atol=1e-5)
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ----------------------------------------------------------------- the fold and the clamp


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_rangebn_fold_bit_equal(rng, affine, with_bias):
    c = 24
    w = (rng.standard_normal((3, 3, 8, c)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32) if with_bias else None
    gamma = rng.uniform(0, 1, c).astype(np.float32) if affine else None
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32) if affine else None
    mean = (rng.standard_normal(c) * 0.1).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, c).astype(np.float32)
    jf, jb = jfold.rangebn_fold_params(gamma, beta, scale)
    tf, tb = tfold.rangebn_fold_params(gamma, beta, scale)
    np.testing.assert_array_equal(tf, np.asarray(jf))
    np.testing.assert_array_equal(tb, np.asarray(jb))
    jw, jbias = jfold.fold_rangebn_into_conv(w, b, gamma, beta, mean, scale)
    tw, tbias = tfold.fold_rangebn_into_conv(w, b, gamma, beta, mean, scale)
    np.testing.assert_array_equal(tw, np.asarray(jw))
    np.testing.assert_array_equal(tbias, np.asarray(jbias))


@pytest.mark.parametrize("obs", [(-1.2, 3.4), (0.5, 0.7), (1.0, 1.0)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_rangebn_y_clip_bit_equal(rng, obs, with_bias):
    """The engine's clamp bounds equal JAX's, negative gamma (a factor that
    flips the bounds) included; an observer with no range gives none."""
    cin, cout = 6, 10
    jconv = jlayers.QConv2d(cin, cout, 3, padding=1, use_bias=with_bias, rngs=nnx.Rngs(0))
    if with_bias:
        jconv.bias.set_value(jnp.asarray((rng.standard_normal(cout) * 0.1).astype(np.float32)))
    jbn = jlayers.RangeBN(cout, rngs=nnx.Rngs(1))
    gamma = rng.uniform(-1, 1, cout).astype(np.float32)
    jbn.weight.set_value(jnp.asarray(gamma))
    jbn.bias.set_value(jnp.asarray((rng.standard_normal(cout) * 0.1).astype(np.float32)))
    jbn.running_mean.set_value(jnp.asarray((rng.standard_normal(cout) * 0.1).astype(np.float32)))
    jbn.running_var.set_value(jnp.asarray(rng.uniform(0.5, 1.5, cout).astype(np.float32)))
    jbn.quantize_input.running_min.set_value(jnp.asarray([obs[0]], jnp.float32))
    jbn.quantize_input.running_max.set_value(jnp.asarray([obs[1]], jnp.float32))
    tconv = load_jax_arrays(tlayers.QConv2d(cin, cout, 3, padding=1, use_bias=with_bias,
                                            generator=torch.Generator()), flat_state(jconv))
    tbn = load_jax_arrays(tlayers.RangeBN(cout, generator=torch.Generator()), flat_state(jbn))
    jw, jb = jconvert._fold(jconv, jbn)
    tw, tb = tconvert._fold(tconv, tbn)
    np.testing.assert_array_equal(tw, np.asarray(jw))
    np.testing.assert_array_equal(tb, np.asarray(jb))
    want = jconvert._rangebn_y_clip(jconv, jbn, np.asarray(jb))
    got = tconvert._rangebn_y_clip(tconv, tbn, tb)
    if want is None:
        assert got is None
    else:
        assert got.shape == (2, cout) and (got[0] <= got[1]).all()
        np.testing.assert_array_equal(got, want)
    int_conv = tconvert._convert_conv(tconv, tbn, 8, "xla")
    jint = jconvert._convert_conv(jconv, jbn, 8, "xla")
    assert (int_conv.y_clip is None) == (jint.y_clip is None)
    if jint.y_clip is not None:
        np.testing.assert_array_equal(int_conv.y_clip.numpy(), np.asarray(jint.y_clip.get_value()))


# ----------------------------------------------------------------- weight qparams


def test_weight_qparams_bit_equal(rng):
    w = (rng.standard_normal((3, 3, 16, 32)) * 0.1).astype(np.float32)
    w[..., 5] = 0.0  # a dead channel: the scale floor
    lin = (rng.standard_normal((10, 64)) * 0.2).astype(np.float32)
    for num_bits in (8, 4):
        pairs = [(jcal.weight_qparams_per_channel(w, num_bits), tcal.weight_qparams_per_channel(w, num_bits), w),
                 (jcal.weight_qparams_per_tensor(w, num_bits), tcal.weight_qparams_per_tensor(w, num_bits), w),
                 (jcal.linear_weight_qparams_per_channel(lin, num_bits),
                  tcal.linear_weight_qparams_per_channel(lin, num_bits), None)]
        for jq, tq, src in pairs:
            assert tq.per_channel == jq.per_channel
            assert np.asarray(tq.scale).dtype == np.float32
            np.testing.assert_array_equal(np.asarray(tq.scale), np.asarray(jq.scale))
            if src is not None:
                np.testing.assert_array_equal(tq.quantize(src), jq.quantize(src))
                q = tq.quantize(src)
                np.testing.assert_array_equal(tq.dequantize(q), jq.dequantize(q))
