"""The port's AlexNet-OWT-BN and its int8-resident engine, int8 and int4
weights, against the JAX package's, with the BN scales as initialised
(``tests/test_torch_alexnet_flip.py`` negates some, so that the min-pool
dual runs; the engine checks and their tolerances are in
``tests/torch_alexnet_checks.py``).

The model is ``_calibrated_model("alexnet_quantized")`` on both sides
(observers frozen at [-4, 4], as the JAX package's serving bench builds
it), the JAX model's parameters, BN statistics and observer ranges carried
by the weight bridge (its Dropout's RNG state stays behind). AlexNet
exists only at 224x224 (fc1 takes a 6x6x256 map): the JAX engines run
eagerly on their ``"xla"`` backend, the port's on ``"pallas"`` with the
plain versions, on two images.

Tolerances of this file: the fake-quant forward, layer by layer and whole,
within 1e-5 (float32 convolutions summed in another order; measured
6e-6); the int8 VALID pools and the max/min dual equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_alexnet_checks as checks
from flax import nnx

from __graft_entry__ import _calibrated_model as j_calibrated_model
from quantized_tpu.engine import int8_alexnet as jalex
from quantized_tpu.models.alexnet import _maxpool as j_maxpool
from quantized_tpu_torch.engine import IntExecutor
from quantized_tpu_torch.engine import int8_alexnet as talex
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.models.alexnet import AlexNetOWTBN
from quantized_tpu_torch.models.alexnet import _maxpool as t_maxpool
from quantized_tpu_torch.models.alexnet_quantized import alexnet_quantized

_t, _flat_state = checks.t, checks.flat_state


@pytest.fixture(scope="module")
def engines():
    return checks.build_engines(j_calibrated_model("alexnet_quantized"), flip=False)


# ----------------------------------------------------------------- model


def _fake_quant_layers(m, relu, pool):
    """(name, layer) of a fake-quant AlexNet's forward, in order."""
    def feature(i, pooled):
        conv, bn = getattr(m, f"conv{i}"), getattr(m, f"bn{i}")
        return lambda x: relu(bn(pool(conv(x)) if pooled else conv(x)))

    def dense(i):
        fc, bn = getattr(m, f"fc{i}"), getattr(m, f"bnf{i}")
        return lambda x: relu(bn(fc(x)))

    return [("conv1", feature(1, True)), ("conv2", feature(2, True)), ("conv3", feature(3, False)),
            ("conv4", feature(4, False)), ("conv5", feature(5, True)),
            ("flatten", lambda x: x.reshape(x.shape[0], -1)), ("fc1", dense(1)), ("fc2", dense(2)),
            ("fc3", m.fc3)]


def test_weight_bridge_and_fake_quant_forward_match_jax(engines):
    """Each fake-quant layer fed the JAX model's input to it agrees within
    1e-5 (measured 6e-6: float32 convolutions summed in another order), and
    so does the port's whole forward with the JAX model's layers run
    eagerly in turn (measured 4e-7). (A jitted JAX forward lands elsewhere:
    XLA fuses the fake-quant arithmetic and a value near a grid midpoint
    rounds to the other step.)"""
    jq, tq = engines["jq"], engines["tq"]
    assert set(_flat_state(jq)) == set(tq.state_dict())
    assert tq.flatten_linear == jq.flatten_linear and tq.regime == jq.regime
    assert (tq.input_size, tq.input_transform) == (jq.input_size, jq.input_transform) == (224, "imagenet")
    assert isinstance(tq.dropout, torch.nn.Dropout) and tq.dropout.p == 0.5
    assert isinstance(tq, AlexNetOWTBN) and get_model("alexnet_quantized") is alexnet_quantized
    x = np.random.default_rng(3).standard_normal((1, 224, 224, 3)).astype(np.float32)
    h = jnp.asarray(x)
    with torch.no_grad():
        for (name, jlayer), (_, tlayer) in zip(_fake_quant_layers(jq, nnx.relu, j_maxpool),
                                               _fake_quant_layers(tq, torch.relu, t_maxpool)):
            h_next = jlayer(h)
            np.testing.assert_allclose(tlayer(_t(h)).numpy(), np.asarray(h_next), atol=1e-5, rtol=0,
                                       err_msg=name)
            h = h_next
        got = tq(_t(x)).numpy()
    assert got.shape == (1, 1000)
    np.testing.assert_allclose(got, np.asarray(h), atol=1e-5, rtol=0)


# ----------------------------------------------------------------- pools


@pytest.mark.parametrize("shape", [(2, 55, 55, 64), (1, 13, 13, 8), (2, 27, 26, 5)])
@pytest.mark.parametrize("reduce", ["max", "min"])
def test_valid_pool_matches_jax(rng, shape, reduce):
    x = rng.integers(-128, 128, shape).astype(np.int8)
    want = np.asarray(jalex.pool_3x3_s2_valid_int8(jnp.asarray(x), reduce))
    got = talex.pool_3x3_s2_valid_int8(_t(x), reduce)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_pool_dual_matches_jax(rng):
    x = rng.integers(-128, 128, (2, 27, 27, 12)).astype(np.int8)
    mask = np.zeros(12, bool)
    mask[::5] = True
    for m in (None, mask):
        want = np.asarray(jalex._pool_dual(jnp.asarray(x), None if m is None else jnp.asarray(m)))
        got = talex._pool_dual(_t(x), None if m is None else _t(m))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        talex.pool_3x3_s2_valid_int8(_t(x), "mean")


# ----------------------------------------------------------------- engines


def test_engine_layers_equal_jax(engines):
    checks.check_layers_equal_jax(engines)


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_matches_jax(engines, bits):
    checks.check_engine_matches_jax(engines, bits)


def test_run_u8_matches_f32_ingest(engines):
    checks.check_u8_ingest_matches_f32(engines)


def test_entry_points_refuse_a_missing_gpu(engines):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        talex.build_int8_alexnet(engines["tq"], weight_bits=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        IntExecutor(engines["t8"], ingest="u8")
