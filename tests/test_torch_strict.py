"""The port's strict engine against the JAX package's, on the CPU: the seven
cases of ``tests/test_strict_parity.py`` (the strict quantizer, a conv with
padding, bias and a zero-excluding range, a depthwise conv, a dense layer,
the float-BN and RangeBN CIFAR ResNet-20, and the ``per_tensor`` switch
that the JAX CLI's ``--weight-quant`` flag sets), then ``convert_to_int``'s
AlexNet warning.

Each layer or model is calibrated on the port's side (observer-update
passes on numpy-seeded inputs) and carried to the JAX one key for key.
Bounds, those of ``tests/test_strict_parity.py``: a strict layer within
0.05 of an activation step of its fake-quant forward (identical integer
math, f32 summation order only) and of JAX's strict layer; a strict model's
logits within 2 steps of the fc's grid of its fake-quant logits and of
JAX's, the argmax equal; the strict quantizer's integers equal.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from quantized_tpu.engine import convert_to_int as j_convert_to_int
from quantized_tpu.engine import strict as jstrict
from quantized_tpu.models import layers as jlayers
from quantized_tpu_torch.engine import convert_to_int
from quantized_tpu_torch.engine import strict as tstrict
from quantized_tpu_torch.entry import _calibrated_model
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.models import layers as tlayers
from quantized_tpu_torch.quantcore import fake_quant_array
from torch_jax_twins import jax_model, load_flat_state


def _t(a):
    return torch.from_numpy(np.array(a))


def _calibrate(module, x):
    """One observer-update pass, then eval mode."""
    module.train()
    with torch.no_grad():
        module(_t(x))
    return module.eval()


def _layer_pair(tmod, jmod, x_cal):
    """The port layer calibrated on ``x_cal`` and its JAX twin with the same
    state."""
    _calibrate(tmod, x_cal)
    load_flat_state(jmod, {k: v.numpy() for k, v in tmod.state_dict().items()})
    jmod.eval()
    return tmod, jmod


def test_strict_quantize_matches_fakequant_ints(rng):
    x = (rng.standard_normal((64, 64)) * 3.0).astype(np.float32)
    rmin, rmax = -2.0, 5.0
    scale, rmin_q = tstrict.strict_act_qparams(rmin, rmax)
    assert (scale, rmin_q) == jstrict.strict_act_qparams(rmin, rmax)
    stored = tstrict.quantize_strict_stored(_t(x), scale, rmin_q)
    np.testing.assert_array_equal(stored.numpy(), np.asarray(jstrict.quantize_strict_stored(jnp.asarray(x), scale,
                                                                                            rmin_q)))
    ref = fake_quant_array(_t(x), 8, rmin, rmax).numpy()
    np.testing.assert_array_equal(stored.numpy().astype(np.int32) + 128, np.round((ref - rmin) / scale))


@pytest.mark.parametrize("case", ["conv", "grouped"])
def test_strict_conv_matches_fakequant_and_jax(rng, case):
    """A 3x3 conv with padding, stride 2, a bias and an input range that
    excludes 0 (the border map matters); a depthwise conv over 12 channels."""
    if case == "conv":
        cin, cout, kw = 8, 16, dict(padding=1, stride=2, use_bias=True)
        x_cal, x = (rng.standard_normal((2, 4, 16, 16, cin)) + 3.0).astype(np.float32)
    else:
        cin, cout, kw = 12, 12, dict(padding=1, groups=12, use_bias=False)
        x_cal, x = (rng.standard_normal((2, 2, 8, 8, cin)) * 2.0 - 1.0).astype(np.float32)
    tconv = tlayers.QConv2d(cin, cout, 3, generator=torch.Generator().manual_seed(0), **kw)
    if tconv.bias is not None:
        with torch.no_grad():
            tconv.bias.copy_(_t((rng.standard_normal(cout) * 0.1).astype(np.float32)))
    tconv, jconv = _layer_pair(tconv, jlayers.QConv2d(cin, cout, 3, rngs=nnx.Rngs(0), **kw), x_cal)
    with torch.no_grad():
        ref = tconv(_t(x)).numpy()
        strict = tstrict.StrictIntConv2d(tconv)
        got = strict(_t(x)).numpy()
    jst = jstrict.StrictIntConv2d(jconv)
    want = np.asarray(jst(jnp.asarray(x)))
    step = strict.act_scale
    assert (strict.act_scale, strict.act_rmin, strict.s_w, strict.wmin) == (jst.act_scale, jst.act_rmin, jst.s_w,
                                                                           jst.wmin)
    np.testing.assert_array_equal(strict.w_q.numpy(), np.asarray(jst.w_q.get_value()))
    np.testing.assert_array_equal(strict.colsum.numpy(), np.asarray(jst.colsum.get_value()))
    assert np.abs(got - ref).max() < 0.05 * step, (np.abs(got - ref).max(), step)
    assert np.abs(got - want).max() < 0.05 * step, (np.abs(got - want).max(), step)


def test_strict_linear_matches_fakequant_and_jax(rng):
    x_cal, x = (rng.standard_normal((2, 16, 96)) - 0.5).astype(np.float32)
    tlin, jlin = _layer_pair(tlayers.QLinear(96, 10, generator=torch.Generator().manual_seed(0)),
                             jlayers.QLinear(96, 10, rngs=nnx.Rngs(0)), x_cal)
    with torch.no_grad():
        ref = tlin(_t(x)).numpy()
        strict = tstrict.StrictIntLinear(tlin)
        got = strict(_t(x)).numpy()
    jst = jstrict.StrictIntLinear(jlin)
    want = np.asarray(jst(jnp.asarray(x)))
    np.testing.assert_array_equal(strict.w_q.numpy(), np.asarray(jst.w_q.get_value()))
    assert np.abs(got - ref).max() < 0.05 * strict.act_scale
    assert np.abs(got - want).max() < 0.05 * strict.act_scale


@pytest.mark.parametrize("name,seed", [("resnet_quantized_float_bn", 5), ("resnet_quantized", 6)])
def test_full_model_strict_twin(rng, name, seed):
    """CIFAR ResNet-20, float-BN and RangeBN flavors: the strict engine's
    logits within 2 fc steps of the fake-quant model's and of JAX's strict
    engine's, the argmax equal; BN and RangeBN left unfolded."""
    tq = get_model(name)(dataset="cifar10", depth=20, generator=torch.Generator().manual_seed(0))
    _calibrate(tq, (rng.standard_normal((8, 32, 32, 3)) * 1.5).astype(np.float32))
    jq = load_flat_state(jax_model(name, dataset="cifar10", depth=20), {k: v.numpy() for k, v in
                                                                           tq.state_dict().items()})
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (8, 32, 32, 3)))
    with torch.no_grad():
        ref = tq(_t(x)).numpy()
    bn_type = type(tq.bn1)
    convert_to_int(tq, weight_quant="per_tensor", device="cpu")
    assert isinstance(tq.conv1, tstrict.StrictIntConv2d) and isinstance(tq.fc, tstrict.StrictIntLinear)
    assert type(tq.bn1) is bn_type  # not folded
    with torch.no_grad():
        got = tq(_t(x)).numpy()
    want = np.asarray(j_convert_to_int(jq, weight_quant="per_tensor")(jnp.asarray(x)))
    fc_step = tq.fc.act_scale
    assert np.abs(got - ref).max() < 2 * fc_step, (np.abs(got - ref).max(), fc_step)
    assert np.abs(got - want).max() < 2 * fc_step, (np.abs(got - want).max(), fc_step)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_per_tensor_switch_and_its_checks():
    """``weight_quant="per_tensor"`` (the JAX CLI's ``--weight-quant``) is the
    strict engine; the production grid folds; other values are refused."""
    model = get_model("resnet_quantized_float_bn")(dataset="cifar10", depth=20)
    assert isinstance(convert_to_int(model, weight_quant="per_tensor", device="cpu").fc, tstrict.StrictIntLinear)
    folded = convert_to_int(get_model("resnet_quantized_float_bn")(dataset="cifar10", depth=20), device="cpu")
    assert type(folded.bn1).__name__ == "Identity" and type(folded.fc).__name__ == "IntLinear"
    with pytest.raises(ValueError, match="weight_quant"):
        convert_to_int(model, weight_quant="per_row", device="cpu")
    with pytest.raises(ValueError, match="weight_bits"):
        convert_to_int(get_model("resnet_quantized_float_bn")(dataset="cifar10", depth=20), weight_bits=6,
                       device="cpu")


@pytest.mark.parametrize("flip", [False, True])
def test_convert_to_int_warns_on_negative_alexnet_bn(caplog, flip):
    """AlexNet pools between its convs and their BN: with a negative BN
    factor the surgery's pool-after-fold is unsound, and it says so (as the
    JAX module does); the all-positive model converts quietly."""
    model = _calibrated_model("alexnet_quantized", device="cpu")
    if flip:
        with torch.no_grad():
            model.bn2.scale[::7] *= -1.0
    with caplog.at_level(logging.WARNING, logger="quantized_tpu_torch.engine.convert"):
        convert_to_int(model, device="cpu")
    warned = [r for r in caplog.records if "negative-scale" in r.getMessage()]
    assert [r.getMessage().split()[0] for r in warned] == (["bn2"] if flip else [])
    assert type(model.bn2).__name__ == "Identity" and type(model.fc1).__name__ == "IntLinear"
