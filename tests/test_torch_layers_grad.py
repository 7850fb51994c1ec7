"""The port's quantized layers in training against the JAX package's:
``QConv2d``, ``QLinear`` and ``RangeBN`` in train mode, forward and every
gradient (input, weight, bias, gamma, beta) against ``nnx.grad`` of the
JAX module fed the same numpy inputs and cotangent, its parameters carried
over by the weight bridge.

- ``num_bits_grad=None`` (the plain straight-through backward), and
  ``num_bits_grad=8`` with and without bi-precision under
  ``stochastic=False`` on both sides (``quantize_grad`` patched in each
  package's layer and STE modules, as JAX's oracle test checks the
  deterministic path): the quantized cotangent is then the same bits on
  both sides, and everything else is f32 arithmetic in another summation
  order, so outputs and gradients agree within 1e-5 relative (of the
  tensor's largest magnitude).
- The observers' running ranges and RangeBN's running statistics after the
  step agree within the same bound.
- ``set_compute_dtype`` switches 22 layers of a CIFAR ResNet-20 (its 19
  convs, 2 downsample convs and the fc), and the bf16 forward lands within
  (0, 0.15) relative of the f32 one, as JAX's
  ``tests/test_training_serving.py:51`` checks its own.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from quantized_tpu.models import layers as jlayers
from quantized_tpu.quantcore import ste as jste
from quantized_tpu_torch.entry import _calibrated_model
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import layers as tlayers
from quantized_tpu_torch.quantcore import ste as tste
from quantized_tpu_torch.training import set_compute_dtype
from torch_threads import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5


def _flat(module, kinds=(nnx.Param, nnx.BatchStat)) -> dict:
    return {".".join(map(str, k)): np.asarray(v.get_value())
            for k, v in nnx.to_flat_state(nnx.state(module)) if isinstance(v, kinds)}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(np.abs(want).max(), 1e-30), err_msg=what)


@pytest.fixture
def deterministic_grad_quant(monkeypatch):
    """``quantize_grad`` with ``stochastic=False`` wherever the layers and
    bi-precision call it, in both packages."""
    jq = functools.partial(jste.quantize_grad, stochastic=False)
    tq = functools.partial(tste.quantize_grad, stochastic=False)
    monkeypatch.setattr(jlayers, "quantize_grad", jq)
    monkeypatch.setattr(jste, "quantize_grad", jq)
    monkeypatch.setattr(tlayers, "quantize_grad", tq)
    monkeypatch.setattr(tste, "quantize_grad", tq)


def _make(kind, num_bits_grad, biprecision):
    rngs, gen = nnx.Rngs(3), torch.Generator().manual_seed(3)
    if kind == "qconv":
        args = dict(in_channels=4, out_channels=6, kernel_size=3, stride=1, padding=1, num_bits_grad=num_bits_grad,
                    biprecision=biprecision)
        return (jlayers.QConv2d(**args, rngs=rngs), tlayers.QConv2d(**args, generator=gen), (2, 8, 8, 4),
                (2, 8, 8, 6))
    if kind == "qlinear":
        args = dict(in_features=12, out_features=5, num_bits_grad=num_bits_grad, biprecision=biprecision)
        return jlayers.QLinear(**args, rngs=rngs), tlayers.QLinear(**args, generator=gen), (6, 12), (6, 5)
    return (jlayers.RangeBN(6, num_bits_grad=num_bits_grad, rngs=rngs),
            tlayers.RangeBN(6, num_bits_grad=num_bits_grad, generator=gen), (4, 8, 8, 6), (4, 8, 8, 6))


CASES = [("qconv", None, False), ("qconv", 8, False), ("qconv", 8, True), ("qlinear", None, False),
         ("qlinear", 8, False), ("qlinear", 8, True), ("rangebn", None, False), ("rangebn", 8, False)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_train_mode_forward_and_gradients_match_jax(case, deterministic_grad_quant):
    kind, num_bits_grad, biprecision = CASES[case]
    jm, tm, shape, out_shape = _make(kind, num_bits_grad, biprecision)
    load_jax_arrays(tm, _flat(jm))
    rng = np.random.default_rng(case)
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(out_shape).astype(np.float32)
    jm.train()
    tm.train()

    def loss(m, xx):
        y = m(xx)
        return jnp.sum(y * ct), y

    (_, jy), (jgrads, jgx) = nnx.value_and_grad(loss, argnums=(0, 1), has_aux=True)(jm, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tm(tx)
    _close(ty.detach().numpy(), jy, f"{kind} forward")
    (ty * torch.from_numpy(ct)).sum().backward()
    _close(tx.grad.numpy(), jgx, f"{kind} d/dx")
    jg = {".".join(map(str, k)): np.asarray(v.get_value()) for k, v in nnx.to_flat_state(jgrads)}
    params = dict(tm.named_parameters())
    assert set(jg) == set(params), (sorted(jg), sorted(params))
    for name, p in params.items():
        assert p.grad is not None and p.grad.abs().max() > 0, name  # the straight-through backward is live
        _close(p.grad.numpy(), jg[name], f"{kind} d/d{name}")
    state = _flat(jm, (nnx.BatchStat,))
    for name, buf in tm.named_buffers():
        _close(buf.numpy(), state[name], f"{kind} {name} after the step")


def test_grad_quant_streams_advance_once_per_training_forward():
    conv = tlayers.QConv2d(3, 4, 3, padding=1, num_bits_grad=8, biprecision=True,
                           generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 5, 3)
    conv.train()
    conv(x).sum().backward()
    with torch.no_grad():  # a calibration pass: no gradient path, no draw
        conv(x)
    conv.eval()
    conv(x)
    assert conv.grad_quant_rng.count == 1
    assert "grad_quant_rng" not in "".join(conv.state_dict())  # neither seed nor count is a buffer


def test_bf16_compute_dtype_switches_every_product():
    model = _calibrated_model("resnet_quantized_float_bn", device="cpu", dataset="cifar10", depth=20)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        y_f32 = model(x)
        assert set_compute_dtype(model, torch.bfloat16) == 22
        y_bf16 = model(x)
        assert y_bf16.dtype == torch.float32
        rel = float((y_bf16 - y_f32).abs().max() / (y_f32.abs().max() + 1e-6))
        assert 0 < rel < 0.15, rel
        assert set_compute_dtype(model, None) == 22
        torch.testing.assert_close(model(x), y_f32, rtol=0, atol=0)
