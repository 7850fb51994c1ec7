"""The port's straight-through estimators, gradient quantization and
bi-precision against the JAX package's ``quantcore/ste.py``, and
``storage_shift`` / ``dequantize`` against ``quantcore/affine.py``.

Inputs come from numpy with a seed. Tolerances:

- ``fake_quant``'s gradients (identity to x, zero to the range) and
  ``quantize_grad(stochastic=False)``'s quantized cotangent: bit-exact, as
  JAX's own oracle test checks the deterministic path
  (``tests/test_quantcore_oracle.py:170``).
- Stochastic rounding cannot repeat JAX's threefry stream, so it is held
  to its contract: every element within one grad step of the exact
  cotangent, the mean error over 64 seeds within 0.05 step, the same
  generator seed giving the same gradient.
- Bi-precision: the value bit-equal to JAX's (inputs on a dyadic grid, so
  every product and sum is exact in f32 whatever the summation order); the
  weight and bias gradients (the full-precision ``out1`` path) within 1e-6
  relative (f32 sums in another order); the input gradient within the
  bound one grad step of the cotangent gives it, ``step * sum |w|``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu.models.layers import conv2d_nhwc as j_conv2d_nhwc
from quantized_tpu.quantcore import affine as jaffine
from quantized_tpu.quantcore import ste as jste
from quantized_tpu_torch.models.layers import conv2d_nhwc as t_conv2d_nhwc
from quantized_tpu_torch.quantcore import affine as taffine
from quantized_tpu_torch.quantcore import ste as tste
from torch_threads import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W_RTOL = 1e-6


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _grad_step(g: np.ndarray, num_bits: int) -> float:
    return float((g.max() - g.min()) / (2.0 ** num_bits - 1.0))


@pytest.mark.parametrize("num_bits", [2, 4, 8])
@pytest.mark.parametrize("range_from", ["given", "tensor"])
def test_fake_quant_gradient_is_straight_through(num_bits, range_from):
    rng = np.random.default_rng(num_bits)
    x = rng.standard_normal((4, 6, 6, 3)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    mn, mx = np.float32(-1.5), np.float32(1.25)

    def jloss(xx, lo, hi):
        if range_from == "tensor":  # the weight path: the range recomputed from the tensor
            lo, hi = jnp.min(xx), jnp.max(xx)
        return jnp.sum(jste.fake_quant(xx, lo, hi, num_bits=num_bits) * ct)

    jgx, jglo, jghi = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(mn), jnp.asarray(mx))
    tx, tlo, thi = _t(x, True), _t(mn, True), _t(mx, True)
    lo, hi = (tx.min(), tx.max()) if range_from == "tensor" else (tlo, thi)
    y = tste.fake_quant(tx, lo, hi, num_bits=num_bits)
    jy = jste.fake_quant(jnp.asarray(x), *((jnp.min(x), jnp.max(x)) if range_from == "tensor" else (mn, mx)),
                         num_bits=num_bits)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    gx, glo, ghi = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), (tx, tlo, thi), allow_unused=True,
                                       materialize_grads=True)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(gx.numpy(), ct)  # the identity
    for got, want in ((glo, jglo), (ghi, jghi)):
        assert float(got) == float(want) == 0.0


@pytest.mark.parametrize("num_bits", [2, 8])
def test_quantize_grad_deterministic_is_bit_exact(num_bits):
    rng = np.random.default_rng(10 + num_bits)
    x = rng.standard_normal((3, 5, 5, 4)).astype(np.float32)
    ct = (rng.standard_normal(x.shape) * 0.01).astype(np.float32)
    jgx = jax.grad(lambda xx: jnp.sum(jste.quantize_grad(xx, jax.random.key(0), num_bits=num_bits, stochastic=False)
                                      * ct))(jnp.asarray(x))
    tx = _t(x, True)
    y = tste.quantize_grad(tx, None, num_bits=num_bits, stochastic=False)
    np.testing.assert_array_equal(y.detach().numpy(), x)  # identity forward
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgx))
    assert not np.array_equal(tx.grad.numpy(), ct)  # the cotangent was quantized


@pytest.mark.parametrize("num_bits", [2, 8])
def test_quantize_grad_stochastic_contract(num_bits):
    rng = np.random.default_rng(20 + num_bits)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    step = _grad_step(ct, num_bits)

    def grad(seed):
        tx = _t(x, True)
        y = tste.quantize_grad(tx, torch.Generator().manual_seed(seed), num_bits=num_bits)
        (y * torch.from_numpy(ct)).sum().backward()
        return tx.grad.numpy()

    grads = np.stack([grad(seed) for seed in range(64)])
    err = (grads.astype(np.float64) - ct) / step
    assert np.abs(err).max() <= 1.0 + 1e-4, np.abs(err).max()
    assert abs(err.mean()) < 0.05, err.mean()
    assert len({g.tobytes() for g in grads}) > 1  # the rounding is random
    np.testing.assert_array_equal(grad(3), grads[3])  # the same seed, the same gradient
    # JAX's stochastic path keeps the same contract on its own stream
    jg = np.asarray(jax.grad(lambda xx: jnp.sum(jste.quantize_grad(xx, jax.random.key(1), num_bits=num_bits)
                                                * ct))(jnp.asarray(x)))
    assert np.abs((jg.astype(np.float64) - ct) / step).max() <= 1.0 + 1e-4


def test_stochastic_rounding_needs_a_generator():
    x = torch.ones(4, requires_grad=True)
    with pytest.raises(ValueError, match="Generator"):
        tste.quantize_grad(x, None)
    with pytest.raises(ValueError, match="Generator"):
        taffine.fake_quant_array(x.detach(), stochastic=True)


def _dyadic(rng, shape, denom):
    return (rng.integers(-8, 9, shape) / denom).astype(np.float32)


def _linear_case(rng):
    x, w, b = _dyadic(rng, (6, 12), 8), _dyadic(rng, (5, 12), 16), _dyadic(rng, (5,), 4)
    return x, w, b, rng.standard_normal((6, 5)).astype(np.float32)


def _conv_case(rng):
    x, w, b = _dyadic(rng, (2, 6, 6, 4), 8), _dyadic(rng, (3, 3, 4, 5), 16), _dyadic(rng, (5,), 4)
    return x, w, b, rng.standard_normal((2, 6, 6, 5)).astype(np.float32)


def _j_conv(xx, ww, bb):
    return j_conv2d_nhwc(xx, ww, 1, 1) + bb


def _t_conv(xx, ww, bb):
    return t_conv2d_nhwc(xx, ww, 1, 1) + bb


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_biprec_value_and_gradients(kind):
    rng = np.random.default_rng({"linear": 30, "conv": 31}[kind])
    x, w, b, ct = (_linear_case if kind == "linear" else _conv_case)(rng)
    key = jax.random.key(5)
    if kind == "linear":
        jfn = lambda xx, ww, bb: jste.linear_biprec(xx, ww, bb, key)
        tfn = lambda xx, ww, bb, g: tste.linear_biprec(xx, ww, bb, g)
        dense = lambda xx, ww, bb: jnp.dot(xx, ww.T) + bb
        w_abs_sum = np.abs(w).sum(axis=0)  # per input feature
    else:
        jfn = lambda xx, ww, bb: jste.conv_biprec(_j_conv, xx, ww, bb, key)
        tfn = lambda xx, ww, bb, g: tste.conv_biprec(_t_conv, xx, ww, bb, g)
        dense = _j_conv
        w_abs_sum = np.abs(w).sum(axis=(0, 1, 3))  # per input channel, every tap and output
    jx, jw, jb = map(jnp.asarray, (x, w, b))
    jy, vjp = jax.vjp(jfn, jx, jw, jb)
    jgx, jgw, jgb = vjp(jnp.asarray(ct))
    _, exact_vjp = jax.vjp(dense, jx, jw, jb)
    egx = np.asarray(exact_vjp(jnp.asarray(ct))[0], np.float64)

    tx, tw, tb = _t(x, True), _t(w, True), _t(b, True)
    ty = tfn(tx, tw, tb, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    (ty * torch.from_numpy(ct)).sum().backward()
    for got, want in ((tw.grad, jgw), (tb.grad, jgb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=W_RTOL, atol=W_RTOL * np.abs(want).max())
    bound = _grad_step(ct, 8) * w_abs_sum * (1 + 1e-4) + 1e-6
    for got in (tx.grad.numpy(), np.asarray(jgx)):
        assert np.all(np.abs(got - egx) <= bound), np.abs(got - egx).max()
    assert not np.allclose(tx.grad.numpy(), egx, rtol=0, atol=1e-7)  # the input gradient was quantized


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
@pytest.mark.parametrize("channel_axis", [None, -1])
def test_storage_shift_and_dequantize_bit_exact(dtype, channel_axis):
    rng = np.random.default_rng(40)
    lo, hi = (-128, 128) if dtype == "int8" else (0, 256)
    q = rng.integers(lo, hi, (3, 4, 4, 6)).astype(dtype)
    scale = rng.uniform(0.01, 0.1, 6 if channel_axis is not None else ()).astype(np.float32)
    zp = rng.integers(0, 256, 6 if channel_axis is not None else ()).astype(np.int32)
    assert taffine.storage_shift(8, getattr(torch, dtype)) == jaffine.storage_shift(8, getattr(jnp, dtype))
    assert taffine.storage_shift(4, torch.int8) == jaffine.storage_shift(4, jnp.int8) == 8
    got = taffine.dequantize(torch.from_numpy(q), torch.from_numpy(scale), torch.from_numpy(zp),
                             channel_axis=channel_axis)
    want = jaffine.dequantize(jnp.asarray(q), jnp.asarray(scale), jnp.asarray(zp), channel_axis=channel_axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stochastic_fake_quant_repeats_with_its_generator():
    """The noise comes from the generator handed in: the same seed repeats
    the draw, and ``stochastic=False`` (the default) matches JAX's
    deterministic rounding bit for bit."""
    x = torch.from_numpy(np.random.default_rng(50).standard_normal((8, 8)).astype(np.float32))
    a = taffine.fake_quant_array(x, num_bits=4, stochastic=True, generator=torch.Generator().manual_seed(1))
    b = taffine.fake_quant_array(x, num_bits=4, stochastic=True, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = jaffine.fake_quant_array(jnp.asarray(x.numpy()), num_bits=4)
    np.testing.assert_array_equal(taffine.fake_quant_array(x, num_bits=4).numpy(), np.asarray(want))
