"""Grouped int8 convs of any grouping: the port's ``int8_conv_xla`` against
the JAX package's, bit for bit, on the CPU.

``feature_group_count`` splits C and Cout into ``groups`` equal slices,
output slice g reading input slice g. The port computes the exact int32
accumulator per group (``grouped_conv_acc``: int32 ``F.conv2d`` with
``groups`` on the CPU, im2col and an exact integer matmul per group on a
GPU, tap by tap for depthwise convs) and the JAX package's epilogue, so
both the f32 and the requantized int8 outputs must be equal bit for bit.
``tests/test_torch_cuda.py`` holds the GPU path against this CPU one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from quantized_tpu.ops import int8_conv as jconv
from quantized_tpu_torch import ops

# (x shape, HWIO kernel shape, groups): two input and three output channels a
# group's worth of the issue's case, four groups, and a depthwise conv with a
# channel multiplier of 2 (one input, two outputs a group), which the
# tap-by-tap depthwise path does not take
CASES = [((2, 8, 8, 8), (3, 3, 4, 6), 2), ((2, 8, 8, 8), (3, 3, 2, 8), 4), ((2, 8, 8, 8), (3, 3, 1, 16), 8)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(rng, x_shape, w_shape):
    x = rng.integers(-128, 128, x_shape).astype(np.int8)
    w = rng.integers(-127, 128, w_shape).astype(np.int8)
    cout = w_shape[3]
    alpha = (rng.uniform(0.5, 1.5, cout) * 1e-4).astype(np.float32)
    beta = rng.uniform(-1, 1, cout).astype(np.float32)
    return x, w, alpha, beta


@pytest.mark.parametrize("out_requant", [None, (0.05, 37)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("x_shape,w_shape,groups", CASES)
def test_grouped_int8_conv_xla_equals_jax(rng, x_shape, w_shape, groups, stride, out_requant):
    x, w, alpha, beta = _case(rng, x_shape, w_shape)
    kw = dict(stride=stride, padding=1, stored_zp=-17, relu=True, out_requant=out_requant, groups=groups)
    want = np.asarray(jconv.int8_conv_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta),
                                          **kw))
    got = ops.int8_conv_xla(_t(x), _t(w), _t(alpha), _t(beta), **kw).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 8 // stride, 8 // stride, w_shape[3])
    if out_requant is None:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert (want > 0).mean() > 0.2
    else:
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(want)) > 50


@pytest.mark.parametrize("x_shape,w_shape,groups", CASES)
def test_grouped_conv_acc_is_the_exact_grouped_sum(rng, x_shape, w_shape, groups):
    """The accumulator, group by group, equals a float64 conv of each
    group's channels on the zero-point-padded input (exact: every sum is an
    integer below 2**53)."""
    x, w, _, _ = _case(rng, x_shape, w_shape)
    acc = ops.grouped_conv_acc(_t(x), ops.pack_conv_weight(_t(w)), (3, 3), 2, 1, -17, groups)
    xp = F.pad(_t(x).double().permute(0, 3, 1, 2), (1, 1, 1, 1), value=-17.0)
    cg, og = x_shape[3] // groups, w_shape[3] // groups
    for g in range(groups):
        ref = F.conv2d(xp[:, g * cg:(g + 1) * cg], _t(w[..., g * og:(g + 1) * og]).double().permute(3, 2, 0, 1),
                       stride=2)
        assert torch.equal(acc[..., g * og:(g + 1) * og], ref.permute(0, 2, 3, 1).to(torch.int32))


def test_grouped_conv_acc_refuses_groupings_that_do_not_divide(rng):
    x = _t(rng.integers(-128, 128, (1, 5, 5, 6)).astype(np.int8))
    for w_shape, groups in [((3, 3, 2, 8), 3), ((3, 3, 3, 6), 4), ((3, 3, 2, 6), 2)]:  # Cout, C, K don't fit
        w = ops.pack_conv_weight(_t(rng.integers(-127, 128, w_shape).astype(np.int8)))
        with pytest.raises(ValueError):
            ops.grouped_conv_acc(x, w, (3, 3), 1, 1, -3, groups)
