"""The port's int8 ops (quantized_tpu_torch.ops) against the JAX package's.

Inputs are made with numpy from a seed and go through both. The JAX Pallas
kernels run in interpret mode, as tests/test_ops.py and
tests/test_pallas_conv.py run them; the port runs the plain PyTorch version
of each kernel, which is what its wrappers take for CPU tensors. int8
outputs must be equal; f32 outputs agree within atol=1e-3, the tolerance the
JAX tests allow between their own kernels and references.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu.ops import int8_conv as jconv
from quantized_tpu.ops import int8_conv_pallas as jpallas
from quantized_tpu.ops.int8_matmul import (
    int8_matmul as j_int8_matmul,
    int8_matmul_requant as j_int8_matmul_requant,
    matmul_epilogue_params as j_matmul_epilogue_params,
)
from quantized_tpu_torch import ops
from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.int8_conv_pallas import use_gather_k

F32_ATOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _conv_case(rng, n, h, cin, cout, k):
    x = rng.integers(-128, 128, (n, h, h, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    alpha = rng.uniform(1e-4, 3e-4, (cout,)).astype(np.float32)
    beta = rng.uniform(-0.1, 0.1, (cout,)).astype(np.float32)
    return x, w, alpha, beta


def _assert_same(got: torch.Tensor, want, int8: bool):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if int8:
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


# the cases of tests/test_pallas_conv.py, plus the space-to-depth stem's
# gather-K shape (Cin=12, 4x4, stride 1, no padding) and a strided gather-K
DIRECT_CASES = [
    # n, h, cin, cout, k, stride, pad, out_requant
    (4, 14, 256, 256, 3, 1, 1, None),
    (4, 14, 256, 256, 3, 1, 1, (0.07, 113)),
    (2, 28, 128, 128, 3, 2, 1, (0.05, 120)),
    (4, 8, 64, 96, 1, 1, 0, (0.05, 128)),
    (2, 15, 32, 64, 3, 2, 1, None),
    (2, 9, 512, 512, 3, 1, 1, (0.04, 99)),
    (2, 19, 12, 64, 4, 1, 0, (0.07, 130)),
    (2, 11, 12, 16, 3, 2, 1, None),
]


@pytest.mark.parametrize("n,h,cin,cout,k,s,pad,req", DIRECT_CASES)
def test_int8_conv_direct_matches_pallas(rng, n, h, cin, cout, k, s, pad, req):
    x, w, alpha, beta = _conv_case(rng, n, h, cin, cout, k)
    want = jpallas.int8_conv_direct(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta), stride=s,
        padding=pad, stored_zp=-5, relu=True, out_requant=req, interpret=True)
    got = ops.int8_conv_direct(_t(x), _t(w), _t(alpha), _t(beta), stride=s, padding=pad,
                               stored_zp=-5, relu=True, out_requant=req)
    _assert_same(got, want, req is not None)


def test_gather_k_rule_matches_pallas():
    """The gather-K form is taken where the Pallas kernel takes it
    (``cin <= 32 and taps > 1``): the stem's 4x4 over Cin=12, not a 1x1."""
    assert use_gather_k(12, (4, 4))
    assert use_gather_k(32, (3, 3))
    assert not use_gather_k(64, (3, 3))
    assert not use_gather_k(32, (1, 1))


@pytest.mark.parametrize("m,k,n,relu", [(96, 300, 200, False), (37, 2048, 130, True)])
def test_int8_matmul_matches_pallas(rng, m, k, n, relu):
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    alpha = rng.uniform(1e-4, 1e-3, (n,)).astype(np.float32)
    beta = rng.uniform(-1, 1, (n,)).astype(np.float32)
    want = j_int8_matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(alpha), jnp.asarray(beta),
                         relu=relu, interpret=True)
    got = ops.int8_matmul(_t(a), _t(b), _t(alpha), _t(beta), relu=relu)
    _assert_same(got, want, False)


@pytest.mark.parametrize("relu", [True, False])
def test_int8_matmul_requant_matches_pallas(rng, relu):
    m, k, n = 200, 576, 64
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    alpha = rng.uniform(1e-5, 1e-4, (n,)).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, (n,)).astype(np.float32)
    want = j_int8_matmul_requant(jnp.asarray(a), jnp.asarray(b), jnp.asarray(alpha),
                                 jnp.asarray(beta), 0.02, 117, relu=relu, interpret=True)
    got = ops.int8_matmul_requant(_t(a), _t(b), _t(alpha), _t(beta), 0.02, 117, relu=relu)
    _assert_same(got, want, True)


@pytest.mark.parametrize("cin,cout,k,stride,padding,req", [
    (8, 16, 3, 1, 1, None),
    (8, 16, 3, 2, 1, (0.05, 110)),
    (16, 24, 1, 2, 0, (0.03, 128)),
])
def test_int8_conv_gemm_matches_pallas(rng, cin, cout, k, stride, padding, req):
    x, w, alpha, beta = _conv_case(rng, 2, 10, cin, cout, k)
    want = jconv.int8_conv_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha),
                                jnp.asarray(beta), stride, padding, -20, relu=True,
                                out_requant=req, interpret=True)
    got = ops.int8_conv_gemm(_t(x), _t(w), _t(alpha), _t(beta), stride, padding, -20,
                             relu=True, out_requant=req)
    _assert_same(got, want, req is not None)


@pytest.mark.parametrize("req,relu", [(None, True), ((0.06, 101), True), ((0.06, 101), False)])
def test_int8_conv_xla_reference_matches_jax(rng, req, relu):
    x, w, alpha, beta = _conv_case(rng, 2, 9, 16, 32, 3)
    want = jconv.int8_conv_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha),
                               jnp.asarray(beta), 1, 1, -7, relu=relu, out_requant=req)
    got = ops.int8_conv_xla(_t(x), _t(w), _t(alpha), _t(beta), 1, 1, -7, relu=relu,
                            out_requant=req)
    _assert_same(got, want, req is not None)


def test_pad_and_im2col_match_jax(rng):
    x = rng.integers(-128, 128, (2, 7, 6, 5)).astype(np.int8)
    xp_j = jconv.pad_stored_zp(jnp.asarray(x), (1, 2), -9)
    xp_t = ops.pad_stored_zp(_t(x), (1, 2), -9)
    np.testing.assert_array_equal(xp_t.numpy(), np.asarray(xp_j))
    np.testing.assert_array_equal(ops.im2col_int8(xp_t, (3, 2), (2, 1)).numpy(),
                                  np.asarray(jconv.im2col_int8(xp_j, (3, 2), (2, 1))))


def test_matmul_epilogue_params_match_jax(rng):
    n = 48
    s_w = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    colsum = rng.integers(-4000, 4000, n).astype(np.int32)
    bias = rng.standard_normal(n).astype(np.float32)
    aj, bj = j_matmul_epilogue_params(0.0313725490196, 121, jnp.asarray(s_w),
                                      jnp.asarray(colsum), jnp.asarray(bias))
    at, bt = ops.matmul_epilogue_params(0.0313725490196, 121, _t(s_w), _t(colsum), _t(bias))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


def test_wrappers_check_their_inputs(rng):
    a = torch.zeros((4, 32), dtype=torch.int8)
    w = torch.zeros((8, 32), dtype=torch.int8)
    ab = torch.zeros(8)
    with pytest.raises(ValueError):
        ops.int8_matmul_nk(a, torch.zeros((8, 16), dtype=torch.int8), ab, ab)
    with pytest.raises(TypeError):
        ops.int8_matmul_nk(a.float(), w, ab, ab)
    with pytest.raises(ValueError):
        ops.int8_conv_direct_ck(torch.zeros((1, 4, 4, 16), dtype=torch.int8),
                                torch.zeros((8, 9 * 8), dtype=torch.int8), (3, 3), ab, ab)


def test_cpu_tensors_do_not_count_as_launches(rng):
    _cuda.reset_launches()
    x, w, alpha, beta = _conv_case(rng, 1, 6, 16, 16, 3)
    ops.int8_conv_direct(_t(x), _t(w), _t(alpha), _t(beta), stride=1, padding=1)
    ops.int8_matmul(_t(x.reshape(36, 16)), _t(w[0, 0]), _t(alpha), _t(beta))
    assert set(_cuda.launch_counts().values()) == {0}
