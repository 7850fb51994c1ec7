"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs a CUDA GPU and nvcc; elsewhere it skips. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

int8 outputs must be equal (both sides accumulate exactly and round the
epilogue in the same order, without contracting it into an FMA); f32
outputs agree within F32_ATOL.
"""

import numpy as np
import pytest
import torch
from torch_markers import cuda_device  # noqa: F401  (fixture)

from quantized_tpu_torch import ops

F32_ATOL = 1e-3

CONV_CASES = [
    # n, h, cin, cout, k, stride, pad, out_requant: ResNet-50's shapes, the
    # stem's gather-K form, and ragged / odd cases
    (2, 56, 64, 256, 1, 1, 0, None),
    (2, 56, 64, 64, 3, 1, 1, (0.07, 113)),
    (2, 56, 128, 128, 3, 2, 1, (0.05, 120)),
    (2, 56, 256, 512, 1, 2, 0, None),
    (2, 115, 12, 64, 4, 1, 0, (0.07, 130)),
    (3, 9, 12, 16, 3, 2, 1, None),
    (2, 9, 8, 70, 3, 1, 1, (0.04, 99)),
    (1, 7, 2048, 40, 1, 1, 0, (0.03, 128)),
]


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _dev(a, device):
    return torch.from_numpy(np.array(a)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout,k,s,pad,req", CONV_CASES)
def test_conv_kernel_matches_plain(cuda_device, gen, n, h, cin, cout, k, s, pad, req):
    x = _dev(gen.integers(-128, 128, (n, h, h, cin)).astype(np.int8), cuda_device)
    w_ck = _dev(gen.integers(-127, 128, (cout, k * k * cin)).astype(np.int8), cuda_device)
    alpha = _dev(gen.uniform(1e-4, 3e-4, cout).astype(np.float32), cuda_device)
    beta = _dev(gen.uniform(-0.1, 0.1, cout).astype(np.float32), cuda_device)
    args = ((k, k), alpha, beta, s, pad, -5, True, req)
    got = ops.int8_conv_direct_ck(x, w_ck, *args)
    want = ops.int8_conv_direct_plain(x, w_ck, *args)
    torch.cuda.synchronize()
    if req is None:
        torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(32, 2048, 1000), (37, 100, 70), (1000, 576, 64), (5, 16, 8)])
def test_gemm_kernel_matches_plain(cuda_device, gen, m, k, n):
    a = _dev(gen.integers(-128, 128, (m, k)).astype(np.int8), cuda_device)
    w = _dev(gen.integers(-127, 128, (n, k)).astype(np.int8), cuda_device)
    alpha = _dev(gen.uniform(1e-5, 1e-4, n).astype(np.float32), cuda_device)
    beta = _dev(gen.uniform(-1, 1, n).astype(np.float32), cuda_device)
    y = ops.int8_matmul_nk(a, w, alpha, beta, relu=True)
    q = ops.int8_matmul_requant_nk(a, w, alpha, beta, 0.05, 113, relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ops.int8_matmul_plain(a, w, alpha, beta, True), atol=F32_ATOL, rtol=0)
    assert torch.equal(q, ops.int8_matmul_requant_plain(a, w, alpha, beta, 0.05, 113, True))


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.zeros((1, 4, 4, 16), dtype=torch.int8, device=cuda_device)
    w = torch.zeros((8, 16), dtype=torch.int8, device=cuda_device)
    ab = torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError):  # a CPU tensor mixed into a CUDA call
        ops.int8_conv_direct_ck(x, w, (1, 1), ab.cpu(), ab)
    with pytest.raises(ValueError):  # not contiguous
        a = torch.zeros((16, 32), dtype=torch.int8, device=cuda_device).T
        ops.int8_matmul_nk(a, w, ab, ab)
    for cin, k in [(5, 3), (8, 1)]:  # a Cin that the gather-K / per-tap form cannot take
        x = torch.zeros((1, 4, 4, cin), dtype=torch.int8, device=cuda_device)
        w = torch.zeros((8, k * k * cin), dtype=torch.int8, device=cuda_device)
        with pytest.raises(ValueError):
            ops.int8_conv_direct_ck(x, w, (k, k), ab, ab)
