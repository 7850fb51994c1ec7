"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs a CUDA GPU and nvcc; elsewhere it skips. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

int8 outputs must be equal (both sides accumulate exactly and round the
epilogue in the same order, without contracting it into an FMA); f32
outputs agree within F32_ATOL. That holds for the fused bottleneck (B3),
BasicBlock (B4) and depthwise-separable (B5) kernels too, whose outputs are
int8, and for the int4 GEMM (B6) in both its forms.
"""

import numpy as np
import pytest
import torch
from torch_markers import cuda_device  # noqa: F401  (fixture)

from quantized_tpu_torch import ops
from quantized_tpu_torch.ops.fused_block import dw_pw_band_rows

F32_ATOL = 1e-3

CONV_CASES = [
    # n, h, cin, cout, k, stride, pad, out_requant: ResNet-50's shapes, the
    # stem's gather-K form, the CIFAR stem's Cin = 3 (gather-K in single
    # bytes), and ragged / odd cases
    (2, 56, 64, 256, 1, 1, 0, None),
    (2, 56, 64, 64, 3, 1, 1, (0.07, 113)),
    (2, 56, 128, 128, 3, 2, 1, (0.05, 120)),
    (2, 56, 256, 512, 1, 2, 0, None),
    (2, 115, 12, 64, 4, 1, 0, (0.07, 130)),
    (3, 9, 12, 16, 3, 2, 1, None),
    (2, 9, 8, 70, 3, 1, 1, (0.04, 99)),
    (1, 7, 2048, 40, 1, 1, 0, (0.03, 128)),
    (2, 32, 3, 16, 3, 1, 1, (0.05, 113)),
    (2, 9, 5, 24, 3, 2, 1, None),
    # AlexNet's conv1: 11x11/s4/p2 over Cin = 3 (gather-K in single bytes, K = 363)
    (2, 224, 3, 64, 11, 4, 2, (0.05, 113)),
    (2, 63, 3, 64, 11, 4, 2, None),
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


def _int4_case(gen, device, m, k, n, a_offset=0):
    """A (M, K) s8 (starting ``a_offset`` bytes into its buffer), int4
    weights (K, N) on [-7, 7] (odd K: a zero row appended, as the
    conversion pads) packed K-major as (N, K/2), and epilogue vectors."""
    kh = (k + 1) // 2
    q = gen.integers(-7, 8, (2 * kh, n)).astype(np.int8)
    q[k:] = 0
    w = ops.pack_int4(torch.from_numpy(q)).T.contiguous().to(device)
    buf = torch.empty(m * k + a_offset, dtype=torch.int8, device=device)
    a = buf[a_offset:].view(m, k)
    a.copy_(_dev(gen.integers(-128, 128, (m, k)).astype(np.int8), device))
    alpha = _dev((gen.uniform(0.5, 1.5, n) * 1.2e-3 / np.sqrt(k)).astype(np.float32), device)
    beta = _dev(gen.uniform(-0.5, 0.5, n).astype(np.float32), device)
    return a, w, alpha, beta


B6_CASES = [
    # m, k, n: AlexNet's fc1 and fc3 at batches 1 and 8, fc2 at 33, and a
    # batch-128 fc1; odd K; K/2 % 16 != 0 (the scalar staging path)
    (1, 9216, 4096), (8, 4096, 1000), (33, 4096, 4096), (128, 9216, 4096), (8, 301, 70), (33, 200, 1000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", B6_CASES)
@pytest.mark.parametrize("relu", [False, True])
def test_int4_gemm_kernel_matches_plain(cuda_device, gen, m, k, n, relu):
    a, w, alpha, beta = _int4_case(gen, cuda_device, m, k, n)
    before = ops.KERNELS["int4_matmul"].launches
    y = ops.int4_matmul_nk(a, w, alpha, beta, relu=relu)
    q = ops.int4_matmul_nk(a, w, alpha, beta, relu=relu, out_scale=0.05, out_zp=113)
    assert ops.KERNELS["int4_matmul"].launches == before + 2
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ops.int4_matmul_plain(a, w, alpha, beta, relu), atol=F32_ATOL, rtol=0)
    assert torch.equal(q, ops.int4_matmul_plain(a, w, alpha, beta, relu, out_scale=0.05, out_zp=113))


@pytest.mark.cuda
def test_int4_gemm_scalar_path_on_an_unaligned_pointer(cuda_device, gen):
    a, w, alpha, beta = _int4_case(gen, cuda_device, 5, 256, 130, a_offset=1)
    assert a.data_ptr() % 16 != 0 and a.is_contiguous()
    y = ops.int4_matmul_nk(a, w, alpha, beta, relu=True)
    q = ops.int4_matmul_nk(a, w, alpha, beta, out_scale=0.05, out_zp=113)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ops.int4_matmul_plain(a, w, alpha, beta, True), atol=F32_ATOL, rtol=0)
    assert torch.equal(q, ops.int4_matmul_plain(a, w, alpha, beta, out_scale=0.05, out_zp=113))


@pytest.mark.cuda
def test_int4_linear_on_the_gpu_equals_its_cpu_result(cuda_device, gen):
    """``IntLinear(int4=True)``: B6's f32 form and the quantize pass on the
    GPU against the plain version on the CPU."""
    from quantized_tpu_torch.engine.int_layers import IntLinear

    k, n = 4095, 1000
    q = gen.integers(-7, 8, (k + 1, n)).astype(np.int8)
    q[k:] = 0
    packed = ops.pack_int4(torch.from_numpy(q))
    alpha = torch.from_numpy((gen.uniform(0.5, 1.5, n) * 1.2e-3 / np.sqrt(k)).astype(np.float32))
    beta = torch.from_numpy(gen.uniform(-0.5, 0.5, n).astype(np.float32))
    cpu = IntLinear(packed, alpha, beta, 0.02, 7, int4=True)
    gpu = IntLinear(packed, alpha, beta, 0.02, 7, int4=True).to(cuda_device)
    x = torch.from_numpy(gen.integers(-128, 128, (32, k)).astype(np.int8))
    before = ops.KERNELS["int4_matmul"].launches
    y = gpu.run_q(x.to(cuda_device), relu=True)
    h = gpu.run_q(x.to(cuda_device), relu=True, out_requant=(0.05, 120))
    assert ops.KERNELS["int4_matmul"].launches == before + 2
    torch.cuda.synchronize()
    torch.testing.assert_close(y.cpu(), cpu.run_q(x, relu=True), atol=F32_ATOL, rtol=0)
    assert torch.equal(h.cpu(), cpu.run_q(x, relu=True, out_requant=(0.05, 120)))


def _fused_case(gen, device, n, h, c, cm, cout, ds):
    """x, K-major weights and epilogue vectors, scaled so the requants land
    inside the int8 range rather than on a clip."""
    def mat(rows, k):
        return _dev(gen.integers(-127, 128, (rows, k)).astype(np.int8), device)

    def vec(k, length, spread):
        a = (gen.uniform(0.5, 1.5, length) * spread / np.sqrt(k)).astype(np.float32)
        return _dev(a, device), _dev(gen.uniform(-8, 8, length).astype(np.float32), device)

    x = _dev(gen.integers(-128, 128, (n, h, h, c)).astype(np.int8), device)
    w = [mat(cm, c), mat(cm, 9 * cm), mat(cout, cm)] + ([mat(cout, c)] if ds else [])
    v = [*vec(c, cm, 4e-3), *vec(9 * cm, cm, 6e-3), *vec(cm, cout, 6e-3)]
    if ds:
        v += [*vec(c, cout, 6e-3)]
    return x, w, v


FUSED_SCALARS = dict(lo1=-21.0, lo2=-9.0, shift=-3.0, zp2_stored=-21)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,c,cm", [
    # ResNet-50's identity blocks (layer1, layer3, layer4), and widths that
    # are not multiples of the 64-wide tile over an image the bands split unevenly
    (2, 56, 256, 64), (2, 14, 1024, 256), (2, 7, 2048, 512), (3, 9, 80, 48), (2, 11, 32, 16),
])
def test_fused_s1_kernel_matches_plain(cuda_device, gen, n, h, c, cm):
    x, w, v = _fused_case(gen, cuda_device, n, h, c, cm, c, ds=False)
    args = (*w, *v)
    kw = dict(FUSED_SCALARS, id_k=0.8137192, id_c=2.71828)
    before = ops.KERNELS["fused_bottleneck_s1"].launches
    got = ops.fused_bottleneck_s1_ck(x, *args, **kw)
    assert ops.KERNELS["fused_bottleneck_s1"].launches == before + 1
    want = ops.fused_bottleneck_s1_plain(x, *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,c,cm,cout,stride,fine", [
    # ResNet-50's downsample blocks: layer1.0 (stride 1), layer2.0, layer4.0
    (2, 56, 64, 64, 256, 1, 32.0), (2, 56, 256, 128, 512, 2, 32.0), (2, 14, 1024, 512, 2048, 2, 32.0),
    (2, 56, 256, 128, 512, 2, 0.0),
    # ragged widths and bands
    (3, 10, 48, 32, 80, 2, 32.0), (2, 9, 32, 16, 40, 1, 0.0),
])
def test_fused_ds_kernel_matches_plain(cuda_device, gen, n, h, c, cm, cout, stride, fine):
    x, w, v = _fused_case(gen, cuda_device, n, h, c, cm, cout, ds=True)
    args = (*w, *v, stride)
    kw = dict(FUSED_SCALARS, ds_fine=fine)
    before = ops.KERNELS["fused_bottleneck_ds"].launches
    got = ops.fused_bottleneck_ds_ck(x, *args, **kw)
    assert ops.KERNELS["fused_bottleneck_ds"].launches == before + 1
    want = ops.fused_bottleneck_ds_plain(x, *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_wrappers_raise_on_shapes_the_kernel_refuses(cuda_device, gen):
    x, w, v = _fused_case(gen, cuda_device, 1, 8, 24, 16, 32, ds=True)  # C = 24: not a multiple of 16
    with pytest.raises(ValueError):
        ops.fused_bottleneck_ds_ck(x, *w, *v, 1, **FUSED_SCALARS)
    x, w, v = _fused_case(gen, cuda_device, 1, 8, 32, 16, 32, ds=True)
    with pytest.raises(ValueError):  # stride 2 over an odd image
        ops.fused_bottleneck_ds_ck(x[:, :7, :7].contiguous(), *w, *v, 2, **FUSED_SCALARS)
    with pytest.raises(ValueError):  # a CPU vector mixed into a CUDA call
        ops.fused_bottleneck_ds_ck(x, *w, v[0].cpu(), *v[1:], 1, **FUSED_SCALARS)


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
    for cin, k in [(24, 1), (8, 1)]:  # a Cin that the per-tap form cannot take
        x = torch.zeros((1, 4, 4, cin), dtype=torch.int8, device=cuda_device)
        w = torch.zeros((8, k * k * cin), dtype=torch.int8, device=cuda_device)
        with pytest.raises(ValueError):
            ops.int8_conv_direct_ck(x, w, (k, k), ab, ab)


def _basic_case(gen, device, n, h, c, cm, ds):
    """x, K-major weights (w1 (Cm, 9*C), w2 (Cm, 9*Cm), wd (Cm, C)) and
    epilogue vectors, scaled so the requants land inside the int8 range."""
    def mat(rows, k):
        return _dev(gen.integers(-127, 128, (rows, k)).astype(np.int8), device)

    def vec(k, spread):
        a = (gen.uniform(0.5, 1.5, cm) * spread / np.sqrt(k)).astype(np.float32)
        return _dev(a, device), _dev(gen.uniform(-8, 8, cm).astype(np.float32), device)

    x = _dev(gen.integers(-128, 128, (n, h, h, c)).astype(np.int8), device)
    w = [mat(cm, 9 * c), mat(cm, 9 * cm)] + ([mat(cm, c)] if ds else [])
    v = [*vec(9 * c, 4e-3), *vec(9 * cm, 6e-3)] + ([*vec(c, 6e-3)] if ds else [])
    return x, w, v


BASIC_SCALARS = dict(lo1=-21.0, shift=-3.0, zp1_stored=-17, zp2_stored=-40)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,c", [
    # ResNet-18's layer1 and layer3 identity blocks, CIFAR's layer1 (C = 16),
    # and bands that do not divide the image (19 rows in bands of 10)
    (2, 56, 64), (2, 14, 256), (2, 32, 16), (3, 19, 16), (2, 11, 32),
])
def test_fused_basicblock_s1_kernel_matches_plain(cuda_device, gen, n, h, c):
    x, w, v = _basic_case(gen, cuda_device, n, h, c, c, ds=False)
    kw = dict(BASIC_SCALARS, id_k=0.8137192, id_c=2.71828)
    before = ops.KERNELS["fused_basicblock_s1"].launches
    got = ops.fused_basicblock_s1_ck(x, *w, *v, **kw)
    assert ops.KERNELS["fused_basicblock_s1"].launches == before + 1
    want = ops.fused_basicblock_s1_plain(x, *w, *v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,c,cm,stride,fine", [
    # ResNet-18's layer2.0 and layer4.0, CIFAR's layer2.0 with and without the
    # int16 leg, uneven bands (19 output rows), and a stride-1 downsample
    (2, 56, 64, 128, 2, 32.0), (2, 14, 256, 512, 2, 32.0), (2, 32, 16, 32, 2, 32.0),
    (2, 32, 16, 32, 2, 0.0), (3, 38, 16, 32, 2, 32.0), (2, 9, 32, 48, 1, 0.0),
])
def test_fused_basicblock_ds_kernel_matches_plain(cuda_device, gen, n, h, c, cm, stride, fine):
    x, w, v = _basic_case(gen, cuda_device, n, h, c, cm, ds=True)
    kw = dict(BASIC_SCALARS, ds_fine=fine)
    before = ops.KERNELS["fused_basicblock_ds"].launches
    got = ops.fused_basicblock_ds_ck(x, *w, *v, stride, **kw)
    assert ops.KERNELS["fused_basicblock_ds"].launches == before + 1
    want = ops.fused_basicblock_ds_plain(x, *w, *v, stride, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_basicblock_wrappers_raise_on_shapes_the_kernel_refuses(cuda_device, gen):
    x, w, v = _basic_case(gen, cuda_device, 1, 8, 24, 16, ds=True)  # C = 24: not a multiple of 16
    with pytest.raises(ValueError):
        ops.fused_basicblock_ds_ck(x, *w, *v, 1, **BASIC_SCALARS)
    x, w, v = _basic_case(gen, cuda_device, 1, 8, 32, 16, ds=True)
    with pytest.raises(ValueError):  # stride 2 over an odd image
        ops.fused_basicblock_ds_ck(x[:, :7, :7].contiguous(), *w, *v, 2, **BASIC_SCALARS)
    with pytest.raises(ValueError):  # a CPU vector mixed into a CUDA call
        ops.fused_basicblock_ds_ck(x, *w, v[0].cpu(), *v[1:], 1, **BASIC_SCALARS)


def _dw_pw_case(gen, device, n, h, c, cout):
    """x, K-major weights (depthwise (C, 9), pointwise (Cout, C)) and
    epilogue vectors, scaled so both requants land inside the int8 range."""
    x = _dev(gen.integers(-128, 128, (n, h, h, c)).astype(np.int8), device)
    wdw = _dev(gen.integers(-127, 128, (c, 9)).astype(np.int8), device)
    wpw = _dev(gen.integers(-127, 128, (cout, c)).astype(np.int8), device)
    v = [(gen.uniform(0.5, 1.5, c) * 4e-2 / 3), gen.uniform(-8, 8, c),
         (gen.uniform(0.5, 1.5, cout) * 6e-3 / np.sqrt(c)), gen.uniform(-8, 8, cout)]
    return x, wdw, wpw, [_dev(a.astype(np.float32), device) for a in v]


DW_PW_SCALARS = dict(lo1=-21.0, lo2=-9.0, zp1_stored=-17)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,c,cout,stride", [
    # MobileNet-v1's pairs 0, 1, 6 and 11 at 224x224 (two images)
    (2, 112, 32, 64, 1), (2, 112, 64, 128, 2), (2, 14, 512, 512, 1), (2, 14, 512, 1024, 2),
    # C = 32 (half a K step) at stride 2 and stride 1, and C = 48 with Cout = 40
    # and Cout = 200 (not multiples of the 64-wide tile), in bands that do not
    # divide Ho (3 rows over 11 and 20, 4 over 13)
    (32, 22, 32, 64, 2), (32, 20, 32, 64, 1), (32, 26, 48, 40, 2), (4, 14, 128, 200, 1),
])
def test_fused_dw_pw_kernel_matches_plain(cuda_device, gen, n, h, c, cout, stride):
    x, wdw, wpw, v = _dw_pw_case(gen, cuda_device, n, h, c, cout)
    ho = h // stride
    if n == 32:
        assert ho % dw_pw_band_rows(n, ho, h, c, cout, stride), "the case should have a ragged last band"
    before = ops.KERNELS["fused_dw_pw"].launches
    got = ops.fused_dw_pw_ck(x, wdw, wpw, *v, stride, **DW_PW_SCALARS)
    assert ops.KERNELS["fused_dw_pw"].launches == before + 1
    want = ops.fused_dw_pw_plain(x, wdw, wpw, *v, stride, **DW_PW_SCALARS)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert len(torch.unique(want)) > 100


@pytest.mark.cuda
def test_fused_dw_pw_wrapper_raises_on_shapes_the_kernel_refuses(cuda_device, gen):
    x, wdw, wpw, v = _dw_pw_case(gen, cuda_device, 1, 8, 24, 16)  # C = 24: not a multiple of 16
    with pytest.raises(ValueError):
        ops.fused_dw_pw_ck(x, wdw, wpw, *v, 1, **DW_PW_SCALARS)
    x, wdw, wpw, v = _dw_pw_case(gen, cuda_device, 1, 8, 32, 16)
    with pytest.raises(ValueError):  # stride 2 over an odd image
        ops.fused_dw_pw_ck(x[:, :7, :7].contiguous(), wdw, wpw, *v, 2, **DW_PW_SCALARS)
    with pytest.raises(ValueError):  # a CPU vector mixed into a CUDA call
        ops.fused_dw_pw_ck(x, wdw, wpw, v[0].cpu(), *v[1:], 1, **DW_PW_SCALARS)
