"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs a CUDA GPU and nvcc; elsewhere it skips. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

int8 outputs must be equal (both sides accumulate exactly and round the
epilogue in the same order, without contracting it into an FMA); f32
outputs agree within F32_ATOL. That holds for the fused bottleneck (B3),
BasicBlock (B4) and depthwise-separable (B5) kernels too, whose outputs are
int8, for the int4 GEMM (B6) in both its forms, for the flat-row conv (B7)
and K2's fused-residual form (B8); the copy kernels (B9) are exact.
"""

import numpy as np
import pytest
import torch
from torch_markers import cuda_device  # noqa: F401  (fixture)

from quantized_tpu_torch import ops
from quantized_tpu_torch.ops.fused_block import dw_pw_band_rows, dw_pw_plan
from quantized_tpu_torch.ops.int8_matmul import gemm_plan
from torch_gemm_shapes import RAGGED_SPLIT, distinct_plans

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
    # 1x1 convs (the per-tap form) over Cin % 16 != 0: 4-byte chunks (Cin 24,
    # MobileNet-v1's first pointwise conv at width 0.75) and single bytes
    (2, 112, 24, 48, 1, 1, 0, (0.05, 113)), (2, 14, 9, 40, 1, 1, 0, None), (2, 14, 3, 16, 1, 1, 0, (0.05, 113)),
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
@pytest.mark.parametrize("m,k,n", [
    (32, 2048, 1000), (37, 100, 70), (1000, 576, 64), (5, 16, 8),
    # K % 16 != 0, the general tile: the stems' im2col K (CIFAR and MobileNet
    # 27, the 7x7 147, AlexNet's conv1 363) and an odd K
    (300, 27, 16), (64, 147, 64), (40, 363, 64), (9, 301, 130),
])
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


def _gemm_case(gen, device, m, k, n, a_offset=0):
    """A (M, K) s8 (starting ``a_offset`` bytes into its buffer), W (N, K) s8
    and epilogue vectors scaled so the requant lands inside the int8 range."""
    buf = torch.empty(m * k + a_offset, dtype=torch.int8, device=device)
    a = buf[a_offset:].view(m, k)
    a.copy_(_dev(gen.integers(-128, 128, (m, k)).astype(np.int8), device))
    w = _dev(gen.integers(-127, 128, (n, k)).astype(np.int8), device)
    alpha = _dev((gen.uniform(0.5, 1.5, n) * 1e-4 / np.sqrt(k)).astype(np.float32), device)
    beta = _dev(gen.uniform(-0.5, 0.5, n).astype(np.float32), device)
    return a, w, alpha, beta


def _check_k1(a, w, alpha, beta):
    """K1 in both forms against its plain versions: s8 equal, f32 within
    F32_ATOL (0 expected: int32 sums are exact and the epilogue rounds as the
    plain version does); returns the f32 max_abs_err."""
    before = (ops.KERNELS["int8_matmul"].launches, ops.KERNELS["int8_matmul_requant"].launches)
    y = ops.int8_matmul_nk(a, w, alpha, beta, relu=True)
    q = ops.int8_matmul_requant_nk(a, w, alpha, beta, 0.05, 113, relu=True)
    assert (ops.KERNELS["int8_matmul"].launches, ops.KERNELS["int8_matmul_requant"].launches) == (
        before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    err = (y - ops.int8_matmul_plain(a, w, alpha, beta, True)).abs().max().item()
    assert err <= F32_ATOL
    want = ops.int8_matmul_requant_plain(a, w, alpha, beta, 0.05, 113, True)
    assert torch.equal(q, want)
    assert len(torch.unique(q)) > 20  # spread over the int8 range, not stuck on a clip
    return err


@pytest.mark.cuda
@pytest.mark.parametrize("label,m,n,k", distinct_plans(packed=False))
def test_gemm_kernel_matches_plain_at_every_plan(cuda_device, gen, label, m, n, k):
    """One product per distinct (tile, split, stages) of gemm_plan over the
    engines' K1 products, f32 and s8."""
    err = _check_k1(*_gemm_case(gen, cuda_device, m, k, n))
    print(f"K1 {label} {m}x{k}x{n} {gemm_plan(m, n, k)}: f32 max_abs_err {err}")


@pytest.mark.cuda
def test_gemm_general_path_on_an_unaligned_pointer(cuda_device, gen):
    """K % 16 == 0 but A starts off a 16-byte boundary: TMA cannot take it,
    the general tile does."""
    a, w, alpha, beta = _gemm_case(gen, cuda_device, 33, 2048, 1000, a_offset=3)
    assert a.data_ptr() % 16 != 0 and a.is_contiguous()
    _check_k1(a, w, alpha, beta)


@pytest.mark.cuda
def test_gemm_kernels_are_deterministic_and_take_the_current_stream(cuda_device, gen):
    """Two calls on the same inputs give the same bytes (the K split adds
    int32 sums, in any order the same), also on a non-default stream."""
    m, k, n = 32, 9216, 4096  # AlexNet's fc1: a split of 3
    assert gemm_plan(m, n, k).split > 1 and gemm_plan(m, n, k, packed=True).split > 1
    a, w, alpha, beta = _gemm_case(gen, cuda_device, m, k, n)
    a4, w4, alpha4, beta4 = _int4_case(gen, cuda_device, m, k, n)

    def calls():
        return [ops.int8_matmul_nk(a, w, alpha, beta, relu=True),
                ops.int8_matmul_requant_nk(a, w, alpha, beta, 0.05, 113),
                ops.int4_matmul_nk(a4, w4, alpha4, beta4, relu=True),
                ops.int4_matmul_nk(a4, w4, alpha4, beta4, out_scale=0.05, out_zp=113)]

    first = calls()
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):
        second = calls()
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x.view(torch.int8) if x.dtype == torch.int8 else x.view(torch.int32),
                           y.view(torch.int8) if y.dtype == torch.int8 else y.view(torch.int32))
    torch.testing.assert_close(second[0], ops.int8_matmul_plain(a, w, alpha, beta, True), atol=F32_ATOL, rtol=0)
    assert torch.equal(second[3], ops.int4_matmul_plain(a4, w4, alpha4, beta4, out_scale=0.05, out_zp=113))


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
@pytest.mark.parametrize("label,m,n,k", distinct_plans(packed=True))
def test_int4_gemm_kernel_matches_plain_at_every_plan(cuda_device, gen, label, m, n, k):
    """One product per distinct (tile, split, stages) of gemm_plan(...,
    packed=True) over AlexNet's int4 fc1-3, f32 and s8."""
    a, w, alpha, beta = _int4_case(gen, cuda_device, m, k, n)
    before = ops.KERNELS["int4_matmul"].launches
    y = ops.int4_matmul_nk(a, w, alpha, beta, relu=True)
    q = ops.int4_matmul_nk(a, w, alpha, beta, relu=True, out_scale=0.05, out_zp=113)
    assert ops.KERNELS["int4_matmul"].launches == before + 2
    torch.cuda.synchronize()
    err = (y - ops.int4_matmul_plain(a, w, alpha, beta, True)).abs().max().item()
    assert err <= F32_ATOL
    want = ops.int4_matmul_plain(a, w, alpha, beta, True, out_scale=0.05, out_zp=113)
    assert torch.equal(q, want) and len(torch.unique(q)) > 20
    print(f"B6 {label} {m}x{k}x{n} {gemm_plan(m, n, k, packed=True)}: f32 max_abs_err {err}")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,packed", RAGGED_SPLIT)
def test_gemm_ragged_last_stage_under_a_split(cuda_device, gen, m, k, n, packed):
    """A K split whose last 128-byte stage is partial, on the TMA path: TMA
    zero-fills the weights past K (B6: past Kh, where the last low-half
    activation box reads the high half's columns). f32 and s8 equal their
    plain versions exactly."""
    assert gemm_plan(m, n, k, packed=packed).split > 1
    if packed:
        a, w, alpha, beta = _int4_case(gen, cuda_device, m, k, n)
        y = ops.int4_matmul_nk(a, w, alpha, beta, relu=True)
        q = ops.int4_matmul_nk(a, w, alpha, beta, relu=True, out_scale=0.05, out_zp=113)
        y_want = ops.int4_matmul_plain(a, w, alpha, beta, True)
        q_want = ops.int4_matmul_plain(a, w, alpha, beta, True, out_scale=0.05, out_zp=113)
    else:
        a, w, alpha, beta = _gemm_case(gen, cuda_device, m, k, n)
        y = ops.int8_matmul_nk(a, w, alpha, beta, relu=True)
        q = ops.int8_matmul_requant_nk(a, w, alpha, beta, 0.05, 113, relu=True)
        y_want = ops.int8_matmul_plain(a, w, alpha, beta, True)
        q_want = ops.int8_matmul_requant_plain(a, w, alpha, beta, 0.05, 113, True)
    torch.cuda.synchronize()
    assert (y - y_want).abs().max().item() == 0
    assert torch.equal(q, q_want) and len(torch.unique(q)) > 20


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
    # Cout % 16 != 0, odd: the wrapper pads the output channels to 48
    (2, 10, 32, 16, 41, 2, 32.0),
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
    x, w, v = _fused_case(gen, cuda_device, 1, 8, 24, 16, 32, ds=True)  # C = 24, once refused: padded to 32
    before = ops.KERNELS["fused_bottleneck_ds"].routes.get("sm90", 0)
    got = ops.fused_bottleneck_ds_ck(x, *w, *v, 1, **FUSED_SCALARS)
    assert ops.KERNELS["fused_bottleneck_ds"].routes.get("sm90", 0) == before + 1
    assert torch.equal(got, ops.fused_bottleneck_ds_plain(x, *w, *v, 1, **FUSED_SCALARS))
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
    gen = np.random.default_rng(1)
    for cin, k in [(24, 1), (8, 1)]:  # a Cin % 16 != 0 that the per-tap form once refused: now computed
        x = _dev(gen.integers(-128, 128, (1, 4, 4, cin)).astype(np.int8), cuda_device)
        w = _dev(gen.integers(-127, 128, (8, k * k * cin)).astype(np.int8), cuda_device)
        alpha = torch.full((8,), 1e-3, device=cuda_device)
        before = ops.KERNELS["int8_conv_direct"].launches
        got = ops.int8_conv_direct_ck(x, w, (k, k), alpha, ab)
        assert ops.KERNELS["int8_conv_direct"].launches == before + 1
        torch.testing.assert_close(got, ops.int8_conv_direct_plain(x, w, (k, k), alpha, ab), atol=F32_ATOL, rtol=0)


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
    x, w, v = _basic_case(gen, cuda_device, 1, 8, 24, 16, ds=True)  # C = 24, once refused: padded to 32
    before = ops.KERNELS["fused_basicblock_ds"].routes.get("sm90", 0)
    got = ops.fused_basicblock_ds_ck(x, *w, *v, 1, **BASIC_SCALARS)
    assert ops.KERNELS["fused_basicblock_ds"].routes.get("sm90", 0) == before + 1
    assert torch.equal(got, ops.fused_basicblock_ds_plain(x, *w, *v, 1, **BASIC_SCALARS))
    x, w, v = _basic_case(gen, cuda_device, 1, 8, 32, 16, ds=True)
    with pytest.raises(ValueError):  # stride 2 over an odd image
        ops.fused_basicblock_ds_ck(x[:, :7, :7].contiguous(), *w, *v, 2, **BASIC_SCALARS)
    with pytest.raises(ValueError):  # a CPU vector mixed into a CUDA call
        ops.fused_basicblock_ds_ck(x, *w, v[0].cpu(), *v[1:], 1, **BASIC_SCALARS)


@pytest.mark.cuda
@pytest.mark.parametrize("cm", [16, 24])
@pytest.mark.parametrize("stride", [1, 2])
def test_fused_wrappers_pad_widths_that_are_not_multiples_of_16(cuda_device, gen, cm, stride):
    """C = 24 (and Cm 24, Cout 40) on all four block wrappers and the stage
    probe: the operands padded to multiples of 16, the mainloop launched,
    the output sliced, equal to the plain version on the originals."""
    n, h = 2, 10

    def check(name, kernel, plain, *args, **kw):
        before = ops.KERNELS[name].routes.get("sm90", 0)
        got = kernel(*args, **kw)
        assert ops.KERNELS[name].routes.get("sm90", 0) == before + 1
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want), name

    x, w, v = _fused_case(gen, cuda_device, n, h, 24, cm, 40, ds=True)
    check("fused_bottleneck_ds", ops.fused_bottleneck_ds_ck, ops.fused_bottleneck_ds_plain, x, *w, *v, stride,
          **FUSED_SCALARS, ds_fine=32.0)
    x, w, v = _basic_case(gen, cuda_device, n, h, 24, cm, ds=True)
    check("fused_basicblock_ds", ops.fused_basicblock_ds_ck, ops.fused_basicblock_ds_plain, x, *w, *v, stride,
          **BASIC_SCALARS, ds_fine=32.0)
    if stride == 1:
        x, w, v = _fused_case(gen, cuda_device, n, h, 24, cm, 24, ds=False)
        check("fused_bottleneck_s1", ops.fused_bottleneck_s1_ck, ops.fused_bottleneck_s1_plain, x, *w, *v,
              **FUSED_SCALARS, id_k=0.8137192, id_c=2.71828)
        x, w, v = _basic_case(gen, cuda_device, n, h, 24, 24, ds=False)
        check("fused_basicblock_s1", ops.fused_basicblock_s1_ck, ops.fused_basicblock_s1_plain, x, *w, *v,
              **BASIC_SCALARS, id_k=0.8137192, id_c=2.71828)
    else:
        for c, cs in ([(24, 24), (48, 24)] if cm == 24 else [(24, 8)]):  # the stage probe tiles its Cm across C
            x = _dev(gen.integers(-128, 128, (n, h, h, c)).astype(np.int8), cuda_device)
            w1 = _dev(gen.integers(-127, 128, (cs, c)).astype(np.int8), cuda_device)
            w2 = _dev(gen.integers(-127, 128, (cs, 9 * cs)).astype(np.int8), cuda_device)
            a = torch.full((cs,), 0.02, device=cuda_device)
            for stop, name in ((1, "fused_stages_conv1"), (2, "fused_stages_conv12")):
                check(name, ops.fused_stage_ck, ops.fused_stage_plain, x, w1, w2, a, stop)


@pytest.mark.cuda
@pytest.mark.parametrize("w_shape,groups", [((3, 3, 4, 6), 2), ((3, 3, 2, 8), 4), ((3, 3, 1, 16), 8)])
@pytest.mark.parametrize("out_requant", [None, (0.05, 37)])
def test_grouped_conv_on_the_gpu_equals_the_cpu(cuda_device, gen, w_shape, groups, out_requant):
    """Grouped convs other than depthwise: im2col and the exact integer
    matmul per group on the GPU, int32 F.conv2d on the CPU; equal."""
    x = gen.integers(-128, 128, (2, 8, 8, 8)).astype(np.int8)
    w = gen.integers(-127, 128, w_shape).astype(np.int8)
    alpha = (gen.uniform(0.5, 1.5, w_shape[3]) * 1e-4).astype(np.float32)
    beta = gen.uniform(-1, 1, w_shape[3]).astype(np.float32)
    for stride in (1, 2):
        kw = dict(stride=stride, padding=1, stored_zp=-17, relu=True, out_requant=out_requant, groups=groups)
        cpu = ops.int8_conv_xla(*(torch.from_numpy(a) for a in (x, w, alpha, beta)), **kw)
        got = ops.int8_conv_xla(*(_dev(a, cuda_device) for a in (x, w, alpha, beta)), **kw)
        assert got.is_cuda and torch.equal(got.cpu(), cpu), (stride, out_requant)


# B3 and B4 on the Hopper mainloop (csrc/block_sm90.cuh): every block shape of
# chip_smoke.py's kernels phase, ResNet-50's layer3 blocks, and shapes whose
# plan leaves a ragged last band; (kind, side, C, Cm, Cout, stride, ds)
BLOCK_SHAPES = [
    ("bottleneck", 56, 256, 64, 256, 1, False),  # ResNet-50 layer1.1
    ("bottleneck", 14, 1024, 256, 1024, 1, False),  # layer3.1
    ("bottleneck", 7, 2048, 512, 2048, 1, False),  # layer4.1
    ("bottleneck", 56, 64, 64, 256, 1, True),  # layer1.0
    ("bottleneck", 56, 256, 128, 512, 2, True),  # layer2.0
    ("bottleneck", 28, 512, 256, 1024, 2, True),  # layer3.0
    ("bottleneck", 14, 1024, 512, 2048, 2, True),  # layer4.0
    ("basic", 56, 64, 64, 64, 1, False),  # ResNet-18 layer1.1
    ("basic", 14, 256, 256, 256, 1, False),  # layer3.1
    ("basic", 32, 16, 16, 16, 1, False),  # CIFAR ResNet-20 layer1.1
    ("basic", 56, 64, 128, 128, 2, True),  # ResNet-18 layer2.0
    ("basic", 14, 256, 512, 512, 2, True),  # layer4.0
    ("basic", 32, 16, 32, 32, 2, True),  # CIFAR layer2.0
]
RAGGED_BLOCKS = [  # at batch 1 the plan cuts these into bands that do not divide the image
    ("bottleneck", 19, 64, 32, 64, 1, False), ("bottleneck", 23, 64, 64, 256, 1, True),
    ("basic", 19, 16, 16, 16, 1, False), ("basic", 38, 16, 32, 32, 2, True),
]


def _run_block(gen, device, kind, n, h, c, cm, cout, stride, ds):
    """The kernel and its plain version on one case; returns the plan."""
    if kind == "bottleneck":
        x, w, v = _fused_case(gen, device, n, h, c, cm, cout, ds)
        if ds:
            name, args = "fused_bottleneck_ds", (*w, *v, stride)
            kw = dict(FUSED_SCALARS, ds_fine=32.0)
            kernel, plain = ops.fused_bottleneck_ds_ck, ops.fused_bottleneck_ds_plain
        else:
            name, args = "fused_bottleneck_s1", (*w, *v)
            kw = dict(FUSED_SCALARS, id_k=0.8137192, id_c=2.71828)
            kernel, plain = ops.fused_bottleneck_s1_ck, ops.fused_bottleneck_s1_plain
    else:
        x, w, v = _basic_case(gen, device, n, h, c, cm, ds)
        if ds:
            name, args = "fused_basicblock_ds", (*w, *v, stride)
            kw = dict(BASIC_SCALARS, ds_fine=32.0)
            kernel, plain = ops.fused_basicblock_ds_ck, ops.fused_basicblock_ds_plain
        else:
            name, args = "fused_basicblock_s1", (*w, *v)
            kw = dict(BASIC_SCALARS, id_k=0.8137192, id_c=2.71828)
            kernel, plain = ops.fused_basicblock_s1_ck, ops.fused_basicblock_s1_plain
    plan = ops.block_plan(kind, n, h, h, c, cm, cout, stride, ds)
    before = ops.KERNELS[name].routes.get("sm90", 0)
    got = kernel(x, *args, **kw)
    assert ops.KERNELS[name].routes.get("sm90", 0) == before + 1
    want = plain(x, *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("kind,h,c,cm,cout,stride,ds", BLOCK_SHAPES)
def test_block_mainloop_matches_plain(cuda_device, gen, batch, kind, h, c, cm, cout, stride, ds):
    _run_block(gen, cuda_device, kind, batch, h, c, cm, cout, stride, ds)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,h,c,cm,cout,stride,ds", RAGGED_BLOCKS)
def test_block_mainloop_ragged_last_band(cuda_device, gen, kind, h, c, cm, cout, stride, ds):
    plan = _run_block(gen, cuda_device, kind, 1, h, c, cm, cout, stride, ds)
    assert (h // stride) % plan.r, plan


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,c,cm", [(2, 56, 256, 64), (3, 9, 64, 32)])
@pytest.mark.parametrize("stop", [1, 2])
def test_fused_stage_probes_match_plain(cuda_device, gen, n, h, c, cm, stop):
    """The stage probes (B3's mainloop stopped after conv1 or conv2) at
    bench/fused_probe.py's geometry and a small one."""
    x = _dev(gen.integers(-128, 128, (n, h, h, c)).astype(np.int8), cuda_device)
    w1 = _dev(gen.integers(-127, 128, (cm, c)).astype(np.int8), cuda_device)
    w2 = _dev(gen.integers(-127, 128, (cm, 9 * cm)).astype(np.int8), cuda_device)
    a = torch.full((cm,), 0.01 if c == 256 else 0.02, device=cuda_device)
    name = "fused_stages_conv1" if stop == 1 else "fused_stages_conv12"
    before = ops.KERNELS[name].routes.get("sm90", 0)
    got = ops.fused_stage_ck(x, w1, w2, a, stop)
    assert ops.KERNELS[name].routes.get("sm90", 0) == before + 1
    want = ops.fused_stage_plain(x, w1, w2, a, stop)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
    # C % 16 != 0: C = 24 (MobileNet-v1 at width 0.75) and C = 8 (width
    # 0.25), x's rows by bulk copies at their true width; C = 9 with Cout = 20
    (2, 112, 24, 48, 1), (2, 28, 24, 48, 2), (2, 56, 8, 16, 1), (2, 30, 9, 20, 2),
])
def test_fused_dw_pw_kernel_matches_plain(cuda_device, gen, n, h, c, cout, stride):
    x, wdw, wpw, v = _dw_pw_case(gen, cuda_device, n, h, c, cout)
    ho = h // stride
    if n == 32:
        assert ho % dw_pw_band_rows(n, ho, h, c, cout, stride), "the case should have a ragged last band"
    # the tile kernel for C % 8 != 0 and for Cout 200 (208 once rounded up: no cluster splits it into wgmma widths)
    _check_dw_pw_route(x, wdw, wpw, v, stride, route="tile" if c % 8 or cout == 200 else "sm90")


def _check_dw_pw_route(x, wdw, wpw, v, stride, route="sm90", **scalars):
    """One call through the wrapper on ``route``, the route its plan gives
    (the Hopper route, computing at C and Cout rounded up to multiples of
    16), one launch, equal to the plain version and spread over the int8
    range; returns the plan."""
    n, h, w, c = x.shape
    plan = dw_pw_plan(n, h, w, c, wpw.shape[0], stride)
    assert plan.route == route, plan
    before, routes = ops.KERNELS["fused_dw_pw"].launches, _routes("fused_dw_pw")
    scalars = {**DW_PW_SCALARS, **scalars}
    got = ops.fused_dw_pw_ck(x, wdw, wpw, *v, stride, **scalars)
    assert ops.KERNELS["fused_dw_pw"].launches == before + 1
    assert _routes("fused_dw_pw").get(plan.route, 0) == routes.get(plan.route, 0) + 1, (plan, _routes("fused_dw_pw"))
    want = ops.fused_dw_pw_plain(x, wdw, wpw, *v, stride, **scalars)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert len(torch.unique(want)) > 100
    return plan


# MobileNet-v1's distinct pair shapes at 224x224 (input side, C, Cout, stride):
# width 1.0's pairs 0, 1, 2, 3, 4, 5, 6-10 and 11, then width 0.75's and 0.25's
DW_PW_PAIRS = [(112, 32, 64, 1), (112, 64, 128, 2), (56, 128, 128, 1), (56, 128, 256, 2), (28, 256, 256, 1),
               (28, 256, 512, 2), (14, 512, 512, 1), (14, 512, 1024, 2)]
DW_PW_NARROW_PAIRS = [(112, 24, 48, 1), (112, 48, 96, 2), (56, 96, 96, 1), (56, 96, 192, 2), (28, 192, 192, 1),
                      (28, 192, 384, 2), (14, 384, 384, 1), (14, 384, 768, 2), (112, 8, 16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 32])
@pytest.mark.parametrize("h,c,cout,stride", DW_PW_PAIRS + DW_PW_NARROW_PAIRS)
def test_fused_dw_pw_at_every_pair_shape(cuda_device, gen, batch, h, c, cout, stride):
    """B5 at every distinct pair shape of MobileNet-v1 at widths 1.0, 0.75
    and 0.25, all on the Hopper route (C 24 and 8 computed as 32 and 16)."""
    x, wdw, wpw, v = _dw_pw_case(gen, cuda_device, batch, h, c, cout)
    plan = _check_dw_pw_route(x, wdw, wpw, v, stride)
    print(f"B5 {batch}x{h}x{h}x{c}->{cout}/{stride}: {plan}")


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,c,cout,stride,zp1", [
    # ragged last bands (26 rows in bands of 4; 13 in bands of 5), an odd
    # batch of two-image tiles (7x7), C 48 (a K block of 64 bytes, zero past
    # C) and 96, the extreme stored zero points of the depthwise padding
    (3, 26, 32, 16, 1, -17), (2, 13, 64, 64, 1, 127), (3, 14, 128, 256, 2, -128), (5, 14, 512, 1024, 2, 127),
    (2, 24, 48, 96, 2, -17), (2, 18, 96, 96, 1, -128),
    # C or Cout % 16 != 0: x's rows by bulk copies (C 24, 40, 8), weights
    # past Cout read as 0 and 8-byte output stores (Cout 40, 24), a ragged
    # band, two-image tiles over an odd batch (an image past the batch)
    (3, 26, 24, 40, 1, -17), (2, 20, 40, 24, 2, 127), (3, 28, 8, 16, 2, -128), (5, 14, 24, 48, 2, 127),
    (2, 16, 32, 40, 1, -17),
])
def test_fused_dw_pw_sm90_edges(cuda_device, gen, n, h, c, cout, stride, zp1):
    x, wdw, wpw, v = _dw_pw_case(gen, cuda_device, n, h, c, cout)
    plan = _check_dw_pw_route(x, wdw, wpw, v, stride, zp1_stored=zp1)
    ho = h // stride
    assert plan.route == "sm90"
    if n in (2, 3) and stride == 1 and h in (26, 13):
        assert ho % plan.tho, "the case should have a ragged last band"


@pytest.mark.cuda
def test_fused_dw_pw_unaligned_input_takes_the_tile(cuda_device, gen):
    """x starting 4 bytes into its buffer: the tile kernel, exactly."""
    n, h, c, cout = 2, 14, 64, 64
    _, wdw, wpw, v = _dw_pw_case(gen, cuda_device, n, h, c, cout)
    buf = torch.empty(n * h * h * c + 4, dtype=torch.int8, device=cuda_device)
    x = buf[4:].view(n, h, h, c)
    x.copy_(_dev(gen.integers(-128, 128, (n, h, h, c)).astype(np.int8), cuda_device))
    routes = _routes("fused_dw_pw")
    got = ops.fused_dw_pw_ck(x, wdw, wpw, *v, 1, **DW_PW_SCALARS)
    assert _routes("fused_dw_pw").get("tile", 0) == routes.get("tile", 0) + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ops.fused_dw_pw_plain(x, wdw, wpw, *v, 1, **DW_PW_SCALARS))


@pytest.mark.cuda
@pytest.mark.parametrize("offset,route", [(16, "sm90"), (8, "tile")])
def test_fused_dw_pw_narrow_input_alignment(cuda_device, gen, offset, route):
    """x at C 24 starting ``offset`` bytes into its buffer: its rows' bulk
    copies take a 16-byte aligned base, the tile kernel the rest, exactly."""
    n, h, c, cout = 2, 14, 24, 48
    _, wdw, wpw, v = _dw_pw_case(gen, cuda_device, n, h, c, cout)
    buf = torch.empty(n * h * h * c + offset, dtype=torch.int8, device=cuda_device)
    x = buf[offset:].view(n, h, h, c)
    x.copy_(_dev(gen.integers(-128, 128, (n, h, h, c)).astype(np.int8), cuda_device))
    routes = _routes("fused_dw_pw")
    got = ops.fused_dw_pw_ck(x, wdw, wpw, *v, 1, **DW_PW_SCALARS)
    assert _routes("fused_dw_pw").get(route, 0) == routes.get(route, 0) + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ops.fused_dw_pw_plain(x, wdw, wpw, *v, 1, **DW_PW_SCALARS))


@pytest.mark.cuda
def test_fused_dw_pw_wrapper_raises_on_shapes_the_kernel_refuses(cuda_device, gen):
    x, wdw, wpw, v = _dw_pw_case(gen, cuda_device, 1, 8, 24, 16)  # C = 24, once refused: now computed
    got = ops.fused_dw_pw_ck(x, wdw, wpw, *v, 1, **DW_PW_SCALARS)
    assert torch.equal(got, ops.fused_dw_pw_plain(x, wdw, wpw, *v, 1, **DW_PW_SCALARS))
    x, wdw, wpw, v = _dw_pw_case(gen, cuda_device, 1, 8, 32, 16)
    with pytest.raises(ValueError):  # stride 2 over an odd image
        ops.fused_dw_pw_ck(x[:, :7, :7].contiguous(), wdw, wpw, *v, 2, **DW_PW_SCALARS)
    with pytest.raises(ValueError):  # a CPU vector mixed into a CUDA call
        ops.fused_dw_pw_ck(x, wdw, wpw, v[0].cpu(), *v[1:], 1, **DW_PW_SCALARS)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,offset", [(24, 1), (16, 4), (9, 3)])
def test_conv_kernel_on_an_unaligned_input(cuda_device, gen, cin, offset):
    """x starting ``offset`` bytes into its buffer: the kernel falls back to
    narrower chunks (1 byte for Cin 24 at offset 1, 4 for Cin 16 at 4)."""
    n, h, cout = 2, 9, 40
    buf = torch.empty(n * h * h * cin + offset, dtype=torch.int8, device=cuda_device)
    x = buf[offset:].view(n, h, h, cin)
    x.copy_(_dev(gen.integers(-128, 128, (n, h, h, cin)).astype(np.int8), cuda_device))
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    w_ck = _dev(gen.integers(-127, 128, (cout, cin)).astype(np.int8), cuda_device)
    alpha = _dev(gen.uniform(1e-4, 3e-4, cout).astype(np.float32), cuda_device)
    beta = _dev(gen.uniform(-0.1, 0.1, cout).astype(np.float32), cuda_device)
    args = ((1, 1), alpha, beta, 1, 0, -5, True, (0.05, 113))
    got = ops.int8_conv_direct_ck(x, w_ck, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.int8_conv_direct_plain(x, w_ck, *args))


def _conv_case(gen, device, n, h, cin, cout, k):
    x = _dev(gen.integers(-128, 128, (n, h, h, cin)).astype(np.int8), device)
    w_ck = _dev(gen.integers(-127, 128, (cout, k * k * cin)).astype(np.int8), device)
    alpha = _dev(gen.uniform(1e-4, 3e-4, cout).astype(np.float32), device)
    beta = _dev(gen.uniform(-0.1, 0.1, cout).astype(np.float32), device)
    return x, w_ck, alpha, beta


FLAT_CASES = [
    # n, h, cin, cout, k, out_requant, gather_k: the JAX package's six cases
    # (tests/test_pallas_conv.py), then Cin 3 (single bytes), Cin 24 (4-byte
    # chunks) and a 5x5 over Cin 64 tap by tap
    (4, 14, 64, 64, 3, (0.07, 113), None),
    (2, 28, 128, 128, 3, (0.05, 120), None),
    (4, 8, 64, 96, 1, (0.05, 128), None),
    (2, 9, 512, 512, 3, None, False),
    (2, 7, 64, 512, 3, (0.06, 77), None),
    (2, 12, 32, 64, 5, (0.04, 99), True),
    (2, 32, 3, 16, 3, (0.05, 113), None),
    (2, 15, 24, 40, 3, None, None),
    (2, 11, 64, 48, 5, (0.05, 113), False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout,k,req,gather_k", FLAT_CASES)
def test_flat_conv_kernel_matches_plain(cuda_device, gen, n, h, cin, cout, k, req, gather_k):
    x, w_ck, alpha, beta = _conv_case(gen, cuda_device, n, h, cin, cout, k)
    args = ((k, k), alpha, beta, 1, k // 2, -5, True, req)
    before = ops.KERNELS["int8_conv_flat"].launches
    got = ops.int8_conv_flat_ck(x, w_ck, *args, gather_k=gather_k)
    assert ops.KERNELS["int8_conv_flat"].launches == before + 1
    want = ops.int8_conv_flat_plain(x, w_ck, *args)
    torch.cuda.synchronize()
    if req is None:
        torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
    else:
        assert torch.equal(got, want)
    # the same function as K2 on the same inputs
    direct = ops.int8_conv_direct_plain(x, w_ck, *args)
    assert torch.equal(want, direct) if req is not None else torch.allclose(want, direct, atol=F32_ATOL, rtol=0)


@pytest.mark.cuda
def test_flat_conv_refuses_stride_2(cuda_device, gen):
    x, w_ck, alpha, beta = _conv_case(gen, cuda_device, 1, 8, 16, 16, 3)
    with pytest.raises(ValueError):
        ops.int8_conv_flat_ck(x, w_ck, (3, 3), alpha, beta, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout,req,relu", [
    # ResNet-18's conv2 + identity at layer1 and layer3, f32 and s8 out,
    # ReLU on and off, and Cin 24 (4-byte chunks)
    (2, 56, 64, 64, (0.06, 105), True), (2, 14, 256, 256, None, True), (2, 14, 64, 64, None, False),
    (2, 14, 256, 256, (0.06, 105), False), (2, 9, 24, 40, (0.06, 105), True), (2, 9, 24, 40, None, False),
])
def test_residual_conv_kernel_matches_plain(cuda_device, gen, n, h, cin, cout, req, relu):
    x, w_ck, alpha, beta = _conv_case(gen, cuda_device, n, h, cin, cout, 3)
    r = _dev(gen.integers(-128, 128, (n, h, h, cout)).astype(np.int8), cuda_device)
    args = ((3, 3), alpha, beta, 1, 1, -5, relu, req)
    kw = dict(residual=r, res_grid=(0.03, 117))
    before = ops.KERNELS["int8_conv_direct_residual"].launches
    got = ops.int8_conv_direct_ck(x, w_ck, *args, **kw)
    assert ops.KERNELS["int8_conv_direct_residual"].launches == before + 1
    want = ops.int8_conv_direct_plain(x, w_ck, *args, **kw)
    torch.cuda.synchronize()
    if req is None:
        torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
    else:
        assert torch.equal(got, want)
        assert len(torch.unique(want)) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 56, 56, 256), (5, 7, 9, 3), (3, 1001), (1, 15)])
def test_copy_kernels_are_exact(cuda_device, gen, shape):
    """Each copy kernel equals its plain version, at the layer1 activation
    and at byte counts that are not multiples of 16, over the ring's S/D/bi
    of the TPU study."""
    x = _dev(gen.integers(-128, 128, shape).astype(np.int8), cuda_device)
    x.view(-1)[0] = 127
    plain, plus = ops.copy_plain(x), ops.copy_plain(x, add=True)
    assert int(plus.view(-1)[0]) == -128  # the +1 wraps at 127
    for bi in (1, 2, 16):
        for add in (False, True):
            assert torch.equal(ops.grid_copy(x, bi, add), plus if add else plain), (bi, add)
    for slots, prefetch, bi in [(4, 2, 1), (8, 4, 1), (4, 2, 4), (8, 6, 1), (4, 4, 2)]:
        for compute in ("none", "add", "sep"):
            got = ops.ring_copy(x, slots, prefetch, bi, compute)
            assert torch.equal(got, plus if compute == "add" else plain), (slots, prefetch, bi, compute)
    for streams in (1, 2, 4, 6):
        assert torch.equal(ops.bulk_copy(x, streams), plain), streams
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("streams", range(1, 7))
@pytest.mark.parametrize("shape", [(32, 56, 56, 256), (3, 1001)])
def test_bulk_copy_on_its_hopper_route(cuda_device, gen, shape, streams):
    """bulk_copy at every stream count: one launch on route "sm90", exact."""
    x = _dev(gen.integers(-128, 128, shape).astype(np.int8), cuda_device)
    before, routes = ops.KERNELS["bulk_copy"].launches, _routes("bulk_copy")
    got = ops.bulk_copy(x, streams)
    assert ops.KERNELS["bulk_copy"].launches == before + 1
    assert _routes("bulk_copy").get("sm90", 0) == routes.get("sm90", 0) + 1
    torch.cuda.synchronize()
    assert torch.equal(got, x)


@pytest.mark.cuda
def test_bulk_copy_under_every_plan_of_the_sweep(cuda_device, gen):
    """Every plan ``probes/dma_ring --plans`` times, exact on the layer1
    activation and on a tensor of 3 x 1001 bytes (empty blocks, a tail)."""
    from quantized_tpu_torch.ops.copy_probe import SMEM_PER_SM, bulk_plan, launch_bulk_copy

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for shape in [(32, 56, 56, 256), (3, 1001)]:
        x = _dev(gen.integers(-128, 128, shape).astype(np.int8), cuda_device)
        for kb in (4, 8, 16, 32):
            for slots in (1, 2, 3, 4, 6, 8):
                for per_sm in (1, 3, 6):
                    plan = bulk_plan(x.numel(), 2, sms, kb * 64, slots, per_sm)
                    if plan.per_sm * (plan.smem + 1024) <= SMEM_PER_SM:
                        assert torch.equal(launch_bulk_copy(x, plan), x), plan
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_copy_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    x = torch.zeros((2, 56, 56, 256), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):  # 16 slots of 4 images: more shared memory than a block has
        ops.ring_copy(x, 16, 2, 4)
    with pytest.raises(ValueError):  # a prefetch past the ring
        ops.ring_copy(x, 2, 4, 1)
    with pytest.raises(ValueError):
        ops.bulk_copy(x, 7)
    with pytest.raises(ValueError):  # not 16-byte aligned
        ops.grid_copy(x.view(-1)[1:33])


def _observed_mobilenet(width: float, side: int):
    """A random-init ``mobilenet_quantized`` at ``width`` after two
    observer-update passes on seeded images."""
    from quantized_tpu_torch.entry import _calibrated_model

    model = _calibrated_model("mobilenet_quantized", device="cpu", generator=torch.Generator().manual_seed(0),
                              num_classes=1000, width_mult=width)
    g = torch.Generator().manual_seed(5)
    model.train()
    with torch.no_grad():
        for _ in range(2):
            model(torch.randn((2, side, side, 3), generator=g))
    return model.eval()


def _assert_logits_close(got, want):
    """Within F32_ATOL of the logits' magnitude (the fc sums in another order)."""
    tol = F32_ATOL * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=0)


@pytest.mark.cuda
def test_narrow_mobilenet_on_the_gpu_equals_its_cpu_twin(cuda_device):
    """MobileNet-v1 at width 0.75 (C = 24 at the first pair), unfused and
    fused, on the GPU: every conv or fused stage int8-equal to the same
    engine on the CPU, and the fused pairs on B5 (12 of them)."""
    import copy

    from quantized_tpu_torch.engine import build_int8_mobilenet, fuse_mobilenet_blocks
    from quantized_tpu_torch.engine.int8_resident import u8_to_stored

    side = 64
    model = _observed_mobilenet(0.75, side)
    gpu = build_int8_mobilenet(model, backend="pallas", device=cuda_device)
    cpu = build_int8_mobilenet(model, backend="pallas", device="cpu")
    u8 = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, side, side, 3), dtype=np.uint8))
    with torch.inference_mode():
        hg, hc = u8_to_stored(u8.to(cuda_device), gpu.input_grid), u8_to_stored(u8, cpu.input_grid)
        for i in range(gpu.num_convs):
            hg = getattr(gpu, f"conv{i}").run_q(hg, relu=True, out_requant=gpu.requant_grids[i])
            hc = getattr(cpu, f"conv{i}").run_q(hc, relu=True, out_requant=cpu.requant_grids[i])
            if hc.dtype == torch.int8:
                assert torch.equal(hg.cpu(), hc), f"conv{i}"
                assert len(torch.unique(hc)) > 1, f"conv{i} is constant"
        _assert_logits_close(gpu.run_u8(u8.to(cuda_device)), cpu.run_u8(u8))
        fg, fc = copy.deepcopy(gpu), copy.deepcopy(cpu)
        assert fuse_mobilenet_blocks(fg) == fuse_mobilenet_blocks(fc) == 12
        hg, hc = u8_to_stored(u8.to(cuda_device), fg.input_grid), u8_to_stored(u8, fc.input_grid)
        before = ops.KERNELS["fused_dw_pw"].launches
        for j in range(fg.num_fused_stages):
            hg, hc = getattr(fg, f"stage{j}")(hg), getattr(fc, f"stage{j}")(hc)
            if hc.dtype == torch.int8:
                assert torch.equal(hg.cpu(), hc), f"stage{j}"
        assert ops.KERNELS["fused_dw_pw"].launches == before + 12
        _assert_logits_close(fg.run_u8(u8.to(cuda_device)), fc.run_u8(u8))


# ----------------------------------------------------------------- the Hopper conv mainloop (K2 per-tap, B7)

SM90_CONV_CASES = [
    # n, h, cin, cout, k, stride, pad, out_requant: each ResNet-50 shape class
    # at batch 2 (1x1 s1, 3x3 s1, 3x3 s2 at 56->28, 28->14 and 14->7 with pad
    # 1 and pad 0, 1x1 s2), ragged M, Cout 32 and 192, AlexNet's 5x5 pad-2
    # conv2, Cin 16 and 48 (a 32-byte chunk zero-filled past Cin)
    (2, 56, 64, 256, 1, 1, 0, None),
    (2, 28, 512, 128, 1, 1, 0, (0.05, 113)),
    (2, 56, 64, 64, 3, 1, 1, (0.07, 113)),
    (2, 14, 256, 256, 3, 1, 1, None),
    (2, 7, 512, 512, 3, 1, 1, (0.04, 99)),
    (2, 56, 128, 128, 3, 2, 1, (0.05, 120)),
    (2, 28, 256, 256, 3, 2, 1, None),
    (2, 14, 512, 512, 3, 2, 1, (0.05, 120)),
    (2, 14, 512, 512, 3, 2, 0, (0.05, 120)),
    (2, 15, 64, 64, 3, 2, 0, None),
    (2, 56, 256, 512, 1, 2, 0, None),
    (2, 14, 1024, 2048, 1, 2, 0, (0.03, 128)),
    (3, 9, 64, 40, 3, 1, 1, (0.05, 113)),
    (5, 11, 128, 70, 1, 1, 0, None),
    (2, 14, 64, 32, 3, 1, 1, (0.05, 113)),
    (2, 14, 128, 192, 3, 1, 1, None),
    (2, 27, 64, 192, 5, 1, 2, (0.05, 113)),
    (1, 27, 64, 192, 5, 1, 2, None),
    (2, 14, 16, 32, 1, 1, 0, (0.05, 113)),
    (2, 13, 48, 64, 3, 1, 1, None),
]


def _routes(name):
    return dict(ops.KERNELS[name].routes)


def _sm90_case(gen, device, n, h, cin, cout, k):
    """_conv_case with alpha scaled by 1/sqrt(K), so the requant spreads over
    the int8 range at any K instead of saturating."""
    x, w_ck, _, beta = _conv_case(gen, device, n, h, cin, cout, k)
    alpha = _dev((gen.uniform(0.5, 1.5, cout) * 1e-3 / np.sqrt(k * k * cin)).astype(np.float32), device)
    return x, w_ck, alpha, beta


def _check_conv_route(x, w_ck, args, route, name="int8_conv_direct", spread=False, **kw):
    """One call through the wrapper: the route taken and one launch, then
    the output against the plain version (s8 equal, f32 within F32_ATOL;
    ``spread``: s8 outputs take more than 20 values)."""
    before, routes = ops.KERNELS[name].launches, _routes(name)
    fn, plain = ((ops.int8_conv_flat_ck, ops.int8_conv_flat_plain) if name == "int8_conv_flat"
                 else (ops.int8_conv_direct_ck, ops.int8_conv_direct_plain))
    got = fn(x, w_ck, *args, **kw)
    assert ops.KERNELS[name].launches == before + 1
    assert _routes(name).get(route, 0) == routes.get(route, 0) + 1, (route, _routes(name))
    want = plain(x, w_ck, *args, **{k: v for k, v in kw.items() if k in ("residual", "res_grid")})
    torch.cuda.synchronize()
    if got.dtype == torch.int8:
        assert torch.equal(got, want)
        assert not spread or len(torch.unique(want)) > 20  # not stuck on a clip
    else:
        torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout,k,s,pad,req", SM90_CONV_CASES)
def test_conv_sm90_route_matches_plain(cuda_device, gen, n, h, cin, cout, k, s, pad, req):
    """K2's per-tap form on the Hopper mainloop, the route asserted."""
    x, w_ck, alpha, beta = _sm90_case(gen, cuda_device, n, h, cin, cout, k)
    plan = ops.conv_plan(n, h, h, cin, cout, (k, k), (s, s), (pad, pad))
    print(f"K2 {n}x{h}x{h}x{cin}->{cout} {k}x{k}/{s} pad {pad}: {plan}")
    assert plan.route == "sm90"
    _check_conv_route(x, w_ck, ((k, k), alpha, beta, s, pad, -5, True, req), "sm90", spread=True)


@pytest.mark.cuda
@pytest.mark.parametrize("stored_zp", [127, -128])
def test_conv_sm90_border_correction_at_extreme_zero_points(cuda_device, gen, stored_zp):
    """The zero-filled padding corrected by stored_zp * tapsum at the
    extreme stored zero points, with the border sums passed (as the engines
    pass them) and left to the wrapper; 3x3 pad 1 and 5x5 pad 2."""
    for n, h, cin, cout, k, s, pad in [(2, 14, 64, 64, 3, 1, 1), (2, 13, 64, 96, 5, 2, 2)]:
        x, w_ck, alpha, beta = _sm90_case(gen, cuda_device, n, h, cin, cout, k)
        args = ((k, k), alpha, beta, s, pad, stored_zp, True, (0.05, 113))
        given = _check_conv_route(x, w_ck, args, "sm90", spread=True,
                                  border_sums=ops.conv_border_sums(w_ck, (k, k)))
        assert torch.equal(given, _check_conv_route(x, w_ck, args, "sm90"))
        _check_conv_route(x, w_ck, ((k, k), alpha, beta, s, pad, stored_zp, False, None), "sm90")


@pytest.mark.cuda
def test_conv_stays_on_the_tile_where_the_mainloop_cannot_take_it(cuda_device, gen):
    """An unaligned input (Cin 64, 3x3), a 1x1 over Cin 9 (no pixel group
    of it is a multiple of 16 bytes), a 3x3 over Cin 40, the gather-K stem
    over an unaligned input and the residual form over Cin 24 (3x3) take the
    general tile, exactly."""
    n, h, cin, cout = 2, 9, 64, 40
    buf = torch.empty(n * h * h * cin + 8, dtype=torch.int8, device=cuda_device)
    x = buf[8:].view(n, h, h, cin)
    x.copy_(_dev(gen.integers(-128, 128, (n, h, h, cin)).astype(np.int8), cuda_device))
    assert x.data_ptr() % 16 != 0
    _, w_ck, alpha, beta = _conv_case(gen, cuda_device, n, h, cin, cout, 3)
    _check_conv_route(x, w_ck, ((3, 3), alpha, beta, 1, 1, -5, True, (0.05, 113)), "tile")
    x9, w9, a9, b9 = _conv_case(gen, cuda_device, 2, 14, 9, 40, 1)
    _check_conv_route(x9, w9, ((1, 1), a9, b9, 1, 0, -5, True, (0.05, 113)), "tile")
    x40, w40, a40, b40 = _conv_case(gen, cuda_device, 2, 9, 40, 40, 3)
    _check_conv_route(x40, w40, ((3, 3), a40, b40, 1, 1, -5, True, None), "tile")
    _, ws, as_, bs = _conv_case(gen, cuda_device, 2, 30, 12, 64, 4)  # the gather-K form over an unaligned input
    sbuf = torch.empty(2 * 30 * 30 * 12 + 4, dtype=torch.int8, device=cuda_device)
    xs = sbuf[4:].view(2, 30, 30, 12)
    xs.copy_(_dev(gen.integers(-128, 128, (2, 30, 30, 12)).astype(np.int8), cuda_device))
    _check_conv_route(xs, ws, ((4, 4), as_, bs, 1, 0, -5, True, (0.05, 113)), "tile",
                      name="int8_conv_direct_gatherk")
    xr, wr, ar, br = _conv_case(gen, cuda_device, 2, 14, 24, 64, 3)
    r = _dev(gen.integers(-128, 128, (2, 14, 14, 64)).astype(np.int8), cuda_device)
    kw = dict(residual=r, res_grid=(0.03, 117))
    before = _routes("int8_conv_direct_residual").get("tile", 0)
    got = ops.int8_conv_direct_ck(xr, wr, (3, 3), ar, br, 1, 1, -5, True, (0.06, 105), **kw)
    assert _routes("int8_conv_direct_residual")["tile"] == before + 1
    assert torch.equal(got, ops.int8_conv_direct_plain(xr, wr, (3, 3), ar, br, 1, 1, -5, True, (0.06, 105), **kw))


# n, h, cin, cout, stride, stored_zp: ResNet-18's conv2 + identity at layer1
# and layer3, Cout 40 and 30 (30: byte-wise residual loads), stride 2, and
# the extreme stored zero points in the padding
RESIDUAL_SM90_CASES = [
    (2, 56, 64, 64, 1, -5), (2, 14, 256, 256, 1, -5), (2, 9, 64, 40, 1, 127), (3, 10, 32, 30, 2, -128),
    (2, 14, 128, 40, 2, -5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("req", [None, (0.06, 105)])
@pytest.mark.parametrize("n,h,cin,cout,s,zp", RESIDUAL_SM90_CASES)
def test_residual_conv_sm90_route_matches_plain(cuda_device, gen, n, h, cin, cout, s, zp, req):
    """B8 on the Hopper mainloop (its RES instances), route "sm90"
    asserted, f32 and s8 out, against its plain version; the border sums
    passed as the engines pass them and left to the wrapper."""
    x, w_ck, alpha, beta = _sm90_case(gen, cuda_device, n, h, cin, cout, 3)
    ho = (h + 2 - 3) // s + 1
    r = _dev(gen.integers(-128, 128, (n, ho, ho, cout)).astype(np.int8), cuda_device)
    plan = ops.conv_plan(n, h, h, cin, cout, (3, 3), (s, s), (1, 1), "residual")
    assert plan.route == "sm90" and plan == ops.conv_plan(n, h, h, cin, cout, (3, 3), (s, s), (1, 1))
    args = ((3, 3), alpha, beta, s, 1, zp, True, req)
    kw = dict(residual=r, res_grid=(0.03, 117))
    given = _check_conv_route(x, w_ck, args, "sm90", name="int8_conv_direct_residual", spread=True,
                              border_sums=ops.conv_border_sums(w_ck, (3, 3)), **kw)
    assert torch.equal(given, _check_conv_route(x, w_ck, args, "sm90", name="int8_conv_direct_residual", **kw))
    # the same conv without the residual differs: the residual was added
    assert not torch.equal(given, ops.int8_conv_direct_ck(x, w_ck, *args))


# n, h, cin, cout: MobileNet-v1's first pointwise conv at widths 0.75 and
# 0.25 (Cin 24 and 8 at 112x112), ragged last tiles and Cout 40
PIXEL_GROUP_CASES = [(2, 112, 24, 48), (2, 112, 8, 16), (4, 9, 24, 40), (1, 14, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("req", [None, (0.05, 113)])
@pytest.mark.parametrize("n,h,cin,cout", PIXEL_GROUP_CASES)
def test_conv_pixel_groups_on_the_mainloop(cuda_device, gen, n, h, cin, cout, req):
    """A 1x1 over Cin 24 or 8 on groups of four pixels (route "sm90"), the
    group operands built by the wrapper and passed as the layer passes
    them, and the residual form on the same route; each against its plain
    version."""
    x, w_ck, alpha, beta = _sm90_case(gen, cuda_device, n, h, cin, cout, 1)
    plan = ops.conv_plan(n, h, h, cin, cout, (1, 1))
    assert (plan.route, plan.pixels) == ("sm90", 4)
    args = ((1, 1), alpha, beta, 1, 0, -5, True, req)
    built = _check_conv_route(x, w_ck, args, "sm90", spread=True)
    given = _check_conv_route(x, w_ck, args, "sm90",
                              pixel_groups=ops.pixel_group_operands(w_ck, alpha, beta))
    assert torch.equal(built, given)
    r = _dev(gen.integers(-128, 128, (n, h, h, cout)).astype(np.int8), cuda_device)
    _check_conv_route(x, w_ck, args, "sm90", name="int8_conv_direct_residual", residual=r, res_grid=(0.03, 117))
    _check_conv_route(x[:1, :7, :7].contiguous(), w_ck, args, "tile")  # 49 pixels: not whole groups of 4


@pytest.mark.cuda
def test_residual_conv_raises_where_its_hopper_plan_cannot_launch(cuda_device, gen, monkeypatch):
    """A call that the plan puts on the mainloop and the C entry refuses
    (here a plan whose shared memory is not its ring's) raises, and nothing
    is launched on the tile in its place."""
    from quantized_tpu_torch.ops import int8_conv_pallas

    x, w_ck, alpha, beta = _conv_case(gen, cuda_device, 2, 14, 64, 64, 3)
    r = _dev(gen.integers(-128, 128, (2, 14, 14, 64)).astype(np.int8), cuda_device)
    real = int8_conv_pallas.conv_plan
    monkeypatch.setattr(int8_conv_pallas, "conv_plan",
                        lambda *a, **k: real(*a, **k)._replace(smem=real(*a, **k).smem + 16))
    before = ops.KERNELS["int8_conv_direct_residual"].launches
    with pytest.raises(RuntimeError):
        ops.int8_conv_direct_ck(x, w_ck, (3, 3), alpha, beta, 1, 1, -5, True, (0.06, 105), residual=r,
                                res_grid=(0.03, 117))
    assert ops.KERNELS["int8_conv_direct_residual"].launches == before


# n, h, cin, cout, k, stride, pad: the gather-K form's five shape families at
# their serving sizes (two images): the s2d stem; MobileNet's stem at widths
# 1.0 and 0.75; AlexNet's conv1; the CIFAR stem; CIFAR's Cin-16 and Cin-32
# 3x3 convs at strides 1 and 2; then an odd batch of 8x8 outputs (two images
# a tile) and a row wider than a tile (row segments)
GATHERK_CASES = [
    (2, 115, 12, 64, 4, 1, 0), (2, 224, 3, 32, 3, 2, 1), (2, 224, 3, 24, 3, 2, 1), (2, 224, 3, 64, 11, 4, 2),
    (2, 32, 3, 16, 3, 1, 1), (2, 32, 16, 16, 3, 1, 1), (2, 32, 16, 32, 3, 2, 1), (2, 16, 32, 32, 3, 1, 1),
    (2, 16, 32, 64, 3, 2, 1), (3, 16, 32, 64, 3, 2, 1), (1, 150, 3, 8, 3, 1, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("req", [None, (0.05, 113)])
@pytest.mark.parametrize("n,h,cin,cout,k,s,pad", GATHERK_CASES)
def test_conv_gatherk_route_matches_plain(cuda_device, gen, n, h, cin, cout, k, s, pad, req):
    """K2's gather-K form on its Hopper route, a nonzero stored zero point
    in the padding, f32 and s8 out, the route asserted."""
    x, w_ck, alpha, beta = _sm90_case(gen, cuda_device, n, h, cin, cout, k)
    plan = ops.conv_plan(n, h, h, cin, cout, (k, k), (s, s), (pad, pad), "gatherk")
    print(f"K2 gather-K {n}x{h}x{h}x{cin}->{cout} {k}x{k}/{s} pad {pad}: {plan}")
    assert plan.route == "sm90"
    _check_conv_route(x, w_ck, ((k, k), alpha, beta, s, pad, -5, True, req), "sm90",
                      name="int8_conv_direct_gatherk", spread=True)
    _check_conv_route(x, w_ck, ((k, k), alpha, beta, s, pad, 127, False, req), "sm90",
                      name="int8_conv_direct_gatherk")


@pytest.mark.cuda
def test_conv_sm90_is_deterministic_and_takes_the_current_stream(cuda_device, gen):
    """Two calls give the same bytes, also on a non-default stream, for K2
    (s8 and f32) and B7."""
    x, w_ck, alpha, beta = _conv_case(gen, cuda_device, 4, 28, 128, 128, 3)

    def calls():
        return [ops.int8_conv_direct_ck(x, w_ck, (3, 3), alpha, beta, 1, 1, -5, True, (0.05, 113)),
                ops.int8_conv_direct_ck(x, w_ck, (3, 3), alpha, beta, 2, 1, -5, True, None),
                ops.int8_conv_flat_ck(x, w_ck, (3, 3), alpha, beta, 1, 1, -5, True, (0.05, 113))]

    first = calls()
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):
        second = calls()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int8) if a.dtype == torch.int8 else a.view(torch.int32),
                           b.view(torch.int8) if b.dtype == torch.int8 else b.view(torch.int32))
    assert torch.equal(second[2], ops.int8_conv_direct_plain(x, w_ck, (3, 3), alpha, beta, 1, 1, -5, True,
                                                             (0.05, 113)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout,k,req,gather_k", FLAT_CASES)
def test_flat_conv_route(cuda_device, gen, n, h, cin, cout, k, req, gather_k):
    """B7 takes the mainloop where Cin % 16 == 0, in both K walks, and the
    tile elsewhere (Cin 3 and 24)."""
    x, w_ck, alpha, beta = _conv_case(gen, cuda_device, n, h, cin, cout, k)
    route = "sm90" if cin % 16 == 0 else "tile"
    _check_conv_route(x, w_ck, ((k, k), alpha, beta, 1, k // 2, -5, True, req), route, name="int8_conv_flat",
                      gather_k=gather_k)


# ----------------------------------------------------------------- the plain backends and the autotuner

def _cifar20_engine(backend, device):
    from quantized_tpu_torch.engine import build_int8_resident
    from quantized_tpu_torch.entry import _calibrated_model

    model = _calibrated_model("resnet_quantized_float_bn", device="cpu", generator=torch.Generator().manual_seed(0),
                              dataset="cifar10", depth=20)
    return build_int8_resident(model, backend=backend, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["bf16", "bf16-split"])
def test_bf16_engine_on_the_gpu_is_close_to_its_cpu_twin(cuda_device, backend):
    """A CIFAR ResNet-20 with every conv on a bf16 backend (cuDNN on the
    GPU) against the same engine on the CPU: logits within the JAX bf16
    bound, 0.35 (tests/test_autotune_bf16.py), and the argmax equal."""
    u8 = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    gpu, cpu = _cifar20_engine(backend, cuda_device), _cifar20_engine(backend, "cpu")
    with torch.inference_mode():
        got, want = gpu.run_u8(u8.to(cuda_device)).cpu(), cpu.run_u8(u8)
    assert (got - want).abs().max().item() <= 0.35
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 16, 17, 128])
def test_int8_matmul_xla_on_the_gpu_equals_k1(cuda_device, gen, m):
    """``int8_matmul_xla`` (``torch._int_mm`` past M = 16, the exact float64
    product below) equals K1 and the CPU result."""
    k, n = 2048, 1000
    a = _dev(gen.integers(-128, 128, (m, k)).astype(np.int8), cuda_device)
    w = _dev(gen.integers(-127, 128, (n, k)).astype(np.int8), cuda_device)
    alpha = _dev(gen.uniform(1e-5, 3e-5, n).astype(np.float32), cuda_device)
    beta = _dev(gen.uniform(-0.5, 0.5, n).astype(np.float32), cuda_device)
    got = ops.int8_matmul_xla_nk(a, w, alpha, beta, relu=True)
    assert torch.equal(got, ops.int8_matmul_nk(a, w, alpha, beta, relu=True))
    assert torch.equal(got.cpu(), ops.int8_matmul_xla_nk(a.cpu(), w.cpu(), alpha.cpu(), beta.cpu(), relu=True))


@pytest.mark.cuda
def test_maxpool_forms_and_s4_conv_on_the_gpu(cuda_device, gen):
    """The maxpool's "rw" form equals "interleave" on int8 CUDA tensors; the
    two-half int4 conv equals its CPU result and the unpacked conv."""
    from quantized_tpu_torch.engine.int8_resident import maxpool_3x3_s2_int8

    x = _dev(gen.integers(-128, 128, (4, 56, 56, 64)).astype(np.int8), cuda_device)
    assert torch.equal(maxpool_3x3_s2_int8(x, "rw"), maxpool_3x3_s2_int8(x, "interleave"))
    q = _dev(gen.integers(-7, 8, (3, 3, 32, 48)).astype(np.int8), "cpu")
    packed = ops.pack_int4_conv_channels(q).to(cuda_device)
    xq = _dev(gen.integers(-128, 128, (2, 14, 14, 32)).astype(np.int8), cuda_device)
    alpha = _dev(gen.uniform(1e-4, 3e-4, 48).astype(np.float32), cuda_device)
    beta = _dev(gen.uniform(-0.5, 0.5, 48).astype(np.float32), cuda_device)
    args = (alpha, beta, (1, 1), (1, 1), -5, True, (0.05, 113))
    got = ops.int4_conv_s4(xq, packed, *args)
    assert torch.equal(got.cpu(), ops.int4_conv_s4(xq.cpu(), packed.cpu(), *(a.cpu() if torch.is_tensor(a) else a
                                                                           for a in args)))
    assert torch.equal(got, ops.int8_conv_xla(xq, q.to(cuda_device), *args))


@pytest.mark.cuda
def test_autotuner_on_the_gpu(cuda_device, tmp_path):
    """Every race of a CIFAR ResNet-20 at batch 8 measured on the card
    (conv backends, fc, blocks): the tuned engine's logits within 0.35 of
    the untuned one's; the written cache, applied to a fresh engine, gives
    the same forms and bit-equal logits."""
    from quantized_tpu_torch.engine import apply_cached_backends, autotune_resident

    u8 = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)).to(cuda_device)
    untuned, tuned = _cifar20_engine("pallas", cuda_device), _cifar20_engine("pallas", cuda_device)
    cache = str(tmp_path / "autotune.json")
    table = autotune_resident(tuned, u8, cache_path=cache, verbose=False)  # every race on: a CUDA device
    assert any(k.startswith("block:") for k in table) and any(k.startswith("fc:") for k in table)
    fresh = _cifar20_engine("pallas", cuda_device)
    assert apply_cached_backends(fresh, u8, cache_path=cache)
    forms = [(n, getattr(m, "backend", type(m).__name__)) for n, m in tuned.named_modules()]
    assert forms == [(n, getattr(m, "backend", type(m).__name__)) for n, m in fresh.named_modules()]
    with torch.inference_mode():
        got, want = tuned.run_u8(u8), untuned.run_u8(u8)
        assert torch.equal(fresh.run_u8(u8), got)
    assert (got - want).abs().max().item() <= 0.35


# ----------------------------------------------------------------- the RangeBN clamp (CLIP instances)

def _clip_bounds(gen, cout, y, device):
    """Per-channel clamp bounds that bind on a large share of the values of
    ``y`` (f32 ``acc * alpha + beta``); channel 3's cross (hi < lo: the
    clamp takes hi)."""
    span = y.abs().mean().item()
    lo = -gen.uniform(0.25, 1.0, cout) * span
    hi = gen.uniform(0.25, 1.0, cout) * span
    lo[3], hi[3] = 0.2 * span, -0.1 * span
    return _dev(np.stack([lo, hi]).astype(np.float32), device)


CLIP_CONV_CASES = [
    # n, h, cin, cout, k, stride, pad, out_requant, the route: the mainloop's per-tap (4-D boxes) and
    # flat 1x1 forms, the gather-K route, pixel groups, the general tile (Cin 9)
    (2, 56, 64, 64, 3, 1, 1, (0.05, 113), "sm90"),
    (2, 56, 64, 64, 3, 1, 1, None, "sm90"),
    (2, 28, 128, 128, 3, 2, 1, (0.05, 120), "sm90"),
    (2, 56, 64, 256, 1, 1, 0, None, "sm90"),
    (2, 56, 64, 256, 1, 1, 0, (0.05, 113), "sm90"),
    (2, 14, 256, 512, 1, 2, 0, None, "sm90"),
    (2, 115, 12, 64, 4, 1, 0, (0.05, 130), "sm90"),
    (2, 115, 12, 64, 4, 1, 0, None, "sm90"),
    (2, 224, 3, 64, 7, 2, 3, None, "sm90"),
    (2, 112, 24, 48, 1, 1, 0, (0.05, 113), "sm90"),
    (2, 14, 9, 40, 1, 1, 0, (0.05, 113), "tile"),
    (2, 14, 9, 40, 1, 1, 0, None, "tile"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout,k,s,pad,req,route", CLIP_CONV_CASES)
def test_conv_clip_instances_match_plain(cuda_device, gen, n, h, cin, cout, k, s, pad, req, route):
    """K2 with the RangeBN clamp on each route's CLIP instances (counted
    under ``<route>+clip``): s8 equal to the plain version, f32 within
    F32_ATOL; the clamp changes the output."""
    x, w_ck, alpha, beta = _conv_case(gen, cuda_device, n, h, cin, cout, k)
    y = ops.int8_conv_direct_plain(x, w_ck, (k, k), alpha, beta, s, pad, -5, False, None)
    yc = _clip_bounds(gen, cout, y, cuda_device)
    args = ((k, k), alpha, beta, s, pad, -5, True, req)
    name = "int8_conv_direct_gatherk" if cin <= 32 and k > 1 else "int8_conv_direct"
    routes = _routes(name)
    clip = ops.kernel_clip(yc, cout, req, True)
    got = ops.int8_conv_direct_ck(x, w_ck, *args, clip=clip)
    torch.cuda.synchronize()
    assert _routes(name).get(route + "+clip", 0) == routes.get(route + "+clip", 0) + 1, _routes(name)
    want = ops.int8_conv_direct_plain(x, w_ck, *args, clip=clip)
    if req is None:
        torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
    else:
        assert torch.equal(got, want)
    assert not torch.equal(got, ops.int8_conv_direct_ck(x, w_ck, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,route", [(32, 2048, 1000, "sm90"), (6272, 576, 64, "sm90"), (1000, 64, 256, "sm90"),
                                         (9, 301, 130, "tile"), (300, 27, 16, "tile")])
def test_gemm_clip_instances_match_plain(cuda_device, gen, m, k, n, route):
    """K1 with the clamp, f32 and requant forms, on the Hopper GEMM and the
    general tile: equal to the plain versions."""
    a, w, alpha, beta = _gemm_case(gen, cuda_device, m, k, n)
    yc = _clip_bounds(gen, n, ops.int8_matmul_plain(a, w, alpha, beta), cuda_device)
    routes = {name: _routes(name) for name in ("int8_matmul", "int8_matmul_requant")}
    qc = ops.requant_clip_bounds((yc[0], yc[1]), 0.01, 113, True)
    y = ops.int8_matmul_nk(a, w, alpha, beta, relu=True, clip=yc)
    q = ops.int8_matmul_requant_nk(a, w, alpha, beta, 0.01, 113, relu=True, clip=qc)
    torch.cuda.synchronize()
    for name in routes:
        assert _routes(name).get(route + "+clip", 0) == routes[name].get(route + "+clip", 0) + 1, _routes(name)
    torch.testing.assert_close(y, ops.int8_matmul_plain(a, w, alpha, beta, True, clip=yc), atol=F32_ATOL, rtol=0)
    assert torch.equal(q, ops.int8_matmul_requant_plain(a, w, alpha, beta, 0.01, 113, True, clip=qc))
    assert not torch.equal(q, ops.int8_matmul_requant_nk(a, w, alpha, beta, 0.01, 113, relu=True))


def _rangebn_cifar20(backend, device):
    """A RangeBN CIFAR ResNet-20, two observer-update passes on seeded
    images, its RangeBN observers narrowed to 40% (the clamp binds), built
    on ``backend``."""
    from quantized_tpu_torch.engine import build_int8_resident
    from quantized_tpu_torch.models import get_model
    from quantized_tpu_torch.models.layers import RangeBN

    model = get_model("resnet_quantized")(dataset="cifar10", depth=20, generator=torch.Generator().manual_seed(0))
    model.train()
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for _ in range(2):
            model(torch.randn((8, 32, 32, 3), generator=g))
        for m in model.modules():
            if isinstance(m, RangeBN):
                m.quantize_input.running_min.mul_(0.4)
                m.quantize_input.running_max.mul_(0.4)
    return build_int8_resident(model.eval(), backend=backend, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("via_convert", [False, True])
def test_strict_engine_of_a_model_already_on_the_gpu(cuda_device, via_convert):
    """``convert_to_int_strict`` (and ``convert_to_int(weight_quant=
    "per_tensor")``) of a RangeBN CIFAR ResNet-20 that already lies on the
    card: every buffer and parameter of the result on the card, its logits
    within 2 fc steps of the CPU twin's, the argmax equal."""
    import copy

    from quantized_tpu_torch.engine import convert_to_int, convert_to_int_strict
    from quantized_tpu_torch.models import get_model
    from quantized_tpu_torch.models.layers import RangeBN

    model = get_model("resnet_quantized")(dataset="cifar10", depth=20, generator=torch.Generator().manual_seed(0))
    model.train()
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for _ in range(2):
            model(torch.randn((8, 32, 32, 3), generator=g))
    model.eval()
    assert any(isinstance(m, RangeBN) for m in model.modules())
    convert = ((lambda m, **kw: convert_to_int(m, weight_quant="per_tensor", **kw)) if via_convert
               else convert_to_int_strict)
    gpu = convert(copy.deepcopy(model).to(cuda_device))
    cpu = convert(copy.deepcopy(model), device="cpu")
    assert all(t.device.type == "cuda" for t in list(gpu.parameters()) + list(gpu.buffers()))
    x = torch.randn((4, 32, 32, 3), generator=g)
    with torch.inference_mode():
        got, want = gpu(x.to(cuda_device)).cpu(), cpu(x)
    assert (got - want).abs().max().item() < 2 * cpu.fc.act_scale
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "gemm"])
def test_rangebn_engine_on_the_gpu_equals_its_cpu_twin(cuda_device, backend):
    """The clamped CIFAR ResNet-20 on K2 (gather-K and per-tap CLIP
    instances, the prescaled f32 legs) or on K1 (im2col): every launch on a
    CLIP instance but the fc's, the logits equal to the CPU twin's within
    F32_ATOL, and no block fused."""
    from quantized_tpu_torch.engine import fuse_resident_blocks

    u8 = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
    gpu, cpu = _rangebn_cifar20(backend, cuda_device), _rangebn_cifar20(backend, "cpu")
    assert fuse_resident_blocks(gpu) == 0
    ops.reset_launches()
    with torch.inference_mode():
        got, want = gpu.run_u8(u8.to(cuda_device)).cpu(), cpu.run_u8(u8)
    torch.cuda.synchronize()
    for name, by_route in ops.route_counts().items():
        clipped = sum(v for r, v in by_route.items() if r.endswith("+clip"))
        assert clipped == sum(by_route.values()) - (1 if name == "int8_matmul" else 0), (name, by_route)
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)


# ----------------------------------------------------------------- the executor: CUDA graphs and pinned slots


def test_executor_on_cuda_raises_without_a_gpu(monkeypatch):
    """``IntExecutor(device="cuda")`` refuses where torch sees no GPU (here
    by monkeypatching, so the check runs on any machine)."""
    from quantized_tpu_torch.engine import IntExecutor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        IntExecutor(torch.nn.Linear(2, 2), device="cuda")


def _graph_engines(device):
    """CIFAR ResNet-20 (unfused and fused) and MobileNet-v1 w0.25 at 64x64
    (fused), each with its side."""
    import copy

    from quantized_tpu_torch.engine import build_int8_mobilenet, fuse_mobilenet_blocks, fuse_resident_blocks

    r20 = _cifar20_engine("pallas", device)
    r20_fused = copy.deepcopy(r20)
    fuse_resident_blocks(r20_fused)
    mob = build_int8_mobilenet(_observed_mobilenet(0.25, 64), backend="pallas", device=device)
    fuse_mobilenet_blocks(mob)
    return {"resnet20": (r20, 32), "resnet20 fused": (r20_fused, 32), "mobilenet w0.25 fused": (mob, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["resnet20", "resnet20 fused", "mobilenet w0.25 fused"])
def test_graph_replay_equals_eager(cuda_device, key):
    """One CUDA graph per input shape: the replay's logits equal the eager
    forward's bit for bit, at two batch shapes, from host and device
    inputs; the captured forward's launches are the eager forward's, on
    their Hopper routes; each shape replays its own graph."""
    from quantized_tpu_torch.engine import IntExecutor

    engine, side = _graph_engines(cuda_device)[key]
    graph = IntExecutor(engine, ingest="u8", device=cuda_device, graphs=True)
    eager = IntExecutor(engine, ingest="u8", device=cuda_device, graphs=False)
    gen = np.random.default_rng(3)
    for batch in (1, 8):
        for _ in range(2):
            u8 = torch.from_numpy(gen.integers(0, 256, (batch, side, side, 3), dtype=np.uint8))
            want = eager(u8)
            assert torch.equal(graph(u8), want)
            assert torch.equal(graph(u8.to(cuda_device)), want)
    stats = graph.graph_stats()
    assert set(stats) == {(1, side, side, 3), (8, side, side, 3)}
    ops.reset_launches()
    eager(u8)
    torch.cuda.synchronize()
    for s in stats.values():
        assert s["replays"] == 4 and s["seconds"] > 0
        assert s["launches"] == {k: n for k, n in ops.launch_counts().items() if n}
        assert all(set(r) <= {"sm90"} for r in s["routes"].values()), s["routes"]


@pytest.mark.cuda
def test_pinned_slot_ring_under_pipelining(cuda_device):
    """``dispatch`` with 5 slots a shape (pipeline depth 4): 12 batches of
    one bucket back to back, waited on only afterwards, oldest first. No
    replay may overwrite logits still on their way to the host, and no
    slot may be refilled before its copies complete: every result equals
    the eager forward of its own batch. Then the batcher at depth 4 over the
    same executor answers each request as the eager forward of its image."""
    from quantized_tpu_torch.engine import IntExecutor
    from quantized_tpu_torch.engine.batching import ContinuousBatcher

    engine, side = _graph_engines(cuda_device)["resnet20"]
    ex = IntExecutor(engine, ingest="u8", device=cuda_device, graphs=True, slots=5)
    eager = IntExecutor(engine, ingest="u8", device=cuda_device, graphs=False)
    gen = np.random.default_rng(4)
    batches = [gen.integers(0, 256, (8, side, side, 3), dtype=np.uint8) for _ in range(12)]
    results = [ex.dispatch(b) for b in batches]
    for b, r in zip(batches, results):
        np.testing.assert_array_equal(r.wait(), eager(torch.from_numpy(b)).cpu().numpy())
    assert ex.pinned_bytes() == 5 * (8 * side * side * 3 + 8 * 10 * 4)
    assert ex.graph_stats()[(8, side, side, 3)]["replays"] == 12

    imgs = gen.integers(0, 256, (40, side, side, 3), dtype=np.uint8)
    batcher = ContinuousBatcher(ex, (side, side, 3), batch_sizes=(1, 8), dtype=np.uint8, pipeline_depth=4)
    batcher.warmup().start()
    futs = [batcher.submit(im) for im in imgs]
    got = np.stack([f.result(timeout=60) for f in futs])
    batcher.stop()
    want = np.concatenate([eager(torch.from_numpy(imgs[i: i + 1])).cpu().numpy() for i in range(len(imgs))])
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_lent_input_slots(cuda_device):
    """``input_slot`` lends a pinned slot of a captured shape (None for a
    shape not captured or another dtype); a batch assembled in it and
    dispatched equals the eager forward, with no host copy of the batch; a
    lent slot is not lent again until its batch was dispatched and waited."""
    from quantized_tpu_torch.engine import IntExecutor

    engine, side = _graph_engines(cuda_device)["resnet20"]
    ex = IntExecutor(engine, ingest="u8", device=cuda_device, graphs=True, slots=3)
    eager = IntExecutor(engine, ingest="u8", device=cuda_device, graphs=False)
    shape = (8, side, side, 3)
    assert ex.input_slot(shape, np.uint8) is None  # not captured yet
    ex.warmup(np.zeros(shape, np.uint8))
    assert ex.input_slot(shape, np.float32) is None
    gen = np.random.default_rng(6)
    results, batches = [], []
    for _ in range(7):
        slot = ex.input_slot(shape, np.uint8)
        assert slot.shape == shape and all(slot is not b for b in batches[-2:])
        slot[:] = gen.integers(0, 256, shape, dtype=np.uint8)
        batches.append(slot)
        want = eager(torch.from_numpy(slot.copy())).cpu().numpy()
        results.append((ex.dispatch(slot), want))
    for result, want in results:
        np.testing.assert_array_equal(result.wait(), want)
    assert ex.pinned_bytes() == 3 * (8 * side * side * 3 + 8 * 10 * 4)


@pytest.mark.cuda
def test_capture_raises_under_debug_s16(cuda_device, monkeypatch):
    """QTPU_DEBUG_S16 reads a count back to the host inside the forward:
    capture refuses it (no silent eager forward); graphs=False serves."""
    from quantized_tpu_torch.engine import IntExecutor

    engine, side = _graph_engines(cuda_device)["resnet20"]
    monkeypatch.setenv("QTPU_DEBUG_S16", "1")
    u8 = torch.zeros((2, side, side, 3), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="QTPU_DEBUG_S16"):
        IntExecutor(engine, ingest="u8", device=cuda_device, graphs=True)(u8)
    assert IntExecutor(engine, ingest="u8", device=cuda_device, graphs=False)(u8).shape == (2, 10)


@pytest.mark.cuda
def test_grad_quant_draws_on_the_gpu(cuda_device):
    """A gradient-quantizing layer on the card draws its stochastic rounding
    from a generator made on the card (a CPU generator cannot draw there):
    the step runs, the stream advances once, and the quantized cotangent
    stays within one grad step of the exact one."""
    from quantized_tpu_torch.models import layers as L
    from quantized_tpu_torch.quantcore.ste import quantize_grad

    conv = L.QConv2d(8, 16, 3, padding=1, num_bits_grad=8, biprecision=True,
                     generator=torch.Generator().manual_seed(0)).to(cuda_device).train()
    x = torch.randn(4, 12, 12, 8, device=cuda_device, requires_grad=True)
    conv(x).square().sum().backward()
    assert conv.grad_quant_rng.count == 1 and torch.isfinite(x.grad).all() and conv.kernel.grad.abs().max() > 0
    g = torch.randn(64, 64, device=cuda_device)
    y = torch.zeros_like(g, requires_grad=True)
    gen = conv.grad_quant_rng(cuda_device)
    assert gen.device.type == "cuda"
    (quantize_grad(y, gen) * g).sum().backward()
    step = (g.max() - g.min()) / 255.0
    assert ((y.grad - g).abs() <= step * (1 + 1e-4)).all()


@pytest.mark.cuda
def test_trainer_step_on_the_gpu_matches_the_cpu(cuda_device):
    """One SGD step of the float CIFAR ResNet-8 through ``Trainer`` on the
    card against the CPU from the same weights: every tensor within 5e-3 of
    the larger of its magnitude and the largest step (conv sums in another
    order; BN biases are sums with cancellation), the loss within 1e-5."""
    import copy

    from quantized_tpu_torch.models import get_model
    from quantized_tpu_torch.training import Trainer

    regime = {0: {"optimizer": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}}
    cpu = get_model("resnet")(dataset="cifar10", depth=8, generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu)
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    rng = np.random.default_rng(3)
    batch = [(rng.standard_normal((16, 32, 32, 3)).astype(np.float32), rng.integers(0, 10, 16))]
    want = Trainer(cpu, regime=regime, device="cpu").train_epoch(batch, 0)
    got = Trainer(gpu, regime=regime, device=cuda_device).train_epoch(batch, 0)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    step = max((v - before[k]).abs().max().item() for k, v in cpu.state_dict().items()
               if not k.endswith(("mean", "var")))
    for k, v in cpu.state_dict().items():
        err = (gpu.state_dict()[k].cpu() - v).abs().max().item()
        assert err <= 5e-3 * max(v.abs().max().item(), step), (k, err)


# ----------------------------------------------------------------- the mesh (one rank a GPU, NCCL)


@pytest.mark.cuda
def test_one_rank_nccl_mesh_executor_with_graphs(cuda_device):
    """``create_mesh`` with no process group brings up a one-rank NCCL group;
    ``IntExecutor(mesh=)`` with one CUDA graph per shape (the collectives
    captured in it) gives the single-device executor's logits, bit for
    bit, at two shapes."""
    import copy

    import torch.distributed as dist

    from quantized_tpu_torch.engine import IntExecutor
    from quantized_tpu_torch.parallel import create_mesh
    from quantized_tpu_torch.parallel.collectives import collective_counts, reset_collectives

    engine = _cifar20_engine("pallas", cuda_device)
    mesh = create_mesh(device="cuda")
    try:
        assert dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
        single = IntExecutor(copy.deepcopy(engine), ingest="u8", device=cuda_device)
        reset_collectives()
        meshed = IntExecutor(copy.deepcopy(engine), mesh=mesh, ingest="u8", device=cuda_device)
        gen = np.random.default_rng(5)
        for batch in (1, 8):
            u8 = torch.from_numpy(gen.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8)).to(cuda_device)
            assert torch.equal(meshed(u8), single(u8))
        assert set(meshed.graph_stats()) == {(1, 32, 32, 3), (8, 32, 32, 3)}
        assert collective_counts()["all_gather"]["model"] > 0  # counted at the eager warm-ups and the captures
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_layer4_shards_in_turn_at_model_parallel_4(cuda_device):
    """ResNet-50's layer4 convs (the explicit-TP stage) as the four ranks of
    a model axis of 4 hold them, run in turn on the card on the inputs of
    one forward: each shard launches its kernel, and the shards' outputs
    concatenated along channels equal the whole conv's, bit for bit."""
    from quantized_tpu_torch.engine import build_int8_resident
    from quantized_tpu_torch.entry import _calibrated_model
    from quantized_tpu_torch.parallel.tp_engine import shard_copies

    model = _calibrated_model("resnet_quantized_float_bn", device="cpu", generator=torch.Generator().manual_seed(0),
                              dataset="imagenet", depth=50)
    engine = build_int8_resident(model, backend="pallas", device=cuda_device)
    calls = []
    for block in engine.layer4.children():
        for name in ("conv1", "conv2", "conv3", "downsample"):
            conv = getattr(block, name, None)
            if conv is None:
                continue
            run = conv.run_q

            def record(*args, _conv=conv, _run=run, **kwargs):
                out = _run(*args, **kwargs)
                calls.append((_conv, args, kwargs, out))
                return out

            conv.run_q = record
    u8 = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (8, 224, 224, 3), dtype=np.uint8))
    with torch.inference_mode():
        engine.run_u8(u8.to(cuda_device))
    assert len(calls) == 10
    for conv, args, kwargs, whole in calls:
        del conv.run_q
        outs = []
        for shard in shard_copies(conv, 4):
            ops.reset_launches()
            with torch.inference_mode():
                outs.append(shard.run_q(*args, **kwargs))
            assert sum(ops.launch_counts().values()) == 1
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(outs, dim=-1), whole)
