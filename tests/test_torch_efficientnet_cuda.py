"""EfficientNet's kernels and engine on the card, against their plain
PyTorch versions run on the same card:

    python -m pytest --noconftest tests/test_torch_efficientnet_cuda.py -q

- the depthwise kernel at each of B0's depthwise shapes, its int8 output
  and its int32 sums equal to the plain version's, and at the extreme zero
  points and an odd batch;
- the squeeze and the gate pass, equal;
- K2's SiLU epilogue on each route B0 runs it (the gather-K stem, the
  per-tap mainloop, its pixel groups) and the residual form without an
  activation, int8 equal and f32 within F32_ATOL; K1's SiLU requant and
  sigmoid f32 forms on both routes;
- a small EfficientNet built on the card equal to its CPU twin at every
  block boundary, at most one step apart where the card's ``expf`` and the
  host's ``exp`` round a SiLU or the sigmoid apart, every depthwise conv,
  squeeze and gate pass on the kernels, and its CUDA graph's replay equal
  to its eager forward.

Every test needs a CUDA GPU and nvcc; elsewhere it skips. The file imports
neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch
from torch_markers import cuda_device  # noqa: F401  (fixture)

from quantized_tpu_torch import ops
from quantized_tpu_torch.ops.int8_matmul import ACT_SIGMOID, ACT_SILU

F32_ATOL = 1e-3
# B0's depthwise convs at 224: (input side, channels, k, stride)
DW_SHAPES = [(112, 32, 3, 1), (112, 96, 3, 2), (56, 144, 3, 1), (56, 144, 5, 2), (28, 240, 5, 1), (28, 240, 3, 2),
             (14, 480, 3, 1), (14, 480, 5, 1), (14, 672, 5, 1), (14, 672, 5, 2), (7, 1152, 5, 1), (7, 1152, 3, 1)]
SMALL = {"num_classes": 10, "blocks": [[1, 3, 1, 16, 1], [6, 3, 2, 24, 1], [6, 5, 1, 24, 1], [6, 5, 2, 40, 1]],
         "head_width": 64}


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _dev(a, device):
    return torch.from_numpy(np.array(a)).to(device)


def _dw_inputs(gen, device, n, side, c, k):
    x = _dev(gen.integers(-128, 128, (n, side, side, c)).astype(np.int8), device)
    w = _dev(gen.integers(-127, 128, (k, k, c)).astype(np.int8), device)
    alpha = _dev(gen.uniform(2e-4, 6e-4, c).astype(np.float32), device)
    beta = _dev(gen.uniform(-2.0, 2.0, c).astype(np.float32), device)
    return x, w, alpha, beta


@pytest.mark.cuda
@pytest.mark.parametrize("side,c,k,s", DW_SHAPES)
def test_dw_kernel_matches_plain(cuda_device, gen, side, c, k, s):
    x, w, alpha, beta = _dw_inputs(gen, cuda_device, 3, side, c, k)
    args = (alpha, beta, s, -7, ACT_SILU, (0.03, 40))
    before = ops.KERNELS["dw_conv"].launches
    got, sums = ops.dw_conv(x, w, *args)
    want, want_sums = ops.dw_conv_plain(x, w, *args)
    torch.cuda.synchronize()
    assert ops.KERNELS["dw_conv"].launches == before + 1
    assert torch.equal(got, want) and torch.equal(sums, want_sums)
    assert len(torch.unique(got)) > 100  # the epilogue spreads the output over the grid


@pytest.mark.cuda
@pytest.mark.parametrize("stored_zp", [-128, 127])
@pytest.mark.parametrize("act", [0, ACT_SILU])
def test_dw_kernel_at_extreme_zero_points(cuda_device, gen, stored_zp, act):
    x, w, alpha, beta = _dw_inputs(gen, cuda_device, 5, 9, 48, 5)
    args = (alpha, beta, 2, stored_zp, act, (0.05, 128))
    got, sums = ops.dw_conv(x, w, *args)
    want, want_sums = ops.dw_conv_plain(x, w, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(sums, want_sums)


@pytest.mark.cuda
def test_se_squeeze_and_gate_match_plain(cuda_device, gen):
    n, side, c = 5, 14, 480
    x = _dev(gen.integers(-128, 128, (n, side, side, c)).astype(np.int8), cuda_device)
    sums = x.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32)
    got = ops.se_squeeze(sums, side * side, (0.04, 90), (0.01, 30))
    assert torch.equal(got, ops.se_squeeze_plain(sums, side * side, (0.04, 90), (0.01, 30)))
    g = torch.rand((n, c), generator=torch.Generator(cuda_device).manual_seed(1), device=cuda_device)
    got = ops.se_gate(x, g, (0.04, 90), (0.02, 110))
    torch.cuda.synchronize()
    assert torch.equal(got, ops.se_gate_plain(x, g, (0.04, 90), (0.02, 110)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout,k,s,pad,req,route", [
    (4, 224, 3, 32, 3, 2, 1, (0.05, 113), "sm90"),  # the stem, gather-K
    (4, 112, 16, 96, 1, 1, 0, (0.04, 60), "sm90"),  # an expand conv on the mainloop
    (4, 56, 24, 144, 1, 1, 0, (0.04, 60), "sm90"),  # on pixel groups
    (4, 7, 320, 1280, 1, 1, 0, None, "sm90"),  # the head, f32 out
    (2, 9, 40, 24, 3, 1, 1, (0.05, 128), "tile"),  # the general tile
])
def test_conv_silu_epilogue_matches_plain(cuda_device, gen, n, h, cin, cout, k, s, pad, req, route):
    x = _dev(gen.integers(-128, 128, (n, h, h, cin)).astype(np.int8), cuda_device)
    w_ck = _dev(gen.integers(-127, 128, (cout, k * k * cin)).astype(np.int8), cuda_device)
    alpha = _dev(gen.uniform(1e-4, 3e-4, cout).astype(np.float32), cuda_device)
    beta = _dev(gen.uniform(-2.0, 2.0, cout).astype(np.float32), cuda_device)
    args = ((k, k), alpha, beta, s, pad, -5, ACT_SILU, req)
    ops.reset_launches()
    got = ops.int8_conv_direct_ck(x, w_ck, *args)
    want = ops.int8_conv_direct_plain(x, w_ck, *args)
    torch.cuda.synchronize()
    assert [r for k in ops.route_counts().values() for r in k] == [route]
    if req is None:
        torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
        assert float(got.min()) < 0.0  # SiLU, not ReLU
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_residual_conv_without_activation_matches_plain(cuda_device, gen):
    n, h, cin, cout = 4, 14, 672, 112
    x = _dev(gen.integers(-128, 128, (n, h, h, cin)).astype(np.int8), cuda_device)
    r = _dev(gen.integers(-128, 128, (n, h, h, cout)).astype(np.int8), cuda_device)
    w_ck = _dev(gen.integers(-127, 128, (cout, cin)).astype(np.int8), cuda_device)
    alpha = _dev(gen.uniform(1e-5, 3e-5, cout).astype(np.float32), cuda_device)
    beta = _dev(gen.uniform(-1.0, 1.0, cout).astype(np.float32), cuda_device)
    args = ((1, 1), alpha, beta, 1, 0, 3, False, (0.05, 128))
    got = ops.int8_conv_direct_ck(x, w_ck, *args, residual=r, res_grid=(0.04, 100))
    want = ops.int8_conv_direct_plain(x, w_ck, *args, residual=r, res_grid=(0.04, 100))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,route", [(128, 1152, 48, "sm90"), (128, 96, 4, "sm90"), (128, 20, 480, "tile"),
                                         (128, 48, 1152, "sm90"), (5, 8, 32, "tile")])
def test_gemm_silu_and_sigmoid_match_plain(cuda_device, gen, m, k, n, route):
    a = _dev(gen.integers(-128, 128, (m, k)).astype(np.int8), cuda_device)
    w = _dev(gen.integers(-127, 128, (n, k)).astype(np.int8), cuda_device)
    alpha = _dev(gen.uniform(1e-4, 3e-4, n).astype(np.float32), cuda_device)
    beta = _dev(gen.uniform(-2.0, 2.0, n).astype(np.float32), cuda_device)
    ops.reset_launches()
    got = ops.int8_matmul_requant_nk(a, w, alpha, beta, 0.02, 40, relu=ACT_SILU)
    want = ops.int8_matmul_requant_plain(a, w, alpha, beta, 0.02, 40, relu=ACT_SILU)
    g = ops.int8_matmul_nk(a, w, alpha, beta, relu=ACT_SIGMOID)
    g_want = ops.int8_matmul_plain(a, w, alpha, beta, relu=ACT_SIGMOID)
    torch.cuda.synchronize()
    assert ops.route_counts() == {"int8_matmul_requant": {route: 1}, "int8_matmul": {route: 1}}
    assert torch.equal(got, want)
    torch.testing.assert_close(g, g_want, atol=1e-6, rtol=0)
    assert 0.0 <= float(g.min()) and float(g.max()) <= 1.0


def _small_engines(device):
    from quantized_tpu_torch.engine import build_int8_efficientnet
    from quantized_tpu_torch.models import get_model

    model = get_model("efficientnet_quantized")(generator=torch.Generator().manual_seed(3), **SMALL)
    gen = torch.Generator().manual_seed(5)
    model.train()
    with torch.no_grad():  # the observers' ranges and the BN statistics from two passes
        for _ in range(2):
            model(torch.randn((8, 32, 32, 3), generator=gen))
    model.eval()
    return build_int8_efficientnet(model, device="cpu"), build_int8_efficientnet(model, device=device)


@pytest.mark.cuda
def test_engine_on_the_card_equals_its_cpu_twin(cuda_device):
    from quantized_tpu_torch.engine import IntExecutor
    from quantized_tpu_torch.engine.int8_resident import u8_to_stored

    cpu, gpu = _small_engines(cuda_device)
    u8 = torch.randint(0, 256, (8, 32, 32, 3), generator=torch.Generator().manual_seed(7), dtype=torch.uint8)
    with torch.inference_mode():
        want = cpu.block_outputs(u8_to_stored(u8, cpu.input_grid))
        ops.reset_launches()
        got = gpu.block_outputs(u8_to_stored(u8.to(cuda_device), gpu.input_grid))
        torch.cuda.synchronize()
        assert gpu.routes() == {"dw.sm90": 4, "dw.plain": 0, "squeeze.sm90": 4, "squeeze.plain": 0,
                                "gate.sm90": 4, "gate.plain": 0}
        assert {k: ops.launch_counts()[k] for k in ("dw_conv", "se_squeeze", "se_gate")} == {
            "dw_conv": 4, "se_squeeze": 4, "se_gate": 4}
        # the SE's reduces (K 32-144) on K1's Hopper route, its expands over squeeze widths 8, 4, 6, 6 on the tile
        routes = ops.route_counts()
        assert routes["int8_matmul_requant"] == {"sm90": 4} and routes["int8_matmul"] == {"tile": 4}
        for i, (g, w) in enumerate(zip(got, want)):
            step = (g.cpu().to(torch.int32) - w.to(torch.int32)).abs()
            assert int(step.max()) <= 1, i
            assert float((step > 0).float().mean()) < 0.01, i
        graph = IntExecutor(gpu, ingest="u8", device=cuda_device, graphs=True)
        eager = IntExecutor(gpu, ingest="u8", device=cuda_device, graphs=False)
        logits = eager(u8)
        assert torch.equal(graph(u8), logits) and torch.equal(graph(u8), logits)
        torch.testing.assert_close(logits.cpu(), cpu.run_u8(u8), atol=0.25, rtol=0)
