"""The port's flat-row conv (B7), K2's fused-residual form (B8), the copy
probes (B9) and the timing helpers against the JAX package's.

B7: the port's ``int8_conv_flat`` (its plain version on the CPU) against
JAX's Pallas ``int8_conv_flat`` in interpret mode and JAX's
``int8_conv_xla``, on the six cases of ``tests/test_pallas_conv.py`` (forced
``gather_k`` included): int8 outputs equal, f32 within 1e-3, the JAX
test's bound.

B8: ``int8_conv_direct(..., residual=, res_grid=)`` against JAX's Pallas
residual form in interpret mode. int8 outputs are equal except where XLA's
CPU backend contracts a multiply and an add of the Pallas epilogue into one
fused multiply-add: such an element lies exactly on a .5 tie of the port's
separately rounded value and lands 1 step away. Each differing element is
checked to be that tie, and they stay under 1e-3 of the elements. f32
outputs within 1e-3. The Hopper mainloop's residual arithmetic
(``int8_conv_zero_filled_plain(..., residual=)``: zero-filled padding,
``stored_zp * tapsum`` added back, then the residual epilogue) is held to
the same bounds against JAX and to K2's plain version bit for bit.

B9: the copy wrappers' plain versions against JAX's ``xla_add`` (its +1
wraps at 127), the probes' tables and refusals on the CPU.
"""

import importlib.util
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu.ops.int8_conv import int8_conv_xla as j_int8_conv_xla
from quantized_tpu.ops.int8_conv_pallas import int8_conv_direct as j_int8_conv_direct
from quantized_tpu.ops.int8_conv_pallas import int8_conv_flat as j_int8_conv_flat
from quantized_tpu_torch import ops
from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops.int8_matmul import f32
from quantized_tpu_torch.probes import dma_ring, sweep_conv
from quantized_tpu_torch.utils import chain_time, per_iter_time

ROOT = Path(__file__).resolve().parent.parent
F32_ATOL = 1e-3
MAX_TIE_SHARE = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand_case(rng, n, h, cin, cout, k):
    """As ``tests/test_pallas_conv.py`` draws them."""
    x = rng.integers(-128, 128, (n, h, h, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    alpha = rng.uniform(1e-4, 3e-4, (cout,)).astype(np.float32)
    beta = rng.uniform(-0.1, 0.1, (cout,)).astype(np.float32)
    return x, w, alpha, beta


def _assert_close(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.numpy().dtype == want.dtype, what
    if want.dtype == np.int8:
        np.testing.assert_array_equal(got.numpy(), want, what)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0, err_msg=what)


# ----------------------------------------------------------------- B7


FLAT_CASES = [
    # the cases of tests/test_pallas_conv.py::test_flat_matches_xla
    (4, 14, 64, 64, 3, (0.07, 113), None),     # auto gather-K (small Cin)
    (2, 28, 128, 128, 3, (0.05, 120), None),   # per-tap dots
    (4, 8, 64, 96, 1, (0.05, 128), None),      # 1x1 = plain matmul
    (2, 9, 512, 512, 3, None, False),          # f32 out, multi-Cout-tile
    (2, 7, 64, 512, 3, (0.06, 77), None),      # Cout tiles > 1, int8 out
    (2, 12, 32, 64, 5, (0.04, 99), True),      # 5x5, forced gather-K
]


@pytest.mark.parametrize("n,h,cin,cout,k,req,gather_k", FLAT_CASES)
def test_flat_plain_matches_jax_pallas_and_xla(rng, n, h, cin, cout, k, req, gather_k):
    x, w, alpha, beta = _rand_case(rng, n, h, cin, cout, k)
    pad = k // 2
    kw = dict(stride=1, padding=pad, stored_zp=-5, relu=True, out_requant=req)
    want_pallas = j_int8_conv_flat(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta),
                                   gather_k=gather_k, interpret=True, **kw)
    want_xla = j_int8_conv_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta), 1, pad,
                               -5, relu=True, out_requant=req)
    _cuda.reset_launches()
    got = ops.int8_conv_flat(_t(x), _t(w), _t(alpha), _t(beta), gather_k=gather_k, **kw)
    assert _cuda.launch_counts()["int8_conv_flat"] == 0  # CPU tensors run the plain version
    _assert_close(got, want_pallas, "against the Pallas kernel")
    _assert_close(got, want_xla, "against int8_conv_xla")
    if req is not None:
        assert len(np.unique(np.asarray(want_pallas))) > 50


def test_flat_plain_takes_the_junk_columns_and_the_tail(rng):
    """A 5x5 over a 6x6 image, padding 1: the flat rows of the last output
    row's taps run past the padded image (the tail the JAX wrapper pads with
    the stored zero point), and 4 of every Wp = 8 flat output rows are junk;
    K2's plain version computes the same function without either."""
    x, w, alpha, beta = _rand_case(rng, 2, 6, 24, 40, 5)
    args = (_t(x), ops.pack_conv_weight(_t(w)), (5, 5), _t(alpha), _t(beta), 1, 1, -5, True)
    for req in (None, (0.05, 113)):
        got = ops.int8_conv_flat_plain(*args, req)
        want = ops.int8_conv_direct_plain(*args, req)
        assert tuple(got.shape) == (2, 4, 4, 40)
        torch.testing.assert_close(got, want, atol=F32_ATOL if req is None else 0, rtol=0)
    want_pallas = j_int8_conv_flat(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta),
                                   padding=1, stored_zp=-5, relu=True, out_requant=(0.05, 113), interpret=True)
    _assert_close(ops.int8_conv_flat_plain(*args, (0.05, 113)), want_pallas, "against the Pallas kernel")


def test_flat_refuses_stride_2(rng):
    x, w, alpha, beta = _rand_case(rng, 1, 8, 16, 16, 3)
    with pytest.raises(ValueError, match="stride-1"):
        ops.int8_conv_flat(_t(x), _t(w), _t(alpha), _t(beta), stride=2, padding=1)
    with pytest.raises(ValueError, match="stride-1"):
        ops.int8_conv_flat_plain(_t(x), ops.pack_conv_weight(_t(w)), (3, 3), _t(alpha), _t(beta), (1, 2), 1)


def test_flat_gather_k_rule_is_the_pallas_one():
    """``cin < 128 and taps > 1`` (int8_conv_pallas.py:307), unlike K2's
    ``cin <= 32``."""
    from quantized_tpu_torch.ops.int8_conv_pallas import flat_gather_k, use_gather_k

    assert flat_gather_k(64, (3, 3)) and flat_gather_k(127, (3, 3)) and not flat_gather_k(128, (3, 3))
    assert not flat_gather_k(3, (1, 1))
    assert use_gather_k(32, (3, 3)) and not use_gather_k(64, (3, 3))


# ----------------------------------------------------------------- B8

RES_GRID, RES_REQ = (0.03, 117), (0.06, 105)


def _residual_case(rng, n, h, c, cout, stride=1):
    x, w, alpha, beta = _rand_case(rng, n, h, c, cout, 3)
    ho = (h + 2 - 3) // stride + 1
    r = rng.integers(-128, 128, (n, ho, ho, cout)).astype(np.int8)
    return x, w, alpha, beta, r


def _requant_preimage(x, w, alpha, beta, r, relu, stride=1):
    """The port's value before the requant's rounding, each float32
    operation rounded on its own."""
    y = ops.int8_conv_direct_plain(_t(x), ops.pack_conv_weight(_t(w)), (3, 3), _t(alpha), _t(beta), stride, 1, -5,
                                   relu, None, residual=_t(r), res_grid=RES_GRID)
    return (y * f32(1.0 / RES_REQ[0]) + f32(RES_REQ[1] - 128)).numpy()


def _assert_equal_but_fma_ties(got: torch.Tensor, want, pre: np.ndarray, what: str):
    want = np.asarray(want)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape, what
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"{what}: {diff.max()} steps"
    assert (diff > 0).mean() < MAX_TIE_SHARE, f"{what}: {(diff > 0).mean():.5f} of elements differ"
    for idx in map(tuple, np.argwhere(diff)):
        assert abs(float(pre[idx]) - math.floor(float(pre[idx]))) == 0.5, (what, idx, float(pre[idx]))


@pytest.mark.parametrize("n,h,c,cout", [(2, 14, 128, 128), (2, 9, 24, 40)])
def test_residual_plain_matches_jax_pallas(rng, n, h, c, cout):
    """(2, 14, 14, 128) as the JAX test runs it, and Cin 24 (JAX's residual
    form is per-tap even for Cin <= 32); s8 out with ReLU, then f32 out."""
    x, w, alpha, beta, r = _residual_case(rng, n, h, c, cout)
    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta))
    targs = (_t(x), _t(w), _t(alpha), _t(beta))
    kw = dict(stride=1, padding=1, stored_zp=-5, res_grid=RES_GRID)
    want = j_int8_conv_direct(*jargs, residual=jnp.asarray(r), relu=True, out_requant=RES_REQ, interpret=True, **kw)
    got = ops.int8_conv_direct(*targs, residual=_t(r), relu=True, out_requant=RES_REQ, **kw)
    _assert_equal_but_fma_ties(got, want, _requant_preimage(x, w, alpha, beta, r, True), "s8")
    assert len(np.unique(np.asarray(want))) > 100
    want32 = j_int8_conv_direct(*jargs, residual=jnp.asarray(r), relu=False, interpret=True, **kw)
    _assert_close(ops.int8_conv_direct(*targs, residual=_t(r), relu=False, **kw), want32, "f32")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n,h,c,cout", [(2, 9, 32, 30), (2, 10, 64, 64)])
def test_mainloop_residual_arithmetic_matches_jax_pallas(rng, n, h, c, cout, stride):
    """B8 as the Hopper mainloop computes it (the padding read as zeros,
    ``stored_zp * tapsum`` added back over the outside taps, then the
    residual epilogue) at strides 1 and 2, padding 1 with the stored zero
    point -5, Cout 30 (not a multiple of 4: the kernel's byte-wise residual
    loads) and 64: equal to K2's plain version bit for bit, to JAX's
    residual form s8 but for XLA's FMA ties and f32 within 1e-3."""
    x, w, alpha, beta, r = _residual_case(rng, n, h, c, cout, stride)
    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta))
    w_ck = ops.pack_conv_weight(_t(w))
    kw = dict(residual=_t(r), res_grid=RES_GRID)
    for req, relu in ((RES_REQ, True), (None, False), (None, True)):
        got = ops.int8_conv_zero_filled_plain(_t(x), w_ck, (3, 3), _t(alpha), _t(beta), stride, 1, -5, relu, req,
                                              **kw)
        want = ops.int8_conv_direct_plain(_t(x), w_ck, (3, 3), _t(alpha), _t(beta), stride, 1, -5, relu, req, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want), (req, relu)
        jax_out = j_int8_conv_direct(*jargs, residual=jnp.asarray(r), stride=stride, padding=1, stored_zp=-5,
                                     relu=relu, out_requant=req, res_grid=RES_GRID, interpret=True)
        if req is None:
            _assert_close(got, jax_out, f"f32, relu {relu}")
        else:
            _assert_equal_but_fma_ties(got, jax_out, _requant_preimage(x, w, alpha, beta, r, relu, stride), "s8")
            assert len(np.unique(np.asarray(jax_out))) > 50


def test_residual_plain_within_one_step_of_the_unfused_composition(rng):
    """The JAX test's own bound: the fused residual within 1 step of the
    unfused conv + dequantized residual + ReLU + requant, on under 1e-3."""
    x, w, alpha, beta, r = _residual_case(rng, 2, 14, 128, 128)
    acc = j_int8_conv_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta), 1, 1, -5,
                          relu=False, out_requant=None)
    r_deq = (jnp.asarray(r).astype(jnp.float32) + jnp.float32(128 - RES_GRID[1])) * jnp.float32(RES_GRID[0])
    y = jnp.maximum(acc + r_deq, 0.0)
    q_ref = np.asarray((jnp.clip(jnp.round(y * (1.0 / RES_REQ[0])) + RES_REQ[1], 0, 255) - 128).astype(jnp.int8))
    got = ops.int8_conv_direct(_t(x), _t(w), _t(alpha), _t(beta), 1, 1, -5, True, RES_REQ, residual=_t(r),
                               res_grid=RES_GRID)
    d = np.abs(got.numpy().astype(np.int32) - q_ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_residual_checks_its_arguments(rng):
    x, w, alpha, beta, r = _residual_case(rng, 1, 6, 16, 16)
    args = (_t(x), _t(w), _t(alpha), _t(beta), 1, 1)
    with pytest.raises(ValueError, match="res_grid"):
        ops.int8_conv_direct(*args, residual=_t(r))
    with pytest.raises(ValueError):  # not the output's shape
        ops.int8_conv_direct(*args, residual=_t(r)[:, :5], res_grid=RES_GRID)
    with pytest.raises(TypeError):
        ops.int8_conv_direct(*args, residual=_t(r).float(), res_grid=RES_GRID)
    _cuda.reset_launches()
    out = ops.int8_conv_direct(*args, residual=_t(r), res_grid=RES_GRID)
    assert tuple(out.shape) == (1, 6, 6, 16) and out.dtype == torch.float32
    assert _cuda.launch_counts()["int8_conv_direct_residual"] == 0


# ----------------------------------------------------------------- B9 and the probes


def _jax_probe3_xla_add(monkeypatch):
    """``xla_add`` of ``bench/dma_ring_probe3.py``, loaded from the file (it
    reads its batch from argv at import)."""
    monkeypatch.setattr(sys, "argv", ["dma_ring_probe3.py"])
    spec = importlib.util.spec_from_file_location("dma_ring_probe3", ROOT / "bench" / "dma_ring_probe3.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.xla_add


def test_copy_plain_versions_equal_jax_xla_add(rng, monkeypatch):
    xla_add = _jax_probe3_xla_add(monkeypatch)
    x = rng.integers(-128, 128, (3, 5, 7, 16)).astype(np.int8)
    x.reshape(-1)[:2] = (127, -128)
    want = np.asarray(xla_add(jnp.asarray(x)))
    assert want.reshape(-1)[0] == -128  # the +1 wraps at 127
    tx = _t(x)
    _cuda.reset_launches()
    np.testing.assert_array_equal(ops.copy_plain(tx, add=True).numpy(), want)
    np.testing.assert_array_equal(ops.grid_copy(tx, 2, add=True).numpy(), want)
    np.testing.assert_array_equal(ops.ring_copy(tx, 4, 2, 1, "add").numpy(), want)
    for got in (ops.grid_copy(tx), ops.ring_copy(tx, 8, 4, 1, "sep"), ops.bulk_copy(tx, 2)):
        assert torch.equal(got, tx) and got.data_ptr() != tx.data_ptr()
    assert all(n == 0 for k, n in _cuda.launch_counts().items() if k.endswith("_copy"))


def test_copy_wrappers_check_their_arguments():
    x = torch.zeros((2, 4, 4, 16), dtype=torch.int8)
    with pytest.raises(ValueError):
        ops.ring_copy(x, 2, 4, 1)  # prefetch past the ring
    with pytest.raises(ValueError):
        ops.ring_copy(x, 4, 2, 1, "mul")
    with pytest.raises(ValueError):
        ops.bulk_copy(x, 0)
    with pytest.raises(ValueError):
        ops.grid_copy(x, 0)
    with pytest.raises(TypeError):
        ops.grid_copy(x.float())


def test_ring_slot_plan_fits_the_layer1_variants():
    """Every ring variant of the probe fits one block's shared memory on
    132 SMs at the layer1 geometry (batch 128)."""
    from quantized_tpu_torch.ops.copy_probe import SMEM_PER_BLOCK, ring_slot_bytes

    x = torch.empty((128, 56, 56, 256), dtype=torch.int8, device="meta")
    for slots, bi, sep in [(4, 1, False), (8, 1, False), (4, 4, False), (4, 4, True), (8, 4, False)]:
        assert slots * ring_slot_bytes(x, bi, 132) * (2 if sep else 1) <= SMEM_PER_BLOCK, (slots, bi, sep)
    assert ring_slot_bytes(x, 1, 132) == 6144  # 802,816 bytes over 132 blocks, in whole 128-byte lines


def test_dma_ring_probe_checks_and_times_every_variant_on_the_cpu():
    lines = []
    times = dma_ring.run_probe(1, target_secs=1e-3, reps=1, device="cpu", out=lines.append)
    assert set(times) == set(dma_ring.VARIANTS) | {"torch copy_"}
    assert all(t > 0 and math.isfinite(t) for t in times.values())
    assert {"grid-copy", "raw-1dma", "raw-2dma", "ring-dyn", "ring-unroll-sep-bi4", "copy-bi16"} <= set(times)
    assert len(lines) == len(times) + 1


def test_conv_sweep_refuses_flat_only_at_stride_2_on_the_cpu():
    shapes = [("s1", 6, 16, 24, 3, 1, 2), ("s2", 6, 16, 24, 3, 2, 1), ("pw", 5, 24, 8, 1, 1, 3)]
    times = sweep_conv.run_sweep(1, ("direct", "flat", "gemm", "i8io"), target_secs=1e-3, reps=1, probe_loops=1,
                                 device="cpu", shapes=shapes, out=lambda line: None)
    for shape, *_, stride, _ in shapes:
        assert math.isnan(times["flat"][shape]) == (stride != 1)
        assert times["direct"][shape] > 0 and times["gemm"][shape] > 0
        assert math.isnan(times["i8io"][shape])  # a TPU-only mode
    assert len(sweep_conv.SHAPES) == 24 and sum(row[5] == 2 for row in sweep_conv.SHAPES) == 7


# ----------------------------------------------------------------- timing


def test_per_iter_time_is_a_positive_time_per_step():
    calls = []

    def step(carry, a):
        calls.append(carry)
        return carry + a.sum()

    dt = per_iter_time(step, torch.ones(3), target_secs=1e-3, reps=3, probe_loops=4)
    assert math.isfinite(dt) and dt > 0
    # the warm run (1 step), then each run starts again from 0
    assert [float(c) for c in calls[1:4]] == [0.0, 3.0, 6.0]


def test_chain_time_feeds_each_output_back_as_the_next_input():
    seen = []

    def fn(y, c):
        seen.append(y.clone())
        return y + c

    dt = chain_time(fn, torch.zeros(2), torch.ones(2), target_secs=1e-3, reps=1, probe_loops=3)
    assert math.isfinite(dt) and dt > 0
    # the warm run (1 call), then each run starts again from x: 0, 1, 2, ...
    assert [float(v[0]) for v in seen[1:4]] == [0.0, 1.0, 2.0]
