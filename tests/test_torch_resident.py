"""The slice as a whole: the port's int8-resident ResNet-50 against the JAX
package's, on the same calibrated model.

The JAX model is ``_calibrated_model("resnet_quantized_float_bn",
dataset="imagenet", depth=50)`` (observers frozen at [-4, 4]); its state
crosses to the port through the weight bridge. The JAX engine runs
``backend="xla"``, the plain reference its own tests use; the port runs
``backend="pallas"`` (the direct conv's plain version, as on the CPU) and
``backend="gemm"``. Two images at 64x64 keep it small.

Tolerances, and why:
- the JAX "xla" backend emits a block's downsample leg as int16 at 1/32 of
  an output step (``S16_FINE``); the port keeps that leg in f32, as the JAX
  "pallas" backend does. So the output of a block with a downsample may
  differ by 1 int8 step, on under 1% of its elements; the other blocks run
  the same arithmetic and are equal on the "gemm" backend (which rounds its
  requant in XLA's order) and within 1 step on "pallas" (the direct conv
  applies its requant after the f32 epilogue, ``rint(relu(acc*a + b) *
  (1/s) + zp')``, where XLA folds 1/s into a and b first);
- each block gets the JAX engine's input to that block, so a difference
  shows where it arises and does not compound; a stage's output is its
  last block's;
- logits, end to end: 1-step differences do compound through an untrained
  net. Measured 0.11 on logits of magnitude 3.3; LOGIT_ATOL = 0.25, inside
  the bound of 1.0 that tests/test_int8_resident.py holds between two JAX
  engines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from __graft_entry__ import _calibrated_model as j_calibrated_model
from quantized_tpu.engine import int8_resident as jres
from quantized_tpu_torch.engine import IntExecutor
from quantized_tpu_torch.engine import int8_resident as tres
from quantized_tpu_torch.entry import _calibrated_model as t_calibrated_model
from quantized_tpu_torch.ingest import load_jax_arrays

MODEL = ("resnet_quantized_float_bn", dict(dataset="imagenet", depth=50))
MAX_STEP = 1
MAX_DIFF_SHARE = 0.01
LOGIT_ATOL = 0.25


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    name, cfg = MODEL
    jq = j_calibrated_model(name, **cfg)
    flat = {
        ".".join(map(str, k)): np.asarray(v.get_value())
        for k, v in nnx.to_flat_state(nnx.state(jq))
        if isinstance(v, (nnx.Param, nnx.BatchStat))
    }
    tq = t_calibrated_model(name, device="cpu", generator=torch.Generator().manual_seed(1), **cfg)
    assert set(flat) == set(tq.state_dict())
    load_jax_arrays(tq, flat)
    jeng = jres.build_int8_resident(jq, backend="xla")
    tengs = {b: tres.build_int8_resident(tq, backend=b, device="cpu") for b in ("pallas", "gemm")}
    u8 = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    return jeng, tengs, u8


def _assert_within_one_step(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape, what
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_STEP, f"{what}: max diff {diff.max()}"
    assert (diff > 0).mean() < MAX_DIFF_SHARE, f"{what}: {(diff > 0).mean():.4f} of elements differ"


@pytest.mark.parametrize("backend", ["pallas", "gemm"])
def test_block_and_stage_outputs_match_jax(pair, backend):
    jeng, tengs, u8 = pair
    teng = tengs[backend]
    x_j = jres.u8_to_stored(jnp.asarray(u8), jeng.stem.grid)
    assert teng.stem.grid == jeng.stem.grid and teng.stem_out_grid == jeng.stem_out_grid
    np.testing.assert_array_equal(tres.u8_to_stored(_t(u8), teng.stem.grid).numpy(), np.asarray(x_j))
    with torch.inference_mode():
        stem_j = jeng.stem.run_q(x_j, relu=True, out_requant=jeng.stem_out_grid)
        _assert_within_one_step(teng.stem.run_q(_t(x_j), relu=True, out_requant=teng.stem_out_grid),
                                stem_j, "stem")
        h = jres.maxpool_3x3_s2_int8(stem_j)
        np.testing.assert_array_equal(tres.maxpool_3x3_s2_int8(_t(stem_j)).numpy(), np.asarray(h))
        for i in range(1, 5):
            jstage, tstage = getattr(jeng, f"layer{i}"), getattr(teng, f"layer{i}")
            for k in range(jstage.num_blocks):
                jblock, tblock = getattr(jstage, str(k)), getattr(tstage, str(k))
                h_next = jblock(h)
                got = tblock(_t(h))
                what = f"layer{i}.{k}"
                if tblock.out_grid is None:  # the last block emits f32 for the pool and fc
                    np.testing.assert_allclose(got.numpy(), np.asarray(h_next), atol=1e-3, rtol=0)
                elif backend == "gemm" and tblock.downsample is None:
                    np.testing.assert_array_equal(got.numpy(), np.asarray(h_next), what)
                else:
                    _assert_within_one_step(got, h_next, what)
                h = h_next
        pooled = jnp.mean(h, axis=(1, 2))
        np.testing.assert_allclose(teng.fc(_t(pooled)).numpy(), np.asarray(jeng.fc(pooled)),
                                   atol=1e-3, rtol=0)


@pytest.mark.parametrize("backend", ["pallas", "gemm"])
def test_logits_match_jax(pair, backend):
    jeng, tengs, u8 = pair
    want = np.asarray(jeng.run_u8(jnp.asarray(u8)))
    ex = IntExecutor(tengs[backend], ingest="u8", device="cpu")
    got = ex(u8)
    assert got.shape == (2, 1000) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    # the f32 entry quantizes onto the stem grid first
    x = (u8.astype(np.float32) / 255.0 - 0.45) / 0.225
    want_f32 = np.asarray(jeng(jnp.asarray(x)))
    got_f32 = IntExecutor(tengs[backend], ingest="f32", device="cpu")(x)
    np.testing.assert_allclose(got_f32.numpy(), want_f32, atol=LOGIT_ATOL, rtol=0)


def test_launch_plan_has_53_convs(pair):
    """One ResNet-50 forward runs 53 convs (1 stem, 48 block convs, 4
    downsamples) and one fc, each one kernel launch on the card."""
    _, tengs, _ = pair
    convs = [m for m in tengs["pallas"].modules() if type(m).__name__ == "IntConv2d"]
    linears = [m for m in tengs["pallas"].modules() if type(m).__name__ == "IntLinear"]
    assert len(convs) == 53 and len(linears) == 1
    assert tengs["pallas"].stem.conv.kernel_size == (4, 4)


def test_entry_points_refuse_a_missing_gpu(pair):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, tengs, _ = pair
    with pytest.raises(RuntimeError, match="CUDA"):
        IntExecutor(tengs["pallas"], ingest="u8")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_calibrated_model("resnet_quantized_float_bn", dataset="imagenet", depth=50)
