"""MobileNet-v1 at width 0.75 on the port against the JAX package: channel
counts that are not multiples of 16 (C = 24 at the stem's output, the first
depthwise conv and fused pair 0, and the first pointwise conv's input).

The same calibrated model on both sides (two observer-update passes at
64x64, the JAX model's state carried by the weight bridge), two images:
- the port fuses the same pairs as JAX's ``fuse_mobilenet_blocks`` (12 of
  13) into the same stage plan;
- unfused, each conv fed the JAX engine's input to it: the depthwise convs
  equal, the stem and the pointwise convs (K2's plain version) within 1 int
  step on under 1% of the elements, the last conv's f32 within 1e-3; then
  the unfused and the fused logits within LOGIT_ATOL of JAX's, the bounds of
  ``tests/test_torch_mobilenet.py``.
The GPU half (K2's per-tap form and B5 over C = 24) is in
``tests/test_torch_cuda.py``.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from __graft_entry__ import _calibrated_model as j_calibrated_model
from quantized_tpu.engine import fused as jfused
from quantized_tpu.engine import int8_mobilenet as jmob
from quantized_tpu.engine.int8_resident import u8_to_stored as j_u8_to_stored
from quantized_tpu_torch.engine import IntExecutor
from quantized_tpu_torch.engine import fused as tfused
from quantized_tpu_torch.engine import int8_mobilenet as tmob
from quantized_tpu_torch.entry import _calibrated_model as t_calibrated_model
from quantized_tpu_torch.ingest import load_jax_arrays

WIDTH = 0.75
SIDE = 64
MAX_STEP = 1
MAX_DIFF_SHARE = 0.01
LOGIT_ATOL = 0.25


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat_state(module) -> dict:
    return {
        ".".join(map(str, k)): np.asarray(v.get_value())
        for k, v in nnx.to_flat_state(nnx.state(module))
        if isinstance(v, (nnx.Param, nnx.BatchStat))
    }


@pytest.fixture(scope="module")
def engines():
    jq = j_calibrated_model("mobilenet_quantized", width_mult=WIDTH)
    jq.train()  # observer-update mode
    calibrate = nnx.jit(lambda m, v: m(v))
    r = np.random.default_rng(1)
    for _ in range(2):
        calibrate(jq, jnp.asarray(r.standard_normal((2, SIDE, SIDE, 3)), jnp.float32))
    jq.eval()
    tq = t_calibrated_model("mobilenet_quantized", device="cpu", generator=torch.Generator().manual_seed(1),
                            width_mult=WIDTH)
    load_jax_arrays(tq, _flat_state(jq))
    jeng = jmob.build_int8_mobilenet(jq)
    teng = tmob.build_int8_mobilenet(tq, backend="pallas", device="cpu")
    jf, tf = copy.deepcopy(jeng), copy.deepcopy(teng)
    counts = (jfused.fuse_mobilenet_blocks(jf), tfused.fuse_mobilenet_blocks(tf))
    u8 = np.random.default_rng(0).integers(0, 256, (2, SIDE, SIDE, 3), dtype=np.uint8)
    return dict(jeng=jeng, teng=teng, jf=jf, tf=tf, counts=counts, u8=u8,
                x_j=j_u8_to_stored(jnp.asarray(u8), jeng.input_grid))


def test_narrow_channels_are_not_multiples_of_16(engines):
    teng = engines["teng"]
    cout = [getattr(teng, f"conv{i}").w_ck.shape[0] for i in range(3)]
    assert cout == [24, 24, 48]  # the stem, the first depthwise conv (over C = 24), its pointwise conv
    assert tuple(engines["tf"].stage1.wpw.shape) == (48, 24)  # fused pair 0 over C = 24


def test_fused_plan_equals_jax(engines):
    assert engines["counts"] == (12, 12)
    jf, tf = engines["jf"], engines["tf"]
    assert tf.num_fused_stages == jf.num_fused_stages == 15
    kinds = [type(getattr(tf, f"stage{j}")).__name__ for j in range(tf.num_fused_stages)]
    assert kinds == [type(getattr(jf, f"stage{j}")).__name__ for j in range(jf.num_fused_stages)]
    assert kinds == ["_ConvStage"] + ["FusedInt8DwPw"] * 12 + ["_ConvStage"] * 2


def test_unfused_convs_match_jax(engines):
    jeng, teng, x_j = engines["jeng"], engines["teng"], engines["x_j"]
    h = x_j
    with torch.inference_mode():
        for i in range(jeng.num_convs):
            jc, tc, grid = getattr(jeng, f"conv{i}"), getattr(teng, f"conv{i}"), jeng.requant_grids[i]
            want = np.asarray(jc.run_q(h, relu=True, out_requant=grid))
            got = tc.run_q(_t(h), relu=True, out_requant=grid)
            assert len(np.unique(want)) > 1, f"conv{i} is constant"
            if grid is None:  # the last conv emits f32 for the pool and fc
                np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
            elif tc.groups > 1:  # the exact grouped path on both sides
                np.testing.assert_array_equal(got.numpy(), want, f"conv{i}")
            else:
                diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= MAX_STEP and (diff > 0).mean() < MAX_DIFF_SHARE, f"conv{i}"
            h = want


def test_logits_match_jax(engines):
    u8 = engines["u8"]
    got = IntExecutor(engines["teng"], ingest="u8", device="cpu")(u8).numpy()
    assert got.shape == (2, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(engines["jeng"].run_u8(jnp.asarray(u8))), atol=LOGIT_ATOL, rtol=0)
    fused = IntExecutor(engines["tf"], ingest="u8", device="cpu")(u8).numpy()
    assert fused.shape == (2, 1000) and np.isfinite(fused).all()
    np.testing.assert_allclose(fused, np.asarray(engines["jf"].run_u8(jnp.asarray(u8))), atol=LOGIT_ATOL, rtol=0)
