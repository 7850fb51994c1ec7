"""The port's int4 weight-only MobileNet-v1 against the JAX package's.

The same calibrated model on both sides (the JAX model's state carried by
the weight bridge) at 64x64, two images, after two observer-update passes
(as ``tests/test_torch_mobilenet.py`` calibrates it: on frozen [-4, 4]
grids a random-init MobileNet's convs past the fourth are constant). At
``weight_bits=4`` the 13 pointwise convs keep packed int4 weights; the stem
(Cin = 3) and the 13 depthwise convs (one channel per group) keep int8
storage on the int4 grid, as in JAX. The JAX engine runs ``backend="xla"``
eagerly, the port ``"pallas"`` with the plain versions.

Bounds, those of ``tests/test_torch_mobilenet.py``: every conv's packed
bytes (or int8 weights), alpha and beta equal; each conv fed the JAX
engine's input to it within 1 int step on under 1% of its elements (K2
rounds its requant after the f32 epilogue, XLA folds it in first), the
depthwise convs equal (the exact grouped path on both sides), the last
conv's f32 output within 1e-3, the logits within LOGIT_ATOL = 0.25.
``fuse_mobilenet_blocks`` fuses 0 pairs on both sides.
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

MAX_STEP = 1
MAX_DIFF_SHARE = 0.01
LOGIT_ATOL = 0.25
SIDE = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat_state(module) -> dict:
    return {
        ".".join(map(str, k)): np.asarray(v.get_value())
        for k, v in nnx.to_flat_state(nnx.state(module))
        if isinstance(v, (nnx.Param, nnx.BatchStat))
    }


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype == np.float32
    return a.view(np.int32)


@pytest.fixture(scope="module")
def engines():
    jq = j_calibrated_model("mobilenet_quantized")
    jq.train()  # observer-update mode
    calibrate = nnx.jit(lambda m, v: m(v))
    r = np.random.default_rng(1)
    for _ in range(2):
        calibrate(jq, jnp.asarray(r.standard_normal((2, SIDE, SIDE, 3)), jnp.float32))
    jq.eval()
    tq = t_calibrated_model("mobilenet_quantized", device="cpu", generator=torch.Generator().manual_seed(1))
    load_jax_arrays(tq, _flat_state(jq))
    jeng = jmob.build_int8_mobilenet(jq, weight_bits=4, backend="xla")
    teng = tmob.build_int8_mobilenet(tq, weight_bits=4, backend="pallas", device="cpu")
    u8 = np.random.default_rng(0).integers(0, 256, (2, SIDE, SIDE, 3), dtype=np.uint8)
    return dict(jeng=jeng, teng=teng, u8=u8)


def test_int4_mobilenet_weights_equal_jax(engines):
    jeng, teng = engines["jeng"], engines["teng"]
    assert teng.num_convs == jeng.num_convs == 27 and teng.requant_grids == jeng.requant_grids
    for i in range(teng.num_convs):
        jc, tc = getattr(jeng, f"conv{i}"), getattr(teng, f"conv{i}")
        pointwise = i > 0 and i % 2 == 0
        assert (tc.int4_shape is not None) == pointwise == (jc.int4_shape is not None), i
        w_j = np.asarray(jc.w_q.get_value())
        if pointwise:
            kh, kw, cin, cout = tc.int4_shape
            np.testing.assert_array_equal(tc.w_int4.reshape(cout, kh, kw, cin // 2).permute(1, 2, 3, 0).numpy(),
                                          w_j, f"conv{i}")
        else:
            np.testing.assert_array_equal(tc.weights().numpy(), w_j, f"conv{i}")
        assert np.abs(tc.weights().numpy()).max() <= 7, i
        for k in ("alpha", "beta"):
            np.testing.assert_array_equal(_bits(getattr(tc, k).numpy()), _bits(getattr(jc, k).get_value()))
    assert not teng.fc.int4 and np.abs(teng.fc.w_q.numpy()).max() <= 7
    np.testing.assert_array_equal(teng.fc.w_q.numpy(), np.asarray(jeng.fc.w_q.get_value()))


def test_int4_mobilenet_fuses_nothing(engines):
    counts = (jfused.fuse_mobilenet_blocks(copy.deepcopy(engines["jeng"])),
              tfused.fuse_mobilenet_blocks(copy.deepcopy(engines["teng"])))
    assert counts == (0, 0)


def _assert_within_one_step(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape, what
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_STEP, f"{what}: max diff {diff.max()}"
    assert (diff > 0).mean() < MAX_DIFF_SHARE, f"{what}: {(diff > 0).mean():.4f} of elements differ"


def test_int4_mobilenet_matches_jax(engines):
    """Each conv fed the JAX engine's input to it, then the logits end to
    end; no conv's output is constant."""
    jeng, teng, u8 = engines["jeng"], engines["teng"], engines["u8"]
    h = j_u8_to_stored(jnp.asarray(u8), jeng.input_grid)
    with torch.inference_mode():
        for i in range(jeng.num_convs):
            jc, tc, grid = getattr(jeng, f"conv{i}"), getattr(teng, f"conv{i}"), jeng.requant_grids[i]
            h_next = jc.run_q(h, relu=True, out_requant=grid)
            got = tc.run_q(_t(h), relu=True, out_requant=grid)
            assert len(np.unique(np.asarray(h_next))) > 1, f"conv{i} is constant"
            if grid is None:  # the last conv emits f32 for the pool and fc
                np.testing.assert_allclose(got.numpy(), np.asarray(h_next), atol=1e-3, rtol=0)
            elif tc.groups > 1:
                np.testing.assert_array_equal(got.numpy(), np.asarray(h_next), f"conv{i}")
            else:
                _assert_within_one_step(got, h_next, f"conv{i}")
            h = h_next
        want = np.asarray(jeng.fc(jnp.mean(h, axis=(1, 2))))  # the chain above is the JAX engine's run_u8
    got = IntExecutor(teng, ingest="u8", device="cpu")(u8).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
