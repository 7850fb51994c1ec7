"""Checks of the port's int8-resident AlexNet against the JAX package's,
shared by ``tests/test_torch_alexnet.py`` (BN scales as initialised) and
``tests/test_torch_alexnet_flip.py`` (every 7th scale of bn1, bn2 and bn5
negated, so that the min-pool dual runs). Each file builds one model on
both sides; AlexNet exists only at 224x224.

Tolerances, and why:
- every layer's weights (packed int4 bytes where JAX packs), alpha and beta
  bit for bit, the negative-factor masks equal;
- each engine layer fed the JAX engine's input to it: the convs within 1
  int step on under 1% of the elements (the port's K2 applies its requant
  after the f32 epilogue; XLA folds 1/s into alpha and beta first); fc1
  and fc2 within 1 step too (K1/B6's f32 epilogue and then the quantize
  pass on both sides, but XLA may contract ``acc * alpha + beta`` into one
  fused multiply-add); fc3's f32 logits within rtol 1e-6, atol 1e-5 (the
  same contraction);
- the logits end to end within LOGIT_ATOL = 0.25, as for the other nets;
- the uint8 ingest against the f32 ingest: within 1 step on under 1% of
  the input, the logits within LOGIT_ATOL (at the check).
"""

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from quantized_tpu.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from quantized_tpu.engine import int8_alexnet as jalex
from quantized_tpu.engine import int8_resident as jres
from quantized_tpu.engine import int_layers as jil
from quantized_tpu_torch.engine import IntExecutor
from quantized_tpu_torch.engine import int8_alexnet as talex
from quantized_tpu_torch.engine.int8_resident import u8_to_stored
from quantized_tpu_torch.engine.int_layers import quantize_input_stored
from quantized_tpu_torch.entry import _calibrated_model as t_calibrated_model
from quantized_tpu_torch.ingest import load_jax_arrays

MAX_STEP = 1
MAX_DIFF_SHARE = 0.01
LOGIT_ATOL = 0.25
F32_RTOL, F32_ATOL = 1e-6, 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def flat_state(module) -> dict:
    """Parameters, BN statistics and observer ranges (not the Dropout's RNG
    state), keyed by their dotted paths."""
    return {
        ".".join(map(str, k)): np.asarray(v.get_value())
        for k, v in nnx.to_flat_state(nnx.state(module))
        if isinstance(v, (nnx.Param, nnx.BatchStat))
    }


def f32_bits(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype == np.float32
    return a.view(np.int32)


def flip_gamma(jq):
    """Negate every 7th BN scale of bn1, bn2 and bn5 (in place)."""
    for bn in (jq.bn1, jq.bn2, jq.bn5):
        s = np.array(bn.scale.get_value())
        s[::7] *= -1.0
        bn.scale.set_value(jnp.asarray(s))
    return jq


def build_engines(jq, flip: bool) -> dict:
    """The port's twin of the JAX model ``jq`` (through the weight bridge),
    and the int8 and int4 engines of both: the JAX ones on ``"xla"``, the
    port's on ``"pallas"`` on the CPU; two uint8 images."""
    tq = t_calibrated_model("alexnet_quantized", device="cpu", generator=torch.Generator().manual_seed(1))
    load_jax_arrays(tq, flat_state(jq))
    out = dict(flip=flip, jq=jq, tq=tq,
               u8=np.random.default_rng(0).integers(0, 256, (2, 224, 224, 3), dtype=np.uint8))
    for bits in (8, 4):
        out[f"j{bits}"] = jalex.build_int8_alexnet(jq, weight_bits=bits, backend="xla")
        out[f"t{bits}"] = talex.build_int8_alexnet(tq, weight_bits=bits, backend="pallas", device="cpu")
    return out


def check_layers_equal_jax(engines):
    """Geometry, grids, the negative-factor masks, and every layer's weights
    (packed int4 bytes where JAX packs: conv2-5 channel-split, fc1-3
    split-half; conv1's Cin = 3 stays int8 storage), alpha and beta bit for
    bit."""
    for bits in (8, 4):
        jeng, teng = engines[f"j{bits}"], engines[f"t{bits}"]
        assert teng.requant_grids == jeng.requant_grids and teng.input_size == jeng.input_size == 224
        for name in ("neg1", "neg2", "neg5"):
            jm, tm = getattr(jeng, name), getattr(teng, name)
            if engines["flip"]:  # the min-pool dual engaged
                assert tm is not None and tm.dtype == torch.bool
                np.testing.assert_array_equal(tm.numpy(), np.asarray(jm.get_value()))
            else:  # no negative factor: the max-pool alone
                assert tm is None and jm is None
        for i in range(1, 6):
            jc, tc = getattr(jeng, f"conv{i}"), getattr(teng, f"conv{i}")
            assert (tc.stride, tc.padding, tc.grid) == (tuple(jc.stride), tuple(jc.padding), jc.grid), i
            packed = bits == 4 and i > 1
            assert (tc.int4_shape is not None) == packed == (jc.int4_shape is not None), i
            w_j = np.asarray(jc.w_q.get_value())
            if packed:
                kh, kw, cin, cout = tc.int4_shape
                np.testing.assert_array_equal(
                    tc.w_int4.reshape(cout, kh, kw, cin // 2).permute(1, 2, 3, 0).numpy(), w_j)
            else:
                np.testing.assert_array_equal(tc.weights().numpy(), w_j)
            for k in ("alpha", "beta"):
                np.testing.assert_array_equal(f32_bits(getattr(tc, k).numpy()),
                                              f32_bits(getattr(jc, k).get_value()))
        for i in range(1, 4):
            jf, tf = getattr(jeng, f"fc{i}"), getattr(teng, f"fc{i}")
            assert tf.int4 == jf.int4 == (bits == 4) and tf.grid == jf.grid
            np.testing.assert_array_equal(tf.w_q.numpy(), np.asarray(jf.w_q.get_value()))
            for k in ("alpha", "beta"):
                np.testing.assert_array_equal(f32_bits(getattr(tf, k).numpy()),
                                              f32_bits(getattr(jf, k).get_value()))
    # the fc head's packed bytes: half of int8's 58.6 MB
    assert sum(getattr(engines["t4"], f"fc{i}").w_nk.numel() for i in (1, 2, 3)) * 2 == \
        sum(getattr(engines["t8"], f"fc{i}").w_nk.numel() for i in (1, 2, 3)) == 58_621_952


def assert_within_one_step(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape, what
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_STEP, f"{what}: max diff {diff.max()}"
    assert (diff > 0).mean() < MAX_DIFF_SHARE, f"{what}: {(diff > 0).mean():.4f} of elements differ"


def _steps(eng, pool_dual, as_mask):
    """(name, step) of an Int8AlexNet's layers: each conv with its pool, each
    dense layer; fc3 emits the f32 logits."""
    g = eng.requant_grids

    def conv(i, neg=None):
        def step(h):
            h = getattr(eng, f"conv{i}").run_q(h, relu=True, out_requant=g[i - 1])
            return h if neg is False else pool_dual(h, as_mask(getattr(eng, neg)))
        return step

    return [("conv1", conv(1, "neg1")), ("conv2", conv(2, "neg2")), ("conv3", conv(3, False)),
            ("conv4", conv(4, False)), ("conv5", conv(5, "neg5")),
            ("fc1", lambda h: eng.fc1.run_q(h.reshape(h.shape[0], -1), relu=True, out_requant=g[5])),
            ("fc2", lambda h: eng.fc2.run_q(h, relu=True, out_requant=g[6])),
            ("fc3", lambda h: eng.fc3.run_q(h))]


def check_engine_matches_jax(engines, bits):
    """Each layer fed the JAX engine's input to it, then the logits end to
    end; no layer's output is constant."""
    jeng, teng, u8 = engines[f"j{bits}"], engines[f"t{bits}"], engines["u8"]
    jsteps = _steps(jeng, jalex._pool_dual, lambda v: None if v is None else v.get_value())
    tsteps = _steps(teng, talex._pool_dual, lambda v: v)
    h = jres.u8_to_stored(jnp.asarray(u8), jeng.conv1.grid)
    with torch.inference_mode():
        for (name, jstep), (_, tstep) in zip(jsteps, tsteps):
            h_next = jstep(h)
            got = tstep(t(h))
            assert len(np.unique(np.asarray(h_next))) > 1, f"{name} is constant"
            if name == "fc3":
                np.testing.assert_allclose(got.numpy(), np.asarray(h_next), rtol=F32_RTOL, atol=F32_ATOL)
            else:
                assert_within_one_step(got, h_next, name)
            h = h_next
    # the chain of JAX layers above is the JAX engine's run_u8
    got = IntExecutor(teng, ingest="u8", device="cpu")(u8).numpy()
    assert got.shape == (2, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(h), atol=LOGIT_ATOL, rtol=0)


def check_u8_ingest_matches_f32(engines):
    """The uint8 ingest (normalize folded into the quantize) and the f32
    ingest each equal JAX's bit for bit, and land within 1 step of each
    other on under 1% of the input (measured 0.13%); the logits of the two
    within LOGIT_ATOL (measured 0.022 on logits of magnitude 0.17: on the
    frozen [-4, 4] grids of this untrained net a one-step input difference
    compounds)."""
    jeng, teng, u8 = engines["j4"], engines["t4"], engines["u8"]
    f32 = ((u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    from_u8 = u8_to_stored(t(u8), teng.conv1.grid)
    from_f32 = quantize_input_stored(t(f32), *teng.conv1.grid)
    np.testing.assert_array_equal(from_u8.numpy(),
                                  np.asarray(jres.u8_to_stored(jnp.asarray(u8), jeng.conv1.grid)))
    np.testing.assert_array_equal(from_f32.numpy(),
                                  np.asarray(jil.quantize_input_stored(jnp.asarray(f32), *jeng.conv1.grid)))
    assert_within_one_step(from_u8, from_f32.numpy(), "ingest")
    y_u8 = IntExecutor(teng, ingest="u8", device="cpu")(u8)
    y_f32 = IntExecutor(teng, device="cpu")(f32)
    assert torch.equal(y_f32, teng._forward_q(from_f32)) and torch.equal(y_u8, teng._forward_q(from_u8))
    np.testing.assert_allclose(y_u8.numpy(), y_f32.numpy(), atol=LOGIT_ATOL, rtol=0)
