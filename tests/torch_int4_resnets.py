"""Checks of the port's int4 weight-only ResNets against the JAX package's,
shared by ``tests/test_torch_int4.py`` (CIFAR ResNet-20 at 32x32) and
``tests/test_torch_int4_resnet50.py`` (ResNet-50 at 64x64).

The same calibrated model on both sides (the JAX model's state carried by
the weight bridge), two images. The JAX engine runs ``backend="xla"``
eagerly, the port ``"pallas"`` with the plain versions. The bounds are
those of ``tests/test_torch_resident.py``: every conv's packed bytes,
alpha and beta equal; each block fed the JAX engine's input to it within 1
int step on under 1% of its elements (the port's K2 rounds its requant
after the f32 epilogue, JAX's "xla" form folds it in first; the JAX "xla"
downsample leg is int16), the last block's f32 output within 1e-3, the
logits within LOGIT_ATOL = 0.25. On int4 engines ``fuse_resident_blocks``
fuses 0 on both sides.
"""

import copy

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from __graft_entry__ import _calibrated_model as j_calibrated_model
from quantized_tpu.engine import fused as jfused
from quantized_tpu.engine import int8_resident as jres
from quantized_tpu_torch.engine import IntExecutor
from quantized_tpu_torch.engine import fused as tfused
from quantized_tpu_torch.engine import int8_resident as tres
from quantized_tpu_torch.entry import _calibrated_model as t_calibrated_model
from quantized_tpu_torch.ingest import load_jax_arrays

MAX_STEP = 1
MAX_DIFF_SHARE = 0.01
LOGIT_ATOL = 0.25
# name: (config, input side, block convs)
ENGINES = {
    "cifar20": (dict(dataset="cifar10", depth=20), 32, 20),
    "resnet50": (dict(dataset="imagenet", depth=50), 64, 52),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype == np.float32
    return a.view(np.int32)


def build_engines(key: str) -> dict:
    cfg, side, _ = ENGINES[key]
    jq = j_calibrated_model("resnet_quantized_float_bn", **cfg)
    tq = t_calibrated_model("resnet_quantized_float_bn", device="cpu", generator=torch.Generator().manual_seed(1),
                            **cfg)
    load_jax_arrays(tq, {
        ".".join(map(str, k)): np.asarray(v.get_value())
        for k, v in nnx.to_flat_state(nnx.state(jq))
        if isinstance(v, (nnx.Param, nnx.BatchStat))
    })
    jeng = jres.build_int8_resident(jq, weight_bits=4, backend="xla")
    teng = tres.build_int8_resident(tq, weight_bits=4, backend="pallas", device="cpu")
    u8 = np.random.default_rng(0).integers(0, 256, (2, side, side, 3), dtype=np.uint8)
    return dict(key=key, jeng=jeng, teng=teng, u8=u8)


def _conv_pairs(jeng, teng):
    """(name, JAX conv, port conv) of every block conv of the two engines, in
    execution order (the stems apart: the JAX ImageNet stem is
    space-to-depth like the port's, built from the same unpacked weights)."""
    pairs = []
    for i in range(1, teng.num_stages + 1):
        jstage, tstage = getattr(jeng, f"layer{i}"), getattr(teng, f"layer{i}")
        for b in range(tstage.num_blocks):
            jb, tb = getattr(jstage, str(b)), getattr(tstage, str(b))
            for cn in ("conv1", "conv2", "conv3", "downsample"):
                if getattr(tb, cn, None) is not None:
                    pairs.append((f"layer{i}.{b}.{cn}", getattr(jb, cn), getattr(tb, cn)))
    return pairs


def check_weights_equal_jax(engines):
    """Every block conv packs (its Cin is even), with JAX's bytes, alpha and
    beta; the stem (Cin = 3) and the fc stay int8 storage on the int4 grid
    on both sides."""
    jeng, teng = engines["jeng"], engines["teng"]
    packed = 0
    for name, jc, tc in _conv_pairs(jeng, teng):
        assert tc.int4_shape == (None if jc.int4_shape is None else tuple(jc.int4_shape)), name
        for k in ("alpha", "beta"):
            np.testing.assert_array_equal(_bits(getattr(tc, k).numpy()), _bits(getattr(jc, k).get_value()), name)
        w_j = np.asarray(jc.w_q.get_value())
        if tc.int4_shape is None:
            np.testing.assert_array_equal(tc.weights().numpy(), w_j, name)
        else:
            kh, kw, cin, cout = tc.int4_shape
            np.testing.assert_array_equal(tc.w_int4.reshape(cout, kh, kw, cin // 2).permute(1, 2, 3, 0).numpy(),
                                          w_j, name)
            packed += 1
        assert np.abs(tc.weights().numpy()).max() <= 7, name
    assert packed == ENGINES[engines["key"]][2]
    assert not teng.fc.int4 and not jeng.fc.int4 and np.abs(teng.fc.w_q.numpy()).max() <= 7
    np.testing.assert_array_equal(teng.fc.w_q.numpy(), np.asarray(jeng.fc.w_q.get_value()))


def check_fuse_nothing(engines):
    counts = (jfused.fuse_resident_blocks(copy.deepcopy(engines["jeng"])),
              tfused.fuse_resident_blocks(copy.deepcopy(engines["teng"])))
    assert counts == (0, 0)


def _assert_within_one_step(got: torch.Tensor, want, what: str):
    want = np.asarray(want)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape, what
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_STEP, f"{what}: max diff {diff.max()}"
    assert (diff > 0).mean() < MAX_DIFF_SHARE, f"{what}: {(diff > 0).mean():.4f} of elements differ"


def check_engine_matches_jax(engines):
    """Each block fed the JAX engine's input to it, then the logits end to
    end."""
    jeng, teng, u8 = engines["jeng"], engines["teng"], engines["u8"]
    with torch.inference_mode():
        x_j = jres.u8_to_stored(jnp.asarray(u8), jeng.stem.grid)
        h = jeng.stem.run_q(x_j, relu=True, out_requant=jeng.stem_out_grid)
        _assert_within_one_step(teng.stem.run_q(_t(x_j), relu=True, out_requant=teng.stem_out_grid), h, "stem")
        if jeng.imagenet_pool:
            h = jres.maxpool_3x3_s2_int8(h)
        for i in range(1, jeng.num_stages + 1):
            jstage, tstage = getattr(jeng, f"layer{i}"), getattr(teng, f"layer{i}")
            for k in range(jstage.num_blocks):
                h_next = getattr(jstage, str(k))(h)
                got = getattr(tstage, str(k))(_t(h))
                if got.dtype == torch.float32:  # the last block emits f32 for the pool and fc
                    np.testing.assert_allclose(got.numpy(), np.asarray(h_next), atol=1e-3, rtol=0)
                else:
                    _assert_within_one_step(got, h_next, f"layer{i}.{k}")
                h = h_next
        want = np.asarray(jeng.fc(jnp.mean(h, axis=(1, 2))))  # the chain above is the JAX engine's run_u8
    got = IntExecutor(teng, ingest="u8", device="cpu")(u8).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
