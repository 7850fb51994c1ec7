"""The port's autotuner (``engine/autotune.py``), the forms it races beside
the conv backends (the stems, the maxpool), the float ResNet that a
throughput ratio divides by, and ``engine/bench_hook.model_throughput``, on
the CPU.

Against the JAX package: the cache's signatures of the same engines are the
same strings (a CIFAR ResNet-20 and an ImageNet ResNet-18, JAX parameters
drawn from a seed, ``tests/torch_jax_twins.py``); the stem forms equal JAX's
(integer forms) or lie within 1 step on under 1% of the outputs (bf16); the
float ResNet's state keys equal JAX's both ways and its forward is within
1e-4 of JAX's. The tuner itself runs on the port's CPU engines: the cache
round trip, the frozen policy with the race switched off, the winners under
patched timers, and one real tune whose logits stay within 0.35 of the
untuned engine's (``tests/test_autotune_bf16.py:47``).
"""

import copy
import hashlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import quantized_tpu_torch.engine.autotune as at
from quantized_tpu.engine import autotune as jat
from quantized_tpu.engine import int8_resident as jres
from quantized_tpu.engine.fused import fusable as j_fusable
from quantized_tpu_torch.engine import (
    FusedInt8BasicBlock,
    FusedInt8BasicBlockDS,
    FusedInt8DwPw,
    apply_cached_backends,
    autotune_resident,
    build_int8_mobilenet,
    fusable,
    model_throughput,
)
from quantized_tpu_torch.engine import int8_resident as tres
from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear
from quantized_tpu_torch.entry import _calibrated_model as t_calibrated_model
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import get_model as t_get_model
from torch_jax_twins import flat_state, jax_model

ROOT = Path(__file__).resolve().parent.parent
BF16_ATOL = 0.35


def _t(a):
    return torch.from_numpy(np.array(a))


def _u8(side, n=2, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, side, side, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def cifar_model():
    return t_calibrated_model("resnet_quantized_float_bn", device="cpu", dataset="cifar10", depth=20)


def _engine(model, **kw):
    return tres.build_int8_resident(model, device="cpu", **kw)


def _mobilenet():
    model = t_calibrated_model("mobilenet_quantized", device="cpu", width_mult=0.25, num_classes=10)
    model.train()  # two observer-update passes: a random-init MobileNet's activations vanish on [-4, 4]
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for _ in range(2):
            model(torch.randn((2, 32, 32, 3), generator=gen))
    return build_int8_mobilenet(model.eval(), device="cpu")


# ----------------------------------------------------------------- the cache's keys against JAX's


@pytest.mark.parametrize("dataset,depth,side", [("cifar10", 20, 32), ("imagenet", 18, 64)])
def test_signatures_equal_jax(dataset, depth, side):
    """The same engine on both sides records the same conv, fc, block and
    stem signatures (the space-to-depth stem's own convs are the stem race's
    on both sides), so one cache's keys mean one shape on either."""
    jq = jax_model("resnet_quantized_float_bn", dataset=dataset, depth=depth)
    tq = t_calibrated_model("resnet_quantized_float_bn", device="cpu", dataset=dataset, depth=depth)
    load_jax_arrays(tq, flat_state(jq))
    jeng, teng = jres.build_int8_resident(jq), _engine(tq)
    x = np.random.default_rng(0).standard_normal((2, side, side, 3)).astype(np.float32)
    jat._record_shapes(jeng, jnp.asarray(x))
    at._record_shapes(teng, _t(x))
    jconvs = [jat._sig_key(jat.conv_signature(m)) for _, m in nnx.iter_modules(jeng)
              if isinstance(m, jat.IntConv2d) and hasattr(m, "last_input_shape")]
    assert sorted(jconvs) == sorted(at._sig_key(at.conv_signature(m)) for m in at._tunable_convs(teng))
    jfc = [jat._fc_signature(m) for _, m in nnx.iter_modules(jeng) if isinstance(m, jat.IntLinear)]
    assert jfc == [at._fc_signature(m) for m in teng.modules() if isinstance(m, IntLinear)]
    jblocks = [jat._block_signature(b) for _, _, b in at._blocks(jeng) if j_fusable(b)]
    assert jblocks == [at._block_signature(b) for _, _, b in at._blocks(teng) if fusable(b)] and jblocks
    if dataset == "imagenet":
        assert at._stem_key(teng.stem, _t(x)) == f"stem:{json.dumps([2, side, side, 3])}"


# ----------------------------------------------------------------- the tuner


def test_apply_cached_backends_roundtrip(cifar_model, tmp_path):
    """A fabricated cache (convs on bf16, the fc on a TPU block form, every
    fusable block fused), keyed "cpu", applied to a fresh engine: every conv
    on bf16, the fc form taken, every block fused."""
    x = _u8(32)
    model = _engine(cifar_model)
    at._record_shapes(model, x)
    table = {at._sig_key(at.conv_signature(m)): "bf16" for m in at._tunable_convs(model)}
    table[at._fc_signature(model.fc)] = "pallas:128,256,512"
    sigs = [at._block_signature(b) for _, _, b in at._blocks(model) if fusable(b)]
    assert sigs, "CIFAR resnet20 should have fusable blocks"
    table.update({sig: "fused" for sig in sigs})  # several blocks share a signature
    cache = tmp_path / "autotune.json"
    cache.write_text(json.dumps({"cpu": table}))

    fresh = _engine(cifar_model)
    assert apply_cached_backends(fresh, x, cache_path=str(cache))
    assert {m.backend for m in fresh.modules() if isinstance(m, IntConv2d)} == {"bf16"}
    assert fresh.fc.backend == "pallas:128,256,512"
    fused = [m for m in fresh.modules() if isinstance(m, (FusedInt8BasicBlock, FusedInt8BasicBlockDS))]
    assert len(fused) == len(sigs)
    assert fresh.run_u8(x).shape == (2, 10)
    assert not apply_cached_backends(_engine(cifar_model), x, cache_path=str(tmp_path / "none.json"))


def test_frozen_policy_with_the_switch_off(cifar_model, monkeypatch):
    """With the fused race switched off (``tune_fused=False``, or on the CPU
    with QTPU_TUNE_FUSED unset) unseen blocks and pairs are recorded
    "unfused" untimed; switched on (the argument, or QTPU_TUNE_FUSED=1) they
    are timed."""
    monkeypatch.delenv("QTPU_TUNE_FUSED", raising=False)
    timed = []
    monkeypatch.setattr(at, "_time_block", lambda *a, **k: timed.append(a) or 1.0)
    x = _u8(32)
    for switch in (False, None):
        model = _engine(cifar_model)
        at._record_shapes(model, x)
        table = {}
        assert at._tune_blocks(model, table, verbose=False, tune_fused=switch) > 0
        assert not timed and set(table.values()) == {"unfused"}
        assert all(k.startswith("block:") for k in table)
    mob = _mobilenet()
    at._record_shapes(mob, x)
    table = {}
    assert at._tune_mobilenet_pairs(mob, table, verbose=False, tune_fused=False) > 0
    assert not timed and set(table.values()) == {"unfused"} and all(k.startswith("dwpw:") for k in table)
    assert not any(isinstance(m, FusedInt8DwPw) for m in mob.modules())

    model = _engine(cifar_model)
    at._record_shapes(model, x)
    at._tune_blocks(model, {}, verbose=False, tune_fused=True)
    assert timed, "tune_fused=True must measure"
    timed.clear()
    monkeypatch.setenv("QTPU_TUNE_FUSED", "1")
    model = _engine(cifar_model)
    at._record_shapes(model, x)
    at._tune_blocks(model, {}, verbose=False)
    assert timed, "QTPU_TUNE_FUSED=1 must measure"


def test_race_switches(monkeypatch):
    """An argument decides; else the variable where it is set; else on for a
    CUDA device, off on the CPU."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv("QTPU_TUNE_EXTENDED", raising=False)
    assert at._switch(None, "QTPU_TUNE_EXTENDED", cuda) and not at._switch(None, "QTPU_TUNE_EXTENDED", cpu)
    monkeypatch.setenv("QTPU_TUNE_EXTENDED", "0")
    assert not at._switch(None, "QTPU_TUNE_EXTENDED", cuda) and at._switch(True, "QTPU_TUNE_EXTENDED", cuda)
    monkeypatch.setenv("QTPU_TUNE_EXTENDED", "1")
    assert at._switch(None, "QTPU_TUNE_EXTENDED", cpu) and not at._switch(False, "QTPU_TUNE_EXTENDED", cpu)


def test_candidates():
    """The default race set; a grouped conv races its exact grouped path as
    "xla" in place of "pallas" and "gemm"; packed int4 layers add the
    native-S4 forms."""
    mob = _mobilenet()
    dense, depthwise = mob.conv0, mob.conv1
    assert at._conv_candidates(dense, at.DEFAULT_BACKENDS) == ["pallas", "gemm", "bf16", "bf16-split"]
    assert depthwise.groups > 1
    assert at._conv_candidates(depthwise, at.DEFAULT_BACKENDS) == ["xla", "bf16", "bf16-split"]
    int4 = tres.build_int8_resident(t_calibrated_model("resnet_quantized_float_bn", device="cpu", dataset="cifar10",
                                                       depth=20), weight_bits=4, device="cpu")
    packed = next(m for m in int4.modules() if isinstance(m, IntConv2d) and m.int4_shape is not None)
    assert at._conv_candidates(packed, ("xla", "bf16")) == ["xla", "bf16", "s4", "s4-split"]
    assert at.STEM_BACKENDS == ("pallas", "gemm", "bf16", "raw-pallas", "raw-bf16-split")
    assert at.FC_BACKENDS == ("xla", "pallas")


def test_winners_under_patched_timers(cifar_model, monkeypatch, tmp_path):
    """With every time patched: each conv takes its fastest candidate (gemm
    for 1x1s, bf16-split for 3x3s), each identity block fuses and each
    downsample block stays unfused, the fc takes "xla"; the verdicts reach
    the cache, and a second tune reads them without timing anything."""
    def conv_time(conv, backend, requant=None):
        fast = "gemm" if conv.kernel_size == (1, 1) else "bf16-split"
        return 1.0 if backend == fast else 2.0

    monkeypatch.setattr(at, "_time_backend", conv_time)
    monkeypatch.setattr(at, "_time_block", lambda mod, shape: 1.0 if isinstance(mod, FusedInt8BasicBlock) else 2.0)
    monkeypatch.setattr(at, "_time_fc_backend", lambda lin, b: 1.0 if b == "xla" else 2.0)
    cache = tmp_path / "autotune.json"
    x = _u8(32)
    model = _engine(cifar_model)
    table = autotune_resident(model, x, cache_path=str(cache), verbose=False, tune_extended=True, tune_fused=True)
    for m in model.modules():
        if isinstance(m, IntConv2d):
            assert m.backend == ("gemm" if m.kernel_size == (1, 1) else "bf16-split")
    kinds = [type(b).__name__ for _, _, b in at._blocks(model)]
    assert kinds.count("FusedInt8BasicBlock") == 6 and "FusedInt8BasicBlockDS" not in kinds
    assert model.fc.backend == "xla"
    assert json.loads(cache.read_text()) == {"cpu": table}

    def refuse(*a, **k):
        raise AssertionError("a cached verdict was timed again")

    for name in ("_time_backend", "_time_block", "_time_fc_backend"):
        monkeypatch.setattr(at, name, refuse)
    again = _engine(cifar_model)
    assert autotune_resident(again, x, cache_path=str(cache), verbose=False, tune_extended=True) == table
    assert [type(b).__name__ for _, _, b in at._blocks(again)] == kinds


def test_real_tune_on_the_cpu(capsys):
    """ResNet-18 at 64x64 with every race timed on the CPU (conv backends,
    maxpool, stem, fc, blocks), nothing cached: a printed line per race, the
    stem and pool forms pinned, and the tuned logits within 0.35 of the
    untuned engine's."""
    model = t_calibrated_model("resnet_quantized_float_bn", device="cpu", dataset="imagenet", depth=18)
    x = _u8(64)
    untuned = _engine(model)
    tuned = copy.deepcopy(untuned)
    table = autotune_resident(tuned, x, cache_path=None, tune_extended=True, tune_fused=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("autotune ")]
    assert len(lines) == len(table)
    assert {k.split(":")[0] for k in table if not k.startswith("[")} == {"maxpool", "stem", "fc", "block"}
    assert tuned.stem.backend == table[f"stem:{json.dumps([2, 64, 64, 3])}"]
    assert tres._POOL_IMPL_TABLE[(2, 32, 32, 64)] == table[f"maxpool:{json.dumps([2, 32, 32, 64])}"]
    with torch.inference_mode():
        np.testing.assert_allclose(tuned.run_u8(x).numpy(), untuned.run_u8(x).numpy(), atol=BF16_ATOL, rtol=0)


def test_the_tpu_table_is_never_written(tmp_path):
    """The default cache is the port's own file; the root autotune_cache.json
    (the JAX package's TPU table) is refused, and stays as it was."""
    assert Path(at.DEFAULT_CACHE) == ROOT / "quantized_tpu_torch" / "autotune_cache.json"
    tpu = ROOT / "autotune_cache.json"
    before = hashlib.sha256(tpu.read_bytes()).hexdigest()
    with pytest.raises(ValueError, match="TPU table"):
        at._save({"cpu": {}}, str(tpu))
    assert hashlib.sha256(tpu.read_bytes()).hexdigest() == before
    at._save({"cpu": {"a": "b"}}, str(tmp_path / "c.json"))
    assert json.loads((tmp_path / "c.json").read_text()) == {"cpu": {"a": "b"}}


def test_model_throughput(cifar_model):
    """Images per second of a uint8 batch through ``run_u8`` and of an f32
    batch through ``forward``."""
    engine = _engine(cifar_model)
    for x in (_u8(32), torch.randn(2, 32, 32, 3)):
        ips = model_throughput(engine, x, target_secs=0.01, reps=1, probe_loops=1)
        assert 0 < ips < float("inf")


# ----------------------------------------------------------------- the forms the tuner races


@pytest.fixture(scope="module")
def stems():
    """ResNet-18's stem on both sides (JAX "xla"; the port's space-to-depth
    and raw stems) and the stored input of two 64x64 images."""
    jq = jax_model("resnet_quantized_float_bn", dataset="imagenet", depth=18)
    tq = t_calibrated_model("resnet_quantized_float_bn", device="cpu", dataset="imagenet", depth=18)
    load_jax_arrays(tq, flat_state(jq))
    jeng = jres.build_int8_resident(jq, backend="xla")
    teng = _engine(tq, backend="xla")
    raw = _engine(tq, backend="xla", space_to_depth=False)
    return jeng, teng, raw, jres.u8_to_stored(jnp.asarray(_u8(64, seed=2).numpy()), jeng.stem.grid)


@pytest.mark.parametrize("backend", ["xla", "xla-split", "raw-xla-split", "raw-xla", "pallas", "gemm", "bf16",
                                     "raw-bf16-split"])
def test_stem_forms(stems, backend):
    """The space-to-depth stem and the raw 7x7 stem (``space_to_depth=False``)
    on each backend: the integer forms equal each other and JAX's s8 stem
    (the same taps, the same epilogue; "pallas" and "gemm" round the requant
    in K2's and K1's order, within 1 step); the bf16 forms within 1 step of
    it on under 5% of the outputs, and of JAX's same form."""
    jeng, teng, raw, x_j = stems
    want = np.asarray(jeng.stem.run_q(x_j, relu=True, out_requant=jeng.stem_out_grid))  # JAX's s8 "xla"
    assert isinstance(teng.stem, tres.Int8SpaceToDepthStem) and isinstance(raw.stem, IntConv2d)
    stem = copy.deepcopy(teng.stem)
    with torch.inference_mode():
        np.testing.assert_array_equal(raw.stem.run_q(_t(x_j), relu=True, out_requant=raw.stem_out_grid).numpy(),
                                      want)
        stem.set_backend(backend)
        got = stem.run_q(_t(x_j), relu=True, out_requant=teng.stem_out_grid).numpy()
    assert stem.backend == backend
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if backend.startswith(("xla", "raw-xla")):
        np.testing.assert_array_equal(got, want)
    else:
        assert diff.max() <= 1 and (diff > 0).mean() < (0.05 if "bf16" in backend else 0.01)
    if backend in ("xla-split", "raw-xla-split", "bf16", "raw-bf16-split"):  # JAX's own stem forms
        jstem = copy.deepcopy(jeng.stem)
        jstem.set_backend(backend)
        jgot = np.asarray(jstem.run_q(x_j, relu=True, out_requant=jeng.stem_out_grid))
        jdiff = np.abs(got.astype(np.int32) - jgot.astype(np.int32))
        assert jdiff.max() <= (1 if "bf16" in backend else 0) and (jdiff > 0).mean() < 0.01


@pytest.mark.parametrize("shape", [(2, 32, 32, 64), (3, 16, 10, 8), (1, 7, 9, 4)])
def test_maxpool_forms_equal(rng, shape):
    """"rw" equals "interleave" (even sides) and JAX's "rw" (any side); the
    table picks a shape's form."""
    x = rng.integers(-128, 128, shape).astype(np.int8)
    got = tres.maxpool_3x3_s2_int8(_t(x), "rw").numpy()
    np.testing.assert_array_equal(got, np.asarray(jres.maxpool_3x3_s2_int8(jnp.asarray(x), "rw")))
    if shape[1] % 2 == 0 and shape[2] % 2 == 0:
        np.testing.assert_array_equal(tres.maxpool_3x3_s2_int8(_t(x), "interleave").numpy(), got)
        tres._POOL_IMPL_TABLE[shape] = "interleave"
        try:
            np.testing.assert_array_equal(tres.maxpool_3x3_s2_int8(_t(x)).numpy(), got)
        finally:
            del tres._POOL_IMPL_TABLE[shape]


@pytest.mark.parametrize("dataset,depth", [("imagenet", 50), ("cifar10", 20)])
def test_float_resnet_bridged_from_jax(rng, dataset, depth):
    """The float ResNet (``get_model("resnet")``): its state keys equal the
    JAX model's both ways; with the JAX state (BN statistics drawn from a
    seed) its eval forward is within f32 tolerance of JAX's (jitted: f32
    either way)."""
    jm = jax_model("resnet", dataset=dataset, depth=depth)
    for path, m in nnx.iter_modules(jm):
        if isinstance(m, nnx.BatchNorm):
            c = m.mean.get_value().shape[0]
            m.mean.set_value(jnp.asarray(rng.normal(0, 0.1, c), jnp.float32))
            m.var.set_value(jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32))
            m.scale.set_value(jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32))
            m.bias.set_value(jnp.asarray(rng.normal(0, 0.1, c), jnp.float32))
    flat = flat_state(jm)
    tm = t_get_model("resnet")(dataset=dataset, depth=depth)
    assert set(flat) == set(tm.state_dict())
    load_jax_arrays(tm, flat)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.inference_mode():
        got = tm.eval()(_t(x)).numpy()
    want = np.asarray(nnx.jit(lambda model, v: model(v))(jm, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 1000 if dataset == "imagenet" else 10)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


