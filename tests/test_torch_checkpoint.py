"""Checkpoints of the port on the CPU: its native save and load (the
asynchronous save and ``save_all`` included), and reference ``.pth.tar``
files flowing both ways between the two packages.

JAX export -> port ingest and port export -> JAX ingest, for a float-BN
CIFAR ResNet-20, AlexNet-quantized (whose fc1 columns cross the reference's
NCHW flatten, so the permutation is exercised both ways) and a RangeBN
CIFAR ResNet-20 (RangeBN keeps the reference's names): every parameter and
statistic equal exactly, since the translation only moves and transposes
float32 values. A DataParallel ``module.`` prefix and the
``num_batches_tracked`` bookkeeping of a torch-authored file are dropped.
"""

import os

import numpy as np
import pytest
import torch

from quantized_tpu.ingest import load_into_model as j_load_into_model
from quantized_tpu.utils.checkpoint import export_reference_checkpoint as j_export
from quantized_tpu_torch.ingest import load_into_model, load_reference_checkpoint, state_dict_to_port
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.utils import (
    export_reference_checkpoint,
    load_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from torch_jax_twins import flat_state, jax_model

MODELS = {
    "resnet20": ("resnet_quantized_float_bn", dict(dataset="cifar10", depth=20)),
    "alexnet": ("alexnet_quantized", dict(num_classes=10)),
    "resnet20 rangebn": ("resnet_quantized", dict(dataset="cifar10", depth=20)),
}


def _port(key, seed=0):
    name, cfg = MODELS[key]
    return get_model(name)(generator=torch.Generator().manual_seed(seed), **cfg).eval()


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _assert_states_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("async_save", [False, True])
def test_native_roundtrip_with_best_and_save_all(tmp_path, async_save):
    src = _port("resnet20", seed=3)
    with torch.no_grad():  # statistics away from their init, so the copy shows
        for m in src.modules():
            if hasattr(m, "mean") and isinstance(m.mean, torch.Tensor):
                m.mean.normal_(generator=torch.Generator().manual_seed(1))
    saved = save_checkpoint(src, str(tmp_path), meta={"epoch": 7, "best_prec1": np.float32(12.5)}, is_best=True,
                            save_all=True, async_save=async_save)
    wait_for_checkpoints()
    for base in ("checkpoint", "model_best", "checkpoint_epoch_7"):
        assert os.path.exists(tmp_path / f"{base}.pt") and os.path.exists(tmp_path / f"{base}.meta.json")
    assert saved == str(tmp_path / "checkpoint.pt")
    for base in ("checkpoint", "model_best"):
        dst = _port("resnet20", seed=9)
        meta = load_checkpoint(dst, str(tmp_path), filename=base)
        assert meta == {"epoch": 7, "best_prec1": 12.5}
        _assert_states_equal(_state(dst), _state(src))
    dst = _port("resnet20", seed=9)
    load_checkpoint(dst, str(tmp_path / "checkpoint_epoch_7"))
    _assert_states_equal(_state(dst), _state(src))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(dst(x), src(x), rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(dst, str(tmp_path / "nothing"))


@pytest.mark.parametrize("key", list(MODELS))
def test_jax_export_is_ingested_by_the_port(tmp_path, key):
    name, cfg = MODELS[key]
    jm = jax_model(name, seed=1, **cfg)
    path = str(tmp_path / "ref.pth.tar")
    j_export(jm, path, {"model": name, "config": cfg})
    ckpt = load_reference_checkpoint(path)
    assert ckpt["meta"] == {"model": name, "config": cfg}
    if key == "alexnet":  # the reference layout: (out, C*H*W) columns in NCHW order
        assert ckpt["state_dict"]["fc1.weight"].shape == (4096, 256 * 6 * 6)
        assert not np.array_equal(ckpt["state_dict"]["fc1.weight"], flat_state(jm)["fc1.weight"])
    tm = load_into_model(_port(key), path)
    _assert_states_equal(_state(tm), flat_state(jm))


@pytest.mark.parametrize("key", list(MODELS))
def test_port_export_is_ingested_by_jax(tmp_path, key):
    tm = _port(key, seed=2)
    path = str(tmp_path / "ref.pth.tar")
    export_reference_checkpoint(tm, path, {"model": MODELS[key][0]})
    name, cfg = MODELS[key]
    jm = jax_model(name, seed=5, **cfg)
    j_load_into_model(jm, path)
    _assert_states_equal(flat_state(jm), _state(tm))
    # and back: the port reads its own export to the same state
    _assert_states_equal(_state(load_into_model(_port(key, seed=6), path)), _state(tm))


def test_dataparallel_prefix_and_bn_bookkeeping_are_dropped(tmp_path):
    tm = _port("resnet20", seed=4)
    path = str(tmp_path / "dp.pth.tar")
    export_reference_checkpoint(tm, path)
    payload = torch.load(path, weights_only=True)
    sd = {}
    for k, v in payload["state_dict"].items():
        sd["module." + k] = v
        if k.endswith("running_var"):
            sd["module." + k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(3)
    torch.save({"state_dict": sd, "epoch": 5, "best_prec1": 1.5}, path)
    ckpt = load_reference_checkpoint(path)
    assert not any(k.startswith("module.") for k in ckpt["state_dict"])
    assert ckpt["meta"] == {"epoch": 5, "best_prec1": 1.5}
    _assert_states_equal(_state(load_into_model(_port("resnet20", seed=8), path)), _state(tm))
    # a key with no home in the model, and a missing entry under strict
    with pytest.raises(KeyError, match="no home"):
        state_dict_to_port({"layer9.conv1.weight": np.zeros((1, 1, 1, 1), np.float32)}, tm)
    partial = {k: v for k, v in ckpt["state_dict"].items() if not k.startswith("fc.")}
    with pytest.raises(ValueError, match="missing"):
        load_into_model(_port("resnet20"), partial)
    load_into_model(_port("resnet20"), partial, strict=False)
