"""The port's data layer and meters against the JAX package's, on the CPU.

The port keeps the JAX package's numpy code for the synthetic stand-in
(crc32-seeded), the local loaders, the transforms and the native pipeline's
binding, so every output here is held bit for bit: ``_synthetic`` and
``get_dataset`` (stand-in and planted local files), ``get_transform`` for
evaluation and for seeded augmentation, the batches of a dataset, and the
port's build of ``native/dataload.cpp`` against the JAX package's on the
same images (where g++ builds it). Then the meters (``accuracy`` ranks as
the JAX package's numpy ``argsort`` does, ties included) and ``ResultsLog``
round trips (CSV, JSONL, HTML) without pandas.
"""

import csv
import json
import os
import pickle

import numpy as np
import pytest
import torch

from quantized_tpu.data import datasets as jdatasets
from quantized_tpu.data import get_transform as j_get_transform
from quantized_tpu.data import native as jnative
from quantized_tpu.utils import accuracy as j_accuracy
from quantized_tpu_torch.data import datasets as tdatasets
from quantized_tpu_torch.data import get_dataset, get_transform
from quantized_tpu_torch.data import native as tnative
from quantized_tpu_torch.utils import AverageMeter, ResultsLog, accuracy


@pytest.mark.parametrize("name,split", [("cifar10", "val"), ("cifar10", "train"), ("cifar100", "val"),
                                        ("mnist", "val"), ("synthetic", "train")])
def test_synthetic_stand_in_is_bit_equal(name, split):
    got = tdatasets._synthetic(name, split, None)
    want = jdatasets._synthetic(name, split, None)
    assert got.synthetic and got.name == want.name
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)


def test_get_dataset_falls_back_and_refuses_like_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(tdatasets, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jdatasets, "DATA_DIR", str(tmp_path))
    tf = get_transform("cifar10")
    got = get_dataset("cifar10", "val", tf)
    want = jdatasets.get_dataset("cifar10", "val", j_get_transform("cifar10"))
    np.testing.assert_array_equal(got.images, want.images)
    img, label = got[0]
    np.testing.assert_array_equal(img, want[0][0])
    assert img.dtype == np.float32 and label == want[0][1]
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset("nope")
    with pytest.raises(FileNotFoundError):
        get_dataset("imagenet", allow_synthetic=False)


def test_local_cifar_and_mnist_files_load_like_jax(tmp_path, monkeypatch):
    """Planted CIFAR-10 pickles and MNIST idx files (torchvision's layouts)
    load as the same arrays in both packages, flagged not synthetic."""
    rng = np.random.default_rng(0)
    cdir = tmp_path / "cifar-10-batches-py"
    cdir.mkdir()
    for i in range(1, 6):
        with open(cdir / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 4).tolist()}, f)
    with open(cdir / "test_batch", "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                     b"labels": rng.integers(0, 10, 4).tolist()}, f)
    mdir = tmp_path / "MNIST" / "raw"
    mdir.mkdir(parents=True)
    (mdir / "train-images-idx3-ubyte").write_bytes(b"\x00" * 16 + rng.integers(0, 256, 6 * 784, dtype=np.uint8)
                                                   .tobytes())
    (mdir / "train-labels-idx1-ubyte").write_bytes(b"\x00" * 8 + bytes(range(6)))
    monkeypatch.setattr(tdatasets, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jdatasets, "DATA_DIR", str(tmp_path))
    for name in ("cifar10", "mnist"):
        got, want = get_dataset(name, "train"), jdatasets.get_dataset(name, "train")
        assert not got.synthetic and len(got) == len(want) > 0
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("name,size,augment", [
    ("imagenet", None, False), ("imagenet", 32, False), ("cifar10", None, False), ("mnist", None, False),
    ("cifar10", None, True), ("imagenet", 48, True), ("imagenet_inception", 48, True),
    ("imagenet_inception_color", 48, True),
])
def test_transforms_are_bit_equal(name, size, augment):
    """Evaluation (resize, crop, normalize) and seeded augmentation (padded
    random crop, flip, random-sized crop, color jitter, PCA lighting) give
    the same bytes as the JAX package's on the same generator seed."""
    rng = np.random.default_rng(3)
    shape = (28, 28) if name == "mnist" else (70, 90, 3) if name.startswith("imagenet") else (32, 32, 3)
    imgs = rng.integers(0, 256, (4, *shape), dtype=np.uint8)
    tf, jtf = get_transform(name, size, augment=augment), j_get_transform(name, size, augment=augment)
    for i, img in enumerate(imgs):
        got = tf(img, np.random.default_rng(100 + i))
        want = jtf(img, np.random.default_rng(100 + i))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_batches_match_jax_and_are_seeded():
    """``ArrayDataset.batches`` on the numpy path and, where it builds, the
    native one: the same batches as the JAX package's, shuffled by seed."""
    tf = get_transform("cifar10")
    ds = get_dataset("synthetic", "val", tf)
    jds = jdatasets.get_dataset("synthetic", "val", j_get_transform("cifar10"))
    natives = [False] + ([True] if tnative.available() and jnative.available() else [])
    for native in natives:
        got = list(ds.batches(64, shuffle=True, seed=1, drop_remainder=True, native=native))
        want = list(jds.batches(64, shuffle=True, seed=1, drop_remainder=True, native=native))
        assert len(got) == len(want) == 8 and all(x.shape == (64, 32, 32, 3) for x, _ in got)
        for (x, y), (jx, jy) in zip(got, want):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


@pytest.fixture(scope="module")
def native_libs():
    if not (tnative.available() and jnative.available()):
        pytest.skip("g++ could not build native/dataload.cpp here")
    return tnative, jnative


@pytest.mark.parametrize("name,size,scale,augment", [
    ("imagenet", 32, 48, False), ("cifar10", None, None, False), ("cifar10", None, None, True),
])
def test_native_pipeline_matches_jax_build(native_libs, name, size, scale, augment):
    """The port's own build of ``native/dataload.cpp`` (into
    ``quantized_tpu_torch/_build``) against the JAX package's build, on the
    same images, seed and thread count: bit-equal, eval and CIFAR train;
    the varied-shape entry too."""
    rng = np.random.default_rng(4)
    shape = (75, 100, 3) if name == "imagenet" else (32, 32, 3)
    imgs = rng.integers(0, 256, (8, *shape), dtype=np.uint8)
    tf = get_transform(name, size, scale, augment=augment)
    jtf = j_get_transform(name, size, scale, augment=augment)
    got = tnative.NativePipeline(tf, threads=2, seed=7)(imgs)
    want = jnative.NativePipeline(jtf, threads=2, seed=7)(imgs)
    np.testing.assert_array_equal(got, want)
    assert str(tnative._library_path()).startswith(str(tnative.BUILD_DIR))
    if not augment:
        varied = [imgs[0], imgs[1][:30, :20], imgs[2][:20, :30]]
        np.testing.assert_array_equal(tnative.NativePipeline(tf, threads=2).process_varied(varied),
                                      jnative.NativePipeline(jtf, threads=2).process_varied(varied))


def test_meters_and_accuracy_match_jax():
    m = AverageMeter()
    m.update(1.0, 2)
    m.update(2.0, 2)
    assert m.avg == 1.5 and m.count == 4 and m.val == 2.0
    rng = np.random.default_rng(5)
    logits = rng.integers(0, 4, (64, 10)).astype(np.float32)  # many ties
    target = rng.integers(0, 10, 64)
    want = j_accuracy(logits, target, topk=(1, 5))
    assert accuracy(torch.from_numpy(logits), torch.from_numpy(target), topk=(1, 5)) == want
    assert accuracy(logits, target, topk=(1, 5)) == want


def test_results_log_roundtrip(tmp_path):
    rl = ResultsLog(os.path.join(tmp_path, "res.csv"))
    rl.plot("epoch", ["loss"], title="loss")
    rl.add(epoch=0, loss=1.0)
    rl.add(epoch=1, loss=0.5, top1=np.float32(12.5))
    rl.save("t")
    assert os.path.exists(rl.plot_path)
    with open(rl.path) as f:
        rows = list(csv.DictReader(f))
    assert [float(r["loss"]) for r in rows] == [1.0, 0.5]
    assert rows[0]["top1"] == "" and float(rows[1]["top1"]) == 12.5
    with open(rl.jsonl_path) as f:
        lines = [json.loads(line) for line in f]
    assert [d["epoch"] for d in lines] == [0, 1] and lines[1]["top1"] == 12.5
    with open(rl.plot_path) as f:
        page = f.read()
    assert "<table" in page and "0.5" in page
