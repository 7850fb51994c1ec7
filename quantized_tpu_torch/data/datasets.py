"""Dataset registry of the port (counterpart of
``quantized_tpu/data/datasets.py``, the same numpy code, so the synthetic
stand-in is the same bytes in both packages).

``get_dataset(name, split, transform)`` follows the reference's registry.
Nothing is downloaded: each dataset resolves in order to (1) local files
under ``QTPU_DATA_DIR`` (CIFAR python pickles, MNIST idx, STL-10 binaries,
ImageFolder trees), then (2) a deterministic synthetic stand-in of the right
geometry, flagged by ``.synthetic``, so evaluation and serving run anywhere.
``synthetic`` is also a name of its own.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import zlib
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

# a local file that cannot be parsed leaves the registry to the next source
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, pickle.UnpicklingError)

DATA_DIR = os.environ.get("QTPU_DATA_DIR", os.path.expanduser("~/Datasets"))

_GEOMETRY = {
    "cifar10": (32, 32, 3, 10),
    "cifar100": (32, 32, 3, 100),
    "mnist": (28, 28, 1, 10),
    "stl10": (96, 96, 3, 10),
    "imagenet": (256, 256, 3, 1000),
    "synthetic": (32, 32, 3, 10),
}


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset: uint8 images (N,H,W,C) + int labels (N,)."""

    images: np.ndarray
    labels: np.ndarray
    transform: Optional[Callable] = None
    synthetic: bool = False
    name: str = "dataset"

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        img = self._image(i)
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self.labels[i])

    def _image(self, i: int) -> np.ndarray:
        """Sample ``i``'s stored uint8 image."""
        return self.images[i]

    def _sample(self, i: int, seed: int) -> np.ndarray:
        """Sample ``i`` through the transform; a random augmentation draws
        from a generator seeded by (``seed``, ``i``), so every process that
        batches the same epoch draws alike (the native pipeline seeds its
        draws by the epoch's seed too)."""
        img = self._image(i)
        if self.transform is None:
            return img
        if getattr(self.transform, "augment", False):
            return self.transform(img, np.random.default_rng((seed, int(i))))
        return self.transform(img)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
        rng: Optional[np.random.Generator] = None,
        native: Optional[bool] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (images f32 NHWC, labels i32).

        ``native`` routes preprocessing through the C++ thread-pool pipeline
        (native/dataload.cpp — the framework's counterpart of the reference's
        native DataLoader workers). ``None`` auto-enables it
        when the library builds and the transform is supported; the numpy
        ``Transform`` path remains the PIL-parity route. Either way a random
        augmentation is a function of ``seed`` and the sample, so processes
        that batch alike (the ranks of a mesh) get the same batches."""
        idx = np.arange(len(self))
        if shuffle:
            (rng or np.random.default_rng(seed)).shuffle(idx)
        n = len(idx) - (len(idx) % batch_size if drop_remainder else 0)
        pipe = self._native_pipeline(seed) if native in (None, True) else None
        if native is True and pipe is None:
            raise RuntimeError("native pipeline requested but unavailable")
        for s in range(0, n, batch_size):
            sel = idx[s : s + batch_size]
            if pipe is not None:
                imgs = pipe(np.ascontiguousarray(self.images[sel]))
            else:
                imgs = np.stack([self._sample(i, seed) for i in sel])
            labels = self.labels[sel].astype(np.int32)
            yield imgs, labels

    def _native_pipeline(self, seed: int):
        """Build (and cache) a NativePipeline for this transform, or None."""
        tf = self.transform
        if tf is None or getattr(tf, "inception", False) or getattr(tf, "lighting_std", 0.0):
            return None
        if not isinstance(self.images, np.ndarray) or self.images.dtype != np.uint8:
            return None
        key = (id(tf), seed)
        if getattr(self, "_pipe_key", None) == key:
            return self._pipe
        from quantized_tpu_torch.data.native import NativePipeline, available

        if not available():
            return None
        self._pipe = NativePipeline(tf, seed=seed)
        self._pipe_key = key
        return self._pipe


def _synthetic(name: str, split: str, transform) -> ArrayDataset:
    h, w, c, classes = _GEOMETRY.get(name, _GEOMETRY["synthetic"])
    n = 1024 if split == "train" else 512
    # class-defining signatures must be identical across splits (seeded by
    # dataset name only); sample noise is per-split. Seeds come from crc32,
    # not hash(): str hashing is salted per process, which would make the
    # stand-in data differ between runs (breaks --deterministic).
    class_rng = np.random.default_rng(zlib.crc32(name.encode()))
    rng = np.random.default_rng(zlib.crc32(f"{name}/{split}".encode()))
    labels = rng.integers(0, classes, n)
    # class-dependent means + per-class spatial gradient so accuracy > chance
    # is genuinely learnable (verified: a depth-20 resnet generalizes on this)
    base = class_rng.uniform(80, 176, (classes, 1, 1, c))
    yy = np.linspace(-1, 1, h)[None, :, None, None]
    xx = np.linspace(-1, 1, w)[None, None, :, None]
    angle = 2 * np.pi * np.arange(classes) / classes

    def signature(lab: np.ndarray) -> np.ndarray:
        pattern = 24 * (
            np.cos(angle)[lab, None, None, None] * yy
            + np.sin(angle)[lab, None, None, None] * xx
        )
        return base[lab] + pattern
    sig = signature(labels)
    # ~12% of samples blend their class signature with a second class at a
    # mixing weight straddling 0.5 — the half that lean toward the OTHER
    # class are unrecoverable, pinning the Bayes val top-1 ceiling at ~94%
    # instead of a vacuous 100% (mode deltas stay measurable).
    # Deterministic per split like everything else here.
    n_amb = int(0.12 * n)
    other = (labels[:n_amb] + rng.integers(1, classes, n_amb)) % classes
    lam = rng.uniform(0.3, 0.7, (n_amb, 1, 1, 1))
    sig[:n_amb] = lam * sig[:n_amb] + (1.0 - lam) * signature(other)
    images = np.clip(sig + rng.normal(0, 16, (n, h, w, c)), 0, 255).astype(np.uint8)
    return ArrayDataset(images, labels, transform, synthetic=True, name=f"{name}-synthetic")


def _load_cifar(root: str, name: str, split: str, transform) -> Optional[ArrayDataset]:
    sub = "cifar-10-batches-py" if name == "cifar10" else "cifar-100-python"
    d = os.path.join(root, "CIFAR10" if name == "cifar10" else "CIFAR100", sub)
    if not os.path.isdir(d):
        d2 = os.path.join(root, sub)
        if not os.path.isdir(d2):
            return None
        d = d2
    try:
        files: List[str]
        if name == "cifar10":
            files = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
            key = b"labels"
        else:
            files = ["train"] if split == "train" else ["test"]
            key = b"fine_labels"
        xs, ys = [], []
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                batch = pickle.load(fh, encoding="bytes")
            xs.append(batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            ys.extend(batch[key])
        return ArrayDataset(np.concatenate(xs), np.asarray(ys), transform, name=name)
    except _UNREADABLE:
        return None


def _load_mnist(root: str, split: str, transform) -> Optional[ArrayDataset]:
    d = os.path.join(root, "MNIST", "raw")
    prefix = "train" if split == "train" else "t10k"
    imgs_p = os.path.join(d, f"{prefix}-images-idx3-ubyte")
    labels_p = os.path.join(d, f"{prefix}-labels-idx1-ubyte")
    if not (os.path.exists(imgs_p) and os.path.exists(labels_p)):
        return None
    with open(imgs_p, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8, offset=16)
    with open(labels_p, "rb") as f:
        labels = np.frombuffer(f.read(), np.uint8, offset=8)
    return ArrayDataset(data.reshape(-1, 28, 28, 1), labels.astype(np.int64), transform, name="mnist")


def _load_imagefolder(root: str, name: str, split: str, transform) -> Optional[ArrayDataset]:
    d = os.path.join(root, "ImageNet" if name == "imagenet" else name, "train" if split == "train" else "val")
    if not os.path.isdir(d):
        return None
    try:
        from PIL import Image
    except _UNREADABLE:
        return None
    classes = sorted(e for e in os.listdir(d) if os.path.isdir(os.path.join(d, e)))
    imgs, labels = [], []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(d, cls)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith((".jpeg", ".jpg", ".png")):
                imgs.append(os.path.join(cdir, fn))
                labels.append(ci)
    if not imgs:
        return None
    return _LazyImageFolder(imgs, np.asarray(labels), transform, name=name)


@dataclasses.dataclass
class _LazyImageFolder(ArrayDataset):
    def _image(self, i):
        from PIL import Image

        return np.asarray(Image.open(self.images[i]).convert("RGB"))


def _load_stl10(root: str, split: str, transform) -> Optional[ArrayDataset]:
    """STL-10 binary format (reference data.py registers torchvision STL10):
    uint8 CHW column-major images in {train,test}_X.bin + 1-based labels in
    {train,test}_y.bin under stl10_binary/."""
    d = os.path.join(root, "STL10", "stl10_binary")
    if not os.path.isdir(d):
        d2 = os.path.join(root, "stl10_binary")
        if not os.path.isdir(d2):
            return None
        d = d2
    try:
        tag = "train" if split == "train" else "test"
        with open(os.path.join(d, f"{tag}_X.bin"), "rb") as f:
            x = np.frombuffer(f.read(), np.uint8).reshape(-1, 3, 96, 96)
        # binary layout is column-major within each plane -> transpose H/W
        images = x.transpose(0, 3, 2, 1)  # N, H, W, C
        with open(os.path.join(d, f"{tag}_y.bin"), "rb") as f:
            labels = np.frombuffer(f.read(), np.uint8).astype(np.int64) - 1
        return ArrayDataset(np.ascontiguousarray(images), labels, transform, name="stl10")
    except _UNREADABLE:
        return None


def get_dataset(
    name: str,
    split: str = "train",
    transform: Optional[Callable] = None,
    download: bool = False,  # reference-API parity; nothing is downloaded
    allow_synthetic: bool = True,
) -> ArrayDataset:
    """Reference ``get_dataset(name, split, transform, ...)`` (data.py
    ~L20-60)."""
    name = name.lower()
    loaders = {
        "cifar10": lambda: _load_cifar(DATA_DIR, "cifar10", split, transform),
        "cifar100": lambda: _load_cifar(DATA_DIR, "cifar100", split, transform),
        "mnist": lambda: _load_mnist(DATA_DIR, split, transform),
        "imagenet": lambda: _load_imagefolder(DATA_DIR, "imagenet", split, transform),
        "stl10": lambda: _load_stl10(DATA_DIR, split, transform),
        "synthetic": lambda: None,
    }
    if name not in loaders:
        raise ValueError(f"unknown dataset {name!r}; available: {sorted(loaders)}")
    ds = loaders[name]()
    if ds is not None:
        return ds
    if not allow_synthetic:
        raise FileNotFoundError(f"dataset {name!r} not found under {DATA_DIR}")
    return _synthetic(name, split, transform)
