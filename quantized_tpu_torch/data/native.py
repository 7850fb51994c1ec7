"""ctypes binding of the repository's native C++ data pipeline
(``native/dataload.cpp``), the port's counterpart of
``quantized_tpu/data/native.py``.

The library is compiled with g++ on first use into
``quantized_tpu_torch/_build/`` (named by a digest of the source and the
flags, so an edited source is rebuilt and a current one reused). Where no
toolchain is present every entry point degrades to the numpy ``Transform``
path: this is host-side preprocessing, not a device path.

ctypes calls release the GIL, so the pool's resize/crop/normalize work
overlaps the evaluation or serving loop, the role torch's DataLoader worker
processes play in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parents[2] / "native" / "dataload.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# no -march=native: the library is built where it runs, and baseline x86-64
# with the integer fixed-point kernels is what the JAX package ships too
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


class _Loader:
    """The library, built and bound once per process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.tried = False


_LOADER = _Loader()


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"_dataload-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    if not _SRC.exists():
        logger.warning("native dataload source %s is missing; using the numpy path", _SRC)
        return None
    so = _library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True, capture_output=True, timeout=240)
    except (OSError, subprocess.SubprocessError) as e:  # no toolchain, or it refused the source
        os.unlink(tmp)
        logger.warning("native dataload build failed (%s); using the numpy path", e)
        return None
    os.replace(tmp, so)  # atomic: a concurrent build sees a whole library
    return so


def load_library() -> Optional[ctypes.CDLL]:
    with _LOADER.lock:
        if _LOADER.lib is not None or _LOADER.tried:
            return _LOADER.lib
        _LOADER.tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.qtpu_pipeline_create.restype = ctypes.c_void_p
        lib.qtpu_pipeline_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.qtpu_pipeline_destroy.restype = None
        lib.qtpu_pipeline_destroy.argtypes = [ctypes.c_void_p]
        lib.qtpu_pipeline_run.restype = None
        lib.qtpu_pipeline_run.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
        ]
        lib.qtpu_pipeline_run_varied.restype = None
        lib.qtpu_pipeline_run_varied.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
        ]
        _LOADER.lib = lib
        return lib


def available() -> bool:
    return load_library() is not None


class NativePipeline:
    """Thread-pooled image preprocessing: uint8 HWC images -> normalized f32
    NHWC batch. Follows a ``Transform``'s eval and CIFAR-train semantics (the
    inception-style random-sized crop stays on the numpy path)."""

    def __init__(self, transform, threads: int = 0, seed: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native dataload library unavailable")
        self._lib = lib
        self.transform = transform
        c = len(transform.mean)
        mean = (ctypes.c_float * c)(*[float(m) for m in transform.mean])
        std = (ctypes.c_float * c)(*[float(s) for s in transform.std])
        self.channels = c
        self.input_size = transform.input_size
        self._handle = lib.qtpu_pipeline_create(
            transform.input_size, transform.scale_size, c, mean, std,
            1 if transform.augment else 0, transform.pad if transform.augment else 0,
            seed, threads,
        )
        self._counter = 0

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.qtpu_pipeline_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        self.close()

    def __call__(self, batch_u8: np.ndarray) -> np.ndarray:
        """(N, H, W, C) uint8 -> (N, size, size, C) f32."""
        batch_u8 = np.ascontiguousarray(batch_u8, np.uint8)
        if batch_u8.ndim == 3:
            batch_u8 = batch_u8[..., None]
        n, h, w, c = batch_u8.shape
        if c != self.channels:
            raise ValueError(f"images have {c} channels, the transform {self.channels}")
        out = np.empty((n, self.input_size, self.input_size, c), np.float32)
        self._lib.qtpu_pipeline_run(
            self._handle,
            batch_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n, h, w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._counter,
        )
        self._counter += n
        return out

    def process_varied(self, images) -> np.ndarray:
        """A list of differently shaped uint8 HWC images -> f32 NHWC batch."""
        images = [np.ascontiguousarray(im if im.ndim == 3 else im[..., None], np.uint8) for im in images]
        for im in images:
            if im.shape[2] != self.channels:
                raise ValueError(f"an image has {im.shape[2]} channels, the transform {self.channels}")
        n = len(images)
        ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
            *[im.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for im in images]
        )
        hs = (ctypes.c_int * n)(*[im.shape[0] for im in images])
        ws = (ctypes.c_int * n)(*[im.shape[1] for im in images])
        out = np.empty((n, self.input_size, self.input_size, self.channels), np.float32)
        self._lib.qtpu_pipeline_run_varied(
            self._handle, ptrs, hs, ws, n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), self._counter,
        )
        self._counter += n
        return out
