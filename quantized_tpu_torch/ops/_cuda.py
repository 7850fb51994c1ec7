"""Build the CUDA sources under ``csrc/`` with nvcc and bind their C entry
points with ctypes.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) into ``quantized_tpu_torch/_build/`` the
first time a kernel of it is launched (or ahead of that, by
:func:`build_kernels`, which runs one nvcc per source in parallel). The
library name carries a digest of the sources and flags, so an edited source
is rebuilt and a current one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add contraction: the epilogues must round like the plain
    # PyTorch versions (the sources also spell __fmul_rn/__fadd_rn)
    "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # source name -> nvcc's output (ptxas register/smem report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def _library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_kernels(sources: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every source (default: all of ``csrc/*.cu``) whose library is
    missing, one nvcc process per source, all started together. Returns the
    wall seconds of each build (0.0 for a library that was current). Raises
    with nvcc's output if any build fails."""
    names = sorted(p.name for p in CSRC.glob("*.cu")) if sources is None else list(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    seconds = {}
    for name in names:
        target = _library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / name)]
        procs.append((name, target, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, target, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)  # atomic: a concurrent build sees a whole library
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load_library(source: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = _library_path(source)
            if not path.exists():
                build_kernels([source])
            lib = ctypes.CDLL(str(path))
            lib.qt_error_string.argtypes = [ctypes.c_int]
            lib.qt_error_string.restype = ctypes.c_char_p
            _LIBS[source] = lib
        return lib


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
ARG_TYPES = {"ptr": _P, "int": _I, "long": _L, "float": _F}


class CudaKernel:
    """One C entry point of a ``csrc`` source and its launch count.

    ``launches`` goes up by one for each launch that the CUDA runtime
    accepted, and nowhere else; where the entry has several routes (K1, B6,
    K2 and B7: the Hopper mainloop or the general tile), ``routes[route]``
    counts the same launches by the route the caller passed the entry, which
    runs that route or refuses the call."""

    def __init__(self, name: str, source: str, symbol: str, arg_kinds: Sequence[str]):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes: List = [ARG_TYPES[k] for k in arg_kinds] + [_P]  # + stream
        self.launches = 0
        self.routes: Dict[str, int] = {}
        self._fn = None
        KERNELS[name] = self

    def __call__(self, device: torch.device, *args, route: Optional[str] = None) -> None:
        if self._fn is None:
            lib = load_library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = self._fn(*args, stream)
        if rc != 0:
            msg = self._lib.qt_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: launch failed with CUDA error {rc} ({msg})")
        self.launches += 1
        if route is not None:
            self.routes[route] = self.routes.get(route, 0) + 1


KERNELS: Dict[str, CudaKernel] = {}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.routes = {}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def route_counts() -> Dict[str, Dict[str, int]]:
    """{kernel: {route: launches}} of the kernels with routes."""
    return {name: dict(k.routes) for name, k in KERNELS.items() if k.routes}


def require_cuda_tensors(*tensors: torch.Tensor) -> torch.device:
    """All on one CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if not t.is_contiguous():
            raise ValueError("CUDA kernels take contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on the H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_dtype(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
