"""Tracing (counterpart of ``quantized_tpu/utils/profiling.py``).

- ``trace(dir)``: a context manager that records the enclosed work with
  ``torch.profiler`` (the CPU, and the GPU where one is present) and writes
  a Chrome trace, ``dir/trace.json`` (open it in Perfetto or
  ``chrome://tracing``).
- ``annotate(name)``: a named region on that timeline.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named trace region: ``with annotate('stem'): ...``."""
    return record_function(name)
