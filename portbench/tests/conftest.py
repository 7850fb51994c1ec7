"""CPU tests of the benchmark harness: ``python -m pytest portbench/tests -q``
from the checkout's root. Tests marked ``cuda`` need the card and skip here."""

from __future__ import annotations

import pytest
import torch

from portbench import spec

# a cell at a size the CPU holds: 32x32 images, small batches and pools, no tuner
TINY = {
    "config": {"image_size": 32, "calib_images": 4},
    "traffic": {"batch": 4, "pool_batches": 2, "compare_batches": 64, "pool_images": 16,
                "rate_img_per_s": 20, "buckets": [1, 4], "compare_requests": 64, "answer_wait_s": 120},
    "tuner": {"enabled": False},
}
SEED = 2 ** 31 + 977  # above 32 signed bits, as the driver's seeds are
# the served cell is not in BENCHMARK.json (PERF.md, Open questions); its
# traffic, generator and readers are, and the tests drive them through it
SERVE = {"name": "resnet50.serve", "config": "resnet50", "traffic": "serve_open_bursty", "chips": 1, "why": "served"}


def cell(name: str) -> spec.Cell:
    """A cell of BENCHMARK.json, or the served cell above."""
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    bench["workloads"].append(SERVE)
    return spec.cell(name, bench=bench)


@pytest.fixture
def card():
    """A CUDA device, or the test skips (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs on the card only")
    return torch.device("cuda")
