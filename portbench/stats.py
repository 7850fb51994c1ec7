"""Order statistics over every sample, failures included as infinite."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``p`` percent
    of the samples at or below it. Infinite samples (failed or unanswered
    requests) sort above every latency."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if len(v) == 0:
        return float("nan")
    return float(v[max(0, math.ceil(p / 100.0 * len(v)) - 1)])
