"""Meters and metrics (counterpart of ``quantized_tpu/utils/meters.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


class AverageMeter:
    """Running average (the reference's ``AverageMeter``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def accuracy(output, target, topk: Sequence[int] = (1,)) -> Tuple[float, ...]:
    """Top-k accuracy in percent (the reference's ``accuracy``). ``output``
    (N, classes) and ``target`` (N,) are torch tensors on any device or
    numpy arrays; they are ranked on the host with the JAX package's numpy
    code, so ties fall the same way in both packages."""
    output = _host(output)
    target = _host(target)
    maxk = max(topk)
    pred = np.argsort(-output, axis=-1)[:, :maxk]
    correct = pred == target[:, None]
    return tuple(100.0 * correct[:, :k].any(axis=1).mean() for k in topk)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
