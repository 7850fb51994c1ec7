"""Evaluation loop (counterpart of ``quantized_tpu/training/qat.py``, its
evaluation half).

The reference's shared ``forward(data_loader, model, criterion, epoch,
training, optimizer)`` loop with its meters and periodic logging, run on
the card (unless the caller asks for the CPU) under ``torch.inference_mode()``. QAT training (the
straight-through backward, the optimizer, the regime switch) waits for the
training slice, ROADMAP item A9: ``train_epoch``, ``adjust_for_epoch`` and
a training ``run_epoch`` raise ``NotImplementedError`` naming it, and the
data-parallel mesh waits for item A10.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.utils.meters import AverageMeter, accuracy

logger = logging.getLogger(__name__)

TRAINING_SLICE = "QAT training (the STE backward, the optimizer and the regime) is not ported yet: ROADMAP item A9"
MESH_SLICE = "distribution over a device mesh is not ported yet: ROADMAP item A10"


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, as the JAX package forms it: the
    log-softmax taken at each row's label."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, labels.to(torch.int64)[:, None]).mean()


class Trainer:
    """Epoch-driven loop with the reference's meters; evaluation only.

    The model is moved to ``device`` (the card unless the caller asks for the
    CPU) and each batch with it. ``check_finite`` raises ``FloatingPointError`` on a batch whose logits
    hold a NaN or an infinity (the CLI's ``--debug-nans``)."""

    def __init__(
        self,
        model: nn.Module,
        regime: Optional[Dict[int, Dict[str, Any]]] = None,
        mesh=None,
        print_freq: int = 10,
        compute_dtype=None,
        check_finite: bool = False,
        device: DeviceLike = "cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(MESH_SLICE)
        if compute_dtype is not None:
            raise NotImplementedError(f"compute_dtype={compute_dtype!r}: {TRAINING_SLICE}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.regime = regime if regime is not None else getattr(model, "regime", None)
        self.print_freq = print_freq
        self.check_finite = check_finite

    def adjust_for_epoch(self, epoch: int):
        raise NotImplementedError(TRAINING_SLICE)

    def run_epoch(self, batches: Iterable[Tuple[np.ndarray, np.ndarray]], epoch: int,
                  training: bool) -> Dict[str, float]:
        """The reference's shared ``forward`` loop; ``training=True`` raises
        until the training slice lands."""
        if training:
            raise NotImplementedError(TRAINING_SLICE)
        self.model.eval()
        dev = self.device
        losses, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter()
        batch_time, data_time = AverageMeter(), AverageMeter()
        end = time.time()
        for i, (x, y) in enumerate(batches):
            data_time.update(time.time() - end)
            xs = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
            ys = torch.as_tensor(np.asarray(y)).to(dev)
            with torch.inference_mode():
                logits = self.model(xs)
                loss_t = cross_entropy(logits, ys)
            if self.check_finite and not bool(torch.isfinite(logits).all()):
                raise FloatingPointError(f"eval epoch {epoch} batch {i}: non-finite logits")
            loss = float(loss_t)
            k = min(5, logits.shape[-1])
            accs = accuracy(logits, y, topk=(1, k))
            n = len(y)
            losses.update(loss, n)
            top1.update(accs[0], n)
            top5.update(accs[-1], n)
            batch_time.update(time.time() - end)
            end = time.time()
            if i % self.print_freq == 0:
                logger.info("eval epoch %d [%d]: loss %.4f (%.4f) top1 %.2f (%.2f) time %.3fs data %.3fs",
                            epoch, i, loss, losses.avg, accs[0], top1.avg, batch_time.val, data_time.val)
        return {
            "loss": losses.avg,
            "top1": top1.avg,
            "top5": top5.avg,
            "batch_time": batch_time.avg,
            "data_time": data_time.avg,
        }

    def train_epoch(self, batches, epoch: int):
        raise NotImplementedError(TRAINING_SLICE)

    def validate(self, batches, epoch: int = 0):
        return self.run_epoch(batches, epoch, training=False)
