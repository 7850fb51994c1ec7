"""QAT trainer of the port (counterpart of ``quantized_tpu/training/qat.py``,
the reference's ``main.py`` epoch loop and its shared ``forward`` batch
loop).

A training step is the model's train-mode forward (the observers and BN
statistics update in place, outside the graph), ``cross_entropy``, the
backward through the straight-through quantizers (with gradient
quantization and bi-precision where the layers ask for them) and one step
of the regime's optimizer (``training.regime``); evaluation runs under
``torch.inference_mode()``. The model and each batch live on ``device``,
the card unless the caller asks for the CPU; nothing falls back to the CPU.

Over a (data, model) mesh (``Trainer(mesh=)``, one process a device, every
rank running the same loop on the same global batches) the trainer
computes what the one-device trainer computes on the global batch, as
JAX's trainer does under GSPMD: ``parallel.sharding.prepare_for_training``
slices each layer's state to this rank's block of ``model`` and places
every reduction that spans the batch or a sliced tensor (``models.layers``).
Each rank forwards the rows of its data index (the model ranks of a data
group must be given the same global batch: the step checks that they hold
the same rows, and refuses otherwise); its loss is its rows'
cross-entropy over the global batch size, so its cotangents are the
one-device ones; the gradients are summed over ``data`` and each rank's
optimizer updates its blocks. The reported loss and logits are the global
batch's on every rank.
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
from quantized_tpu_torch.models import layers as L
from quantized_tpu_torch.training.regime import build_optimizer, regime_settings, update_hyperparams
from quantized_tpu_torch.utils.meters import AverageMeter, accuracy

logger = logging.getLogger(__name__)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, as the JAX package forms it: the
    log-softmax taken at each row's label."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, labels.to(torch.int64)[:, None]).mean()


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> int:
    """Run every conv and dense product of ``model`` in ``dtype`` (bf16:
    the tensor cores' operand type, f32 accumulation), the fake-quant
    boundaries, observers, BN statistics, loss, gradients and optimizer
    staying f32; ``None`` restores f32. Returns the number of layers
    switched. bf16 operands blur each fake-quant boundary by about 2^-8
    relative, so reference-parity checks keep f32."""
    n = 0
    for m in model.modules():
        if isinstance(m, (L.Conv2d, L.Linear, L.QConv2d, L.QLinear)):
            m.compute_dtype = dtype
            n += 1
    return n


class Trainer:
    """Epoch-driven QAT trainer with the reference's regime semantics.

    The model is moved to ``device`` (the card unless the caller asks for
    the CPU) and each batch with it. ``compute_dtype`` ``"bf16"`` runs the
    products in bf16 (:func:`set_compute_dtype`). The optimizer is built
    from the regime's settings when a step first needs it.
    ``check_finite`` raises ``FloatingPointError`` on a batch whose logits
    hold a NaN or an infinity (the CLI's ``--debug-nans``). ``mesh``, a
    ``DeviceMesh`` from ``parallel.create_mesh`` over this rank's device,
    trains over it (module docstring): a training batch must split evenly
    over ``data``; :meth:`full_state` gathers the model's state."""

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
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if compute_dtype is not None:
            set_compute_dtype(model, torch.bfloat16 if compute_dtype in ("bf16", "bfloat16") else compute_dtype)
        self.mesh, self.sliced = mesh, {}
        if mesh is not None:
            from quantized_tpu_torch.parallel.mesh import check_mesh
            from quantized_tpu_torch.parallel.sharding import prepare_for_training

            self.sliced = prepare_for_training(model, check_mesh(mesh))
        self.regime = regime if regime is not None else getattr(model, "regime", None)
        self.print_freq = print_freq
        self.check_finite = check_finite
        self._settings = regime_settings(self.regime, 0)
        self._opt = None

    @property
    def optimizer(self):
        """The optimizer of the current settings, built on first use."""
        if self._opt is None:
            self._opt = build_optimizer(self._settings, self.model.parameters())
        return self._opt

    def adjust_for_epoch(self, epoch: int):
        """The reference's ``adjust_optimizer``: apply the regime's settings
        for ``epoch``. A change of optimizer class rebuilds the optimizer
        (fresh state); lr, momentum and weight decay change in place."""
        new = regime_settings(self.regime, epoch)
        if new != self._settings:
            if new["optimizer"] != self._settings["optimizer"]:
                self._opt = None
                logger.info("regime: optimizer -> %s", new["optimizer"])
            elif self._opt is not None:
                update_hyperparams(self._opt, new)
            logger.info("regime epoch %d: %s", epoch, new)
            self._settings = new

    def _train_step(self, x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.mesh is not None:
            return self._mesh_train_step(x, y)
        opt = self.optimizer
        logits = self.model(x)
        loss = cross_entropy(logits, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), logits.detach()

    def _eval_step(self, x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            logits = self.model(x) if self.mesh is None else self._mesh_logits(x)
            return cross_entropy(logits, y), logits

    def _data_coords(self) -> Tuple[int, int]:
        from quantized_tpu_torch.parallel.mesh import DATA_AXIS, axis_index, axis_size

        return axis_index(self.mesh, DATA_AXIS), axis_size(self.mesh, DATA_AXIS)

    def _mesh_train_step(self, x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step over the mesh on the global batch ``(x, y)``: this rank's
        rows forward, the loss over the global batch size, the gradients
        summed over ``data`` (one all-reduce), this rank's blocks updated;
        returns the global loss and logits."""
        from quantized_tpu_torch.parallel.collectives import all_gather, all_reduce
        from quantized_tpu_torch.parallel.distributed import local_batch_slice
        from quantized_tpu_torch.parallel.mesh import DATA_AXIS

        parts = self._data_coords()[1]
        if x.shape[0] % parts:
            raise ValueError(f"a training batch of {x.shape[0]} does not split over {parts} data ranks")
        rows = local_batch_slice(x.shape[0], self.mesh)
        x, y = x[rows], y[rows]
        self._check_same_rows(x, y)
        opt = self.optimizer
        logits = self.model(x)
        loss = cross_entropy(logits, y) / parts
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        summed = all_reduce(torch.cat([g.reshape(-1) for g in grads]), self.mesh, DATA_AXIS)
        torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(summed.split([g.numel() for g in grads]), grads)])
        opt.step()
        return all_reduce(loss.detach().reshape(1), self.mesh, DATA_AXIS)[0], \
            all_gather(logits.detach(), self.mesh, DATA_AXIS)

    def _check_same_rows(self, x: torch.Tensor, y: torch.Tensor) -> None:
        """Raise unless every model rank of this data group holds the same
        rows: each computes its channels of them, and the gathered channels
        of different images would train silently wrong. A checksum of the
        rows (images and labels) is reduced by MIN and MAX over ``model``."""
        from quantized_tpu_torch.parallel.collectives import all_reduce_min_max
        from quantized_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size

        if axis_size(self.mesh, MODEL_AXIS) == 1:
            return
        flat = x.reshape(x.shape[0], -1).double()
        weights = torch.arange(1, flat.shape[1] + 1, dtype=torch.float64, device=x.device)
        sums = torch.cat([flat @ weights, y.double()])
        lo, hi = all_reduce_min_max(sums, sums, self.mesh, (MODEL_AXIS,))
        if not torch.equal(lo, hi):
            raise RuntimeError("the model ranks of a data group were given different training batches: every rank "
                               "must see the same global batch (a data loader whose augmentation is seeded alike)")

    def _mesh_logits(self, x: torch.Tensor) -> torch.Tensor:
        """The logits of the global batch ``x``: this rank's rows (the batch
        padded with zero rows to a multiple of the data degree) forwarded,
        the rows gathered over ``data`` (``MeshEngine``'s evaluation)."""
        from quantized_tpu_torch.parallel.collectives import all_gather
        from quantized_tpu_torch.parallel.mesh import DATA_AXIS

        index, parts = self._data_coords()
        n = x.shape[0]
        if n % parts:
            x = torch.cat([x, x.new_zeros((parts - n % parts, *x.shape[1:]))])
        return all_gather(self.model(x.chunk(parts)[index]), self.mesh, DATA_AXIS)[:n]

    def full_state(self) -> Dict[str, torch.Tensor]:
        """The model's whole state, as one device holds it: over a mesh the
        sliced tensors gathered over ``model`` (a collective, every rank
        calls it), on the model's device."""
        if self.mesh is None:
            return {k: v.detach() for k, v in self.model.state_dict().items()}
        from quantized_tpu_torch.parallel.sharding import gather_state

        return gather_state(self.model, self.mesh, self.sliced)

    def run_epoch(self, batches: Iterable[Tuple[np.ndarray, np.ndarray]], epoch: int,
                  training: bool) -> Dict[str, float]:
        """The reference's shared ``forward`` loop (main.py ~L215-290)."""
        if training:
            self.model.train()
            self.adjust_for_epoch(epoch)
        else:
            self.model.eval()
        dev = self.device
        losses, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter()
        batch_time, data_time = AverageMeter(), AverageMeter()
        end = time.time()
        for i, (x, y) in enumerate(batches):
            data_time.update(time.time() - end)
            xs = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
            ys = torch.as_tensor(np.asarray(y)).to(dev)
            loss_t, logits = (self._train_step if training else self._eval_step)(xs, ys)
            if self.check_finite and not bool(torch.isfinite(logits).all()):
                raise FloatingPointError(f"{'train' if training else 'eval'} epoch {epoch} batch {i}: "
                                         "non-finite logits")
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
                logger.info("%s epoch %d [%d]: loss %.4f (%.4f) top1 %.2f (%.2f) time %.3fs data %.3fs",
                            "train" if training else "eval", epoch, i, loss, losses.avg, accs[0], top1.avg,
                            batch_time.val, data_time.val)
        return {
            "loss": losses.avg,
            "top1": top1.avg,
            "top5": top5.avg,
            "batch_time": batch_time.avg,
            "data_time": data_time.avg,
        }

    def train_epoch(self, batches, epoch: int):
        return self.run_epoch(batches, epoch, training=True)

    def validate(self, batches, epoch: int = 0):
        return self.run_epoch(batches, epoch, training=False)
