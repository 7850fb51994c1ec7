"""QAT train-step time on one CUDA GPU (the port of ``bench/train_step.py``):
the fake-quant forward, the straight-through backward and a plain SGD
update (``p -= 0.01 * g``, as the JAX probe steps) of one model at one
batch, on seeded inputs (images standard normal, labels uniform).

Usage: ``python -m quantized_tpu_torch.probes.train_step [B] [model]
[depth] [dtype] [dataset] [variant]`` (defaults 128,
``resnet_quantized_float_bn``, 18, f32, imagenet, full):

- dtype ``f32`` (the reference's arithmetic) or ``bf16`` (every conv and
  dense product in bf16, ``training.qat.set_compute_dtype``); TF32 is off
  either way. The suffix ``-remat`` (``f32-remat``, ``bf16-remat``)
  rematerializes the forward: each residual block runs under
  ``torch.utils.checkpoint`` (:func:`rematerialize`), its activations
  recomputed in the backward rather than kept, which trades the block's
  forward a second time for the memory its activations held.
- variant, for the gradient-quantizing flagship ``resnet_quantized``:
  ``full`` (the module defaults: 8-bit gradients and bi-precision),
  ``nobiprec`` (gradient quantization kept, bi-precision off: the second
  conv's cost) or ``nogradq`` (both off).

It prints the card (its name and power limit from ``nvidia-smi``), the
step's device time (``utils.timing.Timer.ms``:
the host's launches hidden), its time between CUDA events with the host's
launch time in it (``Timer.event_ms``, what a training loop waits for),
img/s of each and the peak memory. It needs a CUDA GPU.
"""

from __future__ import annotations

import contextlib
import functools
import subprocess
import sys
from typing import Callable, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.models import layers as L
from quantized_tpu_torch.models.resnet_common import BasicBlock, Bottleneck
from quantized_tpu_torch.training.qat import cross_entropy, set_compute_dtype

LR = 0.01
VARIANTS = ("full", "nobiprec", "nogradq")
DTYPES = {"f32": None, "bf16": torch.bfloat16}
REMAT = "-remat"


class _Replay:
    """Makes the recomputation of a checkpointed block leave no trace: the
    block's random streams go back to their counts at the original forward
    for the replay (it draws that forward's noise and masks, so what it
    recomputes is what the forward saved) and forward again after it, and
    the buffers the replay updates (observers, BN and RangeBN statistics)
    get back their values."""

    def __init__(self, block: nn.Module):
        self.block = block
        self.streams = [v for m in block.modules() for v in vars(m).values() if isinstance(v, L.RandomStream)]
        self.counts = []

    def contexts(self):
        return self._forward(), self._replay()

    @contextlib.contextmanager
    def _forward(self):
        self.counts = [st.count for st in self.streams]
        yield

    @contextlib.contextmanager
    def _replay(self):
        after = [st.count for st in self.streams]
        kept = [(b, b.detach().clone()) for b in self.block.buffers()]
        for st, c in zip(self.streams, self.counts):
            st.count = c
        try:
            yield
        finally:
            for st, c in zip(self.streams, after):
                st.count = c
            with torch.no_grad():
                for b, v in kept:
                    b.copy_(v)


def _checkpointed(forward, replay: _Replay, x: torch.Tensor) -> torch.Tensor:
    return checkpoint(forward, x, use_reentrant=False, context_fn=replay.contexts)


def rematerialize(model: nn.Module) -> int:
    """Run each residual block of ``model`` under ``torch.utils.checkpoint``
    (its ``forward`` replaced on the instance; the state's keys stay), the
    recomputation leaving the streams and buffers as the plain step leaves
    them (:class:`_Replay`). Returns the blocks wrapped."""
    blocks = [m for m in model.modules() if isinstance(m, (BasicBlock, Bottleneck))]
    if not blocks:
        raise ValueError(f"{type(model).__name__} has no residual block to rematerialize")
    for block in blocks:
        block.forward = functools.partial(_checkpointed, block.forward, _Replay(block))
    return len(blocks)


def apply_variant(model: nn.Module, variant: str) -> nn.Module:
    """Turn bi-precision off (``nobiprec``), and gradient quantization too
    (``nogradq``), in every layer that has them."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: expected one of {VARIANTS}")
    if variant != "full":
        for m in model.modules():
            if isinstance(m, (L.QConv2d, L.QLinear)):
                m.biprecision = False
            if variant == "nogradq" and isinstance(m, (L.QConv2d, L.QLinear, L.RangeBN)):
                m.num_bits_grad = None
    return model


def build(batch: int, model_name: str, depth: int, dtype: str, dataset: str, variant: str,
          device="cuda") -> Tuple[nn.Module, torch.Tensor, torch.Tensor]:
    """The model (seed 0, in train mode, on ``device``) and its seeded
    batch; ``dtype`` with the ``-remat`` suffix rematerializes the blocks."""
    remat = dtype.endswith(REMAT)
    base = dtype[: -len(REMAT)] if remat else dtype
    if base not in DTYPES:
        raise ValueError(f"dtype {dtype!r}: expected one of {sorted(DTYPES)}, with {REMAT!r} or without")
    cfg = {"dataset": dataset, "depth": depth} if "resnet" in model_name else {}
    model = apply_variant(get_model(model_name)(generator=torch.Generator().manual_seed(0), **cfg), variant)
    set_compute_dtype(model, DTYPES[base])
    if remat:
        rematerialize(model)
    model.to(device).train()
    size = getattr(model, "input_size", 224)
    chans = 1 if dataset == "mnist" else 3
    classes = 10 if dataset.startswith("cifar") or dataset == "mnist" else 1000
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((batch, size, size, chans)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(1).integers(0, classes, (batch,)))
    return model, x.to(device), y.to(device)


def make_step(model: nn.Module, x: torch.Tensor, y: torch.Tensor, lr: float = LR) -> Callable[[], torch.Tensor]:
    """One fwd + bwd + SGD step on ``(x, y)``; returns the loss (on the
    device, not waited for)."""
    params = list(model.parameters())

    def step() -> torch.Tensor:
        for p in params:
            p.grad = None
        loss = cross_entropy(model(x), y)
        loss.backward()
        with torch.no_grad():
            torch._foreach_add_(params, [torch.zeros_like(p) if p.grad is None else p.grad for p in params],
                                alpha=-lr)
        return loss.detach()

    return step


def step_times(step: Callable[[], torch.Tensor], timer, iters: int = 3, warmup: int = 1) -> Tuple[float, float]:
    """(device ms, ms between CUDA events with the host's launches) of one step."""
    return timer.ms(step, iters=iters, warmup=warmup), timer.event_ms(step, iters=iters, warmup=warmup)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("train_step: torch sees no CUDA GPU; this probe times the card")
    from quantized_tpu_torch.utils.timing import Timer

    batch = int(argv[0]) if len(argv) > 0 else 128
    model_name = argv[1] if len(argv) > 1 else "resnet_quantized_float_bn"
    depth = int(argv[2]) if len(argv) > 2 else 18
    dtype = argv[3] if len(argv) > 3 else "f32"
    dataset = argv[4] if len(argv) > 4 else "imagenet"
    variant = argv[5] if len(argv) > 5 else "full"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, x, y = build(batch, model_name, depth, dtype, dataset, variant)
    step = make_step(model, x, y)
    torch.cuda.reset_peak_memory_stats()
    ms, event_ms = step_times(step, Timer("cuda"))
    peak = torch.cuda.max_memory_allocated() / 2**20
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card={card} model={model_name}-{depth} batch={batch} dtype={dtype} "
          f"variant={variant}")
    print(f"QAT train step: {ms:.2f} ms device ({batch / ms * 1e3:.0f} img/s), {event_ms:.2f} ms between events "
          f"({batch / event_ms * 1e3:.0f} img/s), peak memory {peak:.0f} MiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
