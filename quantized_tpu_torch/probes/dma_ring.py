"""Copy probe on one GPU: how fast does each copy route move ResNet-50's
layer1 activation, (B, 56, 56, 256) int8?

The port of the JAX package's TPU DMA studies (``bench/dma_ring_probe3.py``
and its variant list, with ``dma_ring_probe2.py``'s raw-2dma and
ring-unroll-sep and ``fused_probe.py``'s copy-bi{1,2,4,8,16}), onto the
kernels of B9 (``ops/copy_probe.py``, ``csrc/copy_probe.cu``). Each variant
is first checked exact against its plain version (``x``, or ``x + 1``
wrapped in int8), then timed as a chain ``x -> f(x) -> ...`` by
:func:`~quantized_tpu_torch.utils.timing.chain_time`, and printed with its
duplex rate (bytes read + bytes written per second). ``Tensor.copy_`` into
a preallocated tensor is timed beside them as the yardstick; the port never
calls it.

How the TPU variants map onto the card (:data:`VARIANTS` lists each with
its JAX counterpart):
- the auto-pipelined grid copies are :func:`~quantized_tpu_torch.ops.grid_copy`,
  steps of ``bi`` images, each cut into pieces over the whole card;
- the hand-rolled DMA rings are :func:`~quantized_tpu_torch.ops.ring_copy`
  with the same S, D and bi. probe3's ``ring-dyn`` (dynamic slot indices)
  and ``ring-unroll`` (a fully unrolled ring), and probe2's DMA priorities,
  are forms of one TPU compile: on the card they are the same kernel, so
  their rows time the same call;
- the raw whole-array DMAs are :func:`~quantized_tpu_torch.ops.bulk_copy`,
  the array in one or two slices (streams), each streamed by its share of
  the blocks through rings of TMA bulk copies;
- ``xla-add`` (XLA's fused ``x + 1``) is the plain version's ``x + 1``
  through PyTorch's elementwise ops.

With ``--plans`` it times instead, by the L2-flushed
:class:`~quantized_tpu_torch.utils.timing.Timer`, the grid copy under other
plans than :func:`~quantized_tpu_torch.ops.copy_probe.copy_plan`'s (pieces
of 4 to 64 KB, at bi 1 and 16), the
ring over S, D and bi and on two blocks an SM, and the bulk copy under
:func:`~quantized_tpu_torch.ops.copy_probe.bulk_plan` over its chunk size,
slots and blocks an SM, each held exact first, beside
``Tensor.copy_``: what the plans' choices are worth on the card.

Usage, on a GPU: ``python -m quantized_tpu_torch.probes.dma_ring [batch]
[--plans]`` (default 128, as the JAX scripts). It exits non-zero without
one.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from quantized_tpu_torch import ops
from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.utils.timing import chain_time

H = W = 56
C = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet

# name: (copy of x, adds 1, the JAX variant(s) it stands for)
VARIANTS: Dict[str, Tuple[Callable[[torch.Tensor], torch.Tensor], bool, str]] = {
    "xla-add": (lambda x: ops.copy_plain(x, add=True), True, "dma_ring_probe3.py xla-add"),
    "grid-copy": (lambda x: ops.grid_copy(x, 1), False,
                  "dma_ring_probe3.py grid-copy, dma_ring_probe.py grid-copy"),
    "raw-1dma": (lambda x: ops.bulk_copy(x, 1), False, "dma_ring_probe3.py raw-1dma, dma_ring_probe2.py raw-1dma"),
    "raw-2dma": (lambda x: ops.bulk_copy(x, 2), False, "dma_ring_probe2.py raw-2dma"),
    "ring-dyn": (lambda x: ops.ring_copy(x, 4, 2, 1), False, "dma_ring_probe3.py ring-dyn"),
    "ring-dyn-S8D4": (lambda x: ops.ring_copy(x, 8, 4, 1), False, "dma_ring_probe3.py ring-dyn-S8D4"),
    "ring-unroll": (lambda x: ops.ring_copy(x, 4, 2, 1), False, "dma_ring_probe3.py ring-unroll (= ring-dyn here)"),
    "ring-unroll-bi4": (lambda x: ops.ring_copy(x, 4, 2, 4), False, "dma_ring_probe3.py ring-unroll-bi4"),
    "ring-dyn-add": (lambda x: ops.ring_copy(x, 4, 2, 1, "add"), True, "dma_ring_probe3.py ring-dyn-add"),
    "ring-unroll-add": (lambda x: ops.ring_copy(x, 4, 2, 1, "add"), True,
                        "dma_ring_probe3.py ring-unroll-add (= ring-dyn-add here)"),
    "ring-unroll-sep-bi4": (lambda x: ops.ring_copy(x, 4, 2, 4, "sep"), False,
                            "dma_ring_probe2.py ring-unroll-sep-bi4"),
    **{f"copy-bi{bi}": ((lambda x, bi=bi: ops.grid_copy(x, bi)), False, f"fused_probe.py copy-bi{bi}")
       for bi in (1, 2, 4, 8, 16)},
}


def layer1_activation(batch: int, device: DeviceLike) -> torch.Tensor:
    """(batch, 56, 56, 256) int8 from ``numpy.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(-128, 128, (batch, H, W, C), dtype=np.int8)).to(resolve_device(device))


def run_probe(batch: int = 128, target_secs: float = 0.5, reps: int = 3, device: DeviceLike = "cuda",
              out: Callable[[str], None] = print) -> Dict[str, float]:
    """Check every variant exact, then time each; returns {name: seconds
    per copy}, ``Tensor.copy_`` under "torch copy_"."""
    x = layer1_activation(batch, device)
    want = {False: ops.copy_plain(x), True: ops.copy_plain(x, add=True)}
    for name, (fn, add, _) in VARIANTS.items():
        if not torch.equal(fn(x), want[add]):
            raise AssertionError(f"{name}: the copy differs from its plain version")
    gb = x.numel() / 1e9
    out(f"device={torch.cuda.get_device_name(x.device) if x.is_cuda else 'cpu'} batch={batch} "
        f"({gb * 1e3:.1f} MB each way; bound at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: "
        f"{2 * x.numel() / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    times = {}
    for name, (fn, _, counterpart) in VARIANTS.items():
        dt = chain_time(fn, x, target_secs=target_secs, reps=reps)
        times[name] = dt
        out(f"{name:>20}: {dt * 1e3:7.4f} ms  ({2 * gb / dt:6.0f} GB/s duplex)  [{counterpart}]")
    bufs = (torch.empty_like(x), torch.empty_like(x))  # copy_ onto its own source would return at once

    def torch_copy(y):
        return (bufs[1] if y is bufs[0] else bufs[0]).copy_(y)

    dt = chain_time(torch_copy, x, target_secs=target_secs, reps=reps)
    times["torch copy_"] = dt
    out(f"{'torch copy_':>20}: {dt * 1e3:7.4f} ms  ({2 * gb / dt:6.0f} GB/s duplex)  [yardstick, not the port's]")
    return times


def plan_calls(x: torch.Tensor) -> Dict[str, Tuple[Callable[[], torch.Tensor], bool]]:
    """name: (the copy under one plan, adds 1): the grid copy at bi 1 and 16
    at pieces of 4 to 64 KB; the ring (none) over S, D and bi,
    the bytes of loads it may keep in flight being D x bi images; S 4, D 2,
    bi 1 also with "add" and on two blocks an SM; the bulk copy (one stream)
    at chunks of 4 to 32 KB, 2 to 8 slots and 1 to 6 blocks an SM, wherever
    that many blocks' slots fit an SM."""
    from quantized_tpu_torch.ops import _cuda
    from quantized_tpu_torch.ops.copy_probe import (
        SMEM_PER_SM,
        bulk_plan,
        copy_plan,
        launch_bulk_copy,
        launch_grid_copy,
        launch_ring_copy,
        ring_plan,
    )

    sms = _cuda.sm_count(x.device)
    image = x.numel() // x.shape[0]
    calls = {}
    for bi in (1, 16):
        for kb in (4, 8, 16, 32, 64):
            plan = copy_plan(x.numel(), bi * image, sms, max_piece=kb * 1024 // 16)
            calls[f"grid bi{bi} <={kb}KB ({plan.blocks} blocks)"] = (lambda plan=plan: launch_grid_copy(x, plan), False)
    rings = [(s, d, bi, "none", sms) for s, d, bi in ((4, 1, 1), (4, 2, 1), (8, 2, 1), (4, 3, 1), (4, 4, 1),
                                                      (8, 4, 1), (8, 6, 1), (4, 2, 2), (4, 2, 4))]
    # "add"; two blocks an SM; 128 blocks, whose pieces of a layer1 image are whole 128-byte lines
    rings += [(4, 2, 1, "add", sms), (4, 2, 1, "none", 2 * sms), (4, 2, 1, "add", 2 * sms), (4, 2, 1, "none", 128)]
    for slots, depth, bi, compute, blocks in rings:
        plan = ring_plan(x.numel(), bi * image, slots, depth, False, blocks)
        calls[f"ring S{slots}D{depth} bi{bi} {compute} {blocks} blocks"] = (
            lambda plan=plan, compute=compute: launch_ring_copy(x, plan, compute), compute == "add")
    for kb in (4, 8, 16, 32):
        for slots in (2, 3, 4, 6, 8):
            for per_sm in (1, 2, 3, 4, 6):
                plan = bulk_plan(x.numel(), 1, sms, kb * 1024 // 16, slots, per_sm)
                if per_sm * (plan.smem + 1024) <= SMEM_PER_SM:
                    calls[f"bulk {kb}KB S{slots} {per_sm}/SM ({plan.blocks} blocks)"] = (
                        lambda plan=plan: launch_bulk_copy(x, plan), False)
    return calls


def run_plans(batch: int = 32, device: DeviceLike = "cuda", out: Callable[[str], None] = print,
              iters: int = 20) -> Dict[str, float]:
    """Every plan of :func:`plan_calls` checked exact, then its device ms by
    :class:`~quantized_tpu_torch.utils.timing.Timer` (L2 flushed), with
    ``Tensor.copy_`` and the plans' own choices timed beside them."""
    from quantized_tpu_torch.utils.timing import Timer

    x = layer1_activation(batch, device)
    want = {False: ops.copy_plain(x), True: ops.copy_plain(x, add=True)}
    calls = plan_calls(x)
    for name, (fn, add) in calls.items():
        if not torch.equal(fn(), want[add]):
            raise AssertionError(f"{name}: the copy differs from its plain version")
    dst = torch.empty_like(x)
    calls["grid_copy(x, 1)"] = (lambda: ops.grid_copy(x, 1), False)
    calls["ring_copy(x, 4, 2, 1)"] = (lambda: ops.ring_copy(x, 4, 2, 1), False)
    calls["bulk_copy(x, 1)"] = (lambda: ops.bulk_copy(x, 1), False)
    calls["bulk_copy(x, 2)"] = (lambda: ops.bulk_copy(x, 2), False)
    calls["torch copy_"] = (lambda: dst.copy_(x), False)
    timer = Timer(x.device)
    bound = 2 * x.numel() / HBM_BYTES_PER_S * 1e3
    times = {}
    for name, (fn, _) in calls.items():
        times[name] = ms = timer.ms(fn, iters=iters)
        out(f"{name:>36}: {ms:7.4f} ms ({2 * x.numel() / ms / 1e6:6.0f} GB/s duplex, {ms / bound:.2f}x bound)")
    return times


def main(argv: Sequence[str]) -> int:
    if not torch.cuda.is_available():
        print("dma_ring: torch sees no CUDA GPU; this probe runs on one", file=sys.stderr)
        return 1
    args = [a for a in argv if not a.startswith("--")]
    batch = int(args[0]) if args else 128
    if "--plans" in argv:
        run_plans(batch)
    else:
        run_probe(batch)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
