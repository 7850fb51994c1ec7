"""Stage split of the fused bottleneck (B3) on one GPU: which stage of the
block takes the time?

The port of ``bench/fused_probe.py``: on one (B, 56, 56, 256) int8 input
(ResNet-50's layer1 geometry, C = 256, Cm = 64) it times
- copy: ``ops.grid_copy`` (the probe's copy-bi1, B9), the bytes alone;
- conv1: B3's mainloop stopped after conv1 (``fused_stages_conv1``, the
  Pallas body ``k_conv1``): conv1 + requant, h1 tiled out to C channels;
- conv12: stopped after conv2 (``fused_stages_conv12``, ``k_conv12``):
  + the halo-padded 3x3 conv2;
- full: the whole identity block (``fused_bottleneck_s1``).
Each stage is first held equal to its plain version (``fused_stage_plain``)
on the card, then timed by :class:`~quantized_tpu_torch.utils.timing.Timer`
(device time, L2 flushed). The differences between the rows are what each
stage adds.

With ``--plans`` it times instead B3 and B4 at a few ResNet shapes under
launch plans around ``block_plan``'s (other ring depths, cluster sizes and
band heights; ``--every``: every plan ``block_plan`` weighs, at every
ResNet-50/18 block shape), each held equal to its plain version first:
what the plan's choices are worth on the card. ``--shapes`` times every
ResNet-50/18 block shape through its wrapper alone, which a checkout of an
earlier commit also runs (copy this file into it): a parent-and-change
comparison.

Usage, on a GPU: ``python -m quantized_tpu_torch.probes.fused_stages [batch]
[--plans | --every | --shapes]`` (default 128, as the JAX script). It exits
non-zero without one.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, Dict

import numpy as np
import torch

from quantized_tpu_torch import ops
from quantized_tpu_torch.ops import fused_block
from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.utils.timing import Timer

H = W = 56
C, CM = 256, 64
SCALE = 0.01  # the probe's a: jnp.full((1, CM), 0.01)


def probe_inputs(batch: int, device: torch.device, seed: int = 0):
    """x, w1 (Cm, C), w2 (Cm, 9*Cm), a (Cm,), and the full block's other
    weights and epilogue vectors, made from a seed with numpy."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a).to(device)

    x = t(rng.integers(-128, 128, (batch, H, W, C)).astype(np.int8))
    w1 = t(rng.integers(-127, 128, (CM, C)).astype(np.int8))
    w2 = t(rng.integers(-127, 128, (CM, 9 * CM)).astype(np.int8))
    w3 = t(rng.integers(-127, 128, (C, CM)).astype(np.int8))
    a = torch.full((CM,), SCALE, dtype=torch.float32, device=device)
    vecs = []
    for k, n in ((C, CM), (9 * CM, CM), (CM, C)):
        vecs += [t((rng.uniform(0.5, 1.5, n) * 6e-3 / np.sqrt(k)).astype(np.float32)),
                 t(rng.uniform(-8, 8, n).astype(np.float32))]
    return x, w1, w2, w3, a, vecs


def stage_calls(batch: int, device: torch.device) -> Dict[str, tuple]:
    """name: (the call, its plain version or None) on one shared input."""
    x, w1, w2, w3, a, vecs = probe_inputs(batch, device)
    full = (w1, w2, w3, *vecs, -21.0, -9.0, -3.0, -21, 0.8137192, 2.71828)
    return {
        "copy": (lambda: ops.grid_copy(x, 1), lambda: ops.copy_plain(x)),
        "conv1": (lambda: ops.fused_stage_ck(x, w1, w2, a, 1), lambda: ops.fused_stage_plain(x, w1, w2, a, 1)),
        "conv12": (lambda: ops.fused_stage_ck(x, w1, w2, a, 2), lambda: ops.fused_stage_plain(x, w1, w2, a, 2)),
        "full": (lambda: ops.fused_bottleneck_s1_ck(x, *full), lambda: ops.fused_bottleneck_s1_plain(x, *full)),
    }


def run_probe(batch: int = 128, device: DeviceLike = "cuda", out: Callable[[str], None] = print,
              iters: int = 10) -> Dict[str, float]:
    """Each stage held equal to its plain version, then its device ms."""
    dev = resolve_device(device)
    timer = Timer(dev)
    times = {}
    for name, (call, plain) in stage_calls(batch, dev).items():
        got, want = call(), plain()
        if not torch.equal(got, want):
            raise AssertionError(f"fused stages: {name} differs from its plain version")
        times[name] = timer.ms(call, iters=iters)
    nbytes = 2 * batch * H * W * C
    for name, ms in times.items():
        out(f"{name:>7}: {ms:8.4f} ms ({nbytes / ms / 1e6:7.1f} GB/s of input + output) at batch {batch}")
    return times


@contextlib.contextmanager
def forced_plan(plan_of):
    """B3's and B4's wrappers launch under ``plan_of(kind, n, h, w, c, cm,
    cout, stride, ds)`` in place of ``block_plan`` while inside."""
    real = fused_block.block_plan
    fused_block.block_plan = plan_of
    try:
        yield
    finally:
        fused_block.block_plan = real


# kind, label, side, C, Cm, Cout, stride, ds
SWEEP = [
    ("bottleneck", "layer1.1", 56, 256, 64, 256, 1, False),
    ("bottleneck", "layer4.1", 7, 2048, 512, 2048, 1, False),
    ("bottleneck", "layer4.0", 14, 1024, 512, 2048, 2, True),
    ("basic", "resnet18 layer3.1", 14, 256, 256, 256, 1, False),
]


# every B3 and B4 shape of the ResNet-50 and ResNet-18 engines
ALL_SHAPES = [
    ("bottleneck", "layer1.0", 56, 64, 64, 256, 1, True),
    ("bottleneck", "layer1.1", 56, 256, 64, 256, 1, False),
    ("bottleneck", "layer2.0", 56, 256, 128, 512, 2, True),
    ("bottleneck", "layer2.1", 28, 512, 128, 512, 1, False),
    ("bottleneck", "layer3.0", 28, 512, 256, 1024, 2, True),
    ("bottleneck", "layer3.1", 14, 1024, 256, 1024, 1, False),
    ("bottleneck", "layer4.0", 14, 1024, 512, 2048, 2, True),
    ("bottleneck", "layer4.1", 7, 2048, 512, 2048, 1, False),
    ("basic", "resnet18 layer1.1", 56, 64, 64, 64, 1, False),
    ("basic", "resnet18 layer2.0", 56, 64, 128, 128, 2, True),
    ("basic", "resnet18 layer2.1", 28, 128, 128, 128, 1, False),
    ("basic", "resnet18 layer3.0", 28, 128, 256, 256, 2, True),
    ("basic", "resnet18 layer3.1", 14, 256, 256, 256, 1, False),
    ("basic", "resnet18 layer4.0", 14, 256, 512, 512, 2, True),
]


def plan_variants(kind, n, h, c, cm, cout, stride, ds, every=False):
    """``block_plan``'s plan first, then the plans that differ from it in
    one choice: ring stages (2, 3, 6, 8), cluster size, band height (half,
    double); with ``every``, every cluster size, band height and image
    count that ``block_plan`` weighs instead. Those that fit shared memory."""
    base = ops.block_plan(kind, n, h, h, c, cm, cout, stride, ds)
    ho = h // stride
    out = [base]

    def add(q, nb, r, stages):
        bn = next((b for b in fused_block.BLOCK_BNS if (cm // q) % b == 0 and (cout // q) % b == 0), 0)
        smem = fused_block.block_smem_bytes(kind, bn, stages, nb, r, h, cm, stride)
        bands, groups = -(-ho // r), -(-n // nb)
        plan = fused_block.BlockPlan(q, nb, r, bn, stages, smem, q * bands * groups, 0)
        if bn and smem <= fused_block.SMEM_PER_BLOCK and all(p[:6] != plan[:6] for p in out):
            out.append(plan)

    if not every:
        for stages in (2, 3, 6, 8):
            add(base.q, base.nb, base.r, stages)
    qs = [q for q in fused_block.BLOCK_QS if cm % q == 0 and cout % q == 0 and (cm // q) % 16 == 0
          and (cout // q) % 16 == 0]
    shapes = [(1, r) for r in sorted({-(-ho // k) for k in range(1, min(ho, 8) + 1)})] if every else [(base.nb, base.r)]
    if every and 2 * ho * (h // stride) <= fused_block.BLOCK_TILE_M:
        shapes += [(nb, ho) for nb in range(2, min(n, fused_block.BLOCK_TILE_M // (ho * (h // stride))) + 1)]
    for q in qs:
        for nb, r in shapes:
            add(q, nb, r, base.stages)
    if base.nb == 1 and not every:
        for r in (max(1, base.r // 2), min(ho, 2 * base.r)):
            add(base.q, 1, r, base.stages)
    return out


def block_case(kind, h, c, cm, cout, s, ds, batch, rng, dev):
    """x, the wrapper, its plain version and their other arguments of one
    B3 or B4 shape, made from ``rng``."""
    def t(a):
        return torch.from_numpy(a).to(dev)

    x = t(rng.integers(-128, 128, (batch, h, h, c)).astype(np.int8))
    if kind == "bottleneck":
        shapes = [(cm, c), (cm, 9 * cm), (cout, cm)] + ([(cout, c)] if ds else [])
        ks = [c, 9 * cm, cm] + ([c] if ds else [])
    else:
        shapes = [(cm, 9 * c), (cm, 9 * cm)] + ([(cm, c)] if ds else [])
        ks = [9 * c, 9 * cm] + ([c] if ds else [])
    ws = [t(rng.integers(-127, 128, shape).astype(np.int8)) for shape in shapes]
    vecs = []
    for (rows, _), k in zip(shapes, ks):
        vecs += [t((rng.uniform(0.5, 1.5, rows) * 6e-3 / np.sqrt(k)).astype(np.float32)),
                 t(rng.uniform(-8, 8, rows).astype(np.float32))]
    if kind == "bottleneck":
        kernel, plain = ((ops.fused_bottleneck_ds_ck, ops.fused_bottleneck_ds_plain) if ds
                         else (ops.fused_bottleneck_s1_ck, ops.fused_bottleneck_s1_plain))
        args = (*ws, *vecs, s, -21.0, -9.0, -3.0, -21, 32.0) if ds else (*ws, *vecs, -21.0, -9.0, -3.0, -21,
                                                                         0.8137192, 2.71828)
    else:
        kernel, plain = ((ops.fused_basicblock_ds_ck, ops.fused_basicblock_ds_plain) if ds
                         else (ops.fused_basicblock_s1_ck, ops.fused_basicblock_s1_plain))
        args = (*ws, *vecs, s, -21.0, -3.0, -17, -40, 32.0) if ds else (*ws, *vecs, -21.0, -3.0, -17, -40,
                                                                        0.8137192, 2.71828)
    return x, kernel, plain, args


def time_shapes(batch: int = 32, device: DeviceLike = "cuda", out: Callable[[str], None] = print,
                iters: int = 10) -> Dict[str, float]:
    """Every ALL_SHAPES block through its wrapper alone (whatever plan the
    wrapper makes, so a checkout of an earlier commit runs it too): equal
    to the plain version, then its device ms."""
    dev = resolve_device(device)
    timer = Timer(dev)
    rng = np.random.default_rng(1)
    times = {}
    for kind, label, h, c, cm, cout, s, ds in ALL_SHAPES:
        x, kernel, plain, args = block_case(kind, h, c, cm, cout, s, ds, batch, rng, dev)
        if not torch.equal(kernel(x, *args), plain(x, *args)):
            raise AssertionError(f"fused stages --shapes: {label} differs from the plain version")
        times[label] = timer.ms(lambda: kernel(x, *args), iters=iters)
        out(f"{label} batch {batch}: {times[label]:.4f} ms")
    return times


def sweep_plans(batch: int = 32, device: DeviceLike = "cuda", out: Callable[[str], None] = print,
                iters: int = 10, every: bool = False, shapes=None):
    """Each SWEEP shape (``every``: each ALL_SHAPES one) under each of its
    plan variants: equal to the plain version, then its device ms. Returns
    {label: [(plan, ms)]}."""
    dev = resolve_device(device)
    timer = Timer(dev)
    rng = np.random.default_rng(1)
    results = {}
    for kind, label, h, c, cm, cout, s, ds in shapes or SWEEP:
        x, kernel, plain, args = block_case(kind, h, c, cm, cout, s, ds, batch, rng, dev)
        want = plain(x, *args)
        rows = results[label] = []
        for plan in plan_variants(kind, batch, h, c, cm, cout, s, ds, every):
            with forced_plan(lambda *_, plan=plan: plan):
                if not torch.equal(kernel(x, *args), want):
                    raise AssertionError(f"fused stages --plans: {label} under {plan} differs from the plain version")
                ms = timer.ms(lambda: kernel(x, *args), iters=iters)
            rows.append((plan, ms))
            out(f"{label} batch {batch}: q {plan.q} nb {plan.nb} r {plan.r} bn {plan.bn} stages {plan.stages} "
                f"smem {plan.smem} blocks {plan.blocks}: {ms:.4f} ms{'  (block_plan)' if len(rows) == 1 else ''}")
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("fused_stages: needs a CUDA GPU", file=sys.stderr)
        return 1
    nums = [a for a in argv if not a.startswith("--")]
    if "--shapes" in argv:
        time_shapes(int(nums[0]) if nums else 32)
    elif "--plans" in argv or "--every" in argv:
        sweep_plans(int(nums[0]) if nums else 32, every="--every" in argv,
                    shapes=ALL_SHAPES if "--every" in argv else None)
    else:
        run_probe(int(nums[0]) if nums else 128)
    return 0


if __name__ == "__main__":
    sys.exit(main())
