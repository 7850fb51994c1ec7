"""Per-shape conv sweep on one GPU: where does ResNet-50's conv time go?

The port of the JAX package's ``bench/sweep_conv.py``. It times every
distinct conv shape of ResNet-50 (ImageNet geometry, NHWC, batch B) with
:func:`~quantized_tpu_torch.utils.timing.per_iter_time`, on these paths:

- ``direct``: kernel K2 (``int8_conv_direct``), int8 in, requant epilogue,
  int8 out;
- ``flat``: kernel B7 (``int8_conv_flat``), the same; stride 1 only, so a
  stride-2 shape prints a ``FAIL:ValueError`` cell, as the JAX script's
  does;
- ``gemm``: im2col and kernel K1's requant form (``int8_conv_gemm``), the
  same int8 in and out (the JAX script's ``gemm`` started from f32 images
  and quantized them first);
- ``bf16``: a cuDNN bf16 conv (``torch.nn.functional.conv2d``, channels
  last), the float cost model: a baseline only, never called by the port;
- ``xla``: the port's plain ``int8_conv_xla`` (exact int32 accumulation,
  f32 out), the path the JAX package left to XLA;
- ``intmm``: ``torch._int_mm`` on the 1x1 stride-1 shapes (the int32
  product only, no epilogue): the one PyTorch call that computes a conv's
  integer product on CUDA, the yardstick of rule 2 (``n/a`` elsewhere).

``i8io`` and ``b16io`` model TPU-resident layouts that only the JAX package
runs on a TPU; here each prints a refusal cell.

Each shape's inputs come from ``numpy.random.default_rng(0)`` as in the JAX
script (the float images only where ``bf16`` runs). The step passes its
carry through unchanged: PyTorch runs eagerly and writes every output, so
the JAX script's perturbation of the input by the carry (there to stop XLA
from reusing a result) has no counterpart. Prints ms per call, TOP/s and
the share of the H100's dense peaks (1979 int8 TOP/s and 989 bf16 TFLOP/s,
NVIDIA's data sheet), then each path's shape-count-weighted conv time of a
whole ResNet-50, and of its 1x1 stride-1 convs alone. With ``--host`` it
also prints, for the int8 paths, the host's time per wrapper call
(``host_us`` of ``probes/gemm_sweep.py``: checks, plan, output allocation
and launch). The default mode uses only the wrappers, so the file also
runs in an older checkout of the port for a parent-and-change comparison.

Usage, on a GPU: ``python -m quantized_tpu_torch.probes.sweep_conv [batch]
[modes] [--host] [--secs S]`` (defaults: 64, ``direct,flat,gemm,bf16``,
about 1 s a timed loop). It exits non-zero without one.
"""

from __future__ import annotations

import math
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from quantized_tpu_torch import ops
from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.utils.timing import PROBE_LOOPS, per_iter_time

INT8_PEAK_TOPS = 1979.0  # H100 SXM, dense, NVIDIA's data sheet
BF16_PEAK_TOPS = 989.0
DEFAULT_MODES = ("direct", "flat", "gemm", "bf16")
TPU_ONLY_MODES = ("i8io", "b16io")
ONE_BY_ONE_MODES = ("intmm",)  # defined on the 1x1 stride-1 shapes only
OUT_REQUANT = (0.05, 128)
STORED_ZP = 0

# (name, H, Cin, Cout, k, stride, count in ResNet-50)
SHAPES = [
    ("stem7x7", 224, 3, 64, 7, 2, 1),
    ("l1_1x1a", 56, 64, 64, 1, 1, 2),
    ("l1_3x3", 56, 64, 64, 3, 1, 3),
    ("l1_1x1b", 56, 64, 256, 1, 1, 3),
    ("l1_1x1c", 56, 256, 64, 1, 1, 2),
    ("l1_ds", 56, 64, 256, 1, 1, 1),
    ("l2_1x1a", 56, 256, 128, 1, 1, 1),
    ("l2_3x3s2", 56, 128, 128, 3, 2, 1),
    ("l2_1x1b", 28, 128, 512, 1, 1, 4),
    ("l2_1x1c", 28, 512, 128, 1, 1, 3),
    ("l2_3x3", 28, 128, 128, 3, 1, 3),
    ("l2_ds", 56, 256, 512, 1, 2, 1),
    ("l3_1x1a", 28, 512, 256, 1, 1, 1),
    ("l3_3x3s2", 28, 256, 256, 3, 2, 1),
    ("l3_1x1b", 14, 256, 1024, 1, 1, 6),
    ("l3_1x1c", 14, 1024, 256, 1, 1, 5),
    ("l3_3x3", 14, 256, 256, 3, 1, 5),
    ("l3_ds", 28, 512, 1024, 1, 2, 1),
    ("l4_1x1a", 14, 1024, 512, 1, 1, 1),
    ("l4_3x3s2", 14, 512, 512, 3, 2, 1),
    ("l4_1x1b", 7, 512, 2048, 1, 1, 3),
    ("l4_1x1c", 7, 2048, 512, 1, 1, 2),
    ("l4_3x3", 7, 512, 512, 3, 1, 2),
    ("l4_ds", 14, 1024, 2048, 1, 2, 1),
]


INT8_PATHS = {"direct": ops.int8_conv_direct_ck, "flat": ops.int8_conv_flat_ck, "gemm": ops.int8_conv_gemm_ck}


def _step(mode: str, k: int, stride: int, pad: int, inputs: Dict[str, torch.Tensor]):
    """(step(carry, *args), args) of one path on one shape; the step runs
    the conv and passes the carry through."""
    if mode in INT8_PATHS:
        conv = INT8_PATHS[mode]
        fn = lambda x, w, a, b: conv(x, w, (k, k), a, b, stride, pad, STORED_ZP, True, OUT_REQUANT)  # noqa: E731
        args = (inputs["x_q8"], inputs["w_ck"], inputs["alpha"], inputs["beta"])
    elif mode == "xla":
        fn = lambda x, w, a, b: ops.int8_conv_xla(x, w, a, b, stride, pad, STORED_ZP, relu=True)  # noqa: E731
        args = (inputs["x_q8"], inputs["w_q"], inputs["alpha"], inputs["beta"])
    elif mode == "intmm":
        fn = lambda x, w: torch._int_mm(x.reshape(-1, x.shape[-1]), w.T)  # noqa: E731
        args = (inputs["x_q8"], inputs["w_ck"])
    elif mode == "bf16":
        fn = lambda x, w: F.conv2d(x, w, stride=stride, padding=pad)  # noqa: E731
        args = (inputs["x_bf16"], inputs["w_bf16"])
    else:
        raise ValueError(f"unknown mode {mode!r}: the port runs {sorted(INT8_PATHS) + ['bf16', 'intmm', 'xla']}")

    def step(carry, *a):
        fn(*a)
        return carry

    return step, args


def _inputs(rng: np.random.Generator, batch: int, h: int, cin: int, cout: int, k: int, need_float: bool,
            device: torch.device) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if need_float:
        x = torch.from_numpy(rng.standard_normal((batch, h, h, cin), dtype=np.float32))
        w = torch.from_numpy(rng.standard_normal((k, k, cin, cout), dtype=np.float32) * 0.05)
        out["x_bf16"] = x.to(device, torch.bfloat16).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        out["w_bf16"] = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last).to(device, torch.bfloat16)
    w_q = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8))
    out["w_q"] = w_q.to(device)
    out["w_ck"] = ops.pack_conv_weight(w_q).to(device)
    out["alpha"] = torch.full((cout,), 1e-4, dtype=torch.float32, device=device)
    out["beta"] = torch.zeros((cout,), dtype=torch.float32, device=device)
    out["x_q8"] = torch.from_numpy(rng.integers(-128, 128, (batch, h, h, cin), dtype=np.int8)).to(device)
    return out


def run_sweep(batch: int = 64, modes: Sequence[str] = DEFAULT_MODES, target_secs: float = 1.0, reps: int = 3,
              probe_loops: int = PROBE_LOOPS, device: DeviceLike = "cuda",
              shapes: Optional[List[Tuple]] = None, host: bool = False,
              out: Callable[[str], None] = print) -> Dict[str, Dict[str, float]]:
    """Time every shape on every mode and print the table; returns
    {mode: {shape name: seconds per call, nan where the path refused or is
    not defined}}; with ``host``, also {"host_us " + mode: {shape: us}} for
    the int8 paths."""
    dev = resolve_device(device)
    shapes = SHAPES if shapes is None else shapes
    rng = np.random.default_rng(0)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out(f"device={name} batch={batch} modes={list(modes)}")
    out(f"{'shape':>9} {'HxCinxCout':>14} {'GOPs':>7} | " + " | ".join(f"{m:>5}: ms TOPS %pk" for m in modes))
    times: Dict[str, Dict[str, float]] = {m: {} for m in modes}
    for shape, h, cin, cout, k, s, _ in shapes:
        pad = k // 2 if k > 1 else 0
        ho = (h + 2 * pad - k) // s + 1
        gops = 2.0 * batch * ho * ho * k * k * cin * cout / 1e9
        inputs = _inputs(rng, batch, h, cin, cout, k, "bf16" in modes, dev)
        cells = []
        for mode in modes:
            if mode in TPU_ONLY_MODES or (mode in ONE_BY_ONE_MODES and (k, s) != (1, 1)):
                cells.append(f"{'TPU only' if mode in TPU_ONLY_MODES else 'n/a':>17}")
                times[mode][shape] = math.nan
                continue
            step, args = _step(mode, k, s, pad, inputs)
            try:
                dt = per_iter_time(step, *args, target_secs=target_secs, reps=reps, probe_loops=probe_loops)
            except ValueError as exc:  # B7 refuses stride 2
                cells.append(f"FAIL:{type(exc).__name__[:12]:>12}")
                times[mode][shape] = math.nan
                continue
            tops = gops / dt / 1e3
            peak = BF16_PEAK_TOPS if mode == "bf16" else INT8_PEAK_TOPS
            cells.append(f"{dt * 1e3:>7.3f} {tops:>5.1f} {100 * tops / peak:>3.0f}%")
            times[mode][shape] = dt
            if host and mode in INT8_PATHS:
                from quantized_tpu_torch.probes.gemm_sweep import host_us

                us = host_us(lambda step=step, args=args: step(None, *args))
                times.setdefault(f"host_us {mode}", {})[shape] = us
                cells[-1] += f" host {us:6.2f} us"
        out(f"{shape:>9} {h:>4}x{cin:>4}x{cout:>4} {gops:>7.2f} | " + " | ".join(cells))
    out(f"whole-ResNet50 conv time (sum of shape x count), ms/batch of {batch}; nan where a shape refused:")
    counts = {row[0]: row[6] for row in shapes}
    for mode in modes:
        per_shape = times[mode]
        t = sum(per_shape[sh] * counts[sh] for sh in per_shape)
        out(f"  {mode:>5}: {t * 1e3:8.3f} ms  -> {batch / t if t > 0 else math.nan:9.0f} img/s (conv-only bound)")
    out(f"its 1x1 stride-1 convs alone, ms/batch of {batch}:")
    one_by_one = [row[0] for row in shapes if (row[4], row[5]) == (1, 1)]
    for mode in modes:
        t = sum(times[mode][sh] * counts[sh] for sh in one_by_one)
        out(f"  {mode:>5}: {t * 1e3:8.3f} ms")
    return times


def main(argv: Sequence[str]) -> int:
    if not torch.cuda.is_available():
        print("sweep_conv: torch sees no CUDA GPU; this probe runs on one", file=sys.stderr)
        return 1
    host = "--host" in argv
    argv = [a for a in argv if a != "--host"]
    secs = 1.0
    if "--secs" in argv:
        i = argv.index("--secs")
        secs = float(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    batch = int(argv[0]) if argv else 64
    modes = argv[1].split(",") if len(argv) > 1 else list(DEFAULT_MODES)
    torch.backends.cudnn.allow_tf32 = False
    run_sweep(batch, modes, target_secs=secs, host=host)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
