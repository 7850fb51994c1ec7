"""K1 and B6 at the products the engines give them, on one GPU.

The products (``FC``, ``INT4_FC``, ``BATCHES``, ``IM2COL``), their work
(:func:`gemm_work`: bytes moved and operations) and the H100's bound
(:func:`bound_ms`) are kept here once: ``chip_smoke.py``'s kernel phase (its
bound for every kernel) and the tests read them from here.

By default the probe calls each product through its wrapper, as an engine
does: kernel K1 (``int8_matmul_nk``, f32 out) at the ResNet fc and at
AlexNet's fc1-3 at batches 1, 8, 32 and 128, its requant form
(``int8_matmul_requant_nk``) at the "gemm" backend's layer1 3x3 im2col
product, and kernel B6 (``int4_matmul_nk``, f32 out) at AlexNet's fc1-3.
For each it prints

- ``ms``: device time between CUDA events with the L2 cache flushed before
  every call (``utils.timing.Timer``);
- ``host_us``: the host's time per call of the wrapper (checks, plan,
  output allocation and launch), the median over rounds of 100 calls queued
  without a synchronisation;
- ``bound_ms``: the least time the card could take (the bytes of
  :func:`gemm_work` over 3.35 TB/s, or its int8 operations over 1979 TOP/s,
  whichever is larger);
- ``library_ms``: ``torch._int_mm``'s time on the same integer product (a
  yardstick only, on the unpacked int8 weights for B6; it refuses M <= 16).

This mode uses only the wrappers and ``Timer``, so it also times an older
checkout of the port with this file and ``utils/timing.py`` copied into it.

``--plans`` times, instead, K1 and B6 at a few of these products under
every launch plan the kernels take (split 1 to 8 of whole 128-byte stages,
ring depths 2 to 8, and tile 64 beside 128 at batch 128), each against
``gemm_plan``'s own choice: the sweep that chose the plan's rules.

Usage, on a GPU: ``python -m quantized_tpu_torch.probes.gemm_sweep
[--plans]``. Inputs come from ``numpy.random.default_rng(0)``. The last
line is one JSON object with every case. Exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same source
BATCHES = (1, 8, 32, 128)  # serving batches of the fc heads
# name: (N, K) of each engine's fc head
FC = {"resnet fc": (1000, 2048), "mobilenet fc": (1000, 1024), "alexnet fc1": (4096, 9216),
      "alexnet fc2": (4096, 4096), "alexnet fc3": (1000, 4096)}
INT4_FC = ("alexnet fc1", "alexnet fc2", "alexnet fc3")  # B6 runs AlexNet's int4 head
IM2COL = (32 * 56 * 56, 64, 9 * 64)  # (M, N, K): ResNet-50 layer1's 3x3 at batch 32 on the "gemm" backend


def gemm_work(m: int, n: int, k: int, packed: bool = False, s8_out: bool = False) -> Tuple[int, int]:
    """(bytes, operations) of one (M, K) x (N, K)^T product: each input byte
    read once (``packed`` weights: ceil(K/2) bytes a row; alpha and beta 8
    bytes a column), each output byte written once (f32, or s8), 2*M*N*K
    operations."""
    w_bytes = n * ((k + 1) // 2 if packed else k)
    return m * k + w_bytes + 8 * n + m * n * (1 if s8_out else 4), 2 * m * n * k


def bound_ms(nbytes: int, nops: int) -> Tuple[float, str]:
    """The larger of the bytes' time over HBM and the operations' time over
    the int8 tensor-core peak, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cases() -> List[Tuple[str, str, int, int, int]]:
    """(label, form, m, n, k) of the default run."""
    n, k = FC["resnet fc"]
    out = [("K1 resnet fc batch 32", "k1", 32, n, k)]
    out += [(f"K1 {fc} batch {b}", "k1", b, *FC[fc]) for fc in INT4_FC for b in BATCHES]
    out.append(("K1 requant im2col l1_3x3 batch 32", "k1 requant", *IM2COL))
    out += [(f"B6 {fc} batch {b}", "b6", b, *FC[fc]) for fc in INT4_FC for b in BATCHES]
    return out


def host_us(fn, calls: int = 100, rounds: int = 15) -> float:
    """Median host time of one call, in microseconds, over ``rounds`` rounds
    of ``calls`` calls each queued without a synchronisation (a round holds
    far fewer launches than the launch queue, so the host never waits on the
    device inside it)."""
    import torch

    for _ in range(10):
        fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def run(out=print) -> Dict[str, Dict]:
    import numpy as np
    import torch

    from quantized_tpu_torch import ops
    from quantized_tpu_torch.utils.timing import Timer

    dev = torch.device("cuda")
    timer = Timer(dev)
    rng = np.random.default_rng(0)
    results: Dict[str, Dict] = {}
    for label, form, m, n, k in cases():
        a = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(dev)
        alpha = torch.from_numpy((rng.uniform(0.5, 1.5, n) * 1e-4 / np.sqrt(k)).astype(np.float32)).to(dev)
        beta = torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32)).to(dev)
        if form == "b6":
            q = torch.from_numpy(rng.integers(-7, 8, (k, n), dtype=np.int8))
            w = ops.pack_int4(q).T.contiguous().to(dev)
            w_int8 = q.T.contiguous().to(dev)
            fn = lambda: ops.int4_matmul_nk(a, w, alpha, beta, relu=True)  # noqa: E731
        else:
            w = w_int8 = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(dev)
            if form == "k1":
                fn = lambda: ops.int8_matmul_nk(a, w, alpha, beta, relu=True)  # noqa: E731
            else:
                fn = lambda: ops.int8_matmul_requant_nk(a, w, alpha, beta, 0.05, 113, relu=True)  # noqa: E731
        ms = timer.ms(fn, iters=20, warmup=3)
        us = host_us(fn)
        lib = timer.ms(lambda: torch._int_mm(a, w_int8.T), iters=20, warmup=3) if m > 16 else None
        b_ms, b_by = bound_ms(*gemm_work(m, n, k, packed=form == "b6", s8_out=form == "k1 requant"))
        results[label] = dict(m=m, n=n, k=k, ms=ms, host_us=us, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        out(f"{label} {m}x{k}x{n}: ms {ms:.4f} host_us {us:.2f} bound_ms {b_ms:.4f} ({b_by}) x{ms / b_ms:.1f} "
            f"library_ms {lib if lib is None else round(lib, 4)}")
    return results


PLAN_CASES = [("K1 alexnet fc1 batch 32", "k1", 32, *FC["alexnet fc1"]),
              ("B6 alexnet fc1 batch 32", "b6", 32, *FC["alexnet fc1"]),
              ("K1 resnet fc batch 32", "k1", 32, *FC["resnet fc"]),
              ("B6 alexnet fc3 batch 1", "b6", 1, *FC["alexnet fc3"]),
              ("B6 alexnet fc1 batch 128", "b6", 128, *FC["alexnet fc1"]),
              ("K1 alexnet fc2 batch 128", "k1", 128, *FC["alexnet fc2"]),
              ("B6 alexnet fc2 batch 128", "b6", 128, *FC["alexnet fc2"]),
              ("K1 requant im2col l1_3x3 batch 32", "k1", *IM2COL)]


def plan_alternatives(m: int, n: int, k: int, packed: bool):
    """Every plan the kernels take for a product: tile (and 64 beside 128),
    split 1..8 over whole stages (none empty), ring depth 2, 4 or 8 (at most
    the split's stages), within the shared-memory limit."""
    from quantized_tpu_torch.ops.int8_matmul import GEMM_BK, SMEM_LIMIT, GemmPlan, gemm_plan, gemm_smem_bytes

    base = gemm_plan(m, n, k, packed=packed)
    kspan = (k + 1) // 2 if packed else k
    nk = -(-kspan // GEMM_BK)
    out = []
    for tile in sorted({base.tile, 64} if base.tile == 128 else {base.tile}):
        tiles = -(-n // 64) * -(-m // tile)
        for split in range(1, min(8, nk) + 1):
            steps = -(-nk // split)
            if -(-nk // steps) != split:
                continue
            for stages in sorted({min(steps, d) for d in (2, 4, 8)}):
                smem = gemm_smem_bytes(tile, packed, split, stages)
                if smem <= SMEM_LIMIT:
                    out.append(GemmPlan(tile, split, steps, stages, smem, split * tiles, base.tma_shape))
    return base, out if base in out else [base] + out


def run_plans(out=print) -> Dict[str, Dict]:
    """K1 and B6 (f32 out; the im2col product too, whose requant form
    shares its plan) under every plan of PLAN_CASES' products."""
    import numpy as np
    import torch

    from quantized_tpu_torch.ops.int4 import _INT4_MATMUL
    from quantized_tpu_torch.ops.int8_matmul import _MATMUL, gemm_route
    from quantized_tpu_torch.utils.timing import Timer

    dev = torch.device("cuda")
    timer = Timer(dev)
    rng = np.random.default_rng(0)
    results: Dict[str, Dict] = {}
    for label, form, m, n, k in PLAN_CASES:
        packed = form == "b6"
        a = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(dev)
        alpha = torch.full((n,), 1e-4, dtype=torch.float32, device=dev)
        beta = torch.zeros((n,), dtype=torch.float32, device=dev)
        y = torch.empty((m, n), dtype=torch.float32, device=dev)
        if packed:
            w = _packed_weights(rng, k, n).to(dev)

            def launch(plan):
                _INT4_MATMUL(dev, a.data_ptr(), w.data_ptr(), alpha.data_ptr(), beta.data_ptr(), y.data_ptr(),
                             m, n, w.shape[1], k, 1, 0, 0.0, 0.0, 0.0, int(gemm_route(plan, a, w) == "sm90"),
                             *plan.args())
        else:
            w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8)).to(dev)

            def launch(plan):
                _MATMUL(dev, a.data_ptr(), w.data_ptr(), alpha.data_ptr(), beta.data_ptr(), y.data_ptr(),
                        m, n, k, 1, int(gemm_route(plan, a, w) == "sm90"), *plan.args(), None, None)
        base, plans = plan_alternatives(m, n, k, packed)
        times = {}
        for plan in plans:
            times[plan] = timer.ms(lambda plan=plan: launch(plan), iters=20, warmup=3)
        best = min(times, key=times.get)
        warm = _back_to_back_ms(lambda: launch(base))
        out(f"{label} {m}x{k}x{n}: gemm_plan {tuple(base.args()[:4])} {times[base]:.4f} ms "
            f"(back to back, L2 warm: {warm:.4f} ms); best {tuple(best.args()[:4])} {times[best]:.4f} ms")
        for plan, ms in sorted(times.items(), key=lambda kv: kv[1]):
            out(f"  tile {plan.tile} split {plan.split} steps {plan.steps} stages {plan.stages} "
                f"blocks {plan.blocks}: {ms:.4f} ms")
        results[label] = {"gemm_plan": base.args(), "gemm_plan_ms": times[base], "warm_ms": warm,
                          "best": best.args(), "best_ms": times[best]}
    return results


def _back_to_back_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Mean device time of one launch within a CUDA graph of ``launches``
    launches in a row (no host time between them, no flush: the operands
    stay in L2 where they fit)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def _packed_weights(rng, k: int, n: int):
    """(N, K/2) split-half packed int4 weights on [-7, 7]."""
    import numpy as np
    import torch

    from quantized_tpu_torch import ops

    q = torch.from_numpy(rng.integers(-7, 8, (k, n), dtype=np.int8))
    return ops.pack_int4(q).T.contiguous()


def main(argv: List[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gemm_sweep: torch sees no CUDA GPU; this probe runs on one")
    results = run_plans() if "--plans" in argv else run()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card, "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
