"""Device time of B5 (``fused_dw_pw``) at every distinct pair shape of
MobileNet-v1 (widths 1.0, 0.75 and 0.25) and of K2's gather-K form at every
gather-K shape of the engines (the stems of ResNet, MobileNet and AlexNet,
CIFAR ResNet-20's stem and its 3x3 convs over Cin 16 and 32), at one batch.

Each call goes through its wrapper alone, so a copy of this file (and of
``utils/timing.py``) runs in a checkout of an earlier commit too: a
parent-and-change comparison. Every output is first held equal to its plain
version on the card; the time is :class:`~quantized_tpu_torch.utils.timing.Timer`'s
device time (L2 flushed), printed beside the bound (``probes/gemm_sweep``
``bound_ms``: the bytes each input is read and each output written once
over 3.35 TB/s, or the int8 operations over 1979 TOP/s) and the route the
launch took (``none`` where the kernel counts no routes).

With ``--plans`` it times B5 instead under every cluster size that
``dw_pw_plan`` weighs at each pair shape (the plan's own first), each held
equal to the plain version: what the plan's choice of q is worth.

Usage, on a GPU: ``python -m quantized_tpu_torch.probes.pair_stem [batch]
[--plans]`` (default 32). It exits non-zero without one.
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np
import torch

from quantized_tpu_torch import ops
from quantized_tpu_torch._device import resolve_device
from quantized_tpu_torch.probes.gemm_sweep import bound_ms
from quantized_tpu_torch.utils.timing import Timer

# label, input side, C, Cout, stride
PAIRS = [
    ("w1.0 pair 0", 112, 32, 64, 1), ("w1.0 pair 1", 112, 64, 128, 2), ("w1.0 pair 2", 56, 128, 128, 1),
    ("w1.0 pair 3", 56, 128, 256, 2), ("w1.0 pair 4", 28, 256, 256, 1), ("w1.0 pair 5", 28, 256, 512, 2),
    ("w1.0 pairs 6-10", 14, 512, 512, 1), ("w1.0 pair 11", 14, 512, 1024, 2),
    ("w0.75 pair 0", 112, 24, 48, 1), ("w0.75 pair 1", 112, 48, 96, 2), ("w0.75 pair 2", 56, 96, 96, 1),
    ("w0.75 pair 3", 56, 96, 192, 2), ("w0.75 pair 4", 28, 192, 192, 1), ("w0.75 pair 5", 28, 192, 384, 2),
    ("w0.75 pairs 6-10", 14, 384, 384, 1), ("w0.75 pair 11", 14, 384, 768, 2),
    ("w0.25 pair 0", 112, 8, 16, 1),
]
# label, input side, Cin, Cout, kernel, stride, padding
STEMS = [
    ("s2d stem 4x4 12->64", 115, 12, 64, 4, 1, 0), ("mobilenet stem 3x3 s2 3->32", 224, 3, 32, 3, 2, 1),
    ("mobilenet w0.75 stem 3x3 s2 3->24", 224, 3, 24, 3, 2, 1), ("alexnet conv1 11x11 s4 3->64", 224, 3, 64, 11, 4, 2),
    ("cifar stem 3x3 3->16", 32, 3, 16, 3, 1, 1), ("cifar 3x3 16->16", 32, 16, 16, 3, 1, 1),
    ("cifar 3x3 s2 16->32", 32, 16, 32, 3, 2, 1), ("cifar 3x3 32->32", 16, 32, 32, 3, 1, 1),
    ("cifar 3x3 s2 32->64", 16, 32, 64, 3, 2, 1),
]
DW_PW_SCALARS = (-21.0, -9.0, -17)  # lo1, lo2, the depthwise padding's stored zero point


def window_extent(size: int, out: int, k: int, stride: int, pad: int) -> int:
    """Input rows (or columns) that a conv's windows read."""
    return len({o * stride - pad + t for o in range(out) for t in range(k)} & set(range(size)))


def pair_inputs(rng, batch, h, c, cout, device):
    """x, K-major weights (depthwise (C, 9), pointwise (Cout, C)) and the four
    epilogue vectors, scaled so both requants land inside the int8 range."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    x = t(rng.integers(-128, 128, (batch, h, h, c)).astype(np.int8))
    wdw = t(rng.integers(-127, 128, (c, 9)).astype(np.int8))
    wpw = t(rng.integers(-127, 128, (cout, c)).astype(np.int8))
    vecs = [t((rng.uniform(0.5, 1.5, c) * 4e-2 / 3).astype(np.float32)), t(rng.uniform(-8, 8, c).astype(np.float32)),
            t((rng.uniform(0.5, 1.5, cout) * 6e-3 / np.sqrt(c)).astype(np.float32)),
            t(rng.uniform(-8, 8, cout).astype(np.float32))]
    return x, wdw, wpw, vecs


def pair_work(batch, h, c, cout, s):
    """(bytes, operations) of one pair: x, the output, the weights and the
    epilogue vectors once; 2 (9 C + C Cout) operations an output pixel."""
    ho = h // s
    return (batch * h * h * c + batch * ho * ho * cout + 9 * c + c * cout + 8 * (c + cout),
            2 * batch * ho * ho * (9 * c + c * cout))


def stem_work(batch, h, cin, cout, k, s, p):
    ho = (h + 2 * p - k) // s + 1
    rows = window_extent(h, ho, k, s, p)
    return batch * rows * rows * cin + cout * k * k * cin + 8 * cout + batch * ho * ho * cout, \
        2 * batch * ho * ho * k * k * cin * cout


def _route(name, before):
    now = ops.KERNELS[name].routes
    taken = [r for r in now if now[r] != before.get(r, 0)]
    return taken[0] if len(taken) == 1 else "none"


def _check(got, want, label):
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: the kernel differs from its plain version")


def run_probe(batch: int = 32, out: Callable[[str], None] = print, iters: int = 10):
    dev = resolve_device("cuda")
    timer = Timer(dev)
    rng = np.random.default_rng(0)
    times = {}
    for label, h, c, cout, s in PAIRS:
        x, wdw, wpw, v = pair_inputs(rng, batch, h, c, cout, dev)
        before = dict(ops.KERNELS["fused_dw_pw"].routes)
        got = ops.fused_dw_pw_ck(x, wdw, wpw, *v, s, *DW_PW_SCALARS)
        route = _route("fused_dw_pw", before)
        _check(got, ops.fused_dw_pw_plain(x, wdw, wpw, *v, s, *DW_PW_SCALARS), label)
        ms = timer.ms(lambda: ops.fused_dw_pw_ck(x, wdw, wpw, *v, s, *DW_PW_SCALARS), iters=iters)
        b_ms, b_by = bound_ms(*pair_work(batch, h, c, cout, s))
        times[label] = ms
        out(f"B5 {label} batch {batch} {h}x{h} {c}->{cout} s{s}: ms {ms:.4f} bound_ms {b_ms:.4f} ({b_by}) "
            f"route {route}")
    for label, h, cin, cout, k, s, p in STEMS:
        x = torch.from_numpy(rng.integers(-128, 128, (batch, h, h, cin)).astype(np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (cout, k * k * cin)).astype(np.int8)).to(dev)
        alpha = torch.from_numpy((rng.uniform(0.5, 1.5, cout) * 1e-3 / np.sqrt(k * k * cin)).astype(np.float32)).to(dev)
        beta = torch.from_numpy(rng.uniform(-0.1, 0.1, cout).astype(np.float32)).to(dev)
        args = ((k, k), alpha, beta, s, p, -5, True, (0.05, 113))
        before = dict(ops.KERNELS["int8_conv_direct_gatherk"].routes)
        got = ops.int8_conv_direct_ck(x, w, *args)
        route = _route("int8_conv_direct_gatherk", before)
        _check(got, ops.int8_conv_direct_plain(x, w, *args), label)
        ms = timer.ms(lambda: ops.int8_conv_direct_ck(x, w, *args), iters=iters)
        b_ms, b_by = bound_ms(*stem_work(batch, h, cin, cout, k, s, p))
        times[label] = ms
        out(f"K2 gather-K {label} batch {batch} {h}x{h}: ms {ms:.4f} bound_ms {b_ms:.4f} ({b_by}) route {route}")
    return times


def time_plans(batch: int = 32, out: Callable[[str], None] = print, iters: int = 10):
    """B5 under every cluster size the plan weighs at each pair shape."""
    from quantized_tpu_torch.ops import fused_block as fb
    from quantized_tpu_torch.ops.int8_matmul import f32

    dev = resolve_device("cuda")
    timer = Timer(dev)
    rng = np.random.default_rng(0)
    for label, h, c, cout, s in PAIRS:
        plan = fb.dw_pw_plan(batch, h, h, c, cout, s)
        if plan.route != "sm90":
            continue
        x, wdw, wpw, v = pair_inputs(rng, batch, h, c, cout, dev)
        want = ops.fused_dw_pw_plain(x, wdw, wpw, *v, s, *DW_PW_SCALARS)
        cp, coutp = plan.c, plan.cout  # the widths the kernel computes (C 24 and 8: 32 and 16, unclustered)
        qs = [plan.q] + [q for q in fb.BLOCK_QS if q != plan.q and cp == c and cp % q == 0 and coutp % q == 0 and
                         (cp // q) % 16 == 0 and cp // q <= fb.DW_PW_MAX_CS and coutp // q in fb.DW_PW_NS]
        for q in qs:
            smem = fb.dw_pw_sm90_smem_bytes(cp, coutp, q, h, s, plan.tho, plan.nb, c)
            if smem > fb.SMEM_PER_BLOCK:
                continue
            per_sm = min(3 if coutp // q <= 64 else 2, fb.SMEM_PER_SM // (smem + 1024))
            clusters = min(plan.tiles, fb.resident_clusters(q, per_sm))
            p = plan._replace(q=q, smem=smem, clusters=clusters, blocks=q * clusters, per_sm=per_sm)
            outp = torch.empty_like(want)

            def run(p=p, outp=outp):
                fb.DW_PW(dev, x.data_ptr(), wdw.data_ptr(), wpw.data_ptr(), *(t.data_ptr() for t in v),
                         outp.data_ptr(), batch, h, h, c, cout, s, p.tho, DW_PW_SCALARS[2], f32(DW_PW_SCALARS[0]),
                         f32(DW_PW_SCALARS[1]), *p.args(), route="sm90")
                return outp

            _check(run(), want, f"{label} q {q}")
            ms = timer.ms(run, iters=iters)
            out(f"B5 plans {label} batch {batch}: q {q} clusters {clusters} per_sm {per_sm} smem {smem}: "
                f"ms {ms:.4f}{' (the plan)' if q == plan.q else ''}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    nums = [a for a in argv if not a.startswith("--")]
    batch = int(nums[0]) if nums else 32
    if "--plans" in argv:
        time_plans(batch)
    else:
        run_probe(batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
