"""Device time of K2's residual form (B8) and of its 1x1s over Cin % 16 != 0
(MobileNet-v1's first pointwise conv at widths 0.75 and 0.25), each beside
K2 on the same inputs without the residual, the first tile's general kernel
on the same inputs (launched directly) and, for a 1x1, ``torch._int_mm`` on
the same integer product (a yardstick; the port never calls it); then, as a
control whose kernel code the residual form does not touch, K2's and B7's
1x1 64 -> 256 f32.

Each call goes through its wrapper, so a copy of this file (and of
``utils/timing.py``) runs in a checkout of an earlier commit too: a
parent-and-change comparison (there the wrappers take the tile where this
tree takes the mainloop). Every output is first held equal to its plain
version on the card, and the tile's to the call's; times are
:class:`~quantized_tpu_torch.utils.timing.Timer`'s device time (L2 flushed)
beside the bound (``probes/gemm_sweep`` ``bound_ms``), with the route the
call took. It also prints the ptxas line of every residual kernel instance
of this build (``Lb1ELb0E`` in the mangled name: the RES flag, without CLIP).

Usage, on a GPU: ``python -m quantized_tpu_torch.probes.conv_forms [batch]``
(default 32). It exits non-zero without one.
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np
import torch

from quantized_tpu_torch import ops
from quantized_tpu_torch._device import resolve_device
from quantized_tpu_torch.ops import _cuda
from quantized_tpu_torch.ops import int8_conv_pallas as cp
from quantized_tpu_torch.probes.gemm_sweep import bound_ms
from quantized_tpu_torch.utils.timing import Timer

RES_GRID, REQ = (0.03, 117), (0.06, 105)
# label, input side, Cin, Cout, kernel, requant: ResNet-18's conv2 + identity at
# layer1 and layer3, and ResNet-50's layer1 conv3 + identity (128-channel tiles)
RESIDUAL = [
    ("layer1 3x3 56x56 64 s8", 56, 64, 64, 3, REQ), ("layer1 3x3 56x56 64 f32", 56, 64, 64, 3, None),
    ("layer3 3x3 14x14 256 s8", 14, 256, 256, 3, REQ), ("layer3 3x3 14x14 256 f32", 14, 256, 256, 3, None),
    ("layer1 1x1 56x56 64->256 s8", 56, 64, 256, 1, REQ),
]
# label, input side, Cin, Cout: the narrow pointwise convs (s8 out)
NARROW = [("w0.75 pw 1x1 112x112 24->48", 112, 24, 48), ("w0.25 pw 1x1 112x112 8->16", 112, 8, 16)]


def _conv_inputs(rng, batch, h, cin, cout, k, dev):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    x = t(rng.integers(-128, 128, (batch, h, h, cin)).astype(np.int8))
    w = t(rng.integers(-127, 128, (cout, k * k * cin)).astype(np.int8))
    alpha = t((rng.uniform(0.5, 1.5, cout) * 1e-3 / np.sqrt(k * k * cin)).astype(np.float32))
    beta = t(rng.uniform(-0.1, 0.1, cout).astype(np.float32))
    return x, w, alpha, beta


def _tile(x, w, ks, alpha, beta, pad, zp, relu, req, residual=None):
    """K2's general tile (the per-tap or residual form) on these inputs."""
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    ho, wo = cp.conv_out_hw(h, wd, ks, (1, 1), (pad, pad))
    out, out_int8, inv, zps = cp._requant_args(req, (n, ho, wo, cout), x.device)
    kernel, r_ptr, r_off, r_scale = cp.CONV_TAP, None, 0.0, 0.0
    if residual is not None:
        kernel, r_ptr = cp.CONV_RESIDUAL, residual.data_ptr()
        r_off, r_scale = cp.f32(128 - RES_GRID[1]), cp.f32(RES_GRID[0])

    def run():
        kernel(x.device, x.data_ptr(), w.data_ptr(), alpha.data_ptr(), beta.data_ptr(), r_ptr, None, out.data_ptr(),
               n, h, wd, cin, cout, ks[0], ks[1], 1, 1, pad, pad, ho, wo, zp, int(relu), out_int8, inv, zps, r_off,
               r_scale, *([0] * len(cp.CONV_PLAN_ARGS)), None, None, route="tile")
        return out
    return run


def _route(name, before):
    now = ops.KERNELS[name].routes
    taken = [r for r in now if now[r] != before.get(r, 0)]
    return taken[0] if len(taken) == 1 else "none"


def _check(got, want, label):
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: outputs differ")


def res_ptxas(out: Callable[[str], None] = print):
    """The residual instances' ptxas lines from this build of int8_conv.cu."""
    _cuda.build_kernels(["int8_conv.cu"])
    name = None
    for line in _cuda.BUILD_LOGS.get("int8_conv.cu", "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "conv_sm90_kernel" in name and "ELb1ELb0EE" in name and ("Used" in line or "spill" in line):
            out(f"ptxas {name.split('conv_sm90_kernel')[1].split('EEEv')[0]}: {line.strip()}")


def run_probe(batch: int = 32, out: Callable[[str], None] = print, iters: int = 10):
    dev = resolve_device("cuda")
    timer = Timer(dev)
    rng = np.random.default_rng(0)
    res_ptxas(out)
    times = {}
    for label, h, cin, cout, k, req in RESIDUAL:
        x, w, alpha, beta = _conv_inputs(rng, batch, h, cin, cout, k, dev)
        r = torch.from_numpy(rng.integers(-128, 128, (batch, h, h, cout)).astype(np.int8)).to(dev)
        pad = k // 2
        args = ((k, k), alpha, beta, 1, pad, -5, True, req)
        kw = dict(residual=r, res_grid=RES_GRID)
        bs = ops.conv_border_sums(w, (k, k))  # once per weight, as the engines compute it
        before = dict(ops.KERNELS["int8_conv_direct_residual"].routes)
        got = ops.int8_conv_direct_ck(x, w, *args, **kw, border_sums=bs)
        route = _route("int8_conv_direct_residual", before)
        _check(got, ops.int8_conv_direct_plain(x, w, *args, **kw), label)
        tile = _tile(x, w, (k, k), alpha, beta, pad, -5, True, req, r)
        _check(tile(), got, f"{label} tile")
        ms = timer.ms(lambda: ops.int8_conv_direct_ck(x, w, *args, **kw, border_sums=bs), iters=iters)
        k2_ms = timer.ms(lambda: ops.int8_conv_direct_ck(x, w, *args, border_sums=bs), iters=iters)
        tile_ms = timer.ms(tile, iters=iters)
        out_bytes = batch * h * h * cout * (1 if req else 4)
        b_ms, b_by = bound_ms(x.numel() + w.numel() + 8 * cout + r.numel() + out_bytes,
                              2 * batch * h * h * k * k * cin * cout)
        times[f"B8 {label}"] = ms
        out(f"B8 {label} batch {batch}: ms {ms:.4f} route {route}; K2 without the residual {k2_ms:.4f} (ratio "
            f"{ms / k2_ms:.2f}); the tile {tile_ms:.4f} (ratio {ms / tile_ms:.2f}); bound_ms {b_ms:.4f} ({b_by})")
    for label, h, cin, cout in NARROW:
        x, w, alpha, beta = _conv_inputs(rng, batch, h, cin, cout, 1, dev)
        args = ((1, 1), alpha, beta, 1, 0, -5, True, (0.05, 113))
        group = getattr(ops, "pixel_group_operands", None)  # absent before the pixel-group route
        kw = {} if group is None else dict(pixel_groups=group(w, alpha, beta))
        before = dict(ops.KERNELS["int8_conv_direct"].routes)
        got = ops.int8_conv_direct_ck(x, w, *args, **kw)
        route = _route("int8_conv_direct", before)
        _check(got, ops.int8_conv_direct_plain(x, w, *args), label)
        tile = _tile(x, w, (1, 1), alpha, beta, 0, -5, True, (0.05, 113))
        _check(tile(), got, f"{label} tile")
        ms = timer.ms(lambda: ops.int8_conv_direct_ck(x, w, *args, **kw), iters=iters)
        tile_ms = timer.ms(tile, iters=iters)
        try:
            lib = timer.ms(lambda: torch._int_mm(x.reshape(-1, cin), w.T), iters=iters)
        except RuntimeError:  # it refuses K = 8
            lib = None
        b_ms, b_by = bound_ms(x.numel() * (1 + cout / cin) + w.numel() + 8 * cout, 2 * x.numel() * cout)
        times[f"K2 {label}"] = ms
        out(f"K2 {label} batch {batch}: ms {ms:.4f} route {route}; the tile {tile_ms:.4f} (ratio "
            f"{ms / tile_ms:.2f}); torch._int_mm {'refused' if lib is None else f'{lib:.4f}'}; bound_ms {b_ms:.4f} "
            f"({b_by})")
    x, w, alpha, beta = _conv_inputs(rng, batch, 56, 64, 256, 1, dev)
    args = ((1, 1), alpha, beta, 1, 0, -5, True, None)
    for label, fn in (("K2", ops.int8_conv_direct_ck), ("B7", ops.int8_conv_flat_ck)):
        got = fn(x, w, *args)
        torch.testing.assert_close(got, ops.int8_conv_direct_plain(x, w, *args), atol=1e-3, rtol=0)
        ms = [timer.ms(lambda fn=fn: fn(x, w, *args), iters=iters) for _ in range(3)]
        times[f"{label} control"] = min(ms)
        out(f"{label} 1x1 56x56 64->256 f32 batch {batch} (control): ms {' '.join(f'{v:.4f}' for v in ms)}")
    return times


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run_probe(int(argv[0]) if argv else 32)
    return 0


if __name__ == "__main__":
    sys.exit(main())
