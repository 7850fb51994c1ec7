"""Run one cell of ``BENCHMARK.json`` once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``: each number that
decides ``correct`` beside its limit); the last lines of standard error
give the same numbers. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics. Exits non-zero with no result where
there is no CUDA device or fewer than the cell asks for, and where, once
the window has closed, ``jax``, ``jaxlib``, ``flax`` or ``quantized_tpu``
(whole top-level names) is loaded in this process.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "quantized_tpu")


def forbidden_modules(names=None):
    """Top-level names among ``names`` (default: the loaded modules) that are
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted({name.split(".")[0] for name in (sys.modules if names is None else names)} & set(FORBIDDEN))


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import cell as cellmod
    from portbench import spec

    c = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {c.chips} CUDA device(s), this process sees {n}", file=sys.stderr)
        return 2
    cellmod.log(f"portbench: {args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace}")
    run = cellmod.Run(c, args.seed, args.seconds, bool(args.trace), "cuda")
    verdict = run.run()
    power = power_line()  # read after the window: set-up pays nothing for it
    cellmod.log(f"portbench: card {power}")
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    res = cellmod.result(run, verdict)
    res["device"]["power"] = power
    cellmod.log("portbench: phases (s) " + json.dumps({k: round(v, 3) for k, v in run.phases.items()}))
    cellmod.log("portbench: readings " + json.dumps(summary(run)))
    print(json.dumps(res), flush=True)
    for name, v in res["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


def summary(run) -> dict:
    """Scalar readings for the log (long series by their percentiles)."""
    from portbench.stats import percentile

    out = {}
    for k, v in run.readings.items():
        if isinstance(v, (int, float)):
            out[k] = v
        elif isinstance(v, dict) and k != "slice":
            out[k] = v
    for k, ps in (("lag_s", (50, 99)), ("latencies_ms", (50, 95, 99))):
        if k in run.readings:
            out[k] = {f"p{p}": percentile(run.readings[k], p) for p in ps}
    if "slice" in run.readings:
        out["slice"] = {k: run.readings["slice"][k] for k in ("window_s", "busy_s", "units")}
    return out


if __name__ == "__main__":
    sys.exit(main())
