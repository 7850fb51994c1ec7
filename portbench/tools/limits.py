"""The readings that a cell's limits are set from, in one process: the
numbers that decide ``correct`` for sound runs of the program on many
seeds, and for the control, the program's own int4-weight path, on a few.
Each run drives the cell's own window (its traffic, at its sizes) for
``--seconds`` and compares what it produced with the reference.

    python3 -m portbench.tools.limits --workload resnet50.offline --seconds 3 \\
        --seeds 101-112 --control-seeds 201-203

Prints one JSON line per run and a summary (largest sound reading,
smallest control reading, their ratio) as the last line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import cell as cellmod
from portbench import spec


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def one(c, seed: int, seconds: float, device, overrides) -> dict:
    run = cellmod.Run(c, seed, seconds, False, device, overrides)
    verdict = run.run()
    out = {"seed": seed, "weight_bits": run.weight_bits, "correct": verdict["correct"],
           **{k: v["value"] for k, v in verdict["compared"].items()}, "attempted": run.attempted}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", default="101-112")
    p.add_argument("--control-seeds", default="201-203")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    c = spec.cell(a.workload)
    sound = [one(c, s, a.seconds, a.device, None) for s in seeds(a.seeds)]
    control = [one(c, s, a.seconds, a.device, {"weight_bits": 4}) for s in seeds(a.control_seeds)]
    summary = {"workload": a.workload, "card": torch.cuda.get_device_name() if a.device == "cuda" else "cpu"}
    for k in ("logit_gap_max", "logit_gap_mean"):
        lo = max(r[k] for r in sound)
        hi = min(r[k] for r in control) if control else float("nan")
        summary[k] = {"sound_max": lo, "control_min": hi, "ratio": hi / lo if lo > 0 else float("inf")}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
