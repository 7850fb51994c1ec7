"""Find the knee of a served cell: its traffic at each of several rates,
one window each, in one process (set-up once).

    python3 -m portbench.tools.sweep --workload resnet50.serve --seconds 8 \\
        --rates 4000,6000,8000,10000,12000

For each rate one JSON line: the offered and the answered img/s, p50 and
p95 from due time to answer, the backlog when the last burst was sent
(requests sent and not yet answered), and p95 over the window's last
quarter of requests against its first quarter. A rate holds where the
backlog stays under the largest bucket and the last quarter's p95 stays
within twice the first's.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from portbench import cell as cellmod
from portbench import spec
from portbench.stats import percentile
from portbench.traffic import open_bursts


def stage_means(before: dict, after: dict) -> dict:
    """The batcher's per-batch stage means and occupancy over one window."""
    nb = after["batches"] - before["batches"]
    if nb <= 0:
        return {}
    out = {k: (after[k] * after["batches"] - before[k] * before["batches"]) / nb
           for k in after if k.startswith("stage_")}
    rows = after["requests"] / after["occupancy"] - before["requests"] / max(before["occupancy"], 1e-12)
    out.update(batches=nb, occupancy=(after["requests"] - before["requests"]) / rows)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="resnet50.serve")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", default="4000,6000,8000,10000,12000")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    run = cellmod.Run(spec.cell(a.workload), a.seed, a.seconds, False, a.device)
    run.build()
    pool = open_bursts.setup(run)
    top = max(run.mix["buckets"])
    for rate in (float(x) for x in a.rates.split(",")):
        before = run.batcher.stats()
        reqs, due, _, n, lag = open_bursts.window(run, pool, a.seconds, rate=rate)
        done, due = reqs.done[:n], due[:n]
        lat = np.where(np.isfinite(done), (done - due) * 1e3, np.inf)
        last_sent = due[-1]
        backlog = int(np.sum(~(done <= last_sent)))
        q = max(1, n // 4)
        answered = np.isfinite(done)
        out = {"rate": rate, "requests": n, "answered_img_per_s": float(answered.sum() / (np.nanmax(done) - due[0])),
               "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
               "backlog_at_last_send": backlog, "p95_first_quarter_ms": percentile(lat[:q], 95),
               "p95_last_quarter_ms": percentile(lat[-q:], 95), "lag_p99_ms": 1e3 * percentile(lag, 99),
               "holds": bool(backlog < top and percentile(lat[-q:], 95) <= 2 * percentile(lat[:q], 95)),
               "batcher": stage_means(before, run.batcher.stats())}
        print(json.dumps(out), flush=True)
    run.batcher.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
