"""Spawns a torch.distributed gloo group of rank processes on the CPU for
the port's distribution tests, and collects what each rank returns.

The test writes a job (case names and numpy inputs) with pickle; each rank
runs ``tests/torch_dist_worker.py <rank> <world> <port> <dir>``, which
imports torch and the port only (no JAX), joins the group over
``tcp://localhost:<port>``, runs the job's cases in order and pickles a
dict {case: result}. A rank that fails writes its traceback instead.
Pickles are read only from the directory the test made.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """A started group of ``world`` rank processes; :meth:`results` waits
    for them."""

    def __init__(self, world: int, job: dict, workdir: Path):
        self.world, self.dir = world, Path(workdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        with open(self.dir / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
        port = str(free_port())
        self.procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), port, str(self.dir)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                                       cwd=ROOT) for r in range(world)]

    def results(self, timeout: float = 300):
        """[per-rank {case: result}], the processes' exit codes and output."""
        outs = []
        for p in self.procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                raise
        codes = [p.returncode for p in self.procs]
        paths = [self.dir / f"rank{r}.pkl" for r in range(self.world)]
        results = [pickle.loads(p.read_bytes()) if p.exists() else {} for p in paths]
        return results, codes, outs
