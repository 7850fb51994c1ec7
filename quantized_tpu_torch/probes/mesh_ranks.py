"""One rank of the mesh serving check: ``python -m
quantized_tpu_torch.probes.mesh_ranks <dir>``, started once per device with
torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``; one process needs none). ``chip_smoke.py``'s
"mesh" phase starts it on every GPU, NCCL between them; ``device: "cpu"``
in the job runs it on gloo, to rehearse the script on a small model.

``<dir>/job.pt`` (written by the caller, loaded whole) holds the device,
the model degree, the engines by name, a uint8 batch, the requests, the
serving buckets and the timed iterations. The rank:

1. checks an all-gather, a reduce-scatter and an all-reduce over each mesh
   axis against what each rank sent;
2. for each engine, forwards the batch through ``IntExecutor(mesh=...)``
   once eagerly with the kernel launches and collectives counted, then
   through graph executors (one CUDA graph per shape, the collectives
   captured in it), the mesh's and a single-device one's: the logits must
   be equal, bit for bit; times both in turns (single, mesh, mesh, single);
3. serves the requests through ``serve_multihost`` over the autotuned
   engine at the buckets, every answer against a batch-1 forward of the
   single-device executor, bit for bit, and reads the latencies.

It writes ``<dir>/rank<r>.json`` and exits non-zero on any mismatch or
error.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from quantized_tpu_torch import ops
from quantized_tpu_torch.engine.executor import IntExecutor
from quantized_tpu_torch.engine.multihost import serve_multihost
from quantized_tpu_torch.parallel import collectives as C
from quantized_tpu_torch.parallel.distributed import initialize_multihost
from quantized_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size, create_mesh, rank_device


def check_collectives(mesh, dev) -> dict:
    """Each collective over each axis against the values the ranks sent."""
    rank = dist.get_rank()
    out = {}
    for axis in (DATA_AXIS, MODEL_AXIS):
        n, i = axis_size(mesh, axis), axis_index(mesh, axis)
        ranks = torch.tensor(mesh.mesh.tolist(), device="cpu")
        group = ranks.reshape(-1, n) if axis == MODEL_AXIS else ranks.T.reshape(-1, n)
        members = next(row for row in group.tolist() if rank in row)
        mine = torch.arange(6, dtype=torch.int8, device=dev).reshape(2, 3) + rank
        want = torch.cat([torch.arange(6, dtype=torch.int8).reshape(2, 3) + r for r in members], dim=1)
        gathered = C.all_gather(mine, mesh, axis, dim=1).cpu()
        partial = torch.arange(4 * n, dtype=torch.int32, device=dev).reshape(2, 2 * n) * (rank + 1)
        total = torch.arange(4 * n, dtype=torch.int32).reshape(2, 2 * n) * sum(r + 1 for r in members)
        scattered = C.reduce_scatter(partial, mesh, axis, dim=1).cpu()
        mean = C.all_reduce(torch.full((3,), float(rank), device=dev), mesh, axis, op=dist.ReduceOp.AVG).cpu()
        ok = (torch.equal(gathered, want) and torch.equal(scattered, total.chunk(n, dim=1)[i])
              and torch.allclose(mean, torch.full((3,), sum(members) / n)))
        if not ok:
            raise AssertionError(f"rank {rank} {axis}: gather {gathered.tolist()} scatter {scattered.tolist()} "
                                 f"mean {mean.tolist()} against members {members}")
        out[axis] = {"members": members, "ok": True}
    return out


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _time(fn, dev, iters: int) -> float:
    """Mean ms of ``fn`` between CUDA events (wall ms on the CPU)."""
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def run_engine(name, engine, mesh, dev, u8, iters) -> dict:
    graphs = dev.type == "cuda"
    eager = IntExecutor(copy.deepcopy(engine), mesh=mesh, ingest="u8", device=dev, graphs=False)
    with torch.inference_mode():
        eager(u8)  # the kernels' operands formed, then one counted forward
        if graphs:
            torch.cuda.synchronize(dev)
        ops.reset_launches()
        C.reset_collectives()
        logits_eager = eager(u8)
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        routes = ops.route_counts()
        collectives = C.collective_counts()
    del eager
    meshed = IntExecutor(copy.deepcopy(engine), mesh=mesh, ingest="u8", device=dev, graphs=graphs).warmup(u8)
    single = IntExecutor(copy.deepcopy(engine), ingest="u8", device=dev, graphs=graphs).warmup(u8)
    got, want = meshed(u8), single(u8)
    if not (_bits_equal(got, want) and _bits_equal(logits_eager, want)):
        raise AssertionError(f"{name}: mesh logits differ from the single-device executor's by "
                             f"{float((got - want).abs().max())} (eager mesh {float((logits_eager - want).abs().max())})")
    times = {"single": [], "mesh": []}
    for kind in ("single", "mesh", "mesh", "single"):
        ex = single if kind == "single" else meshed
        times[kind].append(_time(lambda: ex(u8), dev, iters))
    stats = {str(k): {key: v for key, v in st.items() if key != "seconds"} for k, st in meshed.graph_stats().items()}
    return {"launches_per_forward": launches, "routes_per_forward": routes, "collectives_per_forward": collectives,
            "sharded": list(meshed.model.sharded), "graphs": stats, "ms": times, "batch": int(u8.shape[0]),
            "equal": True}


def run_serve(engine, mesh, dev, requests, buckets, bursts) -> dict:
    single = IntExecutor(copy.deepcopy(engine), ingest="u8", device=dev, graphs=False)
    with torch.inference_mode():
        want = torch.cat([single(requests[i:i + 1]) for i in range(len(requests))]).cpu().numpy()
    batcher = serve_multihost(copy.deepcopy(engine), mesh, batch_sizes=buckets, input_shape=tuple(requests.shape[1:]),
                              ingest="u8", graphs=dev.type == "cuda")
    imgs = requests.cpu().numpy()
    t0 = time.perf_counter()
    futures, j = [], 0
    for n in bursts:
        futures.extend(batcher.submit(imgs[(j + k) % len(imgs)]) for k in range(n))
        j += n
    answers = np.stack([f.result(timeout=300) for f in futures])
    secs = time.perf_counter() - t0
    batcher.stop()
    expect = want[np.arange(len(answers)) % len(want)]
    if not np.array_equal(answers.view(np.int32), expect.view(np.int32)):
        raise AssertionError(f"served answers differ from batch-1 forwards by {float(np.abs(answers - expect).max())}")
    st = batcher.stats()
    graph_stats = batcher.executor.graph_stats()
    return {"requests": st["requests"], "seconds": secs, "batches": st["batches"],
            "latency_p50_ms": st["latency_p50_ms"], "latency_p99_ms": st["latency_p99_ms"],
            "occupancy": st["occupancy"], "buckets_captured": sorted(k[0] for k in graph_stats), "equal": True}


def main(workdir: str) -> int:
    workdir = Path(workdir)
    job = torch.load(workdir / "job.pt", weights_only=False)
    rank = int(os.environ.get("RANK", "0"))
    result = {"rank": rank}
    t0 = time.perf_counter()
    code = 0
    try:
        initialize_multihost(device=job["device"])
        mesh = create_mesh(model_parallel=job["model_parallel"], device=job["device"])
        dev = rank_device(mesh.device_type)
        result.update({"world": dist.get_world_size(), "backend": dist.get_backend(), "device": str(dev),
                       "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))})
        result["collectives"] = check_collectives(mesh, dev)
        u8 = job["u8"].to(dev)
        result["engines"] = {name: run_engine(name, eng.to(dev), mesh, dev, u8, job["iters"])
                             for name, eng in job["engines"].items()}
        result["serve"] = run_serve(job["engines"][job["serve_engine"]].to(dev), mesh, dev, job["requests"].to(dev),
                                    job["buckets"], job["bursts"])
    except Exception:  # noqa: BLE001 - the caller reads the traceback
        result["error"] = traceback.format_exc()
        code = 1
    result["seconds"] = time.perf_counter() - t0
    (workdir / f"rank{rank}.json").write_text(json.dumps(result))
    if dist.is_initialized():
        dist.destroy_process_group()
    return code


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m quantized_tpu_torch.probes.mesh_ranks <dir holding job.pt>")
    sys.exit(main(sys.argv[1]))
