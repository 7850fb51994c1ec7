"""One rank of the mesh training check: ``python -m
quantized_tpu_torch.probes.mesh_train <dir>``, started once per device with
torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``; one process needs none). ``chip_smoke.py``'s
"mesh train" phase starts it on every GPU, NCCL between them; ``device:
"cpu"`` in the job runs it on gloo, to rehearse the script on a small
model.

``<dir>/job.pt`` (written by the caller, loaded whole) holds the device,
the model degree, the models (registered names), their depth and dataset,
the global batch, the steps, the regime, the tolerances by model for a
world of several ranks (the loss, the update's norm, each tensor:
``chip_smoke.TRAIN_PARITY_TOL``'s form), the timed iterations and whether to run ``entry.dryrun_multichip``
(and at what side). For each model, from seed 0's weights, the rank:

1. trains a copy through ``Trainer(mesh=create_mesh(...))``, a copy
   through ``Trainer(model)`` and a second one-device copy (the control:
   the card's own run-to-run spread) on the same seeded global batches,
   one step each in turn, first under ``torch.use_deterministic_algorithms``
   (``warn_only``: an op without a deterministic form still runs), then
   afresh under the default algorithms, with the kernel launch counts set
   to 0 before and read after (training launches none of the port's
   kernels), the collectives of one mesh step counted and the peak memory
   of each (default algorithms);
2. for each mode, compares the mesh run's and the control's losses and
   gathered states with the single run's (the update's norm, the worst
   tensor, the tensors not bit-equal). Under the deterministic
   algorithms at world size 1 the mesh adds no arithmetic and must be
   bit-equal; on a bigger world it must lie within the tolerances. Under
   the default algorithms the two distances stand side by side: the
   control's is the card's own run-to-run spread;
3. times steps of each in turns (single, mesh, mesh, single) between CUDA
   events (wall time on the CPU), with the default algorithms.

Then ``dryrun_multichip`` on every rank. It writes ``<dir>/rank<r>.json``
(each model's record with ``ok`` and, where not ok, ``why``) and exits
non-zero on any mismatch or error.
"""

from __future__ import annotations

import copy
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from quantized_tpu_torch import ops
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.parallel import collectives as C
from quantized_tpu_torch.parallel.distributed import initialize_multihost
from quantized_tpu_torch.parallel.mesh import create_mesh, rank_device
from quantized_tpu_torch.training import Trainer

STATS = ("mean", "var", "running_mean", "running_var", "running_min", "running_max")


def _batches(job, side: int):
    gen = torch.Generator().manual_seed(29)
    classes = 1000 if job["dataset"] == "imagenet" else 10
    return [(torch.randn((job["batch"], side, side, 3), generator=gen).numpy(),
             torch.randint(0, classes, (job["batch"],), generator=gen).numpy()) for _ in range(job["steps"])]


def _peak_mib(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else 0.0


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _step_ms(trainer, x, y, dev, iters: int) -> float:
    """Mean ms of a training step on device tensors, between CUDA events
    (wall time on the CPU)."""
    trainer._train_step(x, y)  # warm
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            trainer._train_step(x, y)
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        trainer._train_step(x, y)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(mesh_state, single_state, before, tol) -> dict:
    """The mesh run's state against the single run's: the update of all
    parameters relative to its norm, the worst tensor relative to the larger
    of its magnitude and the largest step, and the tensors not bit-equal."""
    params = [k for k in single_state if not k.endswith(STATS)]
    step = max((single_state[k] - before[k]).abs().max().item() for k in params)
    du = torch.cat([(mesh_state[k] - single_state[k]).ravel() for k in params]).norm().item()
    u = torch.cat([(single_state[k] - before[k]).ravel() for k in params]).norm().item()
    worst = max(((mesh_state[k] - v).abs().max().item() / max(v.abs().max().item(), step), k)
                for k, v in single_state.items())
    unequal = [k for k, v in single_state.items() if not torch.equal(mesh_state[k], v)]
    return {"update": du / u, "worst": worst, "unequal": unequal,
            "within": du <= tol[1] * u and worst[0] <= tol[2]}


def _in_turn(model, job, mesh, dev, batches, deterministic: bool) -> dict:
    """Copies of ``model`` trained one step a batch in turn, through
    ``Trainer(model)`` ("single"), a second ``Trainer(model)`` ("control")
    and ``Trainer(mesh=)`` ("mesh"), under
    ``torch.use_deterministic_algorithms(deterministic, warn_only=True)``:
    the trainers, their losses and peak memory, and the collectives of the
    mesh's last step."""
    trainers = {"single": Trainer(copy.deepcopy(model), regime=job["regime"], print_freq=10**6, device=dev),
                "control": Trainer(copy.deepcopy(model), regime=job["regime"], print_freq=10**6, device=dev),
                "mesh": Trainer(copy.deepcopy(model), regime=job["regime"], mesh=mesh, print_freq=10**6, device=dev)}
    losses = {label: [] for label in trainers}
    peaks = {label: 0.0 for label in trainers}
    counts = {}
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        for i, batch in enumerate(batches):
            for label, tr in trainers.items():
                _reset_peak(dev)
                last_mesh = label == "mesh" and i == len(batches) - 1
                if last_mesh:
                    C.reset_collectives()
                losses[label].append(tr.train_epoch([batch], 0)["loss"])
                if last_mesh:
                    counts = C.collective_counts()
                peaks[label] = max(peaks[label], _peak_mib(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        torch.use_deterministic_algorithms(False)
    return {"trainers": trainers, "losses": losses, "peaks": peaks, "counts": counts}


def _held(run, before, tol) -> dict:
    """The mesh run and the control against the single run of one mode."""
    states = {label: {k: v.cpu() for k, v in tr.full_state().items()} for label, tr in run["trainers"].items()}
    cmp = {label: compare(states[label], states["single"], before, tol) for label in ("mesh", "control")}
    loss_err = {label: max(abs(a - b) / abs(b) for a, b in zip(run["losses"][label], run["losses"]["single"]))
                for label in ("mesh", "control")}
    streams = {label: [m.grad_quant_rng.count for m in tr.model.modules() if hasattr(m, "grad_quant_rng")]
               for label, tr in run["trainers"].items()}
    bit_equal = {label: not cmp[label]["unequal"] and loss_err[label] == 0 for label in cmp}
    return {"losses": run["losses"], "loss_err": loss_err, "update": {k: c["update"] for k, c in cmp.items()},
            "worst": {k: list(c["worst"]) for k, c in cmp.items()},
            "unequal": {k: len(c["unequal"]) for k, c in cmp.items()},
            "first_unequal": {k: c["unequal"][:3] for k, c in cmp.items()}, "bit_equal": bit_equal,
            "within": cmp["mesh"]["within"] and loss_err["mesh"] <= tol[0], "tensors": len(states["single"]),
            "streams_equal": streams["mesh"] == streams["single"], "streams_advanced": sum(streams["mesh"]) > 0,
            "finite": all(math.isfinite(v) for losses in run["losses"].values() for v in losses)}


def run_model(name: str, job, mesh, dev) -> dict:
    """The model's three trainers under the deterministic algorithms, then
    afresh under the default ones; at world size 1 the deterministic mesh
    step must equal the single-device step bit for bit (the mesh adds no
    arithmetic), on a bigger world it must lie within the job's tolerance.
    Under the default algorithms the mesh's and the control's distances
    from the single run are recorded side by side: the control measures the
    card's own run-to-run spread. The steps are timed in turns with the
    default algorithms."""
    cfg = {"dataset": job["dataset"], "depth": job["depth"]}
    model = get_model(name)(generator=torch.Generator().manual_seed(0), **cfg)
    side = getattr(model, "input_size", 224) if job.get("side") is None else job["side"]
    batches = _batches(job, side)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tol, world = job["tol"][name], dist.get_world_size()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ops.reset_launches()
    run = _in_turn(model, job, mesh, dev, batches, deterministic=True)
    modes, counts = {"deterministic": _held(run, before, tol)}, run["counts"]
    del run  # its trainers' memory, before the default run
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run = _in_turn(model, job, mesh, dev, batches, deterministic=False)
    modes["default"] = _held(run, before, tol)
    launched = {k: n for k, n in ops.launch_counts().items() if n}
    det, why = modes["deterministic"], []
    if world == 1 and not det["bit_equal"]["mesh"]:
        why.append("at world size 1 under the deterministic algorithms the mesh step is not the single-device "
                   "step bit for bit")
    if world > 1 and not det["within"]:
        why.append(f"the mesh step left the single-device step beyond {tol}")
    if not all(m["streams_equal"] for m in modes.values()):
        why.append("the grad-quant streams differ")
    if not all(m["finite"] for m in modes.values()):
        why.append("a loss is not finite")
    if launched:
        why.append(f"hand-written kernels launched in training: {launched}")
    peaks, single, meshed = run["peaks"], run["trainers"]["single"], run["trainers"]["mesh"]
    x = torch.from_numpy(batches[0][0]).to(dev)
    y = torch.from_numpy(batches[0][1]).to(dev)
    turns = []
    for label, tr in (("single", single), ("mesh", meshed), ("mesh", meshed), ("single", single)):
        turns.append((label, _step_ms(tr, x, y, dev, job["iters"])))
    del run, single, meshed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"ok": not why, "why": "; ".join(why), "modes": modes, "collectives_per_step": counts, "peak_mib": peaks,
            "turns": turns, "launched": launched, "side": side}


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
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        result["models"] = {name: run_model(name, job, mesh, dev) for name in job["models"]}
        result["train_seconds"] = time.perf_counter() - t0
        code = int(not all(m["ok"] for m in result["models"].values()))
        if job.get("dryrun"):
            from quantized_tpu_torch.entry import dryrun_multichip

            t1 = time.perf_counter()
            result["dryrun"] = dryrun_multichip(dist.get_world_size(), device=job["device"],
                                                side=job.get("dryrun_side", 224))
            result["dryrun_seconds"] = time.perf_counter() - t1
    except Exception:  # noqa: BLE001 - the caller reads the traceback
        result["error"] = traceback.format_exc()
        code = 1
    result["seconds"] = time.perf_counter() - t0
    (workdir / f"rank{rank}.json").write_text(json.dumps(result, default=float))
    if dist.is_initialized():
        dist.destroy_process_group()
    return code


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m quantized_tpu_torch.probes.mesh_train <dir holding job.pt>")
    sys.exit(main(sys.argv[1]))
