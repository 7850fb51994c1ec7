"""One rank of the port's distribution tests (``tests/torch_dist.py``
starts it): ``python tests/torch_dist_worker.py <rank> <world> <port> <dir>``.

It joins a gloo group of ``world`` ranks on the CPU, runs the cases that
``<dir>/job.pkl`` lists, in order (every rank the same), and pickles
{label: result} to ``<dir>/rank<rank>.pkl`` after each case. It imports torch and the port,
never JAX. A case's result holds numpy arrays and plain values; a failing
rank writes {"error": traceback}.
"""

import os
import pickle
import signal
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from quantized_tpu_torch.engine import IntExecutor, build_int8_alexnet, build_int8_mobilenet, build_int8_resident
from quantized_tpu_torch.engine.int_layers import IntConv2d
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.parallel import create_mesh
from quantized_tpu_torch.parallel import collectives as C
from quantized_tpu_torch.parallel.distributed import heartbeat_barrier, local_batch_slice
from quantized_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size
from quantized_tpu_torch.parallel.sharding import shard_tensor
from quantized_tpu_torch.parallel.tp_engine import ExplicitTPConv, apply_explicit_tp, tp_int8_conv

BUILDERS = {"resnet": build_int8_resident, "mobilenet": build_int8_mobilenet, "alexnet": build_int8_alexnet}


def _t(a):
    return torch.from_numpy(np.array(a))


_MODELS = {}


def _engine(spec, backend):
    """A port engine from ``spec``: (model name, config, state dict in numpy);
    the fake-quant model is made once per spec (the builders only read it)."""
    name, cfg, state = spec
    model = _MODELS.get(id(spec))
    if model is None:
        model = get_model(name)(generator=torch.Generator().manual_seed(0), **cfg)
        model.load_state_dict({k: _t(v) for k, v in state.items()})
        model = _MODELS[id(spec)] = model.eval()
    kind = next(k for k in BUILDERS if k in name)
    return BUILDERS[kind](model, backend=backend, device="cpu")


def _block(t, index, parts, dim):
    return shard_tensor(t, tuple(MODEL_AXIS if d == dim else None for d in range(t.ndim)), index, parts)


def _mesh_coords(mesh):
    return (axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS),
            axis_index(mesh, MODEL_AXIS))


def case_collectives(job):
    """tp_linear, tp_linear_reduce_scatter and dp_psum_grads on this rank's
    blocks of the job's global tensors."""
    mesh = create_mesh(model_parallel=job["tp"], device="cpu")
    dp, d, tp, m = _mesh_coords(mesh)
    x, w, b = (_t(job[k]) for k in ("x", "w", "b"))
    rows = _block(x, d, dp, 0)
    C.reset_collectives()
    y = C.tp_linear(mesh, rows, _block(w, m, tp, 0), _block(b, m, tp, 0))
    y_rs = C.tp_linear_reduce_scatter(mesh, _block(rows, m, tp, 1), _block(w, m, tp, 1))
    counts = C.collective_counts()
    heartbeat_barrier(timeout_s=60, tag="collectives")
    g = {"w": _t(job["g"]), "b": [_t(job["g"][0])]}
    mine = {"w": g["w"] + d * _t(job["delta"]), "b": [g["b"][0] + d]}
    return {"coords": (dp, d, tp, m), "tp_linear": y.numpy(), "tp_linear_rs": y_rs.numpy(), "counts": counts,
            "rank": dist.get_rank(), "batch_slice": local_batch_slice(8),
            "psum_same": C.dp_psum_grads(mesh, g)["w"].numpy(),
            "psum_mean": {k: v.numpy() if torch.is_tensor(v) else [t.numpy() for t in v]
                          for k, v in C.dp_psum_grads(mesh, mine).items()}}


def case_tp_conv(job):
    """tp_int8_conv over (1, tp): the f32 ReLU form and the int8 requant
    form, on "xla" and "pallas", against the whole conv."""
    mesh = create_mesh(model_parallel=job["tp"], device="cpu")
    x_q = _t(job["x_q"])
    out = {}
    for backend in ("xla", "pallas"):
        for form, kw in (("f32", {"relu": True}), ("s8", {"relu": True, "out_requant": job["grid"]})):
            def conv():
                return IntConv2d(_t(job["w_q"]), _t(job["alpha"]), _t(job["beta"]), job["act_scale"], job["zp"],
                                 padding=(1, 1), backend=backend)
            whole = conv().run_q(x_q, **kw)
            C.reset_collectives()
            shard = ExplicitTPConv(conv(), mesh)
            got = tp_int8_conv(mesh, x_q, shard.conv, **kw)
            out[(backend, form)] = {"tp": got.numpy(), "whole": whole.numpy(), "counts": C.collective_counts(),
                                    "local_cout": int(shard.conv.w_ck.shape[0])}
    return out


def case_explicit_tp(job):
    """apply_explicit_tp over (1, tp) on the job's engine, on each backend,
    against the same engine on one device; the collectives of a forward."""
    mesh = create_mesh(model_parallel=job["tp"], device="cpu")
    x = _t(job["x"])
    out = {}
    for backend in job["backends"]:
        with torch.inference_mode():
            single = _engine(job["model"], backend)(x)
        eng = _engine(job["model"], backend)
        wrapped = apply_explicit_tp(eng, mesh)
        with torch.inference_mode():
            eng(x)  # a first forward, then the counted one
            C.reset_collectives()
            got = eng(x)
        out[backend] = {"tp": got.numpy(), "single": single.numpy(), "wrapped": wrapped,
                        "counts": C.collective_counts()}
    return out


def case_executor(job):
    """IntExecutor(mesh=) over (data, model) on each of the job's engines and
    backends, against the engine on one device."""
    mesh = create_mesh(model_parallel=job["tp"], device="cpu")
    out = {}
    for key, spec in job["models"].items():
        x = _t(job["x"][key])
        for backend in job["backends"]:
            eng = _engine(spec, backend)
            full = {n: c.alpha.shape[0] for n, c in eng.named_modules() if isinstance(c, IntConv2d)}
            with torch.inference_mode():
                single = eng(x)
            ex = IntExecutor(_engine(spec, backend), mesh=mesh, device="cpu")
            C.reset_collectives()
            got = ex(x)
            counts = C.collective_counts()
            shards = {n[len("engine."):]: int(c.conv.alpha.shape[0]) for n, c in ex.model.named_modules()
                      if isinstance(c, ExplicitTPConv)}
            out[(key, backend)] = {"mesh": got.numpy(), "single": single.numpy(), "counts": counts,
                                   "sharded": {n: (c, full[n]) for n, c in shards.items()},
                                   "dense": ex.model.sharded[1]}
    return out


def case_serve(job):
    """Two-rank serve_multihost: the JAX test's unequal loads (4 and 3
    requests), then an idle period on rank 0 while rank 1 submits one."""
    from quantized_tpu_torch.engine.multihost import serve_multihost

    mesh = create_mesh(model_parallel=job["tp"], device="cpu")
    images = job["images"]
    with torch.inference_mode():
        ref = _engine(job["model"], "pallas")(_t(images)).numpy()
    rank = dist.get_rank()
    batcher = serve_multihost(_engine(job["model"], "pallas"), mesh, batch_sizes=(2, 4), input_shape=images.shape[1:])
    mine = list(range(4)) if rank == 0 else list(range(4, 7))
    wave1 = {i: batcher.submit(images[i]) for i in mine}
    got1 = {i: f.result(timeout=120) for i, f in wave1.items()}
    mine2 = [7] if rank == 1 else []
    t0 = time.perf_counter()
    got2 = {i: batcher.submit(images[i]).result(timeout=120) for i in mine2}
    wave2_s = time.perf_counter() - t0
    if rank == 0:
        time.sleep(job["idle_s"])  # idle, not stopped: the heartbeat alone must carry rank 1's request
    batcher.stop()
    return {"ref": ref, "got": {**got1, **got2}, "wave2_s": wave2_s, "stats": batcher.stats()}


def case_kill(job):
    """Rank 1 dies (SIGKILL) mid-serving; rank 0's pending requests must
    fail within the peer timeout and its batcher refuse further submits."""
    from quantized_tpu_torch.engine.multihost import serve_multihost

    mesh = create_mesh(model_parallel=job["tp"], device="cpu")
    timeout = job["peer_timeout_s"]
    img = np.zeros(job["shape"], np.float32)
    batcher = serve_multihost(_engine(job["model"], "pallas"), mesh, batch_sizes=(2,), input_shape=job["shape"],
                              peer_timeout_s=timeout)
    shapes = [f.result(timeout=120).shape for f in [batcher.submit(img) for _ in range(2)]]
    dist.barrier()
    if dist.get_rank() == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(1.0)
    t0 = time.perf_counter()
    failures = 0
    for _ in range(2):
        try:
            fut = batcher.submit(img)
        except RuntimeError:
            failures += 1
            continue
        try:
            fut.result(timeout=timeout + 30)
        except RuntimeError:
            failures += 1
    window = time.perf_counter() - t0
    refused = False
    deadline = time.perf_counter() + timeout + 10
    while time.perf_counter() < deadline:
        try:
            batcher.submit(img)
            time.sleep(0.2)
        except RuntimeError:
            refused = True
            break
    return {"shapes": shapes, "failures": failures, "window_s": window, "refused": refused}


CASES = {"collectives": case_collectives, "tp_conv": case_tp_conv, "explicit_tp": case_explicit_tp,
         "executor": case_executor, "serve": case_serve, "kill": case_kill}


def main():
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    torch.set_num_threads(1)
    job = pickle.loads((workdir / "job.pkl").read_bytes())
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    results = {}
    out = workdir / f"rank{rank}.pkl"
    try:
        for label, case, args in job["cases"]:
            results[label] = CASES[case](args)
            out.write_bytes(pickle.dumps(results))  # a rank that dies later keeps what it did
    except Exception:  # noqa: BLE001 - the test reads the traceback
        results["error"] = traceback.format_exc()
        out.write_bytes(pickle.dumps(results))
    if "error" in results or any(case == "kill" for _, case, _ in job["cases"]):
        os._exit(0 if "error" not in results else 1)  # a dead peer's group cannot be shut down
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
