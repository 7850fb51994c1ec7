"""Command line of the port (counterpart of ``quantized_tpu/cli/main.py``):
QAT training, evaluation, calibration, integer conversion, serving and
checkpoint export.

The flag surface is the JAX package's (the same argparse destinations).
Where the two differ:

- ``--type`` selects the device: ``cuda.float`` (the default; the
  reference's ``torch.cuda.FloatTensor`` is taken too) or ``cpu.float``,
  where every kernel's plain PyTorch version runs; ``cuda.bf16`` (or
  ``cpu.bf16``) also sets ``--compute-dtype bf16``. A ``tpu.*`` type is
  refused.
- ``--backend`` defaults to ``pallas``: the hand-written Hopper kernels,
  as ``build_int8_resident`` does. The JAX package defaults to ``xla``,
  which in the port means plain PyTorch library calls.
- Training (no ``-e``, ``--serve`` or ``--export-reference``) runs the
  JAX CLI's epoch loop: ``--lr``/``--optimizer`` other than the defaults
  replace the model's regime, a checkpoint each epoch (``model_best`` when
  the validation top-1 improves), ``results.csv``, ``--start-epoch`` and
  ``--resume``. The stochastic rounding of the gradient-quantizing layers
  draws from torch generators seeded from ``--seed`` (through the model's
  init generator), so a run repeats; ``--prng`` (JAX's PRNG choice) is
  taken for parity and changes nothing.
- ``--mesh-model-parallel M`` runs evaluation, conversion and ``--serve``
  over a (data, model) mesh of model degree M on ``torch.distributed``:
  launched one rank per GPU by ``torchrun`` (its environment joins the
  ranks, NCCL) or as one process (a one-rank group; gloo with ``--type
  cpu.float``). Evaluation forwards each rank's rows of a batch and gathers
  the logits, so every rank reports the same metrics; ``--serve`` runs the
  multi-host batcher on every rank (``--serve-pipeline 1``).
  ``--tp-explicit`` (with ``--convert-int``) wires the explicit TP forms
  into the engine's last stage and fc head, and without a mesh exits with
  the JAX CLI's message. Training over a mesh exits naming ROADMAP item
  A10b.
- ``--serve`` replays one CUDA graph per batch bucket; ``--debug-nans``
  turns the graphs off (its int16-leg saturation count reads back to the
  host inside the forward) and raises on non-finite logits.
- ``--deterministic`` calls ``torch.use_deterministic_algorithms(True)``
  (cuDNN's deterministic algorithms, a fixed cuBLAS workspace) and loads
  data on one thread.
- ``--gpus`` and ``--workers`` are taken for parity; they change nothing
  here.

Run it as ``python -m quantized_tpu_torch.cli.main ...``.
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
import sys
from datetime import datetime

MESH_TRAINING = "training over a device mesh is not ported yet (ROADMAP item A10b)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="quantized_tpu_torch training, evaluation and serving")
    # --- the reference's flags ---
    p.add_argument("--results_dir", default="./results", help="results dir")
    p.add_argument("--save", default="", help="saved folder name (default: timestamp)")
    p.add_argument("--dataset", default="imagenet", help="dataset name or 'synthetic'")
    p.add_argument("--model", default="alexnet", help="model factory name")
    p.add_argument("--model_config", default="", help="dict literal with model config, e.g. \"{'depth': 18}\"")
    p.add_argument("--input_size", type=int, default=None)
    p.add_argument("--type", default="cuda.float",
                   help="device.dtype selector: cuda.float (default; the reference's torch.cuda.FloatTensor "
                        "too) or cpu.float (the kernels' plain versions on the CPU); .bf16 sets --compute-dtype bf16")
    p.add_argument("--gpus", default=None, help="taken for reference-CLI parity; one GPU is used")
    p.add_argument("-j", "--workers", type=int, default=0, help="taken for parity (the native pipeline threads itself)")
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--optimizer", default="SGD")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--resume", default="", help="native checkpoint dir or reference .pth.tar/.pt")
    p.add_argument("--save_all", action="store_true", help="keep a per-epoch checkpoint copy")
    p.add_argument("--sync-checkpoints", action="store_true", help="block on each checkpoint write")
    p.add_argument("-e", "--evaluate", action="store_true")
    # --- the engine's extensions ---
    p.add_argument("--calibrate", type=int, default=0, metavar="N",
                   help="run N calibration batches (observers update, no grads)")
    p.add_argument("--convert-int", action="store_true", help="convert to true-integer execution before eval/serve")
    p.add_argument("--weight-bits", type=int, default=8, choices=[4, 8])
    p.add_argument("--backend", default="pallas", choices=["xla", "gemm", "pallas", "bf16"],
                   help="int conv backend: pallas (default) runs the hand-written Hopper kernels; xla runs "
                        "PyTorch library calls (the JAX package's default); gemm im2col + the int8 GEMM kernel")
    p.add_argument("--weight-quant", default="per_channel", choices=["per_channel", "per_tensor"],
                   help="per_channel: production grid (symmetric, BN folded); per_tensor: strict-parity mode, "
                        "the reference's own affine weight grid, BN unfolded")
    p.add_argument("--resident", action="store_true",
                   help="int8-resident engine (activations stay int8 across the net; ResNet, MobileNet, AlexNet)")
    p.add_argument("--autotune", action="store_true", help="per-layer backend autotune on the device (resident)")
    p.add_argument("--serve", action="store_true", help="start the continuous-batching server")
    p.add_argument("--serve-steps", type=int, default=0, help="serve for N scheduler steps then exit (0=forever)")
    p.add_argument("--serve-u8", action="store_true",
                   help="serve raw uint8 images (normalize+quantize fused into the engine ingest)")
    p.add_argument("--serve-http", type=int, default=0, metavar="PORT",
                   help="expose the server over HTTP on PORT (/predict raw-bytes POST with X-Shape/X-Dtype "
                        "headers, /stats JSON; 0 = no endpoint)")
    p.add_argument("--serve-timeout", type=float, default=0.0, metavar="SECS",
                   help="serving SLA: fail requests still queued after SECS with TimeoutError (0 = no deadline)")
    p.add_argument("--serve-pipeline", type=int, default=1, metavar="DEPTH",
                   help="batches kept in flight by the scheduler (1 = lowest latency)")
    p.add_argument("--mesh-model-parallel", type=int, default=None,
                   help="TP degree of a (data, model) mesh over the torch.distributed ranks")
    p.add_argument("--tp-explicit", action="store_true",
                   help="explicit TP forms: the last stage's all-gather convs and the reduce-scatter fc head")
    p.add_argument("--export-reference", default="", help="export weights to a reference-format .pth.tar and exit")
    p.add_argument("--compute-dtype", default="f32", choices=["f32", "bf16"],
                   help="training conv/GEMM operand dtype: bf16 runs them on the tensor cores' bf16 path "
                        "(fake-quant boundaries, observers, BN stats and SGD stay f32)")
    p.add_argument("--prng", default="threefry", choices=["threefry", "rbg", "unsafe_rbg"],
                   help="taken for parity (the JAX package's PRNG choice); the gradient-rounding streams "
                        "are torch generators seeded from --seed")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--profile", default="", metavar="DIR", help="write a Chrome trace of the eval to DIR/trace.json")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise on non-finite logits, count int16-leg saturation (QTPU_DEBUG_S16), no CUDA graphs")
    p.add_argument("--deterministic", action="store_true",
                   help="torch.use_deterministic_algorithms(True) and single-threaded data loading")
    return p


def _device_of_type(type_str: str):
    """``--type`` -> (the device name, whether it asks for bf16), or exit
    with the reason."""
    t = type_str.lower()
    if t.startswith("torch."):  # the reference's tensor type names
        t = t[len("torch."):]
        t = "cuda.float" if t.startswith("cuda.") else "cpu.float"
    dev, _, dtype = t.partition(".")
    if dev == "tpu":
        raise SystemExit(f"--type {type_str}: this is the PyTorch/CUDA port; use cuda.float or cpu.float "
                         "(quantized_tpu.cli.main runs on a TPU)")
    if dev not in ("cuda", "cpu"):
        raise SystemExit(f"--type {type_str}: expected cuda.float or cpu.float")
    return dev, dtype in ("bf16", "bfloat16")


def _check_mesh_flags(args) -> None:
    """Exit where the mesh flags ask for what does not run: explicit TP
    without a mesh (the JAX CLI's message), training over a mesh."""
    if args.tp_explicit and not args.mesh_model_parallel:
        raise SystemExit("--tp-explicit requires --mesh-model-parallel")
    if args.mesh_model_parallel and not (args.evaluate or args.serve or args.export_reference):
        raise SystemExit(f"--mesh-model-parallel: {MESH_TRAINING}")


def _make_mesh(args, device):
    """The (data, model) mesh of ``--mesh-model-parallel`` over the ranks
    torchrun started (or this one process); whether this call made the
    process group."""
    import torch.distributed as dist

    from quantized_tpu_torch.parallel import create_mesh
    from quantized_tpu_torch.parallel.distributed import initialize_multihost

    made = not dist.is_initialized()
    if made:
        initialize_multihost(device=device)
    try:
        return create_mesh(model_parallel=args.mesh_model_parallel, device=device), made
    except ValueError as e:
        if made and dist.is_initialized():
            dist.destroy_process_group()
        raise SystemExit(f"--mesh-model-parallel {args.mesh_model_parallel}: {e}") from e


def main(argv=None):
    args = build_parser().parse_args(argv)
    device_name, bf16_type = _device_of_type(args.type)
    if bf16_type:
        args.compute_dtype = "bf16"
    _check_mesh_flags(args)

    if args.deterministic:
        # cuBLAS needs a fixed workspace for deterministic results; set before CUDA starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if args.debug_nans:
        os.environ["QTPU_DEBUG_S16"] = "1"  # the int16 leg's saturation count (ops/int8_conv)
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
        args.workers = 0

    from quantized_tpu_torch._device import resolve_device
    from quantized_tpu_torch.data import get_dataset, get_transform
    from quantized_tpu_torch.models import get_model
    from quantized_tpu_torch.utils import setup_logging
    from quantized_tpu_torch.utils.checkpoint import export_reference_checkpoint, load_checkpoint
    from quantized_tpu_torch.utils.hostbuild import host_build, put_model

    device = resolve_device(device_name)
    save_name = args.save or datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    save_path = os.path.join(args.results_dir, save_name)
    os.makedirs(save_path, exist_ok=True)
    setup_logging(os.path.join(save_path, "log.txt"))
    logger = logging.getLogger("main")
    logger.info("args: %s", vars(args))
    logger.info("device: %s%s", device, f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")

    model_config = {"dataset": args.dataset} if args.dataset != "synthetic" else {"dataset": "cifar10"}
    if args.model_config:
        model_config.update(ast.literal_eval(args.model_config))
    if args.model in ("alexnet", "alexnet_quantized", "mnist", "mobilenet", "mobilenet_quantized"):
        model_config.pop("dataset", None)

    # built and loaded on the host, then moved to the device in one step
    torch.manual_seed(args.seed)
    with host_build():
        model = get_model(args.model)(generator=torch.Generator().manual_seed(args.seed), **model_config)
    logger.info("created model %s with config %s", args.model, model_config)

    regime = getattr(model, "regime", None)
    if args.lr != 0.1 or args.optimizer != "SGD":
        regime = {0: {"optimizer": args.optimizer, "lr": args.lr, "momentum": args.momentum,
                      "weight_decay": args.weight_decay}}

    if args.resume:
        if args.resume.endswith((".pth.tar", ".pt")):
            from quantized_tpu_torch.ingest import load_into_model

            load_into_model(model, args.resume)
            logger.info("ingested reference checkpoint %s", args.resume)
        else:
            meta = load_checkpoint(model, args.resume)
            args.start_epoch = int(meta.get("epoch", args.start_epoch))
            logger.info("resumed %s at epoch %d", args.resume, args.start_epoch)

    if args.export_reference:
        export_reference_checkpoint(model, args.export_reference, {"model": args.model, "config": model_config})
        logger.info("exported reference checkpoint to %s", args.export_reference)
        return 0

    transform_name = getattr(model, "input_transform", args.dataset)
    if args.dataset in ("cifar10", "cifar100", "mnist", "synthetic"):
        transform_name = "cifar10" if args.dataset == "synthetic" else args.dataset
    val_tf = get_transform(transform_name, args.input_size, augment=False)
    val_data = get_dataset(args.dataset, "val", val_tf)
    if val_data.synthetic:
        logger.warning("dataset %s not found locally -> synthetic stand-in", args.dataset)

    mesh = made_group = None
    if args.mesh_model_parallel:  # first: a rank's GPU becomes the current device ("cuda" below)
        mesh, made_group = _make_mesh(args, device)
        logger.info("mesh: %s over %s", dict(zip(mesh.mesh_dim_names, mesh.shape)), device)
    try:
        model = put_model(model, device)
        return _run(args, model, device, mesh, regime, model_config, transform_name, val_data, save_path, logger)
    finally:
        if made_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, model, device, mesh, regime, model_config, transform_name, val_data, save_path, logger) -> int:
    """Calibration, conversion, then serving, evaluation or training."""
    import torch

    from quantized_tpu_torch.training import Trainer

    if args.calibrate:
        model.train()
        with torch.no_grad():
            for i, (x, _) in enumerate(val_data.batches(args.batch_size)):
                if i >= args.calibrate:
                    break
                model(torch.from_numpy(x).to(device))
        model.eval()
        logger.info("calibrated observers on %d batches", args.calibrate)

    if args.convert_int:
        model = _convert(args, model, device, logger)
        if args.tp_explicit:
            from quantized_tpu_torch.parallel.tp_engine import apply_explicit_tp

            n = apply_explicit_tp(model, mesh)
            logger.info("explicit TP wired: fc reduce-scatter head + %d last-stage all-gather convs", n)

    if args.serve:
        from quantized_tpu_torch.engine.server import serve

        return serve(model, mesh=mesh, batch_sizes=(1, 8, 32, args.batch_size), max_steps=args.serve_steps,
                     ingest="u8" if args.serve_u8 else "f32", pipeline_depth=args.serve_pipeline,
                     http_port=args.serve_http or None, request_timeout_s=args.serve_timeout or None,
                     device=device, graphs=not args.debug_nans, check_finite=args.debug_nans)

    if mesh is not None:  # evaluation over the mesh: each rank forwards its rows, the logits gathered
        from quantized_tpu_torch.engine.executor import MeshEngine

        model = MeshEngine(model, mesh)
    trainer = Trainer(model, regime=regime, print_freq=args.print_freq,
                      compute_dtype=None if args.compute_dtype == "f32" else args.compute_dtype,
                      check_finite=args.debug_nans, device=device)
    if not args.evaluate:
        return _train(args, trainer, model, model_config, regime, transform_name, val_data, save_path, logger)
    if args.profile:
        from quantized_tpu_torch.utils.profiling import trace

        with trace(args.profile):
            metrics = trainer.validate(val_data.batches(args.batch_size), 0)
        logger.info("profile trace written to %s", args.profile)
    else:
        metrics = trainer.validate(val_data.batches(args.batch_size), 0)
    logger.info("EVAL: loss %.4f top1 %.2f%% top5 %.2f%%", metrics["loss"], metrics["top1"], metrics["top5"])
    print({"top1": float(metrics["top1"]), "top5": float(metrics["top5"]), "loss": float(metrics["loss"])})
    return 0


def _train(args, trainer, model, model_config, regime, transform_name, val_data, save_path, logger) -> int:
    """The reference's epoch loop: train, validate, checkpoint (``model_best``
    when the validation top-1 improves) and a ``results.csv`` row per
    epoch."""
    from quantized_tpu_torch.data import get_dataset, get_transform
    from quantized_tpu_torch.utils import ResultsLog, save_checkpoint, wait_for_checkpoints

    train_tf = get_transform(transform_name, args.input_size, augment=True)
    train_data = get_dataset(args.dataset, "train", train_tf)
    results = ResultsLog(os.path.join(save_path, "results.csv"))
    results.plot("epoch", ["train_loss", "val_loss"], title="loss")
    results.plot("epoch", ["train_top1", "val_top1"], title="top-1", ylabel="%")
    best_prec1 = 0.0
    for epoch in range(args.start_epoch, args.epochs):
        t = trainer.train_epoch(
            train_data.batches(args.batch_size, shuffle=True, seed=epoch, drop_remainder=True), epoch)
        v = trainer.validate(val_data.batches(args.batch_size), epoch)
        is_best = v["top1"] > best_prec1
        best_prec1 = max(best_prec1, v["top1"])
        save_checkpoint(model, save_path,
                        meta={"epoch": epoch + 1, "model": args.model, "config": model_config,
                              "best_prec1": best_prec1,
                              "regime": {str(k): v2 for k, v2 in (regime or {}).items()}},
                        is_best=is_best, save_all=args.save_all, async_save=not args.sync_checkpoints)
        results.add(epoch=epoch, train_loss=t["loss"], val_loss=v["loss"], train_top1=t["top1"],
                    val_top1=v["top1"], train_top5=t["top5"], val_top5=v["top5"])
        results.save()
        logger.info("epoch %d: train top1 %.2f val top1 %.2f (best %.2f)", epoch, t["top1"], v["top1"], best_prec1)
    wait_for_checkpoints()  # the last asynchronous save is on disk before the exit
    return 0


def _convert(args, model, device, logger):
    """``--convert-int``: the int8-resident engine (``--resident``, with
    ``--autotune``) or the module surgery of ``convert_to_int``."""
    import torch

    if args.resident:
        from quantized_tpu_torch.engine import build_int8_alexnet, build_int8_mobilenet, build_int8_resident

        build = (build_int8_alexnet if "alexnet" in args.model
                 else build_int8_mobilenet if "mobilenet" in args.model else build_int8_resident)
        model = build(model, weight_bits=args.weight_bits, backend=args.backend, device=device)
        if args.autotune:
            from quantized_tpu_torch.engine import apply_cached_backends, autotune_resident

            size = args.input_size or getattr(model, "input_size", 224)
            example = torch.zeros((args.batch_size, size, size, 3), dtype=torch.float32, device=device)
            if not apply_cached_backends(model, example):
                autotune_resident(model, example)
        logger.info("converted to int%d-resident engine (backend=%s)", args.weight_bits, args.backend)
        return model
    from quantized_tpu_torch.engine import convert_to_int

    model = convert_to_int(model, weight_bits=args.weight_bits, backend=args.backend,
                           weight_quant=args.weight_quant, device=device)
    logger.info("converted to int%d execution (backend=%s, weight_quant=%s)",
                args.weight_bits, args.backend, args.weight_quant)
    return model


if __name__ == "__main__":
    sys.exit(main())
