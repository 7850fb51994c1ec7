"""The port's command line against the JAX package's, on the CPU
(in-process; ``--type cpu.float`` runs every kernel's plain version).

- The parser takes the same flags: its argparse destinations equal those of
  JAX's ``build_parser()``.
- A reference checkpoint exported by JAX's CLI (a CIFAR ResNet-20 drawn by
  JAX's initializers) is evaluated by both CLIs with ``--resume x.pth.tar
  --calibrate 2 --convert-int --resident -e``: each calibrates on its own
  side, so the two grids agree to float rounding, and each runs its own
  default backend (JAX "xla", the port "pallas"). The engine bound is
  LOGIT_ATOL = 0.25 on logits (``tests/test_torch_resident.py``), which
  moves a mean cross-entropy by at most 2 * LOGIT_ATOL. Top-1 and top-5
  may differ only by the images whose label sits within 2 * LOGIT_ATOL of
  the k-th boundary of the port's own logits (recomputed here through the
  API, and checked to give the CLI's printed numbers).
- ``--serve --serve-steps 3`` returns 0, with and without the resident
  engine, and ``--export-reference`` writes a reference file (its round
  trip through JAX's ingest is held in ``tests/test_torch_checkpoint.py``).
- Training, the port of JAX's ``test_cli_train_one_epoch_and_resume`` on
  a CIFAR ResNet-8: one epoch writes ``results.csv`` and a checkpoint, and
  ``--resume`` of it with ``--calibrate 1 --convert-int -e`` returns 0;
  two ``--deterministic`` mnist runs write identical ``results.csv``
  files (JAX's ``test_cli_deterministic_reruns_bitmatch``); a bf16 run
  (``--compute-dtype bf16`` or ``--type cpu.bf16``) trains; the float
  models train, evaluate or export without a refusal.
- The mesh flags: one process with ``--mesh-model-parallel 1
  --tp-explicit`` (a one-rank gloo group, the explicit TP forms and the
  mesh executor's collectives) evaluates to the same metrics, to the bit,
  as the run without a mesh, and serves; ``--tp-explicit`` without a mesh
  exits with the JAX CLI's message, a model degree that the world does not
  divide exits naming it, and training over a mesh exits naming ROADMAP
  item A10b; a TPU type is refused.
"""

import ast
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from quantized_tpu.cli.main import build_parser as j_build_parser
from quantized_tpu.cli.main import main as j_main
from quantized_tpu_torch.cli.main import build_parser, main
from quantized_tpu_torch.data import get_dataset, get_transform
from quantized_tpu_torch.engine import build_int8_resident
from quantized_tpu_torch.ingest import load_into_model
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.training import cross_entropy
from quantized_tpu_torch.utils import accuracy
from torch_threads import one_torch_thread  # noqa: F401  (fixture)

LOGIT_ATOL = 0.25
R20 = ["--model", "resnet_quantized_float_bn", "--dataset", "synthetic", "--model_config", "{'depth': 20}"]
R8 = ["--model", "resnet_quantized_float_bn", "--dataset", "synthetic", "--model_config", "{'depth': 8}"]


def _dests(parser):
    return {a.dest for a in parser._actions if a.dest != "help"}


def test_parser_has_the_jax_flag_surface():
    assert _dests(build_parser()) == _dests(j_build_parser())
    args = build_parser().parse_args(["--model", "resnet_quantized", "-b", "32", "-e", "--resume", "x.pth.tar",
                                      "--type", "torch.cuda.FloatTensor"])
    assert args.model == "resnet_quantized" and args.batch_size == 32 and args.evaluate
    assert build_parser().parse_args([]).backend == "pallas" and build_parser().parse_args([]).type == "cuda.float"


def _printed(capsys):
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    return ast.literal_eval(lines[-1])


def _port_logits(ckpt, batch):
    """The port CLI's evaluation, step by step through the API."""
    tf = get_transform("cifar10", None, augment=False)
    val = get_dataset("synthetic", "val", tf)
    model = get_model("resnet_quantized_float_bn")(generator=torch.Generator().manual_seed(123),
                                                   dataset="cifar10", depth=20)
    load_into_model(model, ckpt)
    model.train()
    with torch.no_grad():
        for i, (x, _) in enumerate(val.batches(batch)):
            if i >= 2:
                break
            model(torch.from_numpy(x))
    eng = build_int8_resident(model.eval(), device="cpu")
    logits, labels = [], []
    with torch.inference_mode():
        for x, y in val.batches(batch):
            logits.append(eng(torch.from_numpy(x)))
            labels.append(torch.from_numpy(y))
    return logits, labels


def _ambiguous(logits: np.ndarray, labels: np.ndarray, k: int, eps: float) -> int:
    """Images whose label's top-k membership can flip when every logit moves
    by at most ``eps``."""
    own = logits[np.arange(len(labels)), labels][:, None]
    surely_above = (logits > own + 2 * eps).sum(1)
    maybe_above = (logits >= own - 2 * eps).sum(1) - 1  # the label itself counts once
    return int(((surely_above < k) & (maybe_above >= k)).sum())


def test_jax_export_evaluates_alike_in_both_clis(tmp_path, capsys):
    ckpt = str(tmp_path / "r20.pth.tar")
    common = ["--type", "cpu.float", *R20, "--results_dir", str(tmp_path)]
    assert j_main(common + ["--save", "export", "--export-reference", ckpt]) == 0
    run = ["--resume", ckpt, "--calibrate", "2", "--convert-int", "--resident", "-e", "-b", "64"]
    assert j_main(common + ["--save", "jax"] + run) == 0
    want = _printed(capsys)
    assert main(common + ["--save", "port"] + run) == 0
    got = _printed(capsys)
    assert os.path.exists(tmp_path / "port" / "log.txt")
    assert abs(got["loss"] - want["loss"]) <= 2 * LOGIT_ATOL, (got, want)

    logits, labels = _port_logits(ckpt, 64)
    n = sum(len(y) for y in labels)
    loss = sum(float(cross_entropy(lg, y)) * len(y) for lg, y in zip(logits, labels)) / n
    top = np.mean([accuracy(lg, y, topk=(1, 5)) for lg, y in zip(logits, labels)], axis=0)
    assert loss == pytest.approx(got["loss"], rel=1e-12) and tuple(top) == pytest.approx((got["top1"], got["top5"]))
    all_logits, all_labels = torch.cat(logits).numpy(), torch.cat(labels).numpy()
    for k, key in ((1, "top1"), (5, "top5")):
        flips = round(abs(got[key] - want[key]) * n / 100.0)
        assert flips <= _ambiguous(all_logits, all_labels, k, LOGIT_ATOL), (key, got, want)


def test_cli_serves_and_exports(tmp_path):
    common = ["--type", "cpu.float", *R20, "--results_dir", str(tmp_path), "-b", "8", "--calibrate", "1"]
    assert main(common + ["--save", "serve", "--convert-int", "--serve", "--serve-steps", "3"]) == 0
    assert main(common + ["--save", "serve_u8", "--convert-int", "--resident", "--serve", "--serve-steps", "3",
                          "--serve-u8", "--serve-pipeline", "2"]) == 0
    out = str(tmp_path / "port.pth.tar")
    assert main(common + ["--save", "export", "--export-reference", out]) == 0
    ckpt = torch.load(out, weights_only=True)
    assert ckpt["model"] == "resnet_quantized_float_bn" and "layer1.0.conv1.weight" in ckpt["state_dict"]


@pytest.mark.parametrize("extra,message", [
    (["-e", "--mesh-model-parallel", "2"], "model groups of 2"),
    (["-e", "--tp-explicit"], "--tp-explicit requires --mesh-model-parallel"),
    (["--mesh-model-parallel", "1"], "A10b"),
    (["-e", "--type", "tpu.float"], "TPU"),
])
def test_unported_paths_exit_with_their_item(tmp_path, extra, message):
    with pytest.raises(SystemExit, match=message):
        main(["--type", "cpu.float", *R20, "--results_dir", str(tmp_path), *extra])
    assert not dist.is_initialized()


def test_cli_mesh_evaluates_alike(tmp_path, capsys):
    """``-e`` over a one-rank mesh with the explicit TP forms: the metrics of
    the run without a mesh, bit for bit (the same logits), and the process
    group made for the run is gone after it."""
    common = ["--type", "cpu.float", *R8, "--results_dir", str(tmp_path), "-b", "64", "--calibrate", "1",
              "--convert-int", "--resident", "-e"]
    assert main(common + ["--save", "plain"]) == 0
    want = _printed(capsys)
    assert main(common + ["--save", "mesh", "--mesh-model-parallel", "1", "--tp-explicit"]) == 0
    assert _printed(capsys) == want
    assert not dist.is_initialized()


def test_cli_serves_over_a_mesh(tmp_path):
    common = ["--type", "cpu.float", *R8, "--results_dir", str(tmp_path), "-b", "8", "--calibrate", "1"]
    assert main(common + ["--convert-int", "--resident", "--serve", "--serve-steps", "3",
                          "--mesh-model-parallel", "1", "--tp-explicit"]) == 0
    assert not dist.is_initialized()


MNIST = ["--model", "mnist", "--dataset", "mnist", "-b", "32", "--epochs", "1"]


@pytest.mark.usefixtures("one_torch_thread")
def test_cli_train_one_epoch_and_resume(tmp_path):
    common = ["--type", "cpu.float", *R8, "-b", "64", "--results_dir", str(tmp_path), "--lr", "0.02"]
    assert main(common + ["--save", "trainrun", "--epochs", "1"]) == 0
    run = tmp_path / "trainrun"
    rows = (run / "results.csv").read_text().splitlines()
    assert rows[0].startswith("epoch,train_loss,val_loss") and len(rows) == 2
    assert (run / "checkpoint.pt").exists() and (run / "model_best.pt").exists()
    assert main(common + ["--save", "evalrun", "--resume", str(run), "--calibrate", "1", "--convert-int", "-e"]) == 0


@pytest.mark.usefixtures("one_torch_thread")
def test_cli_deterministic_reruns_bitmatch(tmp_path):
    was = torch.are_deterministic_algorithms_enabled()
    try:
        csvs = []
        for name in ("det_a", "det_b"):
            assert main(["--type", "cpu.float", *MNIST, "--results_dir", str(tmp_path), "--save", name,
                         "--deterministic", "--seed", "7"]) == 0
            csvs.append((tmp_path / name / "results.csv").read_text())
        assert csvs[0] == csvs[1]
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("flags", [["--type", "cpu.float", "--compute-dtype", "bf16"], ["--type", "cpu.bf16"]])
def test_cli_bf16_trains(tmp_path, flags):
    assert main([*flags, *MNIST, "--results_dir", str(tmp_path), "--save", "bf16"]) == 0
    assert (tmp_path / "bf16" / "results.csv").exists()


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("model,extra", [
    ("alexnet", ["--export-reference", "alexnet.pth.tar"]),
    ("mobilenet", ["--model_config", "{'width_mult': 0.25, 'num_classes': 10}", "--dataset", "cifar10",
                   "--input_size", "32", "-b", "128", "--epochs", "1"]),
])
def test_float_zoo_runs(tmp_path, model, extra):
    extra = [str(tmp_path / e) if e.endswith(".pth.tar") else e for e in extra]
    assert main(["--type", "cpu.float", "--model", model, "--results_dir", str(tmp_path), "--save", model,
                 *extra]) == 0
