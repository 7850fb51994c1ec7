"""The port's training over a mesh (``Trainer(mesh=)``) on a gloo group of
four rank processes on the CPU, against the port's one-device trainer on
the global batch and against JAX's GSPMD trainer.

One module-scoped fixture starts the four ranks (``tests/torch_dist.py``;
each runs ``tests/torch_dist_worker.py``, torch and the port only) and,
while they run, computes the references in this process.

- CIFAR ResNet-8 at 28x28, two SGD steps of a global batch of 12 whose
  second half is scaled by 4 (so per-shard statistics would differ from
  the global ones), from JAX-drawn weights, on meshes (4, 1), (2, 2) and
  (1, 4). At 28x28 the last stage's rows (12 x 7 x 7 = 588) split into
  chunks of 36, which straddle the data shards of 147 and 294 rows.
  Against the one-device trainer on the same batches: the loss, every
  parameter and buffer after each step (gathered on rank 0), the
  grad-quant stream counts. Tolerances, as ``tests/test_torch_training.py``
  measures them (the loss, the update of all parameters relative to its
  norm, each tensor relative to the larger of its magnitude and the
  largest step), each about twice the largest gap measured here over the
  three meshes and both steps (``test_mesh_trainer_matches_one_device``
  prints them under ``-s``):
  - the float ``resnet``: the mesh only reorders sums (the shards' means
    averaged, the gradients summed over ``data``); (1e-6, 1e-5, 1e-6),
    measured at most 1.0e-7, 2.8e-6 and 2.4e-7;
  - ``resnet_quantized_float_bn`` (1e-4, 0.1, 3e-2), measured at most
    3.8e-5, 0.055 and 0.014 (at (2, 2), step 2), and the flagship
    ``resnet_quantized`` (8-bit gradients with the global noise draw,
    bi-precision) (1e-3, 0.15, 4e-2), measured at most 5.6e-4, 0.092 and
    0.027 (after step 1: 0.016-0.018 on the update): a sum reordered by
    one ulp moves a fake-quant boundary, and the next step amplifies it.
- The statistics are the global batch's: after the first step at (2, 2)
  the stem's observer range and its BN's (or RangeBN's) running buffers
  equal the one-device run's within 1e-6 relative, and differ from those
  of a run on data shard 0 alone by more than 100 times that.
- MobileNet-v1 at width 0.25 (``mobilenet_quantized``, 32x32, batch 4)
  at (1, 4): the depthwise convs' groups sliced with their channels, one
  step against the one-device trainer within 1e-5 (measured 6.8e-7 on
  the update).
- ``quantize_grad`` (stochastic) at (2, 2) on each rank's block of a
  cotangent whose range sits in two ranks' blocks: bit-equal to that
  block of the one-device quantized cotangent.
- ``collectives.chunk_extrema`` with ties inside and across shards, at
  data degree 4: the values and the gradient against ``amax``/``amin``.
- (2, 2) against JAX's ``Trainer(mesh=create_mesh(num_devices=4,
  model_parallel=2))`` on ``resnet_quantized_float_bn`` from the same
  weights, within ``tests/test_torch_training.py``'s tolerances (1e-3,
  0.2, 5e-2; measured 0.055 on the update, 0.020 on a tensor); JAX's
  ``test_trainer_on_mesh_dp_tp`` and
  ``test_trainer_on_mesh_composes_with_bf16_compute`` (CIFAR ResNet-20,
  four batches of 64, two epochs; here at (2, 2) on four ranks).
- The checkpoint: rank 0's file from the (2, 2) run has the one-device
  keys and shapes and the trained values; loaded into a (1, 4) trainer it
  gives the one-device trainer's next step from the same file.
- ``entry.dryrun_multichip(4)`` on the four ranks, its images at 64x64
  (224 on the card): two DP+TP steps, the sharded flagship forward, the
  explicit-TP forward and one multi-host serving step, one line printed.
"""

import re

import numpy as np
import pytest
import torch

from quantized_tpu.parallel import create_mesh as j_create_mesh
from quantized_tpu.training import Trainer as JTrainer
from quantized_tpu_torch.data import get_dataset, get_transform
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.quantcore import quantize_grad
from quantized_tpu_torch.training import Trainer
from quantized_tpu_torch.utils.checkpoint import load_checkpoint
from torch_dist import Ranks
from torch_jax_twins import flat_state, jax_model

REGIME = {0: {"optimizer": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}}
MODELS = ("resnet", "resnet_quantized_float_bn", "resnet_quantized")
MESHES = {(4, 1): 1, (2, 2): 2, (1, 4): 4}
CFG = {"dataset": "cifar10", "depth": 8}
BATCH, SIDE = 12, 28
STATS = ("mean", "var", "running_mean", "running_var", "running_min", "running_max")
# mesh against one device, name: (loss rtol, update rtol of the norm, per-tensor rtol), each about twice
# the largest gap measured over the three meshes and two steps (module docstring)
TOLERANCES = {"resnet": (1e-6, 1e-5, 1e-6), "resnet_quantized_float_bn": (1e-4, 0.1, 3e-2),
              "resnet_quantized": (1e-3, 0.15, 4e-2)}
MOBILENET_TOL = (1e-5, 1e-5, 1e-5)
JAX_TOL = (1e-3, 0.2, 5e-2)  # tests/test_torch_training.py's, the port against JAX
GLOBAL_RTOL = 1e-6  # the first step's stem statistics
STEM = {"resnet": ("bn1.mean", "bn1.var"),
        "resnet_quantized_float_bn": ("conv1.quantize_input.running_min", "conv1.quantize_input.running_max",
                                      "bn1.mean", "bn1.var"),
        "resnet_quantized": ("conv1.quantize_input.running_min", "conv1.quantize_input.running_max",
                             "bn1.running_mean", "bn1.running_var")}
MOBILENET = {"width_mult": 0.25, "num_classes": 10}
EPOCH_BATCHES, EPOCH_BATCH = 4, 64
DRYRUN_SIDE = 64


def _batches(n=3):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        x = rng.standard_normal((BATCH, SIDE, SIDE, 3)).astype(np.float32)
        x[BATCH // 2:] *= 4.0  # data shard 1's rows (at data degree 2) four times the scale of shard 0's
        out.append((x, rng.integers(0, 10, BATCH).astype(np.int64)))
    return out


def _port(name, state=None, cfg=CFG):
    model = get_model(name)(generator=torch.Generator().manual_seed(0), **cfg)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _one_device(name, state, batches, cfg=CFG):
    """The one-device trainer's loss and state after each batch."""
    tr = Trainer(_port(name, state, cfg), regime=REGIME, print_freq=10**6, device="cpu")
    losses, states = [], []
    for b in batches:
        losses.append(tr.train_epoch([b], 0)["loss"])
        states.append({k: v.numpy().copy() for k, v in tr.model.state_dict().items()})
    streams = [m.grad_quant_rng.count for m in tr.model.modules() if hasattr(m, "grad_quant_rng")]
    return {"losses": losses, "states": states, "streams": streams}


def _epoch_batches():
    train = get_dataset("synthetic", "train", get_transform("cifar10", augment=False))
    return list(train.batches(EPOCH_BATCH, drop_remainder=True))[:EPOCH_BATCHES]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _world(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _world(tmp_path_factory):
    batches = _batches()
    jms = {name: jax_model(name, seed=0, **CFG) for name in MODELS}
    init = {}
    for name, jm in jms.items():
        tm = _port(name)
        load_jax_arrays(tm, flat_state(jm))
        init[name] = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    ckpt = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(5)
    ties = np.round(rng.standard_normal((3, 4 * 37)) * 2).astype(np.float32)  # integers: ties everywhere
    ties[0, 30:45] = 9.0  # channel 0's global max in chunks 3 and 4, on ranks 0 and 1
    extrema = dict(tp=1, y=ties, num_chunks=16, g_max=rng.standard_normal((3, 16)).astype(np.float32),
                   g_min=rng.standard_normal((3, 16)).astype(np.float32))
    g = rng.standard_normal((4, 3, 3, 8)).astype(np.float32)
    g[0, 0, 0, 0], g[3, 2, 2, 7] = -9.0, 7.0  # the global range from rank 0's and rank 3's blocks alone
    grad_block = dict(tp=2, g=g, seed=11, bits=8)
    cases = [("extrema", "extrema", extrema), ("grad_block", "grad_block", grad_block)]
    for name in MODELS:
        for shape, tp in MESHES.items():
            save = str(ckpt) if (name, shape) == ("resnet_quantized_float_bn", (2, 2)) else None
            cases.append(((name, shape), "train", dict(tp=tp, model=(name, CFG, init[name]), regime=REGIME,
                                                      batches=batches[:2], save=save)))
    mobilenet = [(np.random.default_rng(7).standard_normal((4, 32, 32, 3)).astype(np.float32), np.arange(4))]
    cases.append(("mobilenet", "train", dict(tp=4, model=("mobilenet_quantized", MOBILENET, None), regime=REGIME,
                                             batches=mobilenet)))
    float_bn = ("resnet_quantized_float_bn", CFG, None)
    cases.append(("resume", "resume", dict(tp=4, model=float_bn, regime=REGIME, load=str(ckpt), batches=batches[2:])))
    epochs = _epoch_batches()
    r20 = ("resnet_quantized_float_bn", {"dataset": "cifar10", "depth": 20}, None)
    epoch_regime = {0: {"optimizer": "SGD", "lr": 0.05, "momentum": 0.9}}
    for dtype in (None, "bf16"):
        cases.append((("epochs", dtype), "epochs", dict(tp=2, model=r20, regime=epoch_regime, batches=epochs,
                                                        compute_dtype=dtype)))
    cases.append(("dryrun", "dryrun", dict(side=DRYRUN_SIDE)))
    ranks = Ranks(4, {"cases": cases}, tmp_path_factory.mktemp("mesh_train"))

    # the references, while the ranks run
    one = {name: _one_device(name, init[name], batches[:2]) for name in MODELS}
    shard0 = {name: _one_device(name, init[name], [(batches[0][0][:BATCH // 2], batches[0][1][:BATCH // 2])])
              for name in MODELS}
    one["mobilenet"] = _one_device("mobilenet_quantized", None, mobilenet, MOBILENET)
    one["mobilenet"]["init"] = {k: v.numpy()
                                for k, v in _port("mobilenet_quantized", None, MOBILENET).state_dict().items()}
    jm = jms["resnet_quantized_float_bn"]
    jtr = JTrainer(jm, regime=REGIME, mesh=j_create_mesh(num_devices=4, model_parallel=2), print_freq=10**6)
    jax_losses = [jtr.train_epoch([b], 0)["loss"] for b in batches[:2]]
    results, codes, outs = ranks.results()
    for r, (res, out) in enumerate(zip(results, outs)):
        assert "error" not in res, f"rank {r}:\n{res.get('error')}\n{out[-2000:]}"
    assert codes == [0] * 4, (codes, [o[-2000:] for o in outs])
    return {"ranks": results, "one": one, "shard0": shard0, "init": init, "batches": batches, "ckpt": ckpt,
            "extrema": extrema, "grad_block": grad_block, "jax": {"losses": jax_losses, "state": flat_state(jm)}}


def _close(got, want, before, tol, what):
    """``got`` against ``want`` (state dicts in numpy, ``before`` the start):
    the update of all parameters relative to its norm, each tensor relative
    to the larger of its magnitude and the largest step."""
    _, update_rtol, tensor_rtol = tol
    assert set(got) == set(want), what
    params = [k for k in want if not k.endswith(STATS)]
    step = max(np.abs(want[k] - before[k]).max() for k in params)
    du = np.concatenate([(got[k] - want[k]).ravel() for k in params])
    u = np.concatenate([(want[k] - before[k]).ravel() for k in params])
    update = np.linalg.norm(du) / np.linalg.norm(u)
    assert update <= update_rtol, (what, update)
    worst = 0.0
    for k, w in want.items():
        assert got[k].shape == w.shape, (what, k)
        gap = np.abs(got[k] - w).max() / max(np.abs(w).max(), step)
        assert gap <= tensor_rtol, (what, k, gap)
        worst = max(worst, gap)
    return update, worst


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", MODELS)
def test_mesh_trainer_matches_one_device(world, name, shape):
    loss_rtol = TOLERANCES[name][0]
    one = world["one"][name]
    for rank, res in enumerate(world["ranks"]):
        run = res[(name, shape)]
        dp, d, tp, m = run["coords"]
        assert (dp, tp) == shape
        assert run["losses"] == pytest.approx(one["losses"], rel=loss_rtol), (rank, run["losses"], one["losses"])
        assert run["streams"] == one["streams"], rank
        if tp > 1:  # true blocks: the stem's kernel holds 16 / tp out channels
            assert run["blocks"]["conv1.kernel"] == (3, 3, 3, 16 // tp), run["blocks"]["conv1.kernel"]
    states = world["ranks"][0][(name, shape)]["states"]
    befores = [world["init"][name], one["states"][0]]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(world["ranks"][0][(name, shape)]["losses"], one["losses"]))
    for step, (got, want, before) in enumerate(zip(states, one["states"], befores)):
        update, worst = _close(got, want, before, TOLERANCES[name], (name, shape, step))
        print(f"\ngap {name} {shape} step {step}: loss {loss_gap:.3g} update {update:.3g} tensor {worst:.3g}")


@pytest.mark.parametrize("name", MODELS)
def test_statistics_are_the_global_batch(world, name):
    """After the first step at (2, 2) the stem's statistics are the global
    batch's to 1e-6, and a shard's own would be over 100 times farther."""
    got = world["ranks"][0][(name, (2, 2))]["states"][0]
    want = world["one"][name]["states"][0]
    own = world["shard0"][name]["states"][0]
    for k in STEM[name]:
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= GLOBAL_RTOL * scale, (k, np.abs(got[k] - want[k]).max() / scale)
        assert np.abs(own[k] - want[k]).max() > 100 * GLOBAL_RTOL * scale, k


def test_chunk_extrema_straddle_and_ties(world):
    """16 chunks of 9 over 148 elements in four shards of 37: chunks
    straddle shards, ties sit inside and across them (channel 0's maximum
    9 in chunks 3 and 4, on ranks 0 and 1); the gradient splits over the
    global ties as ``amax``'s."""
    job = world["extrema"]
    y = torch.from_numpy(job["y"]).requires_grad_(True)
    yc = y[:, :144].reshape(3, 16, 9)
    gmax, gmin = yc.amax(-1), yc.amin(-1)
    ((gmax * torch.from_numpy(job["g_max"])).sum() + (gmin * torch.from_numpy(job["g_min"])).sum()).backward()
    for res in world["ranks"]:
        e = res["extrema"]
        d, n = e["rows"]
        np.testing.assert_array_equal(e["max"], gmax.detach().numpy())
        np.testing.assert_array_equal(e["min"], gmin.detach().numpy())
        np.testing.assert_allclose(e["grad"], y.grad.numpy()[:, d * n:(d + 1) * n], rtol=1e-6, atol=1e-7)


def _quantized_cotangent(g, seed, bits):
    """``quantize_grad``'s stochastic backward of ``g`` on one device."""
    x = torch.zeros(g.shape, requires_grad=True)
    quantize_grad(x, torch.Generator().manual_seed(seed), num_bits=bits).backward(torch.from_numpy(g))
    return x.grad.numpy()


def test_quantized_cotangent_block_is_the_one_device_block(world):
    """At (2, 2) each rank's stochastic ``quantize_grad`` of its block of a
    (4, 3, 3, 8) cotangent (rows over ``data``; channels whole, and split
    over ``model``) equals, bit for bit, that block of the one-device
    quantized cotangent: the range over both axes, the noise from the global
    draw. A block quantized on its own range with a draw of its own shape
    differs."""
    job = world["grad_block"]
    g = job["g"]
    want = _quantized_cotangent(g, job["seed"], job["bits"])
    for res in world["ranks"]:
        dp, d, tp, m = res["grad_block"]["coords"]
        assert (dp, tp) == (2, 2)
        rows = want[d * 2:(d + 1) * 2]
        np.testing.assert_array_equal(res["grad_block"]["blocks"][False], rows)
        channels = rows[..., m * 4:(m + 1) * 4]
        np.testing.assert_array_equal(res["grad_block"]["blocks"][True], channels)
        own = _quantized_cotangent(np.ascontiguousarray(g[d * 2:(d + 1) * 2, ..., m * 4:(m + 1) * 4]),
                                   job["seed"], job["bits"])
        assert not np.array_equal(own, channels)


def test_mesh_trainer_matches_jax_mesh_trainer(world):
    """(2, 2) against JAX's GSPMD trainer on the same mesh shape from the
    same weights (``tests/test_torch_training.py``'s tolerances, which hold
    the port's one-device trainer against JAX's)."""
    name = "resnet_quantized_float_bn"
    run = world["ranks"][0][(name, (2, 2))]
    assert run["losses"] == pytest.approx(world["jax"]["losses"], rel=JAX_TOL[0])
    _close(run["states"][-1], world["jax"]["state"], world["init"][name], JAX_TOL, "jax")


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_trainer_on_mesh_dp_tp(world, dtype):
    """JAX's ``test_trainer_on_mesh_dp_tp`` and, with bf16,
    ``test_trainer_on_mesh_composes_with_bf16_compute``: the loss falls over
    a second epoch; the parameters stay f32."""
    for res in world["ranks"]:
        e = res[("epochs", dtype)]
        assert e["losses"][1] < e["losses"][0], e["losses"]
        assert e["dtypes"] == ["torch.float32"]
        assert e["switched"] == (22 if dtype else 0)


def test_checkpoint_of_a_mesh_run(world):
    """Rank 0's file from the (2, 2) run: the one-device keys and shapes
    and the trained values; loaded into a (1, 4) trainer it takes the step
    the one-device trainer takes from the same file."""
    name = "resnet_quantized_float_bn"
    saved = torch.load(world["ckpt"] / "checkpoint.pt", weights_only=True)
    trained = world["ranks"][0][(name, (2, 2))]["states"][-1]
    assert {k: tuple(v.shape) for k, v in saved.items()} == {k: v.shape for k, v in world["init"][name].items()}
    for k, v in saved.items():
        np.testing.assert_array_equal(v.numpy(), trained[k])
    model = _port(name)
    load_checkpoint(model, str(world["ckpt"]))
    want = _one_device(name, {k: v.numpy() for k, v in model.state_dict().items()}, world["batches"][2:])
    resumed = world["ranks"][0]["resume"]
    assert resumed["loss"] == pytest.approx(want["losses"][0], rel=TOLERANCES[name][0])
    _close(resumed["state"], want["states"][0], {k: v.numpy() for k, v in saved.items()}, TOLERANCES[name], "resume")


def test_dryrun_multichip(world):
    for res in world["ranks"]:
        line = res["dryrun"]["line"]
        assert line.startswith("dryrun_multichip(4): mesh={'data': 1, 'model': 4}"), line
        assert f"@{DRYRUN_SIDE}x{DRYRUN_SIDE} mesh_logits=(8, 1000)" in line and "tp_logits=(8, 1000)" in line, line
        convs, gathers, scatters = map(int, re.search(r"convs=(\d+), all_gather=(\d+), reduce_scatter=(\d+)",
                                                      line).groups())
        assert convs > 0 and gathers == convs + 1 and scatters == 1, line  # each conv's gather and the head's
        assert line.endswith("multihost_batcher_served=3x(1000,)"), line


def test_mesh_trainer_slices_grouped_convs(world):
    """MobileNet-v1 w0.25 at (1, 4): each depthwise conv holds a quarter of
    its groups; one step equals the one-device step within 1e-5."""
    one = world["one"]["mobilenet"]
    for res in world["ranks"]:
        run = res["mobilenet"]
        assert run["blocks"]["block0.dw.kernel"] == (3, 3, 1, 2), run["blocks"]["block0.dw.kernel"]
        assert run["losses"] == pytest.approx(one["losses"], rel=MOBILENET_TOL[0])
    _close(world["ranks"][0]["mobilenet"]["states"][0], one["states"][0], one["init"], MOBILENET_TOL, "mobilenet")
