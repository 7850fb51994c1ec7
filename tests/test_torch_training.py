"""The port's QAT ``Trainer`` against the JAX package's, on the CPU.

- One training epoch of two batches of 8 seeded images on CIFAR ResNet-8
  (depth 8), the float ``resnet`` and ``resnet_quantized_float_bn``: both
  trainers start from the same weights (the JAX model drawn by
  ``torch_jax_twins``, carried over by the weight bridge) with the same
  regime (SGD, lr 0.05, momentum 0.9, weight decay 1e-4), and every
  parameter, BN statistic and observer buffer is compared after it.
  Tolerances, from the spread of JAX's own ``Trainer`` run jitted against
  the same run under ``jax.disable_jit()`` (``tests/torch_trainer_spread.py``,
  case "test", on this CPU build),
  on the loss, the update of all parameters together (relative to its
  norm) and each tensor (relative to the larger of its own magnitude and
  the largest step any parameter took):
  - ``resnet``: measured 0, 6.7e-4 and 2.1e-4 (BN biases, sums with
    cancellation; JAX's two modes 5e-8, 2.6e-6 and 5e-7): tolerances 1e-6,
    5e-3 and 2e-3.
  - ``resnet_quantized_float_bn``: a fake-quant boundary moved by one ulp
    of a conv sum rounds to the other step, and JAX's two modes differ by
    1.9e-4, 5.8e-2 and 1.5e-2 between themselves; the port against the
    jitted run 1.7e-4, 5.7e-2 and 1.9e-2: tolerances 1e-3, 0.2 and 5e-2.
- The flagship ``resnet_quantized`` (8-bit gradients, bi-precision) at
  depth 8, the port of JAX's ``test_grad_quant_biprec_trainer_step_flagship``:
  the constants wired everywhere, every parameter moved and finite, the
  observers' and RangeBN's statistics moved, every grad-quant stream
  advanced, the loss lower over a second pass of the same batches.
- Every parameter of each quantized model gets a nonzero gradient in train
  mode (the straight-through backward is live everywhere).
- The regime switch (JAX's ``test_trainer_regime_epoch_switch_changes_lr``),
  with the optimizer state kept across an lr change and rebuilt across a
  class change. ``Trainer(mesh=)`` is ``tests/test_torch_mesh_training.py``.
"""

import numpy as np
import pytest
import torch

from quantized_tpu.training import Trainer as JTrainer
from quantized_tpu_torch.data import get_dataset, get_transform
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.models import layers as L
from quantized_tpu_torch.training import Trainer, cross_entropy
from torch_jax_twins import flat_state, jax_model
from torch_threads import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REGIME = {0: {"optimizer": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}}
STATS = ("mean", "var", "running_mean", "running_var", "running_min", "running_max")
# name: (loss rtol, update rtol of the norm, per-tensor rtol)
TOLERANCES = {"resnet": (1e-6, 5e-3, 2e-3), "resnet_quantized_float_bn": (1e-3, 0.2, 5e-2)}


def _batches(n=2, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(TOLERANCES))
def test_one_epoch_matches_jax_trainer(name):
    loss_rtol, update_rtol, tensor_rtol = TOLERANCES[name]
    jm = jax_model(name, seed=0, dataset="cifar10", depth=8)
    tm = get_model(name)(dataset="cifar10", depth=8)
    before = flat_state(jm)
    load_jax_arrays(tm, before)
    batches = _batches()
    want = JTrainer(jm, regime=REGIME, print_freq=10**6).train_epoch(batches, 0)
    got = Trainer(tm, regime=REGIME, print_freq=10**6, device="cpu").train_epoch(batches, 0)
    assert got["loss"] == pytest.approx(want["loss"], rel=loss_rtol)

    jax_after = flat_state(jm)
    port_after = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert set(port_after) == set(jax_after)
    params = [k for k in jax_after if not k.endswith(STATS)]
    step = max(np.abs(jax_after[k] - before[k]).max() for k in params)
    du = np.concatenate([(port_after[k] - jax_after[k]).ravel() for k in params])
    u = np.concatenate([(jax_after[k] - before[k]).ravel() for k in params])
    assert np.linalg.norm(du) <= update_rtol * np.linalg.norm(u), np.linalg.norm(du) / np.linalg.norm(u)
    for k, want_k in jax_after.items():
        scale = max(np.abs(want_k).max(), step)
        err = np.abs(port_after[k] - want_k).max()
        assert err <= tensor_rtol * scale, (k, err / scale)
        if k.endswith(("running_min", "running_max", "mean")):  # the statistics moved on both sides
            assert not np.array_equal(want_k, before[k]), k


def test_flagship_grad_quant_biprec_step():
    train = get_dataset("synthetic", "train", get_transform("cifar10", augment=False))
    model = get_model("resnet_quantized")(dataset="cifar10", depth=8, generator=torch.Generator().manual_seed(0))
    qconvs = [m for m in model.modules() if isinstance(m, L.QConv2d)]
    rbns = [m for m in model.modules() if isinstance(m, L.RangeBN)]
    assert qconvs and rbns
    assert all(c.num_bits_grad == 8 and c.biprecision for c in qconvs)
    assert model.fc.num_bits_grad == 8 and model.fc.biprecision
    assert all(b.num_bits_grad == 8 for b in rbns)
    p_before = {k: v.detach().clone() for k, v in model.named_parameters()}
    ema_before = float(qconvs[0].quantize_input.running_max[0])
    bn_mean_before = rbns[0].running_mean.clone()
    streams = [m.grad_quant_rng for m in model.modules() if hasattr(m, "grad_quant_rng")]
    counts_before = [s.count for s in streams]

    tr = Trainer(model, regime={0: {"optimizer": "SGD", "lr": 0.01, "momentum": 0.9}}, print_freq=10**6,
                 device="cpu")
    batches = [b for _, b in zip(range(6), train.batches(32, drop_remainder=True))]
    m0 = tr.train_epoch(batches, 0)
    for k, p in model.named_parameters():
        delta = (p.detach() - p_before[k]).abs().max()
        assert torch.isfinite(p).all() and delta > 0, k
    assert float(qconvs[0].quantize_input.running_max[0]) != ema_before
    assert not torch.equal(rbns[0].running_mean, bn_mean_before)
    assert all(s.count == c + len(batches) for s, c in zip(streams, counts_before))
    m1 = tr.train_epoch(batches, 1)
    assert np.isfinite(m0["loss"]) and np.isfinite(m1["loss"]) and m1["loss"] < m0["loss"], (m0, m1)


@pytest.mark.parametrize("name,cfg,shape", [
    ("resnet_quantized", dict(dataset="cifar10", depth=8), (2, 32, 32, 3)),
    ("resnet_quantized_float_bn", dict(dataset="cifar10", depth=8), (2, 32, 32, 3)),
    ("mobilenet_quantized", dict(num_classes=10, width_mult=0.25), (2, 64, 64, 3)),
    ("alexnet_quantized", dict(num_classes=10), (2, 224, 224, 3)),
])
def test_every_parameter_gets_a_gradient(name, cfg, shape):
    model = get_model(name)(generator=torch.Generator().manual_seed(1), **cfg).train()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    cross_entropy(model(x), torch.tensor([1, 3])).backward()
    for k, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, k


def test_regime_switch_changes_lr_and_keeps_the_state():
    model = get_model("resnet")(dataset="cifar10", depth=8, generator=torch.Generator().manual_seed(0))
    regime = {0: {"optimizer": "SGD", "lr": 0.1}, 2: {"lr": 0.001}, 3: {"optimizer": "adam", "lr": 1e-3}}
    tr = Trainer(model, regime=regime, print_freq=10**6, device="cpu")
    tr.adjust_for_epoch(0)
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(0.1)
    tr.train_epoch(_batches(n=1), 0)
    opt, trace = tr.optimizer, dict(tr.optimizer.state)
    tr.adjust_for_epoch(2)
    assert tr.optimizer is opt and tr.optimizer.param_groups[0]["lr"] == pytest.approx(0.001)
    assert all(tr.optimizer.state[p]["trace"] is trace[p]["trace"] for p in trace)
    tr.adjust_for_epoch(3)
    assert tr.optimizer is not opt and tr.optimizer.kind == "adam" and not tr.optimizer.state
