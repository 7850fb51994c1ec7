"""How far one training epoch of the port's ``Trainer`` lands from JAX's, and
how far JAX's own ``Trainer`` lands from itself run jitted and eagerly
(``jax.disable_jit()``), on the CPU: the yardstick the training tolerances
of ``tests/test_torch_training.py`` and ``chip_smoke.py``'s
``TRAIN_PARITY_TOL`` are set against. A fake-quant boundary moved by one ulp
of a conv sum rounds to the other step, so two correct runs of a quantized
model differ by what this prints, not by rounding.

Run from the repository root: ``python tests/torch_trainer_spread.py``.
For each case it prints the relative loss difference, the norm of the
parameters' update difference over the norm of the update, and the worst
tensor's difference over the larger of its magnitude and the largest step,
for JAX eager against JAX jitted and for the port against JAX jitted.

- case ``test``: ``tests/test_torch_training.py``'s epoch (CIFAR ResNet-8,
  the JAX model drawn by ``torch_jax_twins``, two seeded batches of 8);
- case ``chip``: ``chip_smoke.py``'s parity step (CIFAR ResNet-20 from the
  port's seed-0 weights, one batch of 32 from ``torch.Generator`` seed 3).
The port runs on one thread, as the tests run it.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import nnx  # noqa: E402

from quantized_tpu.models import get_model as j_get_model  # noqa: E402
from quantized_tpu.training import Trainer as JTrainer  # noqa: E402
from quantized_tpu_torch.ingest import load_jax_arrays  # noqa: E402
from quantized_tpu_torch.models import get_model  # noqa: E402
from quantized_tpu_torch.training import Trainer  # noqa: E402
from torch_jax_twins import flat_state, jax_model, load_flat_state  # noqa: E402

REGIME = {0: {"optimizer": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}}
STATS = ("mean", "var", "running_mean", "running_var", "running_min", "running_max")


def _distances(got, want, before, loss_got, loss_want):
    params = [k for k in want if not k.endswith(STATS)]
    step = max(np.abs(want[k] - before[k]).max() for k in params)
    du = np.linalg.norm(np.concatenate([(got[k] - want[k]).ravel() for k in params]))
    u = np.linalg.norm(np.concatenate([(want[k] - before[k]).ravel() for k in params]))
    worst = max((np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), step), k) for k in want)
    return abs(loss_got - loss_want) / abs(loss_want), du / u, worst


def _jax_twin(name, depth, state):
    jm = nnx.eval_shape(lambda: j_get_model(name)(rngs=nnx.Rngs(0), dataset="cifar10", depth=depth))
    for _, var in nnx.to_flat_state(nnx.state(jm)):
        if isinstance(var, nnx.RngKey):
            var.set_value(jax.random.key(0))
        elif isinstance(var, nnx.RngCount):
            var.set_value(jax.numpy.zeros((), jax.numpy.uint32))
    return load_flat_state(jm, state)


def case(kind, name):
    if kind == "test":
        depth, jm = 8, jax_model(name, seed=0, dataset="cifar10", depth=8)
        before = flat_state(jm)
        rng = np.random.default_rng(0)
        batches = [(rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
                    rng.integers(0, 10, 8).astype(np.int32)) for _ in range(2)]
    else:
        depth = 20
        before = {k: v.numpy().copy() for k, v in
                  get_model(name)(dataset="cifar10", depth=20, generator=torch.Generator().manual_seed(0))
                  .state_dict().items()}
        gen = torch.Generator().manual_seed(3)
        batches = [(torch.randn((32, 32, 32, 3), generator=gen).numpy(),
                    torch.randint(0, 10, (32,), generator=gen).numpy())]
    runs = {}
    for mode in ("jit", "eager"):
        jm = _jax_twin(name, depth, before)
        trainer = JTrainer(jm, regime=REGIME, print_freq=10**6)
        if mode == "eager":
            with jax.disable_jit():
                loss = trainer.train_epoch(batches, 0)["loss"]
        else:
            loss = trainer.train_epoch(batches, 0)["loss"]
        runs[mode] = (loss, flat_state(jm))
    tm = get_model(name)(dataset="cifar10", depth=depth)
    load_jax_arrays(tm, before)
    torch.set_num_threads(1)
    loss = Trainer(tm, regime=REGIME, print_freq=10**6, device="cpu").train_epoch(batches, 0)["loss"]
    port = {k: v.numpy() for k, v in tm.state_dict().items()}
    want_loss, want = runs["jit"]
    for label, (got_loss, got) in (("jax eager vs jit", runs["eager"]), ("port vs jax jit", (loss, port))):
        loss_rel, update_rel, (worst, key) = _distances(got, want, before, got_loss, want_loss)
        print(f"{kind} {name}: {label}: loss {loss_rel:.3g}, update {update_rel:.3g}, worst tensor {worst:.3g} "
              f"({key})", flush=True)


if __name__ == "__main__":
    for kind in ("test", "chip"):
        for name in ("resnet", "resnet_quantized_float_bn"):
            case(kind, name)
