"""The port's optimizer regime against the JAX package's
``training/regime.py``.

- ``regime_settings``: the port of ``test_regime_settings_cumulative_walk``
  (``tests/test_training_serving.py:19``), callable regimes included.
- Each optimizer class the regime names (SGD with momentum and weight
  decay, adam, adamw, rmsprop) against the optax chain of JAX's
  ``build_optimizer`` over five steps of the same numpy gradients: the lr,
  momentum and weight decay change before step 3 (in place, the state
  kept: JAX sets the injected hyperparameters, as ``update_hyperparams``
  does through ``nnx.Optimizer``'s state), and before step 4 the optimizer
  class changes, which rebuilds the state on both sides. Parameters agree
  within 1e-6 relative after every step (f32 arithmetic in the same order;
  the two libraries may contract a multiply-add differently).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quantized_tpu.training.regime import build_optimizer as j_build_optimizer
from quantized_tpu.training.regime import regime_settings as j_regime_settings
from quantized_tpu_torch.training.regime import (
    DEFAULT_SETTINGS,
    RegimeOptimizer,
    build_optimizer,
    regime_settings,
    update_hyperparams,
)

RTOL = 1e-6
SHAPES = {"w": (4, 6), "b": (6,), "k": (3, 3, 2, 5)}


def test_regime_settings_cumulative_walk():
    regime = {
        0: {"optimizer": "SGD", "lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4},
        30: {"lr": 0.01},
        60: {"lr": 1e-3, "weight_decay": 0},
    }
    s0, s45, s99 = (regime_settings(regime, e) for e in (0, 45, 99))
    assert s0["lr"] == 0.1 and s45["lr"] == 0.01 and s99["lr"] == 1e-3
    assert s45["momentum"] == 0.9  # carried forward
    assert s99["weight_decay"] == 0
    assert regime_settings(lambda e: {0: {"lr": e}}, 5)["lr"] == 5
    assert regime_settings(None, 7) == DEFAULT_SETTINGS
    for e in (0, 29, 30, 61, 200):
        assert regime_settings(regime, e) == j_regime_settings(regime, e)


# (first settings, after step 2, after step 3: another class)
SCHEDULES = {
    "sgd": ({"optimizer": "SGD", "lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4},
            {"optimizer": "SGD", "lr": 0.02, "momentum": 0.5, "weight_decay": 1e-3},
            {"optimizer": "adam", "lr": 1e-3, "momentum": 0.0, "weight_decay": 1e-4}),
    "adam": ({"optimizer": "adam", "lr": 1e-2, "momentum": 0.0, "weight_decay": 5e-4},
             {"optimizer": "adam", "lr": 3e-3, "momentum": 0.0, "weight_decay": 0.0},
             {"optimizer": "rmsprop", "lr": 1e-3, "momentum": 0.9, "weight_decay": 0.0}),
    "adamw": ({"optimizer": "AdamW", "lr": 1e-2, "momentum": 0.0, "weight_decay": 1e-2},
              {"optimizer": "AdamW", "lr": 2e-3, "momentum": 0.0, "weight_decay": 1e-3},
              {"optimizer": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 0.0}),
    "rmsprop": ({"optimizer": "RMSprop", "lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-4},
                {"optimizer": "RMSprop", "lr": 1e-3, "momentum": 0.5, "weight_decay": 0.0},
                {"optimizer": "adamw", "lr": 1e-3, "momentum": 0.0, "weight_decay": 1e-2}),
}


def _set_hyperparams(opt_state, settings):
    """JAX's ``update_hyperparams`` applied to a raw optax state (the JAX
    function rebuilds each value through its nnx variable type)."""
    for k in ("lr", "momentum", "weight_decay"):
        opt_state.hyperparams[k] = jnp.asarray(float(settings.get(k, 0.0) or 0.0), jnp.float32)


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_optimizer_matches_optax_chain(kind):
    first, changed, swapped = SCHEDULES[kind]
    rng = np.random.default_rng(sorted(SCHEDULES).index(kind))
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(5)]

    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    tx = j_build_optimizer(first)
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = build_optimizer(first, tparams.values())
    assert isinstance(opt, RegimeOptimizer) and opt.kind == kind

    for step, g in enumerate(grads, start=1):
        if step == 3:
            _set_hyperparams(jstate, changed)
            kept = {id(t) for st in opt.state.values() for t in st.values() if torch.is_tensor(t)}
            update_hyperparams(opt, changed)
            assert {id(t) for st in opt.state.values() for t in st.values() if torch.is_tensor(t)} == kept
            assert opt.param_groups[0]["lr"] == changed["lr"]
        if step == 4:
            tx = j_build_optimizer(swapped)
            jstate = tx.init(jparams)
            opt = build_optimizer(swapped, tparams.values())
            assert not opt.state
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            want = np.asarray(jparams[k])
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                                       err_msg=f"{kind} step {step} {k}")


def test_missing_gradient_counts_as_zero_and_unknown_class_raises():
    """optax updates every parameter: one without a gradient still decays
    and follows its momentum trace."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = build_optimizer({"optimizer": "SGD", "lr": 0.1, "momentum": 0.0, "weight_decay": 0.5}, [p])
    opt.step()
    torch.testing.assert_close(p.detach(), torch.full((3,), 1.0 - 0.1 * 0.5))
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer({"optimizer": "lamb", "lr": 0.1}, [p])
