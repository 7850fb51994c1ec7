"""Optimizer regime of the port (counterpart of
``quantized_tpu/training/regime.py``, the reference's ``adjust_optimizer``).

``regime_settings`` walks every regime entry with epoch <= the current one
and merges its settings (lr, momentum, weight decay, optimizer class by
name); a callable regime is called with the epoch.

:class:`RegimeOptimizer` computes what JAX's optax chains compute, in
their order of operations:

- ``sgd``: ``add_decayed_weights`` then ``optax.sgd`` (a momentum trace
  ``t = g + momentum * t`` kept even at momentum 0, so a regime that turns
  momentum on later continues the trace as optax does; torch's SGD would
  start a fresh buffer);
- ``adam``: ``add_decayed_weights`` then ``optax.adam`` (b1 0.9, b2 0.999,
  eps 1e-8 outside the square root);
- ``adamw``: ``optax.adamw``, the decay added to the Adam update;
- ``rmsprop``: ``add_decayed_weights`` then ``optax.rmsprop`` (decay 0.9,
  eps 1e-8 inside the square root, the momentum trace taken after the lr
  scaling) — not ``torch.optim.RMSprop`` (alpha 0.99, eps outside, the
  trace before the lr).

A parameter without a gradient is updated as with a zero gradient (optax
updates every parameter). lr, momentum and weight decay live in
``param_groups``: :func:`update_hyperparams` changes them and keeps the
state; a change of optimizer class builds a new optimizer (the caller's
job, ``training.qat.Trainer.adjust_for_epoch``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch

DEFAULT_SETTINGS = {"optimizer": "SGD", "lr": 0.1, "momentum": 0.0, "weight_decay": 0.0}
OPTIMIZERS = ("sgd", "adam", "adamw", "rmsprop")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8


def regime_settings(regime: Optional[Dict[int, Dict[str, Any]]], epoch: int) -> Dict[str, Any]:
    """Merged settings at ``epoch`` (the cumulative walk); a callable regime
    is called with the epoch first."""
    merged = dict(DEFAULT_SETTINGS)
    if regime is None:
        return merged
    if callable(regime):
        regime = regime(epoch)
    for e in sorted(k for k in regime if k <= epoch):
        merged.update(regime[e])
    return merged


def _hyperparams(settings: Dict[str, Any]) -> Dict[str, float]:
    return {"lr": float(settings.get("lr", 0.1)),
            "momentum": float(settings.get("momentum", 0.0) or 0.0),
            "weight_decay": float(settings.get("weight_decay", 0.0) or 0.0)}


class RegimeOptimizer(torch.optim.Optimizer):
    """One of optax's ``sgd``, ``adam``, ``adamw`` and ``rmsprop`` chains as
    ``regime.py`` builds them (see the module docstring)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], optimizer: str = "SGD", lr: float = 0.1,
                 momentum: float = 0.0, weight_decay: float = 0.0):
        self.kind = optimizer.lower()
        if self.kind not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {optimizer!r}; known: {OPTIMIZERS}")
        super().__init__(params, {"lr": lr, "momentum": momentum, "weight_decay": weight_decay})

    def _state(self, params, name: str):
        return [self.state[p].setdefault(name, torch.zeros_like(p)) for p in params]

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = group["params"]
            if not ps:
                continue
            lr, momentum, wd = group["lr"], group["momentum"], group["weight_decay"]
            gs = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
            if self.kind != "adamw":  # add_decayed_weights before the core
                gs = torch._foreach_add(gs, ps, alpha=wd)
            if self.kind == "sgd":
                trace = self._state(ps, "trace")
                torch._foreach_mul_(trace, momentum)
                torch._foreach_add_(trace, gs)
                torch._foreach_add_(ps, trace, alpha=-lr)
            elif self.kind in ("adam", "adamw"):
                mu, nu = self._state(ps, "mu"), self._state(ps, "nu")
                count = self.state[ps[0]].get("count", 0) + 1
                self.state[ps[0]]["count"] = count
                torch._foreach_mul_(mu, ADAM_B1)
                torch._foreach_add_(mu, gs, alpha=1.0 - ADAM_B1)
                torch._foreach_mul_(nu, ADAM_B2)
                torch._foreach_addcmul_(nu, gs, gs, value=1.0 - ADAM_B2)
                mu_hat = torch._foreach_div(mu, 1.0 - ADAM_B1 ** count)
                nu_hat = torch._foreach_div(nu, 1.0 - ADAM_B2 ** count)
                denom = torch._foreach_sqrt(nu_hat)
                torch._foreach_add_(denom, ADAM_EPS)
                updates = torch._foreach_div(mu_hat, denom)
                if self.kind == "adamw":
                    torch._foreach_add_(updates, ps, alpha=wd)
                torch._foreach_add_(ps, updates, alpha=-lr)
            else:  # rmsprop
                nu, trace = self._state(ps, "nu"), self._state(ps, "trace")
                torch._foreach_mul_(nu, RMSPROP_DECAY)
                torch._foreach_addcmul_(nu, gs, gs, value=1.0 - RMSPROP_DECAY)
                scaling = torch._foreach_add(nu, RMSPROP_EPS)
                torch._foreach_rsqrt_(scaling)
                updates = torch._foreach_mul(scaling, gs)
                torch._foreach_mul_(trace, momentum)
                torch._foreach_add_(trace, updates, alpha=-lr)
                torch._foreach_add_(ps, trace)
        return None


def build_optimizer(settings: Dict[str, Any], params: Iterable[torch.nn.Parameter]) -> RegimeOptimizer:
    """The optimizer of ``settings`` (class, lr, momentum, weight decay) over
    ``params``, with fresh state."""
    return RegimeOptimizer(params, settings["optimizer"], **_hyperparams(settings))


def update_hyperparams(optimizer: RegimeOptimizer, settings: Dict[str, Any]) -> RegimeOptimizer:
    """Set lr, momentum and weight decay in place, keeping the state."""
    for group in optimizer.param_groups:
        group.update(_hyperparams(settings))
    return optimizer
