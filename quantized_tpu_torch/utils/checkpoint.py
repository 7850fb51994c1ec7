"""Checkpointing (counterpart of ``quantized_tpu/utils/checkpoint.py``).

Two formats:
- **Native**: ``torch.save`` of the model's state dict (``<name>.pt``) and
  the reference's metadata (epoch, model name, config, regime, best_prec1)
  as JSON (``<name>.meta.json``), with the reference's ``checkpoint`` /
  ``model_best`` naming and optional per-epoch copies (``save_all``). An
  asynchronous save copies the state to the host at the call and writes the
  file on a thread; ``wait_for_checkpoints`` joins it. (The JAX package
  writes Orbax directories; the two native formats are not interchangeable.)
- **Reference export**: ``export_reference_checkpoint`` writes a
  torch-loadable ``.pth.tar`` with the reference's key names and layouts
  (OIHW, the Sequential downsample indices, NCHW flatten), the inverse of
  ``ingest.load_into_model``, so checkpoints flow both ways between the two
  packages.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _host_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


class _PendingSaves:
    """In-flight asynchronous saves: (writer thread, post-save step, error box)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.items: List[Tuple[threading.Thread, Callable[[], None], list]] = []


_PENDING = _PendingSaves()


def wait_for_checkpoints() -> None:
    """Block until every in-flight asynchronous save is on disk and its
    post-save copies (``model_best``, per-epoch) are made; re-raise a
    writer's error. Call at the end of training (each save drains the one
    before it, so the pipeline is one save deep)."""
    with _PENDING.lock:
        pending, _PENDING.items = _PENDING.items, []
    for thread, post, error in pending:
        thread.join()
        if error:
            raise error[0]
        post()


def _write(state: Dict[str, torch.Tensor], path: str) -> None:
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # a reader never sees half a file


def save_checkpoint(
    model: nn.Module,
    path: str,
    meta: Optional[Dict[str, Any]] = None,
    is_best: bool = False,
    filename: str = "checkpoint",
    save_all: bool = False,
    async_save: bool = False,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> str:
    """Save the model's state and ``meta`` under ``path/filename``; copy them
    to ``model_best`` when ``is_best`` and to ``checkpoint_epoch_<epoch>``
    with ``save_all``. Returns the state file's path. With ``async_save``
    the state is copied to the host here and written on a thread. ``state``
    is saved in place of the model's own (a mesh trainer's gathered
    ``Trainer.full_state()``, the state one device would hold)."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, filename)
    state = _host_state(model.state_dict() if state is None else state)
    wait_for_checkpoints()
    with open(target + ".meta.json", "w") as f:
        json.dump({k: _jsonable(v) for k, v in (meta or {}).items()}, f)
    saved = target + ".pt"

    def post() -> None:
        if is_best:
            _copy_ckpt(target, os.path.join(path, "model_best"))
        if save_all and meta and "epoch" in meta:
            _copy_ckpt(target, os.path.join(path, f"checkpoint_epoch_{meta['epoch']}"))

    if async_save:
        error: list = []

        def run() -> None:
            try:
                _write(state, saved)
            except Exception as e:  # handed to wait_for_checkpoints, which raises it
                error.append(e)

        thread = threading.Thread(target=run, name="qtpu-checkpoint", daemon=False)
        thread.start()
        with _PENDING.lock:
            _PENDING.items.append((thread, post, error))
        return saved
    _write(state, saved)
    post()
    return saved


def _copy_ckpt(target_base: str, dest_base: str) -> None:
    shutil.copyfile(target_base + ".pt", dest_base + ".pt")
    if os.path.exists(target_base + ".meta.json"):
        shutil.copyfile(target_base + ".meta.json", dest_base + ".meta.json")


def load_checkpoint(model: nn.Module, path: str, filename: str = "checkpoint") -> Dict[str, Any]:
    """Restore ``model`` in place from ``path/filename`` (or the file base
    ``path``); returns the metadata (the reference's ``--resume``). Every
    state entry of the model must be in the file, with its shape."""
    target = os.path.join(path, filename) if os.path.isdir(path) else path
    if not os.path.exists(target + ".pt"):
        raise FileNotFoundError(f"no checkpoint at {target}.pt")
    saved = torch.load(target + ".pt", map_location="cpu", weights_only=True)
    model.load_state_dict(saved, strict=True)
    meta: Dict[str, Any] = {}
    if os.path.exists(target + ".meta.json"):
        with open(target + ".meta.json") as f:
            meta = json.load(f)
    return meta


def export_reference_checkpoint(model: nn.Module, path: str, meta: Optional[Dict[str, Any]] = None) -> str:
    """Write a reference-format torch ``.pth.tar`` (the inverse of
    ``ingest.load_into_model``): OIHW conv weights, torch BN names, the
    Sequential downsample indices, the NCHW flatten of AlexNet's fc1."""
    flatten_name, flatten_chw = getattr(model, "flatten_linear", (None, None))
    state_dict = {}
    for key, t in model.state_dict().items():
        val = t.detach().cpu().numpy()
        parts = key.split(".")
        leaf, prefix = parts[-1], parts[:-1]
        prefix = ["0" if (x == "conv" and i and prefix[i - 1] == "downsample") else x for i, x in enumerate(prefix)]
        prefix = ["1" if (x == "bn" and i and prefix[i - 1] == "downsample") else x for i, x in enumerate(prefix)]
        if (leaf == "weight" and val.ndim == 2 and prefix and prefix[-1] == flatten_name
                and val.shape[1] == int(np.prod(flatten_chw))):
            c, h, w = flatten_chw
            val = val.reshape(val.shape[0], h, w, c).transpose(0, 3, 1, 2).reshape(val.shape[0], -1)
        if leaf == "kernel":
            name, val = "weight", val.transpose(3, 2, 0, 1)
        elif leaf in ("scale", "mean", "var") and val.ndim == 1:
            name = {"scale": "weight", "mean": "running_mean", "var": "running_var"}[leaf]
        else:
            name = leaf
        state_dict[".".join(prefix + [name])] = torch.from_numpy(np.ascontiguousarray(val))
    payload = dict(meta or {})
    payload["state_dict"] = state_dict
    torch.save(payload, path)
    return path


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return float(v) if hasattr(v, "__float__") else str(v)
