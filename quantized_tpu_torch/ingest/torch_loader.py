"""Load reference PyTorch checkpoints into the port's models (counterpart of
``quantized_tpu/ingest/torch_loader.py``).

The port's modules carry the JAX package's state names and layouts (see
``ingest/jax_arrays.py``), so the reference-to-port translation is the JAX
package's reference-to-nnx translation, followed by the weight bridge:
- conv weights: OIHW -> HWIO, key ``<m>.weight`` -> ``<m>.kernel``;
- linear weights: (out, in) kept, key ``weight`` stays;
- BatchNorm: ``weight/bias/running_mean/running_var`` -> ``scale/bias/mean/var``;
- RangeBN: ``weight/bias/running_mean/running_var`` keep their names;
- observers: ``quantize_input.running_min/.running_max`` keep their names;
- downsample: the reference's ``downsample.0``/``downsample.1`` (a
  Sequential) -> ``downsample.conv``/``downsample.bn``;
- the NCHW-flatten boundary (AlexNet's fc1): the reference flattens conv
  maps as (C, H, W), the zoo as NHWC, so those weight columns are permuted;
- ``num_batches_tracked`` (torch BN bookkeeping) is skipped, and a
  DataParallel ``module.`` prefix is stripped.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from quantized_tpu_torch.ingest.jax_arrays import load_jax_arrays


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference ``checkpoint.pth.tar`` (or a bare state dict):
    ``{"state_dict": {key: numpy array}, "meta": the other entries}``. Only
    tensors and plain containers are unpickled (``weights_only``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, Mapping) and "state_dict" in ckpt:
        meta = {k: v for k, v in ckpt.items() if k != "state_dict"}
        state_dict = ckpt["state_dict"]
    else:
        meta, state_dict = {}, ckpt
    out = {}
    for k, v in state_dict.items():
        k = k[len("module."):] if k.startswith("module.") else k
        out[k] = v.detach().cpu().numpy()
    return {"state_dict": out, "meta": meta}


_BN_KEY_MAP = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def state_dict_to_port(state_dict: Mapping[str, np.ndarray], model: nn.Module) -> Dict[str, np.ndarray]:
    """Translate reference keys and layouts into ``{port state key: array}``.

    The model decides whether a BN-like key belongs to a float BatchNorm
    (renamed) or a RangeBN (names kept): the first candidate that exists in
    its state wins. A key with no home raises ``KeyError``."""
    available = set(model.state_dict())
    flatten_name, flatten_chw = getattr(model, "flatten_linear", (None, None))
    out: Dict[str, np.ndarray] = {}
    for key, arr in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        arr = np.asarray(arr)
        parts = key.split(".")
        parts = ["conv" if (p == "0" and i and parts[i - 1] == "downsample") else p for i, p in enumerate(parts)]
        parts = ["bn" if (p == "1" and i and parts[i - 1] == "downsample") else p for i, p in enumerate(parts)]
        leaf, prefix = parts[-1], parts[:-1]
        if (leaf == "weight" and arr.ndim == 2 and prefix and prefix[-1] == flatten_name
                and arr.shape[1] == int(np.prod(flatten_chw))):
            c, h, w = flatten_chw
            arr = arr.reshape(arr.shape[0], c, h, w).transpose(0, 2, 3, 1).reshape(arr.shape[0], -1)
        candidates = []
        if arr.ndim == 4 and leaf == "weight":
            candidates.append((prefix + ["kernel"], arr.transpose(2, 3, 1, 0)))
        if leaf in _BN_KEY_MAP:
            candidates.append((prefix + [_BN_KEY_MAP[leaf]], arr))
        candidates.append((parts, arr))  # identity: RangeBN, observers, linear
        for cand_parts, cand_arr in candidates:
            cand = ".".join(cand_parts)
            if cand in available:
                out[cand] = np.ascontiguousarray(cand_arr)
                break
        else:
            raise KeyError(f"checkpoint key {key!r} has no home in the model "
                           f"(tried {['.'.join(c[0]) for c in candidates]})")
    return out


def load_into_model(model: nn.Module, path_or_state: Any, strict: bool = True) -> nn.Module:
    """Load a reference checkpoint (a path, or a state dict of arrays) into
    ``model`` in place. ``strict`` requires every state entry of the model
    to be covered (the weight bridge's check); otherwise the covered entries
    are copied, each shape checked."""
    if isinstance(path_or_state, (str, os.PathLike)):
        state_dict = load_reference_checkpoint(str(path_or_state))["state_dict"]
    else:
        state_dict = path_or_state
    mapped = state_dict_to_port(state_dict, model)
    if strict:
        return load_jax_arrays(model, mapped)
    state = model.state_dict()
    for k, arr in mapped.items():
        if tuple(arr.shape) != tuple(state[k].shape):
            raise ValueError(f"shape mismatch at {k}: model {tuple(state[k].shape)} checkpoint {arr.shape}")
    with torch.no_grad():
        for k, arr in mapped.items():
            state[k].copy_(torch.from_numpy(np.array(arr, dtype=np.float32)).to(state[k].dtype))
    return model
