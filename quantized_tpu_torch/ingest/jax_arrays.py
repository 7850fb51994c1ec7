"""Weight bridge: load a flat dict of arrays, keyed by the JAX model's state
paths, into the port's model.

The JAX model's parameters and statistics flatten to dotted paths such as
``layer1.0.conv1.kernel``, ``layer1.0.bn1.mean`` or
``conv1.quantize_input.running_min``. The port's modules carry the same
names and layouts (HWIO conv kernels, (out, in) linear weights, observer
buffers of shape (1,)), so its ``state_dict`` has exactly those keys. The
flattening on the JAX side is the caller's; this module only checks and
copies.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def load_jax_arrays(model: nn.Module, arrays: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy ``arrays`` into ``model`` in place and return it.

    Every key of the model must be given and every given key must exist in
    the model, each with the model's shape; otherwise nothing is copied and
    ``ValueError`` names the offending keys."""
    state = model.state_dict()
    missing = sorted(set(state) - set(arrays))
    unexpected = sorted(set(arrays) - set(state))
    bad_shape = sorted(
        f"{k}: {tuple(np.shape(arrays[k]))} != {tuple(state[k].shape)}"
        for k in set(state) & set(arrays)
        if tuple(np.shape(arrays[k])) != tuple(state[k].shape)
    )
    if missing or unexpected or bad_shape:
        raise ValueError(
            f"state does not match the model: missing {missing[:8]} ({len(missing)}), "
            f"unexpected {unexpected[:8]} ({len(unexpected)}), shapes {bad_shape[:8]} ({len(bad_shape)})"
        )
    with torch.no_grad():
        for k, t in state.items():
            t.copy_(torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(t.dtype))
    return model
