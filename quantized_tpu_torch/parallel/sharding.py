"""Partition rules for the port's tensors (counterpart of
``quantized_tpu/parallel/sharding.py``).

A spec is a tuple with one entry per dim: the mesh axis that dim is split
over, or None. TP shards the output channels of every conv and the output
features of every dense layer over ``model``; per-channel vectors follow
their channel; observer buffers (shape (1,)) and scalars replicate; a dim
that does not divide the axis replicates the tensor (JAX's fallback).

The rules name the port's own layouts:

- the fake-quant models keep JAX's layouts (``kernel`` HWIO, ``weight``
  (out, in)), so :func:`param_partition_spec` is JAX's rule dim for dim;
- the int engines hold their weights K-major: a conv's ``w_ck`` (Cout,
  Kh*Kw*Cin) or ``w_int4`` (Cout, Kh*Kw, Cin/2), a dense layer's ``w_nk``
  (N, K), the fused blocks' ``w1``...``wpw`` (Cout, K): the out-channel dim
  is dim 0, where JAX's HWIO kernel has it last and its (K, N) dense weight
  second. The clamp ``y_clip`` (2, Cout) and the strict engine's
  ``tap_w_hat`` (Kh*Kw, Cout) keep it last.

``shard_model_state`` and ``shard_int_engine_state`` replace each sharded
tensor of a module with this rank's slice along ``model`` (the data axis
holds no weights). A sliced engine module computes this rank's output
channels; ``parallel.tp_engine`` wraps the modules it slices so that the
channels are gathered after them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from quantized_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size

Spec = Tuple[Optional[str], ...]
OUT_LAST = ("y_clip", "tap_w_hat")  # int-engine tensors whose out channels are their last dim


def _out_dim_spec(ndim: int, dim: int) -> Spec:
    return tuple(MODEL_AXIS if d == dim else None for d in range(ndim))


def param_partition_spec(name: str, value: torch.Tensor) -> Spec:
    """Fake-quant model rule (structural, as JAX's): HWIO conv kernels shard
    out channels, (out, in) dense weights their rows, per-channel vectors
    their channel; (1,) observer buffers and scalars replicate."""
    ndim = value.ndim
    if ndim == 4:
        return _out_dim_spec(4, 3)
    if ndim == 2:
        return _out_dim_spec(2, 0)
    if ndim == 1 and value.shape[0] > 1:
        return (MODEL_AXIS,)
    return (None,) * ndim


def activation_spec(rank: int) -> Spec:
    """NHWC activations: batch over data, channels over model."""
    if rank == 4:
        return (DATA_AXIS, None, None, MODEL_AXIS)
    if rank == 2:
        return (DATA_AXIS, MODEL_AXIS)
    return (DATA_AXIS,)


def int_engine_partition_spec(name: str, value: torch.Tensor) -> Spec:
    """Int engine rule over the port's K-major layouts (module docstring):
    the out-channel dim of every weight, clamp and per-channel vector over
    ``model``; (1,) tensors and scalars replicate."""
    ndim = value.ndim
    if ndim == 0 or (ndim == 1 and value.shape[0] == 1):
        return (None,) * ndim
    if name.rsplit(".", 1)[-1] in OUT_LAST:
        return _out_dim_spec(ndim, ndim - 1)
    return _out_dim_spec(ndim, 3 if ndim == 4 else 0)


def shard_tensor(t: torch.Tensor, spec: Spec, index: int, parts: int) -> torch.Tensor:
    """Block ``index`` of ``parts`` of ``t`` along its ``model`` dim (a view);
    ``t`` itself where the spec replicates or the dim does not divide."""
    if MODEL_AXIS not in spec:
        return t
    dim = spec.index(MODEL_AXIS)
    if t.shape[dim] % parts:
        return t
    return t.chunk(parts, dim=dim)[index]


def slice_state(module: nn.Module, rule: Callable[[str, torch.Tensor], Spec], index: int, parts: int) -> int:
    """Replace every parameter and persistent buffer of ``module`` that
    ``rule`` shards with block ``index`` of ``parts``, in place; returns
    how many were sliced."""
    sliced = 0
    for prefix, m in module.named_modules():
        for kind in ("_parameters", "_buffers"):
            for name, t in list(getattr(m, kind).items()):
                if t is None or (kind == "_buffers" and name in m._non_persistent_buffers_set):
                    continue
                full = f"{prefix}.{name}" if prefix else name
                block = shard_tensor(t.detach(), rule(full, t), index, parts)
                if block.shape == t.shape:  # replicated, or one part
                    continue
                with torch.inference_mode(False), torch.no_grad():  # its own storage, counting its changes
                    block = block.contiguous().clone()
                getattr(m, kind)[name] = nn.Parameter(block, t.requires_grad) if kind == "_parameters" else block
                sliced += 1
    return sliced


def shard_model_state(module: nn.Module, mesh: DeviceMesh) -> int:
    """Slice a fake-quant model's state to this rank's block of ``model``
    (:func:`param_partition_spec`); returns the tensors sliced."""
    return slice_state(module, param_partition_spec, axis_index(mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS))


def shard_int_engine_state(module: nn.Module, mesh: DeviceMesh) -> int:
    """Slice an int engine module's state to this rank's block of ``model``
    (:func:`int_engine_partition_spec`); returns the tensors sliced."""
    return slice_state(module, int_engine_partition_spec, axis_index(mesh, MODEL_AXIS),
                       axis_size(mesh, MODEL_AXIS))
