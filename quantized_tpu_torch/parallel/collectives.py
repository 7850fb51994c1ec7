"""Explicit collectives over a (data, model) mesh (counterpart of
``quantized_tpu/parallel/collectives.py``).

JAX writes these as ``shard_map`` bodies; here each function is that body,
run on every rank of the mesh: it takes and returns this rank's blocks (the
slices the JAX function's ``in_specs`` and ``out_specs`` name) and calls the
collective on the mesh axis's process group.

- ``tp_linear``: weight rows (output features) sharded over ``model``; each
  rank computes its output columns, and an all-gather over ``model``
  reassembles them.
- ``tp_linear_reduce_scatter``: the contraction sharded over ``model``; the
  partial products are reduce-scattered, each rank keeping its columns.
- ``dp_psum_grads``: gradient all-reduce (mean) over ``data``.

Every collective of the port goes through :func:`all_gather`,
:func:`reduce_scatter` or :func:`all_reduce`, which count their calls by op
and by mesh axis (:func:`collective_counts`): the counterpart of the
collective ops that JAX's tests count in the compiled HLO. A call inside a
CUDA graph capture counts once, at the capture.

NCCL and gloo carry no int16: an int16 all-gather (the int16 shortcut leg)
moves its bytes as int8, which a gather copies unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from quantized_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size

# torch 2.13 renamed the tensor forms; the old names stay for older builds
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

_COUNTS: Dict[str, Dict[str, int]] = {}


def _count(op: str, axis: str) -> None:
    per_axis = _COUNTS.setdefault(op, {})
    per_axis[axis] = per_axis.get(axis, 0) + 1


def reset_collectives() -> None:
    _COUNTS.clear()


def collective_counts() -> Dict[str, Dict[str, int]]:
    """{op: {mesh axis: calls}} since the last :func:`reset_collectives`."""
    return {op: dict(per_axis) for op, per_axis in _COUNTS.items()}


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of ``axis``'s group concatenated along ``dim``, in
    rank order (JAX's ``all_gather(..., tiled=True)``)."""
    if t.dtype == torch.int16:  # no int16 on the wire: its bytes, two a value, gather alike
        return all_gather(t.contiguous().view(torch.int8), mesh, axis, dim).view(torch.int16)
    _count("all_gather", axis)
    n = axis_size(mesh, axis)
    t = t.contiguous()
    rows = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    _ALL_GATHER(rows, t, group=mesh.get_group(axis))
    if n == 1 or dim % t.ndim == 0:  # rank-ordered blocks along dim 0 are the result already
        return rows
    return torch.cat(rows.chunk(n), dim=dim)


def reduce_scatter(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The sum over ``axis``'s group of ``t``, of which this rank keeps its
    block along ``dim`` (JAX's ``psum_scatter(..., tiled=True)``)."""
    _count("reduce_scatter", axis)
    n = axis_size(mesh, axis)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {n} ranks")
    blocks = torch.cat(t.chunk(n, dim=dim)) if dim % t.ndim else t.contiguous()  # rank r's block the r-th
    out = torch.empty((blocks.shape[0] // n, *blocks.shape[1:]), dtype=t.dtype, device=t.device)
    _REDUCE_SCATTER(out, blocks, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``axis``'s group (a new tensor)."""
    _count("all_reduce", axis)
    out = t.clone()
    dist.all_reduce(out, op=op, group=mesh.get_group(axis))
    return out


def tp_linear(mesh: DeviceMesh, x: torch.Tensor, w_oi: torch.Tensor,
              b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w.T + b with w's rows (output features) sharded over
    ``model``: ``x`` is this rank's rows, ``w_oi`` and ``b`` its output
    features; returns its rows at full width (an all-gather over
    ``model``)."""
    y = x @ w_oi.T
    if b is not None:
        y = y + b
    return all_gather(y, mesh, MODEL_AXIS, dim=1)


def tp_linear_reduce_scatter(mesh: DeviceMesh, x: torch.Tensor, w_oi: torch.Tensor) -> torch.Tensor:
    """y = x @ w.T with the contraction sharded over ``model``: ``x`` is this
    rank's rows and columns, ``w_oi`` its columns; the partial products are
    reduce-scattered over ``model``, leaving this rank its output columns."""
    return reduce_scatter(x @ w_oi.T, mesh, MODEL_AXIS, dim=1)


def dp_psum_grads(mesh: DeviceMesh, grads):
    """The mean over ``data`` of every tensor of ``grads`` (a tensor, or a
    dict, list or tuple of them, nested), as a new structure alike."""
    if isinstance(grads, torch.Tensor):
        return all_reduce(grads, mesh, DATA_AXIS, op=dist.ReduceOp.AVG)
    if isinstance(grads, dict):
        return {k: dp_psum_grads(mesh, v) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(dp_psum_grads(mesh, v) for v in grads)
    raise TypeError(f"dp_psum_grads takes tensors, dicts, lists and tuples, got {type(grads).__name__}")
