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

Training over a mesh places by hand the reductions that GSPMD places for
JAX (``training.qat.Trainer(mesh=)``); these carry the gradient:

- :func:`all_reduce_sum_grad`: a sum whose backward sums the incoming
  gradient over the group (float BN's and RangeBN's means, as
  ``SyncBatchNorm`` reduces them);
- :func:`all_reduce_min_max`: a MIN/MAX over one or more axes, with no
  gradient (the weight, observer and cotangent ranges);
- :func:`sum_grad`: the identity, whose backward sums the gradient over the
  group (the full-width input of a layer whose output channels are split
  over ``model``: each rank's backward holds its channels' share);
- :func:`gather_block`: a channel all-gather whose backward keeps this
  rank's block of the incoming gradient. ``torch.distributed.nn``'s gather
  sums the incoming gradients over the group; every model rank computes
  the same replicated loss downstream, so that sum would multiply each
  sharded weight's gradient by the model degree;
- :func:`chunk_extrema`: RangeBN's per-chunk max and min over rows split
  over ``data`` (a chunk may straddle two ranks); its backward sends the
  gradient to the rank or ranks holding the global extreme, a tie split
  over the global count of tied elements, as ``amax`` splits it.

Every collective of the port goes through :func:`all_gather`,
:func:`reduce_scatter` or :func:`all_reduce`, which count their calls by op
and by mesh axis (:func:`collective_counts`; a MIN reduction counts as
``all_reduce_min``): the counterpart of the collective ops that JAX's tests
count in the compiled HLO. A backward's collectives count as they run. A
call inside a CUDA graph capture counts once, at the capture.

NCCL and gloo carry no int16: an int16 all-gather (the int16 shortcut leg)
moves its bytes as int8, which a gather copies unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

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
    _count("all_reduce_min" if op == dist.ReduceOp.MIN else "all_reduce", axis)
    out = t.detach().clone()
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


class _SumWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axis), None, None


def all_reduce_sum_grad(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over ``axis``'s group; its backward sums the incoming
    gradient over the group too. Every rank uses the global value, so the
    gradient of each rank's ``t`` is the sum of what every rank's use of it
    sends back."""
    return _SumWithGrad.apply(t, mesh, axis)


def all_reduce_min_max(lo: torch.Tensor, hi: torch.Tensor, mesh: DeviceMesh,
                       axes: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the MIN of ``lo``, the MAX of ``hi``) over the groups of ``axes``
    in turn: one MIN all-reduce an axis of ``lo`` and ``-hi`` packed
    together. No gradient; the shapes are kept."""
    packed = torch.cat([lo.detach().reshape(-1), -hi.detach().reshape(-1)])
    for axis in axes:
        packed = all_reduce(packed, mesh, axis, op=dist.ReduceOp.MIN)
    n = lo.numel()
    return packed[:n].reshape(lo.shape), -packed[n:].reshape(hi.shape)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axis), None, None


def sum_grad(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``t`` itself; the backward sums the incoming gradient over ``axis``'s
    group. ``t`` is replicated over the group and each rank's use of it
    sends back only its share of the gradient."""
    return _SumGrad.apply(t, mesh, axis)


class _GatherBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.parts, ctx.index, ctx.dim = axis_size(mesh, axis), mesh.get_local_rank(axis), dim
        return all_gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.parts, dim=ctx.dim)[ctx.index], None, None, None


def gather_block(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` of ``axis``'s group concatenated along ``dim``; the
    backward hands this rank its own block of the incoming gradient, not a
    sum over the group (each rank holds the whole replicated gradient of
    the gathered tensor)."""
    return _GatherBlock.apply(t, mesh, axis, dim)


def _chunk_segments(offset: int, n: int, chunk: int, num_chunks: int):
    """(start, stop, first chunk, chunks) of the runs of this rank's
    elements ``0 .. n - 1`` (global ``offset ..``) that fill chunks: a
    partial chunk at either end, whole ones between (at most three runs);
    elements past ``num_chunks * chunk`` belong to none."""
    end, s, runs = min(n, num_chunks * chunk - offset), 0, []
    while s < end:
        k, into = divmod(offset + s, chunk)
        if into or end - s < chunk:
            e, m = min(end, s + chunk - into), 1
        else:
            m = (end - s) // chunk
            e = s + m * chunk
        runs.append((s, e, k, m))
        s = e
    return runs


class _ChunkExtrema(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, axis, offset, chunk, num_chunks):
        c = y.shape[0]
        runs = _chunk_segments(offset, y.shape[1], chunk, num_chunks)
        lmax = y.new_full((c, num_chunks), -torch.inf)
        lmin = y.new_full((c, num_chunks), torch.inf)
        for s, e, k, m in runs:
            v = y[:, s:e].reshape(c, m, -1)
            lmax[:, k:k + m], lmin[:, k:k + m] = v.amax(-1), v.amin(-1)
        g = all_reduce(torch.cat([-lmax, lmin]), mesh, axis, op=dist.ReduceOp.MIN)
        gmax, gmin = -g[:c], g[c:]
        ties = y.new_zeros((2 * c, num_chunks))
        for s, e, k, m in runs:
            v = y[:, s:e].reshape(c, m, -1)
            ties[:c, k:k + m] = (v == gmax[:, k:k + m, None]).sum(-1)
            ties[c:, k:k + m] = (v == gmin[:, k:k + m, None]).sum(-1)
        ctx.mesh, ctx.axis, ctx.runs = mesh, axis, runs
        ctx.save_for_backward(y, gmax, gmin, all_reduce(ties, mesh, axis))
        return gmax, gmin

    @staticmethod
    def backward(ctx, g_max, g_min):
        y, gmax, gmin, ties = ctx.saved_tensors
        c = y.shape[0]
        share = all_reduce(torch.cat([g_max, g_min]).contiguous(), ctx.mesh, ctx.axis) / ties
        dy = torch.zeros_like(y)
        for s, e, k, m in ctx.runs:  # amax's and amin's split: the share at each element equal to the extreme
            v = y[:, s:e].reshape(c, m, -1)
            d = (v == gmax[:, k:k + m, None]) * share[:c, k:k + m, None] \
                + (v == gmin[:, k:k + m, None]) * share[c:, k:k + m, None]
            dy[:, s:e] = d.reshape(c, -1)
        return dy, None, None, None, None, None


def chunk_extrema(y: torch.Tensor, mesh: DeviceMesh, axis: str, offset: int, chunk: int,
                  num_chunks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """RangeBN's per-chunk (max, min), each (C, ``num_chunks``), of rows
    split over ``axis``: ``y`` (C, n) holds elements ``offset`` ..
    ``offset + n - 1`` of each channel's global row, whose chunk ``k`` is
    elements ``k * chunk`` .. ``(k + 1) * chunk - 1`` (the tail past
    ``num_chunks * chunk`` belongs to none). Each rank reduces its part of
    each chunk (its whole chunks as one device reduces them, a partial one
    at either end apart), one MIN all-reduce takes both extremes, a SUM the
    global count of the elements equal to each. The backward sums the incoming
    gradient over the group and splits it evenly over those elements."""
    return _ChunkExtrema.apply(y, mesh, axis, offset, chunk, num_chunks)
