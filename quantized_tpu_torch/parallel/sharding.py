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

``prepare_for_training`` readies a fake-quant model for training over a
mesh: it slices the state by :func:`param_partition_spec` and gives every
layer a :class:`MeshPlace` in its ``mesh_place`` attribute (as
``training.set_compute_dtype`` sets ``compute_dtype``). A sliced conv or
dense layer computes its out-channel block from its full-width input
(whose gradient it sums over ``model``); the BN or RangeBN registered
right after it in the same module normalizes that block and gathers the
channels; a sliced layer with no such BN gathers its own output (a sliced
BN with no such layer before it is refused). Every input of a conv or
dense layer is so at full width. ``gather_state`` puts
the whole state back together.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from quantized_tpu_torch.parallel import collectives as C
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


@dataclasses.dataclass(frozen=True, eq=False)
class MeshPlace:
    """Where a layer of a model prepared for training over ``mesh`` sits:
    this rank's coordinates, whether its output channels are sliced over
    ``model`` (``sharded``) and whether it gathers them after it
    (``gather``). Activations are this rank's rows of the global batch,
    split evenly over ``data`` in its order."""

    mesh: DeviceMesh
    sharded: bool = False
    gather: bool = False
    data_index: int = 0
    data_size: int = 1
    model_index: int = 0
    model_size: int = 1

    @classmethod
    def of(cls, mesh: DeviceMesh, sharded: bool = False, gather: bool = False) -> "MeshPlace":
        return cls(mesh, sharded, gather, axis_index(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS),
                   axis_index(mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS))

    def __deepcopy__(self, memo):
        return self  # a placement, shared by every copy of the layer

    def block(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of a full-width ``t`` along ``dim``."""
        return t.chunk(self.model_size, dim=dim)[self.model_index]

    def shared_input(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, a full-width input of this sliced layer, with its gradient
        summed over ``model`` (``collectives.sum_grad``)."""
        return C.sum_grad(t, self.mesh, MODEL_AXIS)

    def gather_channels(self, t: torch.Tensor) -> torch.Tensor:
        """The output channels of every model rank (``collectives.gather_block``)."""
        return C.gather_block(t, self.mesh, MODEL_AXIS, dim=-1)

    def model_min_max(self, lo: torch.Tensor, hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the MIN of ``lo``, the MAX of ``hi``) over ``model``: the range
        of a tensor whose blocks the model ranks hold. No gradient."""
        return C.all_reduce_min_max(lo, hi, self.mesh, (MODEL_AXIS,))

    def global_min_max(self, lo: torch.Tensor, hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the MIN of ``lo``, the MAX of ``hi``) over both axes: the range
        of a global activation or cotangent of which this rank holds a
        (rows, channels) block. No gradient."""
        return C.all_reduce_min_max(lo, hi, self.mesh, (DATA_AXIS, MODEL_AXIS))

    def sample_means(self, lo: torch.Tensor, hi: torch.Tensor,
                     channels_sharded: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """The means over the global batch of per-sample minima ``lo`` and
        maxima ``hi`` of this rank's rows (each sample's taken over ``model``
        first where ``channels_sharded``): every sample's gathered over
        ``data`` in batch order and averaged as one device averages them."""
        if channels_sharded:
            lo, hi = self.model_min_max(lo, hi)
        both = C.all_gather(torch.stack([lo, hi]), self.mesh, DATA_AXIS, dim=1)
        return both[0].mean(), both[1].mean()

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch's mean from ``t``, this rank's mean over its rows
        (the rows split evenly): the data ranks' ``t`` averaged, the gradient
        summed back (``collectives.all_reduce_sum_grad``)."""
        return C.all_reduce_sum_grad(t, self.mesh, DATA_AXIS) / self.data_size

    def chunk_extrema(self, y: torch.Tensor, chunk: int, num_chunks: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """RangeBN's per-chunk (max, min) of the global rows, ``y`` (C, n)
        this rank's ``n`` of them (``collectives.chunk_extrema``)."""
        return C.chunk_extrema(y, self.mesh, DATA_AXIS, self.data_index * y.shape[1], chunk, num_chunks)

    def uniform(self, shape, generator: torch.Generator, device, channels_sharded: bool) -> torch.Tensor:
        """This rank's block of a U[0, 1) draw of the global tensor: the
        draw one device makes for the whole batch (rows over ``data``, the
        last dim over ``model`` where ``channels_sharded``), so every rank's
        stream draws alike and the block equals the one-device values."""
        rows = shape[0]
        full = (rows * self.data_size, *shape[1:-1], shape[-1] * (self.model_size if channels_sharded else 1))
        u = torch.rand(full, generator=generator, dtype=torch.float32, device=device)
        u = u[self.data_index * rows:(self.data_index + 1) * rows]
        return self.block(u) if channels_sharded else u


def _channels(layer: nn.Module) -> int:
    """A conv's, dense layer's or BN's output channels as its state holds them."""
    if hasattr(layer, "kernel"):
        return layer.kernel.shape[3]
    if hasattr(layer, "in_features"):
        return layer.weight.shape[0]
    return (layer.mean if hasattr(layer, "mean") else layer.running_mean).shape[0]


def prepare_for_training(model: nn.Module, mesh: DeviceMesh) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """Slice ``model``'s state to this rank's block of ``model`` and give
    every layer its :class:`MeshPlace` (module docstring). Returns the
    sliced tensors by state name: (the sliced dim, the full shape)."""
    from quantized_tpu_torch.models import layers as L

    products, norms = (L.Conv2d, L.QConv2d, L.Linear, L.QLinear), (L.BatchNorm, L.RangeBN)
    full = {k: (tuple(v.shape), param_partition_spec(k, v)) for k, v in model.state_dict().items()}
    width = {m: _channels(m) for m in model.modules() if isinstance(m, products + norms)}
    paired = set()
    for parent in model.modules():
        kids = list(parent.children())
        for a, b in zip(kids, kids[1:]):
            if isinstance(a, products) and isinstance(b, norms) and width[a] == width[b]:
                paired.update((a, b))
    shard_model_state(model, mesh)
    state = model.state_dict()
    sliced = {k: (spec.index(MODEL_AXIS), shape) for k, (shape, spec) in full.items()
              if tuple(state[k].shape) != shape}
    for name, m in model.named_modules():
        if isinstance(m, products + norms):
            sharded = _channels(m) != width[m]
            if sharded and isinstance(m, norms) and m not in paired:
                raise ValueError(f"{name}: a sliced BN takes its channels from the conv or dense layer registered "
                                 "right before it in its module, and it has none")
            if sharded and getattr(m, "groups", 1) > 1 and m.groups % axis_size(mesh, MODEL_AXIS):
                raise ValueError(f"{name}: {m.groups} groups do not split over the model axis")
            m.mesh_place = MeshPlace.of(mesh, sharded, gather=sharded and (isinstance(m, norms) or m not in paired))
        elif isinstance(m, (L.QuantMeasure, L.Dropout)):
            m.mesh_place = MeshPlace.of(mesh)
    return sliced


def gather_state(model: nn.Module, mesh: DeviceMesh,
                 sliced: Dict[str, Tuple[int, Tuple[int, ...]]]) -> Dict[str, torch.Tensor]:
    """The whole state of a model prepared by :func:`prepare_for_training`,
    each sliced tensor gathered over ``model`` (a collective: every rank
    calls it), on the model's device."""
    out = {}
    for k, v in model.state_dict().items():
        out[k] = C.all_gather(v.detach(), mesh, MODEL_AXIS, dim=sliced[k][0]) if k in sliced else v.detach()
    return out
