"""Device mesh construction (counterpart of ``quantized_tpu/parallel/mesh.py``).

Axes: ``data`` (batch, data parallel) x ``model`` (tensor parallel over conv
out-channels and fc columns). One rank of ``torch.distributed`` is one
device: a GPU (``cuda:LOCAL_RANK``, NCCL) or, where the caller asks for the
CPU, a process on the host (gloo). Ranks are laid out row-major, so the ranks
of one model group are contiguous, as ``mesh_utils`` lays the model axis
along the fastest links: ranks ``d*tp .. d*tp + tp - 1`` form data row ``d``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from quantized_tpu_torch._device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def infer_mesh_shape(num_devices: int, model_parallel: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) shape. Default: TP degree = min(num_devices, 4) for CNN
    channel dims (64..2048 divide 4 cleanly); DP takes the rest."""
    if model_parallel is None:
        model_parallel = 1
        for cand in (4, 2, 1):
            if num_devices % cand == 0:
                model_parallel = cand
                break
        model_parallel = min(model_parallel, num_devices)
    if model_parallel < 1 or num_devices % model_parallel:
        raise ValueError(f"{num_devices} devices do not split into model groups of {model_parallel}")
    return num_devices // model_parallel, model_parallel


def init_single_rank(device: DeviceLike = "cuda") -> None:
    """Bring up a one-rank process group for ``device``: NCCL on a CUDA
    device (made the current one), gloo only for the CPU. Its store lives in
    this process, so it opens no port."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device() if dev.index is None else dev.index)
    dist.init_process_group(BACKENDS[dev.type], store=dist.HashStore(), world_size=1, rank=0)


def rank_device(device_type: str) -> torch.device:
    """This rank's device: its current GPU, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def create_mesh(num_devices: Optional[int] = None, model_parallel: Optional[int] = None,
                device: DeviceLike = "cuda") -> DeviceMesh:
    """A (data, model) ``DeviceMesh`` over every rank of the process group.

    With no process group, a one-rank group comes up first
    (:func:`init_single_rank`). The group's backend must be the one of
    ``device`` (NCCL for CUDA, gloo for the CPU): a mesh over CUDA tensors
    never runs on gloo. ``num_devices`` may only restate the world size, as
    every rank is one device."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        init_single_rank(dev)
    backend = dist.get_backend()
    if backend != BACKENDS[dev.type]:
        raise RuntimeError(f"a mesh over {dev.type} tensors needs the {BACKENDS[dev.type]} backend, "
                           f"the process group runs {backend}")
    world = dist.get_world_size()
    n = num_devices or world
    if n != world:
        raise ValueError(f"num_devices={n}, but the process group has {world} ranks (one device each)")
    dp, tp = infer_mesh_shape(n, model_parallel)
    return DeviceMesh(dev.type, torch.arange(n).reshape(dp, tp), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def local_mesh(device: DeviceLike = "cuda") -> DeviceMesh:
    """The mesh over every rank of the process group, default shape."""
    return create_mesh(device=device)


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself, or TypeError where it is not a ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (parallel.create_mesh), got {type(mesh).__name__}")
    return mesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)
