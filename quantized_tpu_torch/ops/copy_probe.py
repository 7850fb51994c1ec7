"""Copy probes (B9): an int8 tensor copied, or copied with 1 added to every
byte (wrapping, as ``(x.astype(int32) + 1).astype(int8)`` does), by three
hand-written CUDA kernels (``csrc/copy_probe.cu``), the counterparts of the
Pallas copy and DMA-ring bodies of the JAX package's TPU studies
(``bench/fused_probe.py``, ``bench/dma_ring_probe*.py``):

- :func:`grid_copy`: one kernel block per ``bi`` images (``x.shape[0]``
  counts the images), 16-byte loads and stores: the auto-pipelined grid
  copies;
- :func:`ring_copy`: one persistent block per SM streaming ``bi``-image
  steps through a ``slots``-slot shared-memory ring filled by ``cp.async``,
  ``prefetch`` steps ahead, with ``compute`` "none", "add" (+1) or "sep"
  (a separate out buffer, the slot copied into it before the store): the
  hand-rolled DMA rings (S, D, bi);
- :func:`bulk_copy`: TMA bulk copies through shared memory on an mbarrier,
  ``streams`` in flight per block, issued by one thread: the raw
  whole-array DMAs.

They serve the probe ``quantized_tpu_torch.probes.dma_ring``; no engine
path runs them. A wrapper given a CPU tensor runs :func:`copy_plain`; given
a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from quantized_tpu_torch.ops import _cuda

GRID_COPY = _cuda.CudaKernel("grid_copy", "copy_probe.cu", "qt_grid_copy", ["ptr", "ptr", "long", "long", "int"])
RING_COPY = _cuda.CudaKernel("ring_copy", "copy_probe.cu", "qt_ring_copy",
                             ["ptr", "ptr", "long", "long"] + ["int"] * 4)
BULK_COPY = _cuda.CudaKernel("bulk_copy", "copy_probe.cu", "qt_bulk_copy", ["ptr", "ptr", "long", "int", "int"])

RING_COMPUTE = {"none": 0, "add": 1, "sep": 2}
MAX_PREFETCH = 8  # csrc/copy_probe.cu MAX_DEPTH
MAX_STREAMS = 6  # csrc/copy_probe.cu MAX_STREAMS
SMEM_PER_BLOCK = 232448  # the H100's opt-in shared memory of one block


def copy_plain(x: torch.Tensor, add: bool = False) -> torch.Tensor:
    """Plain version of every copy probe: ``x``, or ``x + 1`` wrapped in int8."""
    if add:
        return (x.to(torch.int32) + 1).to(torch.int8)
    return x.clone()


def _check(x: torch.Tensor):
    _cuda.check_dtype(x, torch.int8, "x")
    if x.ndim < 1 or x.numel() == 0:
        raise ValueError(f"a copy probe takes a non-empty tensor of images, got shape {tuple(x.shape)}")


def _launch_args(x: torch.Tensor):
    """The device, an output like ``x`` and the byte count, once ``x`` is a
    contiguous CUDA tensor that the kernels' 16-byte loads can take."""
    dev = _cuda.require_cuda_tensors(x)
    if x.data_ptr() % 16:
        raise ValueError("the copy kernels read 16-byte words and need x 16-byte aligned")
    return dev, torch.empty_like(x), x.numel()


def _image_bytes(x: torch.Tensor) -> int:
    return x.numel() // x.shape[0]


def grid_copy(x: torch.Tensor, bi: int = 1, add: bool = False) -> torch.Tensor:
    """``x`` (+1 per byte if ``add``), one kernel block per ``bi`` images."""
    _check(x)
    if bi < 1:
        raise ValueError(f"bi must be at least 1, got {bi}")
    if x.device.type == "cpu":
        return copy_plain(x, add)
    dev, out, total = _launch_args(x)
    GRID_COPY(dev, x.data_ptr(), out.data_ptr(), total, bi * _image_bytes(x), int(add))
    return out


def ring_slot_bytes(x: torch.Tensor, bi: int, blocks: int) -> int:
    """Bytes of one ring slot: a block's share of a step of ``bi`` images,
    in whole 16-byte words."""
    step = max(16, bi * _image_bytes(x)) // 16
    return -(-step // blocks) * 16


def ring_copy(x: torch.Tensor, slots: int = 4, prefetch: int = 2, bi: int = 1,
              compute: str = "none") -> torch.Tensor:
    """``x`` (+1 per byte for ``compute="add"``) through a shared-memory
    ring of ``slots`` slots, ``prefetch`` steps of ``bi`` images ahead, one
    persistent block per SM."""
    _check(x)
    if compute not in RING_COMPUTE:
        raise ValueError(f"compute must be one of {sorted(RING_COMPUTE)}, got {compute!r}")
    if bi < 1 or not 1 <= prefetch <= min(slots, MAX_PREFETCH):
        raise ValueError(f"need bi >= 1 and 1 <= prefetch <= min(slots, {MAX_PREFETCH}), "
                         f"got bi {bi}, slots {slots}, prefetch {prefetch}")
    if x.device.type == "cpu":
        return copy_plain(x, compute == "add")
    dev, out, total = _launch_args(x)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    smem = slots * ring_slot_bytes(x, bi, blocks) * (2 if compute == "sep" else 1)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"a ring of {slots} slots of {bi} image(s) needs {smem} bytes of shared memory per "
                         f"block, more than {SMEM_PER_BLOCK}")
    RING_COPY(dev, x.data_ptr(), out.data_ptr(), total, max(16, bi * _image_bytes(x)), slots, prefetch,
              RING_COMPUTE[compute], blocks)
    return out


def bulk_copy(x: torch.Tensor, streams: int = 1) -> torch.Tensor:
    """``x`` by TMA bulk copies of 32 KB, ``streams`` in flight per block."""
    _check(x)
    if not 1 <= streams <= MAX_STREAMS:
        raise ValueError(f"streams must be in 1..{MAX_STREAMS}, got {streams}")
    if x.device.type == "cpu":
        return copy_plain(x)
    dev, out, total = _launch_args(x)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    BULK_COPY(dev, x.data_ptr(), out.data_ptr(), total, streams, blocks)
    return out
