"""Copy probes (B9): an int8 tensor copied, or copied with 1 added to every
byte (wrapping, as ``(x.astype(int32) + 1).astype(int8)`` does), by three
hand-written CUDA kernels (``csrc/copy_probe.cu``), the counterparts of the
Pallas copy and DMA-ring bodies of the JAX package's TPU studies
(``bench/fused_probe.py``, ``bench/dma_ring_probe*.py``):

- :func:`grid_copy`: the auto-pipelined grid copies. A step of ``bi``
  images (``x.shape[0]`` counts the images) is the unit a block draws its
  work from, but :func:`copy_plan` cuts every step into pieces of at most
  16 KB, enough for two blocks on every SM, so the copy fills the card
  whatever ``bi``; a block moves its piece by one TMA bulk load into shared
  memory and one bulk store;
- :func:`ring_copy`: the hand-rolled DMA rings (S, D, bi). One persistent
  block per SM streams its piece of every ``bi``-image step
  (:func:`ring_plan`) through a ``slots``-slot shared-memory ring: TMA bulk
  loads ``prefetch`` steps ahead, each slot sent out by a TMA bulk store, a
  slot refilled once its store has read it, so the spare slots hold stores
  in flight; ``compute`` "none", "add" (+1 in shared memory) or "sep" (the
  slot copied into a separate out buffer before the store);
- :func:`bulk_copy`: the raw whole-array DMAs, the tensor cut into
  ``streams`` contiguous slices. :func:`bulk_plan` gives each slice its
  share of the blocks (a few an SM); each block streams its share through a
  ring of chunk slots in shared memory, TMA bulk loads landing on mbarriers
  while the bulk stores of earlier chunks drain, a slot refilled once its
  own store has read it.

They serve the probes ``quantized_tpu_torch.probes.dma_ring`` and
``probes.fused_stages`` (the copy floor); no engine path runs them. A
wrapper given a CPU tensor runs :func:`copy_plain`; given a CUDA tensor it
launches its kernel or raises. ``grid_copy`` and ``ring_copy`` count their
launches under route "sm90" (``KERNELS[name].routes``), and so does
``bulk_copy``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quantized_tpu_torch.ops import _cuda

GRID_COPY = _cuda.CudaKernel("grid_copy", "copy_probe.cu", "qt_grid_copy",
                             ["ptr", "ptr"] + ["long"] * 4 + ["int"])
RING_COPY = _cuda.CudaKernel("ring_copy", "copy_probe.cu", "qt_ring_copy",
                             ["ptr", "ptr"] + ["long"] * 3 + ["int"] * 4)
BULK_COPY = _cuda.CudaKernel("bulk_copy", "copy_probe.cu", "qt_bulk_copy",
                             ["ptr", "ptr"] + ["long"] * 4 + ["int"] * 2)

RING_COMPUTE = {"none": 0, "add": 1, "sep": 2}
MAX_STREAMS = 6  # the TPU probes' concurrent DMAs (bench/dma_ring_probe2.py raw_dma)
SMEM_PER_BLOCK = 232448  # the H100's opt-in shared memory of one block
UNIT = 16  # bytes a load, a store and a TMA bulk copy move in one piece: plans cut whole units
LINE_UNITS = 8  # a 128-byte line: pieces are cut in whole lines where a step allows
COPY_PIECE_UNITS = 1024  # 16 KB: the grid copy's largest piece (the fastest on the H100, probes/dma_ring --plans)
COPY_BLOCKS_PER_SM = 2  # the least the grid copy's plan puts on every SM
SMEM_PER_SM = 228 * 1024  # an SM's shared memory, 1 KB of it a block for the system
# bulk_copy's plan: 192 KB of loads in flight an SM, the fastest on the H100 (probes/dma_ring --plans)
BULK_CHUNK_UNITS = 1024  # 16 KB a slot
BULK_SLOTS = 4
BULK_BLOCKS_PER_SM = 3


def _cut(step: int, pieces: int) -> int:
    """Units of each of ``pieces`` pieces of a ``step``-unit step: whole
    128-byte lines where the step has more than one line, else units."""
    piece = -(-step // pieces)
    return -(-piece // LINE_UNITS) * LINE_UNITS if step > LINE_UNITS else piece


class CopyPlan(NamedTuple):
    units: int  # whole 16-byte units of the tensor
    tail: int  # bytes past the last whole unit, copied one by one
    step: int  # units a step (bi images), at least 1
    steps: int
    piece: int  # units a piece; the last piece of a step may be shorter
    per_step: int  # pieces a step: block b copies piece b % per_step of step b // per_step
    blocks: int  # steps x per_step, at least 1 (the tail's block)

    def args(self):
        """The C entry's plan arguments: step, piece, pieces a step."""
        return [self.step, self.piece, self.per_step]


def copy_plan(total: int, step_bytes: int, sms: int, max_piece: int = COPY_PIECE_UNITS) -> CopyPlan:
    """The grid copy's plan over ``total`` bytes in steps of ``step_bytes``
    (``bi`` images; whole 16-byte units of it, at least one): each step cut
    into equal pieces of whole 128-byte lines, at most ``max_piece`` units
    (a multiple of 8), and into enough of them that the grid holds
    :data:`COPY_BLOCKS_PER_SM` blocks on each of ``sms`` SMs, however few
    the steps (``probes/dma_ring --plans`` times other piece sizes on the
    card)."""
    units = total // UNIT
    step = max(1, step_bytes // UNIT)
    steps = -(-units // step)
    per_step = min(step, max(-(-step // max_piece), -(-COPY_BLOCKS_PER_SM * sms // max(1, steps))))
    piece = _cut(step, per_step)
    per_step = -(-step // piece)  # no empty piece in a whole step
    return CopyPlan(units, total - units * UNIT, step, steps, piece, per_step, max(1, steps * per_step))


class RingPlan(NamedTuple):
    units: int  # whole 16-byte units of the tensor
    tail: int  # bytes past the last whole unit, copied one by one
    step: int  # units a step (bi images), at least 1
    steps: int
    piece: int  # units of a block's piece of a step, a slot's size; the last blocks' may be shorter
    blocks: int  # persistent blocks, block b the b-th piece of every step
    slots: int
    depth: int  # steps loaded ahead
    smem: int  # dynamic shared memory a block: the slots (twice for "sep") and a mbarrier each

    def args(self):
        """The C entry's plan arguments: step, piece, slots, depth."""
        return [self.step, self.piece, self.slots, self.depth]


def ring_plan(total: int, step_bytes: int, slots: int, prefetch: int, sep: bool, blocks: int) -> RingPlan:
    """The ring copy's plan: steps of ``step_bytes`` (whole 16-byte units,
    at least one) cut into ``blocks`` pieces of whole 128-byte lines (the
    last blocks' shorter or empty), one a block, a slot holding one piece;
    ``sep`` doubles the slots (the separate out buffer)."""
    units = total // UNIT
    step = max(1, step_bytes // UNIT)
    piece = _cut(step, blocks)
    smem = slots * (UNIT * piece * (2 if sep else 1) + 8)
    return RingPlan(units, total - units * UNIT, step, -(-units // step), piece, blocks, slots, prefetch, smem)


class BulkPlan(NamedTuple):
    units: int  # whole 16-byte units of the tensor
    tail: int  # bytes past the last whole unit, copied one by one
    slice: int  # units a stream's slice (the last may be shorter)
    share: int  # units a block's share of a slice (the last of a slice may be shorter)
    per_slice: int  # blocks a slice: block b streams share b % per_slice of slice b // per_slice
    blocks: int  # slices x per_slice, at least 1 (the tail's block)
    chunk: int  # units a ring slot, a TMA bulk copy
    slots: int
    smem: int  # dynamic shared memory a block: the slots and a mbarrier each
    per_sm: int  # blocks an SM the plan was cut for

    def args(self):
        """The C entry's plan arguments: slice, share, blocks a slice, chunk, slots."""
        return [self.slice, self.share, self.per_slice, self.chunk, self.slots]


def bulk_plan(total: int, streams: int, sms: int, chunk: int = BULK_CHUNK_UNITS, slots: int = BULK_SLOTS,
              blocks_per_sm: int = BULK_BLOCKS_PER_SM) -> BulkPlan:
    """``bulk_copy``'s plan over ``total`` bytes: ``streams`` contiguous
    slices of whole 128-byte lines (the TPU probe's DMAs), each cut into
    shares of whole lines for its share of ``blocks_per_sm`` x ``sms``
    blocks (no share empty in a whole slice), each block streaming its share
    through ``slots`` slots of ``chunk`` units (a multiple of 8).
    ``blocks_per_sm`` is lowered where the slots of that many blocks do not
    fit an SM's shared memory."""
    if chunk < 1 or slots < 1:
        raise ValueError(f"need a chunk of at least one unit and a slot, got chunk {chunk}, slots {slots}")
    units = total // UNIT
    smem = slots * (UNIT * chunk + 8)
    blocks_per_sm = max(1, min(blocks_per_sm, SMEM_PER_SM // (smem + 1024)))
    sl = _cut(max(1, units), streams)
    share = _cut(sl, max(1, blocks_per_sm * sms // streams))
    per_slice = -(-sl // share)
    blocks = max(1, -(-units // sl) * per_slice)
    return BulkPlan(units, total - units * UNIT, sl, share, per_slice, blocks, chunk, slots, smem, blocks_per_sm)


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
    """``x`` (+1 per byte if ``add``) in steps of ``bi`` images, each step
    cut into pieces over the whole card (:func:`copy_plan`)."""
    _check(x)
    if bi < 1:
        raise ValueError(f"bi must be at least 1, got {bi}")
    if x.device.type == "cpu":
        return copy_plain(x, add)
    dev = _cuda.require_cuda_tensors(x)
    return launch_grid_copy(x, copy_plan(x.numel(), bi * _image_bytes(x), _cuda.sm_count(dev)), add)


def launch_grid_copy(x: torch.Tensor, plan: CopyPlan, add: bool = False) -> torch.Tensor:
    """The grid copy of a CUDA tensor under ``plan`` (``probes/dma_ring
    --plans`` times plans other than :func:`copy_plan`'s)."""
    dev, out, total = _launch_args(x)
    GRID_COPY(dev, x.data_ptr(), out.data_ptr(), total, *plan.args(), int(add), route="sm90")
    return out


def ring_slot_bytes(x: torch.Tensor, bi: int, blocks: int) -> int:
    """Bytes of one ring slot: a block's share of a step of ``bi`` images,
    in whole 128-byte lines (16-byte words for a step of one line or less)."""
    return UNIT * ring_plan(x.numel(), bi * _image_bytes(x), 1, 1, False, blocks).piece


def ring_copy(x: torch.Tensor, slots: int = 4, prefetch: int = 2, bi: int = 1,
              compute: str = "none") -> torch.Tensor:
    """``x`` (+1 per byte for ``compute="add"``) through a shared-memory
    ring of ``slots`` slots, ``prefetch`` steps of ``bi`` images ahead, one
    persistent block per SM (:func:`ring_plan`)."""
    _check(x)
    if compute not in RING_COMPUTE:
        raise ValueError(f"compute must be one of {sorted(RING_COMPUTE)}, got {compute!r}")
    if bi < 1 or not 1 <= prefetch <= slots:
        raise ValueError(f"need bi >= 1 and 1 <= prefetch <= slots, "
                         f"got bi {bi}, slots {slots}, prefetch {prefetch}")
    if x.device.type == "cpu":
        return copy_plain(x, compute == "add")
    dev = _cuda.require_cuda_tensors(x)
    plan = ring_plan(x.numel(), bi * _image_bytes(x), slots, prefetch, compute == "sep", _cuda.sm_count(dev))
    return launch_ring_copy(x, plan, compute)


def launch_ring_copy(x: torch.Tensor, plan: RingPlan, compute: str = "none") -> torch.Tensor:
    """The ring copy of a CUDA tensor under ``plan``; raises where its slots
    do not fit a block's shared memory."""
    dev, out, total = _launch_args(x)
    if plan.smem > SMEM_PER_BLOCK:
        raise ValueError(f"a ring of {plan.slots} slots of {UNIT * plan.piece} bytes needs {plan.smem} bytes of "
                         f"shared memory per block, more than {SMEM_PER_BLOCK}")
    RING_COPY(dev, x.data_ptr(), out.data_ptr(), total, *plan.args(), RING_COMPUTE[compute], plan.blocks,
              route="sm90")
    return out


def bulk_copy(x: torch.Tensor, streams: int = 1) -> torch.Tensor:
    """``x`` in ``streams`` contiguous slices, each streamed by its share of
    the blocks through rings of TMA bulk copies (:func:`bulk_plan`)."""
    _check(x)
    if not 1 <= streams <= MAX_STREAMS:
        raise ValueError(f"streams must be in 1..{MAX_STREAMS}, got {streams}")
    if x.device.type == "cpu":
        return copy_plain(x)
    dev = _cuda.require_cuda_tensors(x)
    return launch_bulk_copy(x, bulk_plan(x.numel(), streams, _cuda.sm_count(dev)))


def launch_bulk_copy(x: torch.Tensor, plan: BulkPlan) -> torch.Tensor:
    """The bulk copy of a CUDA tensor under ``plan``; raises where its slots
    do not fit a block's shared memory."""
    dev, out, total = _launch_args(x)
    if plan.smem > SMEM_PER_BLOCK:
        raise ValueError(f"{plan.slots} slots of {UNIT * plan.chunk} bytes need {plan.smem} bytes of shared memory "
                         f"per block, more than {SMEM_PER_BLOCK}")
    BULK_COPY(dev, x.data_ptr(), out.data_ptr(), total, *plan.args(), route="sm90")
    return out
