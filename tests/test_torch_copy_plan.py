"""The launch plans of the copy kernels (B9), on the CPU.

``copy_plan`` (``grid_copy``) and ``ring_plan`` (``ring_copy``) decide which
bytes each block of ``csrc/copy_probe.cu`` moves. These tests replay the
kernels' index arithmetic in NumPy (``grid_piece`` and ``ring_piece``) over
ResNet-50's layer1 activation at batches 1, 5, 32 and 128 and over byte
counts that are not multiples of 16, at bi 1 to 16:

- the pieces and the tail cover every byte exactly once;
- every piece is whole 16-byte units (a TMA bulk copy takes nothing else),
  whole 128-byte lines where a step has more than one, and the tail is the
  bytes past the last whole unit;
- no grid-copy block crosses a step, and each ring block's non-empty pieces
  are those of a prefix of the steps (what the ring kernel's step count
  assumes);
- shared memory stays within a block's 232,448 bytes, and the ring refuses
  16 slots of 4 images;
- the grid copy puts at least two blocks on every SM at batches 32 and 128,
  whatever bi;
- the ring's issuing thread, replayed step by step, refills a slot only
  after the store that last read it has finished reading
  (``cp.async.bulk.wait_group.read`` with S - D stores pending, at most 7).
"""

import numpy as np
import pytest
import torch

from quantized_tpu_torch import ops
from quantized_tpu_torch.ops.copy_probe import (
    COPY_BLOCKS_PER_SM,
    COPY_PIECE_UNITS,
    SMEM_PER_BLOCK,
    UNIT,
    copy_plan,
    ring_plan,
    ring_slot_bytes,
)

SMS = 132  # the H100 SXM's streaming multiprocessors
LAYER1_IMAGE = 56 * 56 * 256
# (images, bytes an image): the layer1 activation at four batches, then 3 x 1001 and 1 x 15 bytes
SHAPES = [(1, LAYER1_IMAGE), (5, LAYER1_IMAGE), (32, LAYER1_IMAGE), (128, LAYER1_IMAGE), (3, 1001), (1, 15)]
BIS = range(1, 17)


def _grid_pieces(plan):
    """(begin, end) in units of every block's piece, as grid_piece computes them."""
    b = np.arange(plan.blocks, dtype=np.int64)
    j = b // plan.per_step
    begin = j * plan.step + (b % plan.per_step) * plan.piece
    end = np.minimum(np.minimum(begin + plan.piece, (j + 1) * plan.step), plan.units)
    return begin, end, j


def _ring_pieces(plan):
    """(begin, end) in units of every (step, block) piece, as ring_piece computes them."""
    j = np.arange(plan.steps, dtype=np.int64)[:, None]
    b = np.arange(plan.blocks, dtype=np.int64)[None, :]
    begin = j * plan.step + b * plan.piece
    end = np.maximum(begin, np.minimum(np.minimum(begin + plan.piece, (j + 1) * plan.step), plan.units))
    return begin, end


def _assert_cover(begin, end, plan, total):
    """The non-empty pieces, sorted, tile [0, units) and the tail takes the rest."""
    keep = end > begin
    begin, end = begin[keep], end[keep]
    order = np.argsort(begin, kind="stable")
    begin, end = begin[order], end[order]
    if plan.units:
        assert begin[0] == 0 and end[-1] == plan.units
        assert np.array_equal(begin[1:], end[:-1])  # no gap, no overlap
    else:
        assert begin.size == 0
    assert plan.units * UNIT + plan.tail == total and 0 <= plan.tail < UNIT


@pytest.mark.parametrize("bi", BIS)
@pytest.mark.parametrize("images,image_bytes", SHAPES)
def test_copy_plan_covers_every_byte_once_in_whole_units(images, image_bytes, bi):
    total = images * image_bytes
    plan = copy_plan(total, bi * image_bytes, SMS)
    begin, end, j = _grid_pieces(plan)
    _assert_cover(begin, end, plan, total)
    assert plan.step == max(1, bi * image_bytes // UNIT) and 1 <= plan.piece <= COPY_PIECE_UNITS
    nonempty = end > begin
    assert np.array_equal(begin[nonempty] // plan.step, (end[nonempty] - 1) // plan.step)  # no block crosses a step
    assert np.all(begin[nonempty] // plan.step == j[nonempty])
    whole = j < plan.units // plan.step  # every piece of a whole step is non-empty
    assert np.all(end[whole] > begin[whole])
    assert UNIT * plan.piece <= SMEM_PER_BLOCK  # a block holds its piece in shared memory
    if plan.step > 8:  # whole 128-byte lines
        assert plan.piece % 8 == 0


@pytest.mark.parametrize("bi", BIS)
@pytest.mark.parametrize("batch", [32, 128])
def test_copy_plan_fills_the_card_whatever_bi(batch, bi):
    plan = copy_plan(batch * LAYER1_IMAGE, bi * LAYER1_IMAGE, SMS)
    assert plan.blocks >= COPY_BLOCKS_PER_SM * SMS, plan
    assert plan.blocks == plan.steps * plan.per_step
    if (batch, bi) == (32, 1):
        assert plan.blocks >= 2 * 132


def test_copy_plan_at_the_layer1_activation():
    """Batch 32, bi 1: 32 steps of 50,176 units, each in 49 pieces of 1,024
    (16 KB), 1,568 blocks; bi 16: two steps of 784 pieces of 16 KB."""
    plan = copy_plan(32 * LAYER1_IMAGE, LAYER1_IMAGE, SMS)
    assert (plan.steps, plan.step, plan.per_step, plan.piece, plan.blocks) == (32, 50176, 49, 1024, 1568)
    plan = copy_plan(32 * LAYER1_IMAGE, 16 * LAYER1_IMAGE, SMS)
    assert (plan.steps, plan.per_step, plan.piece, plan.blocks) == (2, 784, COPY_PIECE_UNITS, 1568)
    assert copy_plan(15, 15, SMS) == copy_plan(15, 15, SMS)._replace(units=0, tail=15, blocks=1)


@pytest.mark.parametrize("bi", BIS)
@pytest.mark.parametrize("images,image_bytes", SHAPES)
def test_ring_plan_covers_every_byte_once_in_whole_units(images, image_bytes, bi):
    total = images * image_bytes
    plan = ring_plan(total, bi * image_bytes, 4, 2, False, SMS)
    begin, end = _ring_pieces(plan)
    _assert_cover(begin.ravel(), end.ravel(), plan, total)
    nonempty = end > begin
    # each block's non-empty pieces: a prefix of the steps (the kernel counts them from the first and last)
    count = nonempty.sum(axis=0)
    assert np.array_equal(nonempty, np.arange(plan.steps)[:, None] < count[None, :])
    assert np.all((count == 0) | (count >= plan.steps - 1))
    assert ring_slot_bytes(torch.zeros((images, image_bytes), dtype=torch.int8), bi, SMS) == UNIT * plan.piece


@pytest.mark.parametrize("slots,prefetch,bi,sep", [
    # the TPU studies' rings (dma_ring_probe*.py, probes/dma_ring) and the wrapper's awkward ones
    (4, 2, 1, False), (8, 4, 1, False), (4, 2, 4, False), (4, 2, 4, True), (8, 6, 1, True), (4, 4, 2, True),
])
def test_ring_plan_fits_shared_memory(slots, prefetch, bi, sep):
    plan = ring_plan(32 * LAYER1_IMAGE, bi * LAYER1_IMAGE, slots, prefetch, sep, SMS)
    assert plan.smem == slots * (UNIT * plan.piece * (2 if sep else 1) + 8) <= SMEM_PER_BLOCK


def test_ring_refuses_slots_past_shared_memory():
    """16 slots of 4 images are 389 KB a block: the wrapper's plan says so
    (the CUDA test holds the refusal on the card)."""
    plan = ring_plan(2 * LAYER1_IMAGE, 4 * LAYER1_IMAGE, 16, 2, False, SMS)
    assert plan.smem > SMEM_PER_BLOCK
    assert ring_plan(32 * LAYER1_IMAGE, LAYER1_IMAGE, 4, 2, False, SMS).piece * UNIT == 6144  # 48 lines


def _replay_ring(slots: int, depth: int, steps: int):
    """The issuing thread of ring_copy_kernel, step by step: loads ``depth``
    ahead, a store a step, ``wait_group.read min(S - D, 7)`` before each
    refill. Returns (step, slot, the steps whose stores may still read it)
    at each refill."""
    pending = []  # steps whose stores have not finished reading, oldest first
    refills = []
    for i in range(steps):
        pending.append(i)  # store of step i, committed
        if i + depth < steps:
            keep = min(slots - depth, 7)
            pending = pending[len(pending) - keep:] if keep else []
            refills.append((i + depth, (i + depth) % slots, [p for p in pending if p % slots == (i + depth) % slots]))
    return refills


@pytest.mark.parametrize("slots,prefetch", [(4, 2), (8, 4), (8, 6), (4, 4), (2, 1), (16, 2), (12, 4)])
def test_ring_refills_a_slot_only_after_its_store_has_read_it(slots, prefetch):
    refills = _replay_ring(slots, prefetch, 40)
    assert len(refills) == 40 - prefetch
    for step, slot, readers in refills:
        assert readers == [], (step, slot, readers)


def test_copy_wrappers_take_the_plain_version_on_the_cpu():
    """A CPU tensor runs copy_plain, whatever the plan would be; no launch."""
    from quantized_tpu_torch.ops import _cuda

    x = torch.from_numpy(np.random.default_rng(3).integers(-128, 128, (5, 7, 9, 3)).astype(np.int8))
    before = _cuda.launch_counts()
    assert torch.equal(ops.grid_copy(x, 2, True), ops.copy_plain(x, add=True))
    assert torch.equal(ops.ring_copy(x, 8, 6, 1, "sep"), x)
    assert _cuda.launch_counts() == before
