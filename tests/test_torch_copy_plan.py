"""The launch plans of the copy kernels (B9), on the CPU.

``copy_plan`` (``grid_copy``), ``ring_plan`` (``ring_copy``) and
``bulk_plan`` (``bulk_copy``) decide which bytes each block of
``csrc/copy_probe.cu`` moves. These tests replay the kernels' index
arithmetic in NumPy (``grid_piece``, ``ring_piece`` and bulk_copy_kernel's
shares and chunks) over
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
  (``cp.async.bulk.wait_group.read`` with S - D stores pending, at most 7);
- the bulk copy cuts the tensor into ``streams`` contiguous slices of
  whole lines, each into shares of whole lines with no block across a
  slice, each share into chunks no larger than a slot; its slots fit a
  block's shared memory and its blocks an SM's; it puts a block on every
  SM at batches 1 and 32 whatever ``streams``; and its issuing thread,
  replayed chunk by chunk, keeps ``slots`` loads in flight and refills a
  slot only after the store that last read it has finished reading
  (``wait_group.read 0``).
"""

import numpy as np
import pytest
import torch

from quantized_tpu_torch import ops
from quantized_tpu_torch.ops.copy_probe import (
    COPY_BLOCKS_PER_SM,
    COPY_PIECE_UNITS,
    MAX_STREAMS,
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    UNIT,
    bulk_plan,
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


def _bulk_shares(plan):
    """(begin, end, slice) in units of every block's share, as bulk_copy_kernel computes them."""
    b = np.arange(plan.blocks, dtype=np.int64)
    j = b // plan.per_slice
    begin = j * plan.slice + (b % plan.per_slice) * plan.share
    end = np.maximum(begin, np.minimum(np.minimum(begin + plan.share, (j + 1) * plan.slice), plan.units))
    return begin, end, j


@pytest.mark.parametrize("streams", range(1, MAX_STREAMS + 1))
@pytest.mark.parametrize("images,image_bytes", SHAPES)
def test_bulk_plan_covers_every_byte_once_in_whole_units(images, image_bytes, streams):
    total = images * image_bytes
    plan = bulk_plan(total, streams, SMS)
    begin, end, j = _bulk_shares(plan)
    _assert_cover(begin, end, plan, total)
    assert -(-plan.units // plan.slice) <= streams  # at most `streams` contiguous slices
    nonempty = end > begin
    assert np.array_equal(begin[nonempty] // plan.slice, (end[nonempty] - 1) // plan.slice)  # no block crosses a slice
    assert np.all(begin[nonempty] // plan.slice == j[nonempty])
    whole = j < plan.units // plan.slice  # every share of a whole slice is non-empty
    assert np.all(end[whole] > begin[whole])
    if plan.units > 8:  # slices and shares of whole 128-byte lines: every block starts on a line
        assert plan.slice % 8 == 0 and plan.share % 8 == 0 and np.all(begin % 8 == 0)
    # the kernel's chunks: whole units, none larger than a slot, tiling each share
    for b0, e0 in zip(begin[nonempty][:50], end[nonempty][:50]):
        n = -(-(e0 - b0) // plan.chunk)
        sizes = [min(plan.chunk, e0 - b0 - c * plan.chunk) for c in range(n)]
        assert all(0 < u <= plan.chunk for u in sizes) and sum(sizes) == e0 - b0


@pytest.mark.parametrize("chunk_kb,slots,per_sm", [
    (16, 4, 2), (8, 2, 1), (8, 8, 3), (16, 8, 1), (32, 4, 1), (32, 4, 3), (16, 4, 4), (32, 6, 1),
])
def test_bulk_plan_fits_shared_memory(chunk_kb, slots, per_sm):
    """A block's slots and mbarriers fit its shared memory, and the blocks
    the plan counts on an SM fit the SM's (a plan asked for more is cut)."""
    plan = bulk_plan(32 * LAYER1_IMAGE, 1, SMS, chunk_kb * 1024 // UNIT, slots, per_sm)
    assert plan.smem == slots * (chunk_kb * 1024 + 8) <= SMEM_PER_BLOCK
    assert 1 <= plan.per_sm <= per_sm and plan.per_sm * (plan.smem + 1024) <= SMEM_PER_SM
    if per_sm * (plan.smem + 1024) <= SMEM_PER_SM:
        assert plan.per_sm == per_sm


@pytest.mark.parametrize("streams", range(1, MAX_STREAMS + 1))
@pytest.mark.parametrize("batch", [1, 32])
def test_bulk_plan_puts_a_block_on_every_sm(batch, streams):
    """Every SM gets a block, every slice its share of the blocks: at batch
    32 and one stream, 396 blocks (three an SM), each about 65 KB in 16 KB
    chunks through 4 slots."""
    plan = bulk_plan(batch * LAYER1_IMAGE, streams, SMS)
    begin, end, _ = _bulk_shares(plan)
    assert int((end > begin).sum()) >= SMS, plan
    assert plan.per_slice >= SMS // streams, plan  # each slice its share of the SMs at least
    if (batch, streams) == (32, 1):
        assert (plan.blocks, plan.share, plan.chunk, plan.slots, plan.per_sm) == (396, 4056, 1024, 4, 3)


def test_bulk_plan_refuses_an_empty_ring():
    with pytest.raises(ValueError):
        bulk_plan(32 * LAYER1_IMAGE, 1, SMS, slots=0)
    with pytest.raises(ValueError):
        bulk_plan(32 * LAYER1_IMAGE, 1, SMS, chunk=0)


def _replay_bulk(slots: int, chunks: int):
    """The issuing thread of bulk_copy_kernel, chunk by chunk: ``slots``
    loads issued ahead, a store a chunk, ``wait_group.read 0`` before the
    slot just stored is refilled. Returns, at each refill, (chunk, slot,
    the chunks whose stores may still read that slot, the chunk last held
    there, loads in flight once it is issued)."""
    loaded = list(range(min(slots, chunks)))
    stored = []
    reading = []  # chunks whose stores have not finished reading, oldest first
    refills = []
    for i in range(chunks):
        assert i in loaded  # the chunk being stored has been loaded
        stored.append(i)
        reading.append(i)
        if i + slots < chunks:
            reading = []  # wait_group.read 0: every store issued has read its slot
            c = i + slots
            slot = c % slots
            last = max(k for k in loaded if k % slots == slot)
            loaded.append(c)
            refills.append((c, slot, [k for k in reading if k % slots == slot], last,
                            len([k for k in loaded if k not in stored])))
    return refills, stored


@pytest.mark.parametrize("slots", [1, 2, 3, 4, 6, 8])
def test_bulk_refills_a_slot_only_after_its_store_has_read_it(slots):
    refills, stored = _replay_bulk(slots, 40)
    assert stored == list(range(40))
    assert len(refills) == 40 - slots
    for chunk, slot, readers, last, in_flight in refills:
        assert readers == [], (chunk, slot, readers)
        assert last == chunk - slots and last in stored  # the slot's last chunk was stored before its refill
        assert in_flight == slots  # loads in flight beside the stores


def test_bulk_copy_takes_the_plain_version_on_the_cpu():
    """A CPU tensor runs copy_plain at every stream count; no launch."""
    from quantized_tpu_torch.ops import _cuda

    x = torch.from_numpy(np.random.default_rng(4).integers(-128, 128, (3, 1001)).astype(np.int8))
    before = _cuda.launch_counts()
    for streams in range(1, MAX_STREAMS + 1):
        assert torch.equal(ops.bulk_copy(x, streams), x)
    assert _cuda.launch_counts() == before
    with pytest.raises(ValueError):
        ops.bulk_copy(x, MAX_STREAMS + 1)
