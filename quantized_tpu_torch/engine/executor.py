"""Executor around a converted integer model (counterpart of
``quantized_tpu/engine/executor.py``, single device).

The JAX executor compiles the forward once per input shape. Its
counterpart here is one CUDA graph per input shape: the batcher's buckets
are a few fixed shapes, so each gets a graph at ``warmup`` and every later
batch of that shape is one replay instead of a Python dispatch per kernel
launch. Per shape the executor keeps:

- the graph, captured on the executor's stream after a few eager warm-up
  forwards there (they build the kernels, encode their TMA maps and fill
  every lazily formed operand before capture), with its own memory pool and
  its own static input and output tensors;
- a ring of pinned host slots, taken in turn: a request batch is copied
  into an input slot, or assembled there (:meth:`IntExecutor.input_slot`
  lends the next one), and the host-to-device copy is enqueued before the
  replay; the logits are copied into the matching output slot right after
  the replay, and an event is recorded. A slot is taken again only after
  its batch was dispatched, its event has completed and its logits were
  copied out, so a later replay of the same shape cannot overwrite logits
  still on their way to the host: that copy precedes the next replay in
  stream order.

:meth:`IntExecutor.dispatch` is the batcher's entry: it returns at once with
a :class:`HostResult` whose :meth:`~HostResult.wait` waits on that batch's
event only (the counterpart of JAX's ``copy_to_host_async`` and the fetch
that follows it). ``__call__`` returns the logits as a device tensor.

A capture that fails raises; there is no fall back to the eager forward.
On the CPU, and with ``graphs=False``, the forward runs eagerly: ``__call__``
as a plain forward on the caller's stream, ``dispatch`` (on a GPU) through
the pinned slots and the executor's stream.

With ``mesh=`` (a (data, model) ``DeviceMesh``, ``parallel.mesh``) the
executor runs the model on every rank of the mesh (JAX's ``IntExecutor``
over a mesh, :class:`MeshEngine`). PyTorch has no GSPMD, so the collectives
are placed by ``parallel.tp_engine.shard_engine``: every groups-1 conv and
every dense layer has its out channels sharded over ``model`` and gathered
after it; the fused blocks and pairs and the depthwise convs stay whole on
every rank. Each rank runs its rows of the batch, and the logits are
gathered over ``data``, so every rank returns the whole batch, as JAX's
global array holds it. Every rank must make the same calls in the same
order. With CUDA graphs the NCCL collectives are captured in the graph: the
eager warm-up forwards bring up the communicator first.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.ops import _cuda

WARMUP_FORWARDS = 2  # eager forwards on the executor's stream before a capture


def _added(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """The counts that grew from ``before`` to ``after``, by how much."""
    return {k: n - before.get(k, 0) for k, n in after.items() if n > before.get(k, 0)}


class HostResult:
    """The logits of one dispatched batch, on their way to (or in) a pinned
    host slot. :meth:`wait` blocks on this batch's event alone and returns a
    numpy copy, so the slot may be reused after it."""

    def __init__(self, slot: Optional[torch.Tensor], event, value: Optional[np.ndarray] = None):
        self._slot = slot
        self._event = event
        self._value = value
        self._lock = threading.Lock()

    def wait(self) -> np.ndarray:
        with self._lock:
            if self._value is None:
                self._event.synchronize()  # a device fault of this batch surfaces here
                self._value = self._slot.numpy().copy()
                self._slot = self._event = None
            return self._value

    def __array__(self, dtype=None, copy=None):
        value = self.wait()
        return value if dtype is None else value.astype(dtype)


class _Bucket:
    """One input shape on a CUDA device: its graph, static tensors and
    pinned slots."""

    def __init__(self, shape: Tuple[int, ...], dtype: torch.dtype, slots: int):
        self.shape, self.dtype = shape, dtype
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: Optional[torch.Tensor] = None
        self.static_out: Optional[torch.Tensor] = None
        self.in_slots = [torch.zeros(shape, dtype=dtype, pin_memory=True) for _ in range(slots)]
        self.out_slots: List[Optional[torch.Tensor]] = [None] * slots
        self.events = [torch.cuda.Event() for _ in range(slots)]
        self.results: List[Optional[HostResult]] = [None] * slots
        self.taken = [False] * slots
        self.next = 0
        self.turn = threading.Condition()
        self.replays = 0
        self.capture: Dict[str, object] = {}

    def take_slot(self) -> int:
        """The next slot of the ring, once the batch it last held was
        dispatched, its copies completed and its logits copied out."""
        with self.turn:
            i = self.next
            self.next = (i + 1) % len(self.in_slots)
            self.turn.wait_for(lambda: not self.taken[i])
            self.taken[i] = True
            last, self.results[i] = self.results[i], None
        if last is not None:
            last.wait()
        self.events[i].synchronize()  # returns at once for an event never recorded
        return i

    def give_back(self, i: int, result: Optional[HostResult]) -> None:
        with self.turn:
            self.taken[i] = False
            self.results[i] = result
            self.turn.notify_all()

    def out_slot(self, i: int, out: torch.Tensor) -> torch.Tensor:
        slot = self.out_slots[i]
        if slot is None or slot.shape != out.shape or slot.dtype != out.dtype:
            slot = self.out_slots[i] = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        return slot

    def pinned_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.in_slots + self.out_slots if t is not None)


class MeshEngine(nn.Module):
    """A converted model over a (data, model) mesh, as every rank runs it.

    The model's convs and dense layers are sharded over ``model``
    (``parallel.tp_engine.shard_engine``). With ``local_rows=False`` the
    input is the whole batch: this rank forwards its block of rows (the
    batch padded with zero rows to a multiple of the data degree) and the
    logits are gathered over ``data``. With ``local_rows=True`` (the
    multi-host batcher's form) the input is this rank's own rows: the rows
    of the ranks of its model group are gathered, forwarded together and
    this rank's logits returned, so no collective crosses the data axis."""

    def __init__(self, model: nn.Module, mesh, local_rows: bool = False):
        super().__init__()
        from quantized_tpu_torch.parallel.tp_engine import shard_engine

        self.engine = model
        self.mesh = mesh
        self.local_rows = local_rows
        self.sharded = shard_engine(model, mesh)  # (convs, dense layers)
        self.input_size = getattr(model, "input_size", 224)

    def _run(self, x: torch.Tensor, fn) -> torch.Tensor:
        from quantized_tpu_torch.parallel.collectives import all_gather
        from quantized_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size

        n = x.shape[0]
        if self.local_rows:
            rows = all_gather(x, self.mesh, MODEL_AXIS)
            return fn(rows).chunk(axis_size(self.mesh, MODEL_AXIS))[axis_index(self.mesh, MODEL_AXIS)]
        dp = axis_size(self.mesh, DATA_AXIS)
        if n % dp:
            x = torch.cat([x, x.new_zeros((dp - n % dp, *x.shape[1:]))])
        y = fn(x.chunk(dp)[axis_index(self.mesh, DATA_AXIS)])
        return all_gather(y, self.mesh, DATA_AXIS)[:n]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, self.engine)

    def run_u8(self, u8: torch.Tensor) -> torch.Tensor:
        return self._run(u8, self.engine.run_u8)


class IntExecutor:
    """Forward executor for a converted model on one device, or on this
    rank's device of a mesh (``mesh=``, see the module docstring).

    ``ingest="u8"`` accepts raw uint8 NHWC images and runs the model's fused
    normalize+quantize path (:meth:`Int8ResNet.run_u8`); ``"f32"`` takes
    normalized f32 images. On a CUDA device ``graphs=True`` captures one
    CUDA graph per input shape (see the module docstring); ``slots`` is the
    number of pinned slots per shape (what the caller keeps in flight, plus
    one). ``check_finite`` raises ``FloatingPointError`` where a batch's
    logits hold a NaN or an infinity."""

    LOCAL_ROWS = False  # with a mesh: the input is the whole batch (MeshEngine)

    def __init__(self, model: nn.Module, mesh=None, ingest: str = "f32", device: DeviceLike = "cuda",
                 graphs: bool = True, slots: int = 2, check_finite: bool = False):
        if ingest not in ("f32", "u8"):
            raise ValueError(f"ingest must be 'f32' or 'u8', got {ingest!r}")
        if ingest == "u8" and not hasattr(model, "run_u8"):
            raise ValueError(f"{type(model).__name__} has no uint8 ingest path")
        self.device = resolve_device(device)
        self.ingest = ingest
        self.dtype = torch.uint8 if ingest == "u8" else torch.float32
        self.np_dtype = np.dtype(np.uint8 if ingest == "u8" else np.float32)
        self.mesh = mesh
        if mesh is not None:
            from quantized_tpu_torch.parallel.mesh import check_mesh, rank_device

            if check_mesh(mesh).device_type != self.device.type:
                raise ValueError(f"a mesh over {mesh.device_type} ranks cannot run on {self.device}")
            self.device = rank_device(mesh.device_type)
            model = MeshEngine(model.to(self.device), mesh, local_rows=self.LOCAL_ROWS)
        self.model = model.to(self.device).eval()
        self.cuda = self.device.type == "cuda"
        self.graphs = graphs and self.cuda
        self.slots = max(2, int(slots))
        self.check_finite = check_finite
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._buckets: Dict[Tuple[int, ...], _Bucket] = {}
        self._lent: Dict[int, Tuple[_Bucket, int, np.ndarray]] = {}
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- forward
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.run_u8(x) if self.ingest == "u8" else self.model(x)

    def _check(self, logits: torch.Tensor) -> None:
        if self.check_finite and not bool(torch.isfinite(logits).all()):
            raise FloatingPointError(f"non-finite logits from a batch of {tuple(logits.shape)}")

    def _bucket(self, shape: Tuple[int, ...]) -> _Bucket:
        """The bucket of ``shape``, made (and captured) on first use; the
        caller holds the lock."""
        b = self._buckets.get(tuple(shape))
        if b is None:
            b = _Bucket(tuple(shape), self.dtype, self.slots)
            if self.graphs:
                self._capture(b)
            self._buckets[b.shape] = b
        return b

    def _capture(self, b: _Bucket) -> None:
        """Warm up eagerly on the executor's stream, then capture one forward
        into ``b.graph`` with its own memory pool. Raises if the capture fails."""
        if os.environ.get("QTPU_DEBUG_S16"):
            raise RuntimeError("QTPU_DEBUG_S16 reads a count back to the host inside the forward, which a CUDA "
                               "graph cannot capture: use graphs=False with it")
        s = self.stream
        with torch.cuda.device(self.device), torch.inference_mode():
            s.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(s):
                b.static_in = torch.zeros(b.shape, dtype=b.dtype, device=self.device)
                for _ in range(WARMUP_FORWARDS):
                    self._forward(b.static_in)
            s.synchronize()
            launches0, routes0 = _cuda.launch_counts(), _cuda.route_counts()
            torch.cuda.empty_cache()  # as the capture does first: the pool's growth is measured from here
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(), stream=s):
                    b.static_out = self._forward(b.static_in)
            except RuntimeError as e:
                raise RuntimeError(f"CUDA graph capture of the forward at input {b.shape} failed: {e}") from e
            seconds = time.perf_counter() - t0
        b.graph = graph
        routes = {k: _added(routes0.get(k, {}), rs) for k, rs in _cuda.route_counts().items()}
        b.capture = {
            "seconds": seconds,
            "pool_bytes": torch.cuda.memory_reserved(self.device) - reserved,
            "launches": _added(launches0, _cuda.launch_counts()),
            "routes": {k: v for k, v in routes.items() if v},
        }

    def _run_on_stream(self, b: _Bucket, x: torch.Tensor) -> torch.Tensor:
        """The forward of ``x`` (on the device, or a pinned host slot) on the
        executor's stream: a copy into the static input and a replay, or the
        eager forward. The caller holds the lock and the stream context."""
        if b.graph is None:
            return self._forward(x.to(self.device, non_blocking=True))
        b.static_in.copy_(x, non_blocking=True)
        b.graph.replay()
        b.replays += 1
        return b.static_out

    # ---------------------------------------------------------------- entries
    def input_slot(self, shape: Tuple[int, ...], dtype) -> Optional[np.ndarray]:
        """Lend the next pinned input slot of a shape, as a
        numpy array to assemble a batch in: :meth:`dispatch` of that array
        then copies nothing on the host. ``None`` where there is no such
        slot (on the CPU, a shape not yet captured, another dtype)."""
        if not self.cuda or np.dtype(dtype) != self.np_dtype:
            return None
        with self._lock:  # a capture belongs to warmup or dispatch, not to the caller's thread
            b = self._buckets.get(tuple(shape)) if self.graphs else self._bucket(tuple(shape))
        if b is None:
            return None
        i = b.take_slot()
        view = b.in_slots[i].numpy()
        with self._lock:
            self._lent[id(view)] = (b, i, view)
        return view

    def dispatch(self, batch) -> HostResult:
        """Start one batch (a host array of a bucket's shape, or a slot from
        :meth:`input_slot`) and return at once; :meth:`HostResult.wait`
        gives its logits as a numpy array."""
        if not self.cuda:
            with torch.inference_mode():
                out = self._forward(torch.as_tensor(batch).to(self.dtype))
            self._check(out)
            return HostResult(None, None, out.numpy())
        with self._lock:
            lent = self._lent.pop(id(batch), None)
        if lent is not None:
            b, i, _ = lent
        else:
            x = torch.as_tensor(batch)
            with self._lock:
                b = self._bucket(tuple(x.shape))
            i = b.take_slot()
            b.in_slots[i].copy_(x)
        result = None
        try:
            with self._lock, torch.cuda.device(self.device), torch.cuda.stream(self.stream), \
                    torch.inference_mode():
                try:
                    out = self._run_on_stream(b, b.in_slots[i])
                    self._check(out)
                    slot = b.out_slot(i, out)
                    slot.copy_(out, non_blocking=True)  # the result's copy to the host starts here
                    result = HostResult(slot, b.events[i])
                finally:
                    b.events[i].record(self.stream)  # the slot's copies, whether or not the batch failed
        finally:
            b.give_back(i, result)
        return result

    def __call__(self, x) -> torch.Tensor:
        """The logits of ``x`` (host or device, a bucket's shape or any) as a
        tensor on the executor's device."""
        x = torch.as_tensor(x)
        if not self.graphs:  # a plain forward on the caller's stream
            with torch.inference_mode():
                out = self._forward(x.to(self.device, self.dtype, non_blocking=True))
            self._check(out)
            return out
        cur = torch.cuda.current_stream(self.device)
        with self._lock:
            b = self._bucket(tuple(x.shape))
        i = None if x.is_cuda else b.take_slot()
        try:
            with self._lock, torch.cuda.device(self.device), torch.inference_mode():
                self.stream.wait_stream(cur)
                with torch.cuda.stream(self.stream):
                    if i is None:
                        self._run_on_stream(b, x.to(self.dtype))
                    else:
                        b.in_slots[i].copy_(x)
                        self._run_on_stream(b, b.in_slots[i])
                        b.events[i].record(self.stream)
                    out = b.static_out.clone()  # the static output belongs to the next replay
                cur.wait_stream(self.stream)
        finally:
            if i is not None:
                b.give_back(i, None)
        out.record_stream(cur)
        self._check(out)
        return out

    def warmup(self, example) -> "IntExecutor":
        self(example)
        if self.cuda:
            torch.cuda.synchronize(self.device)
        return self

    # ---------------------------------------------------------------- records
    def graph_stats(self) -> Dict[Tuple[int, ...], Dict[str, object]]:
        """Per captured shape: capture seconds, the pool's reserved bytes, the
        kernel launches and routes of the captured forward, and replays."""
        return {b.shape: {**b.capture, "replays": b.replays} for b in self._buckets.values() if b.graph is not None}

    def pinned_bytes(self) -> int:
        """Bytes of pinned host memory held by the slots."""
        return sum(b.pinned_bytes() for b in self._buckets.values())
