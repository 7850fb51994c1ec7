"""Tracing (counterpart of ``quantized_tpu/utils/profiling.py``) and the
port's span recorder.

- ``trace(dir)``: a context manager that records the enclosed work with
  ``torch.profiler`` (the CPU, and the GPU where one is present) and writes
  a Chrome trace, ``dir/trace.json`` (open it in Perfetto or
  ``chrome://tracing``).
- The span recorder: one per process, in memory, off by default.
  ``enable()`` turns it on (and empties it), ``disable()`` off; ``take()``
  hands over what it holds and empties it. A :class:`Span` is a name, its
  start and end on ``time.perf_counter_ns()``, the recording thread's
  native id, its own id, the id of the span that caused it (``parent``, 0
  for none) and a batch id that every span of one batch shares. Past
  :data:`CAPACITY` spans further ones are dropped and counted
  (``Taken.dropped``). Until ``take`` the recorder holds a span as its name
  and six integers in flat arrays, which Python's cyclic garbage collector
  does not track: a recorder holding many thousand span objects would make
  each full collection walk them (180-190 ms pauses were seen on the card
  with 73,000).

``with span(name):`` records the enclosed block. Spans opened inside it on
its thread are its children and share its batch; ``span(name, cause=s)``
names the causing span instead (a wait on another thread for a dispatched
batch). A span with neither begins a batch of its own. ``phases(s, name)``
cuts an open span into consecutive children: the phase ``name`` begins
where the span began, ``.next(other)`` ends it at one clock read and
begins ``other`` there, and the span's end ends the last one, so the
phases cover the span whole.

With the recorder off, ``span`` checks one module-level boolean and returns
a shared object that does nothing, and ``phases(None, name)`` another:
nothing is allocated. With it on, and inside ``trace(dir)``, each span (not
a phase) is also a ``record_function`` range of that trace. Inside any other profiler session it is not: a range that encloses
kernels adds a ``gpu_user_annotation`` interval to the device's timeline,
which would count as device work for a reader that takes every device
interval as busy (``portbench``'s idle share).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from array import array
from typing import Iterator, List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

CAPACITY = 1 << 18  # spans held before further ones are dropped (about 15 MB)

ENABLED = False
_RANGES = False  # set inside trace(dir): spans are record_function ranges there


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int
    batch: int


class Taken(NamedTuple):
    spans: List[Span]
    dropped: int


_lock = threading.Lock()
_names: List[str] = []
_fields = array("q")  # start, end, thread, id, parent, batch of each span, flat
_dropped = 0
_capacity = CAPACITY
_ids = itertools.count(1)
_batches = itertools.count(1)
_local = threading.local()


def enable() -> None:
    """Start recording into an empty recorder that holds :data:`CAPACITY` spans."""
    global ENABLED, _names, _fields, _dropped, _capacity
    with _lock:
        _names, _fields, _dropped, _capacity = [], array("q"), 0, CAPACITY
    ENABLED = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`take`."""
    global ENABLED
    ENABLED = False


def take() -> Taken:
    """The spans recorded since the last ``take`` (or ``enable``), in the
    order they ended, and the number dropped past capacity; empties the
    recorder."""
    global _names, _fields, _dropped
    with _lock:
        names, fields, dropped = _names, _fields, _dropped
        _names, _fields, _dropped = [], array("q"), 0
    return Taken([Span(n, *fields[6 * k:6 * k + 6]) for k, n in enumerate(names)], dropped)


def _keep(name: str, *fields: int) -> None:
    global _dropped
    with _lock:
        if len(_names) < _capacity:
            _names.append(name)
            _fields.extend(fields)
        else:
            _dropped += 1


class _Frame:
    """An open span (see :func:`span`)."""

    __slots__ = ("name", "id", "parent", "batch", "start_ns", "_rf", "_stack", "_phases")

    def __init__(self, name: str, cause: Optional["_Frame"]):
        s = getattr(_local, "stack", None)
        if s is None:
            s = _local.stack = []
            _local.thread = threading.get_native_id()
        outer = cause if cause is not None else (s[-1] if s else None)
        self.name = name
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else 0
        self.batch = outer.batch if outer is not None else next(_batches)
        self._stack = s
        self._rf = None
        self._phases: Optional[_Phases] = None

    def __enter__(self) -> "_Frame":
        self._stack.append(self)
        if _RANGES:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._stack.remove(self)
        if self._phases is not None:
            self._phases.keep(end_ns)
        if ENABLED:
            _keep(self.name, self.start_ns, end_ns, _local.thread, self.id, self.parent, self.batch)
        return False


class _Off:
    """What ``span`` returns with the recorder off: one shared object."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, cause: Optional[_Frame] = None):
    """``with span(name) as s:`` records the enclosed block as a child of
    ``cause`` (the span that caused this one, where it is not the one open
    on this thread) or of the span open here, in its batch; with neither,
    in a batch of its own. ``s`` is None with the recorder off."""
    if not ENABLED:
        return _OFF
    return _Frame(name, cause)


class _Phases:
    """Consecutive children of an open span (see :func:`phases`)."""

    __slots__ = ("frame", "name", "t")

    def __init__(self, frame: _Frame, name: str):
        self.frame, self.name, self.t = frame, name, frame.start_ns
        frame._phases = self

    def next(self, name: str) -> None:
        """End the current phase now and begin the phase ``name``."""
        t = time.perf_counter_ns()
        self.keep(t)
        self.name, self.t = name, t

    def keep(self, t: int) -> None:
        f = self.frame
        if ENABLED:
            _keep(self.name, self.t, t, _local.thread, next(_ids), f.id, f.batch)


class _NoPhases:
    __slots__ = ()

    def next(self, name: str) -> None:
        pass


_NO_PHASES = _NoPhases()


def phases(frame: Optional[_Frame], name: str):
    """Phases of ``frame``, a span open on this thread: the phase ``name``
    from its start, each ``.next(other)`` one more, the last ending with
    the span. ``frame`` None (the recorder off): a shared object whose
    ``next`` does nothing."""
    return _NO_PHASES if frame is None else _Phases(frame, name)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    global _RANGES
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _RANGES = True
        try:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            _RANGES = False
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
