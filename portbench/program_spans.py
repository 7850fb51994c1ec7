"""The program's own spans (``quantized_tpu_torch.utils.profiling``) and the
device's idle gaps of a profiled slice, read by the launching calls.

- :func:`per_batch_ms`: the executor's phases (``executor.slot_wait``,
  ``executor.host_copy``, ``executor.enqueue``, and the dispatch that holds
  them) in mean milliseconds a batch, over the batches dispatched in a
  window.
- :func:`classify_gaps`: each idle gap of the device by whether the op
  that ends it had been launched when the gap began, found through its
  runtime call (``cudaGraphLaunch``, ``cudaMemcpyAsync``,
  ``cudaLaunchKernel``...) by correlation id: **queued** (the call began
  before the gap: the device idled with work already enqueued, a gap of its
  own) or **starved** (the call began after it: the device waited for the
  host). Where under 99% of the gaps find their launching call the shares
  read None. The profiler traces no work launched before it started, so a
  gap from the window's start to the first traced op is **unseen** (the
  device may have been busy with that work all along) and counts as
  neither.

Times are nanoseconds: the profiler's events on its own clock, the
program's spans on ``time.perf_counter_ns()``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

PHASES = ("executor.slot_wait", "executor.host_copy", "executor.enqueue")
MATCHED_SHARE = 0.99  # gaps whose launching call must be found for a share to be read

Op = Tuple[int, int, int]  # start, end, correlation id


def per_batch_ms(spans, t0_ns: int, t1_ns: int) -> Optional[Dict[str, float]]:
    """Mean milliseconds a batch of ``executor.dispatch`` and each of
    :data:`PHASES`, over the batches whose dispatch started in [t0, t1),
    with every span of those batches counted, wherever it ran."""
    batches = {s.batch for s in spans if s.name == "executor.dispatch" and t0_ns <= s.start_ns < t1_ns}
    if not batches:
        return None
    total: Dict[str, int] = defaultdict(int)
    for s in spans:
        if s.batch in batches:
            total[s.name] += s.end_ns - s.start_ns
    return {name: total[name] / len(batches) / 1e6 for name in ("executor.dispatch",) + PHASES}


def _launches(events) -> Tuple[List[Op], Dict[int, int]]:
    """The device's ops of a profiler's events (as ``trace.Slice`` takes
    them: on a CUDA device, of non-zero length), sorted by start, and the
    start of the host's runtime call of each correlation id."""
    cuda = torch.autograd.DeviceType.CUDA
    ops: List[Op] = []
    calls: Dict[int, int] = {}
    for e in events:
        if e.device_type() == cuda:
            if e.duration_ns() > 0:
                ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id()))
        elif e.correlation_id():
            c = e.correlation_id()
            calls[c] = min(calls.get(c, e.start_ns()), e.start_ns())
    ops.sort()
    return ops, calls


def classify_gaps(gaps: Sequence[Tuple[int, int]], events, window_start: Optional[int] = None) -> dict:
    """Each gap (a, b) of a profiler's ``events`` against the op that ends
    it, the first to start at or after b (of several starting together, the
    one launched first), and its launching call: starved where the call
    began after a, queued where it began at a or before. A gap that begins
    at ``window_start`` is unseen (``unseen_s``) and left out of the rest.
    ``starved_s`` and ``queued_s`` are None where under
    :data:`MATCHED_SHARE` of the other gaps were matched; ``starved`` lists
    the starved gaps."""
    ops, calls = _launches(events)
    unseen = [(a, b) for a, b in gaps if a == window_start]
    gaps = [(a, b) for a, b in gaps if a != window_start]
    starts = [o[0] for o in ops]
    starved: List[Tuple[int, int]] = []
    queued = matched = 0
    for a, b in gaps:
        j = bisect.bisect_left(starts, b)
        if j == len(ops):
            continue
        k = j
        launched = []
        while k < len(ops) and ops[k][0] == ops[j][0]:
            if ops[k][2] in calls:
                launched.append(calls[ops[k][2]])
            k += 1
        if not launched:
            continue
        matched += 1
        if min(launched) > a:
            starved.append((a, b))
        else:
            queued += b - a
    read = not gaps or matched >= MATCHED_SHARE * len(gaps)
    return {"gaps": len(gaps), "matched": matched, "starved_gaps": len(starved),
            "starved_s": sum(b - a for a, b in starved) / 1e9 if read else None,
            "queued_s": queued / 1e9 if read else None, "starved": starved,
            "unseen_s": sum(b - a for a, b in unseen) / 1e9}
