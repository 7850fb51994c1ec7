"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, and the metrics.

Set-up draws the float parameters and the image pools on the device from
the seed, calibrates the BN statistics and observer ranges with the
reference's float forward, hands the parameters to the program, which
builds, tunes and captures its engine, and warms the served path. The
traffic's generator then runs the window. After it: the peak of device
memory is read, the program's state freed, and the reference run over a
sample of the answers the window produced, drawn from the seed.
"""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import compare, spec, trace
from portbench.port.common import tune
from portbench.traffic import images

REFERENCE_BLOCK = 32  # images a reference forward takes at a time


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc``."""
    import os

    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Run:
    """What one run reads and produces; the generators fill ``readings``
    and ``samples``, the metric readers read them."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float, trace_on: bool, device,
                 overrides: Optional[dict] = None):
        overrides = overrides or {}
        self.cell = cell
        self.cfg = {**cell.config, **overrides.get("config", {})}
        self.mix = {**cell.traffic, **overrides.get("traffic", {})}
        self.tuner = {**self.cfg["tuner"], **overrides.get("tuner", {})}
        self.weight_bits = overrides.get("weight_bits", self.cfg["weight_bits"])
        self.fault: Optional[Callable] = overrides.get("fault")
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace_on)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans = trace.Spans(self.trace)
        self.slice = trace.Slice(self.spans)
        self.readings: Dict[str, object] = {}
        self.samples: List[Tuple[np.ndarray, np.ndarray]] = []
        self.attempted = self.failed = 0
        self.phases: Dict[str, float] = {}
        self.memory_peak = 0
        self.engine = self.executor = self.batcher = self.pool_u8 = None
        self.ref = importlib.import_module(f"portbench.reference.{self.cfg['arch']}")
        self.port = importlib.import_module(f"portbench.port.{self.cfg['arch']}")
        self.gen = importlib.import_module(f"portbench.traffic.{self.mix['generator']}")
        self._t_phase = time.perf_counter()
        self.phases["process_start"] = process_age_s()  # interpreter, imports, CUDA's first call

    def phase(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = now - self._t_phase
        self._t_phase = now

    # ------------------------------------------------------------- set-up
    def build(self) -> None:
        with torch.no_grad():
            calib = images.make(self.cfg["calib_images"], self.cfg["image_size"], self.seed, images.CALIB,
                                self.device)
            params = self.ref.make_params(self.cfg, self.seed, calib)
        self.params = {k: v.to("cpu") for k, v in params.items()}
        del params, calib
        self.phase("weights")
        if self.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.engine = self.port.build(self.cfg, self.params, self.device, self.weight_bits)
        self.phase("build")
        if self.weight_bits == self.cfg["weight_bits"]:  # the int4 control runs untuned
            batch = self.mix.get("batch") or max(self.mix["buckets"])
            tune(self.engine, images.make(batch, self.cfg["image_size"], self.seed, images.POOL, self.device),
                 self.cfg["name"], self.tuner)
        self.phase("tune")
        if self.fault is not None:
            self.fault(self.engine)

    def start_window(self) -> float:
        """Marks the end of set-up; returns the window's start on the host
        clock. A traced run records the cyclic garbage collector's pauses
        from here until the window closes."""
        self.phase("traffic_setup")
        self.setup_s = process_age_s()
        if self.trace:
            self.gc_pauses = trace.GcPauses().start()
        return time.perf_counter()

    def window_closed(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)
        if self.trace:
            self.readings["gc"] = self.gc_pauses.stop()
        self.phase("window")

    def time_units(self, forward, batch: int) -> None:
        with torch.inference_mode():
            self.readings["unit_ms"] = trace.unit_times(forward, self.port.hook_units, self.engine)
        self.readings["unit_batch"] = batch
        self.phase("unit_times")

    # ------------------------------------------------------------- check
    def free(self) -> None:
        self.engine = self.executor = self.batcher = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def compare(self) -> Dict[str, Dict[str, float]]:
        """The numbers that decide ``correct``, each with its limit."""
        prog, ref = [], []
        if self.samples:
            params = {k: v.to(self.device) for k, v in self.params.items()}
            with torch.no_grad():
                model = self.ref.int8_forward(self.cfg, params, self.device)
                for idx, logits in self.samples:
                    for i in range(0, len(idx), REFERENCE_BLOCK):
                        u8 = self.pool_u8[torch.as_tensor(idx[i:i + REFERENCE_BLOCK])].to(self.device)
                        ref.append(model(u8).cpu().numpy())
                    prog.append(logits)
            del params, model
        numbers = compare.numbers(np.concatenate(prog) if prog else None, np.concatenate(ref) if ref else None)
        limits = self.cfg["limits"]
        out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
        out["failed"] = {"value": float(self.failed), "limit": 0.0}
        self.phase("reference")
        return out

    def run(self) -> dict:
        self.build()
        self.gen.run(self)
        self.free()
        compared = self.compare()
        correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in compared.values())
        self.readings["setup_s"] = self.setup_s
        return {"correct": correct, "compared": compared}


def device_info(run: Run) -> dict:
    if not run.cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device), "count": run.cell.chips,
            "memory_peak_bytes": int(run.memory_peak)}


def result(run: Run, verdict: dict) -> dict:
    """The result line: the metrics of the run's kind, read by their
    readers; the compared numbers last."""
    metrics = {}
    for m in (run.cell.per_layer if run.trace else run.cell.end_to_end):
        value = spec.reader(m["name"], run.cell.root)(run)
        if value is None:
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = device_info(run)
    out = {"correct": verdict["correct"], "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": dev}
    sl = run.readings.get("slice")
    if run.trace and sl:
        dev["busy_s"], dev["window_s"] = sl["busy_s"], sl["window_s"]
        out["breakdown"] = {"device_ops": sl["device_ops"], "idle_gaps": sl["idle_gaps"]}
    out["compared"] = verdict["compared"]
    return out


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)
