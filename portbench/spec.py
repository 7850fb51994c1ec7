"""``BENCHMARK.json`` and the files it names, found by name under the
checkout's root: a cell's configuration (the config's ``file``), its
traffic mix (``portbench/traffic/<traffic>.json``) and each metric's reader
(``portbench/metrics/<metric>.py``, whose ``read(run)`` returns the value
or None where the run has nothing to read)."""

from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    root: Path = ROOT
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """A metric with ``workloads`` applies to those cells; one without, to
    every cell (a per-layer one: every cell that reports what it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {[x['name'] for x in bench['workloads']]}")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / c["file"])
    traffic = load_json(root / HERE.name / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, [m["name"] for m in e2e])]
    return Cell(name, w["chips"], config, traffic, Path(root), e2e, per_layer)


@functools.lru_cache(maxsize=None)
def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of ``portbench/metrics/<metric>.py``, loaded by path (a
    metric's name may hold dots)."""
    path = Path(root) / HERE.name / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
