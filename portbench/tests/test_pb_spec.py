"""The harness finds configurations, traffic mixes and metric readers by
name, and runs a cell that only added files and entries."""

from __future__ import annotations

import json
import shutil

from portbench import cell as cellmod
from portbench import spec
from portbench.tests.conftest import SEED, TINY


def test_every_cell_resolves():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert c.config["name"] == w["config"] and c.traffic["generator"]
        names = [m["name"] for m in c.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and c.per_layer
        for m in c.end_to_end + c.per_layer:
            assert callable(spec.reader(m["name"]))


def test_added_files_run_without_code_edit(tmp_path):
    """A scratch traffic mix, a scratch metric reader and a workloads entry,
    all new files and entries in a copy of the checkout: the harness runs
    the new cell and reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    mix = spec.load_json(spec.HERE / "traffic" / "offline_b128.json")
    mix.update(batch=2, in_flight=2)
    (root / "portbench" / "traffic" / "scratch_b2.json").write_text(json.dumps(mix))
    (root / "portbench" / "metrics" / "scratch.batches.py").write_text(
        "def read(run):\n    return run.readings.get('batches')\n")
    bench["workloads"].append({"name": "mobilenet_v1.scratch", "config": "mobilenet_v1", "traffic": "scratch_b2",
                               "chips": 1, "why": "scratch"})
    next(m for m in bench["end_to_end"] if m["name"] == "img_per_s.mobilenet_v1")["workloads"].append(
        "mobilenet_v1.scratch")
    bench["end_to_end"].append({"name": "scratch.batches", "unit": "batches", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["mobilenet_v1.scratch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("mobilenet_v1.scratch", root=root)
    assert c.traffic["batch"] == 2
    run = cellmod.Run(c, SEED, 1.0, False, "cpu", {**TINY, "traffic": {**TINY["traffic"], "batch": 2}})
    res = cellmod.result(run, run.run())
    assert res["correct"], res["compared"]
    assert res["metrics"]["scratch.batches"]["value"] == run.readings["batches"] > 0
    assert set(res["metrics"]) == {"img_per_s.mobilenet_v1", "setup_s", "scratch.batches"}
