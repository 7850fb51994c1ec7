"""No module that a run or the reference imports has ``jax``, ``jaxlib``,
``flax`` or ``quantized_tpu`` as its whole top-level name, and the
reference imports nothing of ``quantized_tpu_torch``."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "quantized_tpu"}


def _modules(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_reference_imports_nothing_of_the_program():
    top = _modules("import portbench.reference.resnet, portbench.reference.mobilenet_v1, portbench.compare, "
                   "portbench.work.counts, portbench.traffic.images")
    assert not top & FORBIDDEN
    assert "quantized_tpu_torch" not in top


def test_a_whole_run_imports_no_jax():
    code = ("from portbench import spec, cell\n"
            "from portbench.tests.conftest import TINY, SEED, cell as get\n"
            "for w in ('mobilenet_v1.offline', 'resnet50.serve'):\n"
            "    r = cell.Run(get(w), SEED, 0.5, False, 'cpu', TINY)\n"
            "    assert r.run()['correct']\n")
    top = _modules(code)
    assert "quantized_tpu_torch" in top and not top & FORBIDDEN


def test_the_name_check_compares_whole_top_level_names():
    from portbench.run import forbidden_modules

    assert forbidden_modules(["quantized_tpu_torch.engine", "portbench.run", "jaxtyping", "flaxen.x"]) == []
    assert forbidden_modules(["quantized_tpu.engine", "jax.numpy", "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "quantized_tpu"]
