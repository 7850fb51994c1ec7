"""The port stands alone: importing every module of quantized_tpu_torch
loads no JAX, no flax and nothing of the JAX package (whose name,
``quantized_tpu``, is a prefix of the port's)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import quantized_tpu_torch
names = [m.name for m in pkgutil.walk_packages(quantized_tpu_torch.__path__, "quantized_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "quantized_tpu"))
print(json.dumps({"imported": len(names), "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["imported"] >= 20, result
    assert result["bad"] == [], result
