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
print(json.dumps({"imported": len(names), "names": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["imported"] >= 20, result
    assert result["bad"] == [], result
    # the autotuned bench path: the tuner, the throughput hook, the float ResNet;
    # the RangeBN flavor and the strict engine
    assert {"quantized_tpu_torch.engine.autotune", "quantized_tpu_torch.engine.bench_hook",
            "quantized_tpu_torch.models.resnet", "quantized_tpu_torch.quantcore.rangebn",
            "quantized_tpu_torch.models.resnet_quantized", "quantized_tpu_torch.engine.strict",
            "quantized_tpu_torch.engine.convert"} <= set(result["names"]), result
    # the serving and evaluation entry point and what it needs
    assert {"quantized_tpu_torch.cli.main", "quantized_tpu_torch.engine.batching",
            "quantized_tpu_torch.engine.server", "quantized_tpu_torch.engine.executor",
            "quantized_tpu_torch.data.preprocess", "quantized_tpu_torch.data.native",
            "quantized_tpu_torch.data.datasets", "quantized_tpu_torch.ingest.torch_loader",
            "quantized_tpu_torch.utils.checkpoint", "quantized_tpu_torch.utils.meters",
            "quantized_tpu_torch.utils.logging_utils", "quantized_tpu_torch.utils.hostbuild",
            "quantized_tpu_torch.utils.profiling", "quantized_tpu_torch.training.qat"} <= set(result["names"]), result
    # QAT training and the float models
    assert {"quantized_tpu_torch.training.regime", "quantized_tpu_torch.models.mnist",
            "quantized_tpu_torch.models.mobilenet", "quantized_tpu_torch.models.alexnet",
            "quantized_tpu_torch.probes.train_step"} <= set(result["names"]), result
    # distribution: the mesh, the rules, the collectives, the runtime, explicit TP, multi-host serving
    assert {"quantized_tpu_torch.parallel.mesh", "quantized_tpu_torch.parallel.sharding",
            "quantized_tpu_torch.parallel.collectives", "quantized_tpu_torch.parallel.distributed",
            "quantized_tpu_torch.parallel.tp_engine", "quantized_tpu_torch.engine.multihost"} <= set(result["names"]), result


_SMOKE_PROBE = r"""
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from quantized_tpu_torch import ops
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "quantized_tpu"))
print(json.dumps({"bad": bad, "kernels": sorted(ops.KERNELS), "reported": sorted(smoke.KERNEL_INFO)}))
"""


def test_chip_smoke_imports_no_jax_and_reports_every_kernel():
    """``chip_smoke.py`` (imported, not run) loads no JAX either, and its
    kernels line names every kernel the port registers, the fused
    BasicBlock and depthwise-separable kernels, the int4 GEMM, the flat-row
    conv, K2's residual form, the three copy kernels and the two stage
    probes of the fused bottleneck included."""
    out = subprocess.run([sys.executable, "-c", _SMOKE_PROBE], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == [], result
    assert result["kernels"] == result["reported"], result
    assert {"fused_basicblock_s1", "fused_basicblock_ds", "fused_dw_pw", "int4_matmul", "int8_conv_flat",
            "int8_conv_direct_residual", "grid_copy", "ring_copy", "bulk_copy", "fused_stages_conv1",
            "fused_stages_conv12"} <= set(result["kernels"]), result
    assert len(result["kernels"]) == 17, result
