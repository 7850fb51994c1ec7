"""Building and tuning an engine of the program under test."""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict

import torch

CACHE_DIR = Path(__file__).resolve().parent.parent / "_cache"


def build_kernels(device) -> None:
    """Every CUDA source of the program compiled at once, in parallel, into
    its own build directory inside the checkout (``quantized_tpu_torch/_build``);
    a later run finds them there and compiles nothing."""
    if torch.device(device).type == "cuda":
        from quantized_tpu_torch.ops import _cuda

        _cuda.build_kernels()


def load_float_model(name: str, model_config: dict, params: Dict[str, torch.Tensor]):
    """The program's fake-quant model ``name`` on the host, every parameter,
    BN statistic and observer range replaced by the benchmark's."""
    from quantized_tpu_torch.models import get_model
    from quantized_tpu_torch.utils.hostbuild import host_build

    with host_build():
        model = get_model(name)(generator=torch.Generator().manual_seed(0), **model_config)
    model.load_state_dict({k: v.to("cpu") for k, v in params.items()}, strict=True)
    return model.eval()


def tune(engine, example_u8: torch.Tensor, config_name: str, tuner: dict) -> None:
    """The program's autotuner with explicit race switches and a cache file
    of the benchmark's own (``portbench/_cache``): the first run in a
    checkout measures, later runs apply its verdicts. Prints the verdicts
    on standard error."""
    if not tuner["enabled"]:
        return
    from quantized_tpu_torch.engine.autotune import autotune_resident

    CACHE_DIR.mkdir(exist_ok=True)
    path = CACHE_DIR / f"autotune-{config_name}.json"
    table = autotune_resident(engine, example_u8, cache_path=str(path), verbose=False,
                              tune_extended=tuner["tune_extended"], tune_fused=tuner["tune_fused"])
    print("tuner verdicts " + json.dumps(table, sort_keys=True), file=sys.stderr, flush=True)
