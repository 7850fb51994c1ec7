"""The program's int8-resident ResNet (``build_int8_resident``) and its
residual blocks as units."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from portbench.port.common import build_kernels, load_float_model


def build(cfg, params: Dict[str, torch.Tensor], device, weight_bits: int):
    from quantized_tpu_torch.engine import build_int8_resident

    build_kernels(device)
    model = load_float_model(cfg["model"], cfg["model_config"], params)
    return build_int8_resident(model, weight_bits=weight_bits, backend=cfg["engine"]["backend"], device=device,
                               space_to_depth=cfg["engine"]["space_to_depth"])


def hook_units(engine, record: Callable[[str, int], None]) -> List:
    """Calls ``record(unit, 0)`` as each block starts and ``record(unit, 1)``
    as it ends, whatever form the tuner gave it; returns the hook handles."""
    handles = []
    for s in range(engine.num_stages):
        stage = getattr(engine, f"layer{s + 1}")
        for j in range(stage.num_blocks):
            name, m = f"layer{s + 1}.{j}", getattr(stage, str(j))
            handles.append(m.register_forward_pre_hook(lambda mod, inp, n=name: record(n, 0)))
            handles.append(m.register_forward_hook(lambda mod, inp, out, n=name: record(n, 1)))
    return handles
