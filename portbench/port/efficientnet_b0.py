"""The program's int8-resident EfficientNet (``build_int8_efficientnet``),
its MBConv blocks as units and their depthwise and SE parts."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from portbench.port.common import build_kernels, load_float_model

PARTS = ("dw", "se")  # the parts timed beside each block: ``block<k>.dw``, ``block<k>.se``


def build(cfg, params: Dict[str, torch.Tensor], device, weight_bits: int):
    from quantized_tpu_torch.engine import build_int8_efficientnet

    build_kernels(device)
    model_config = {**cfg["model_config"], "blocks": cfg["blocks"], "stem_width": cfg["stem_width"],
                    "head_width": cfg["head_width"], "num_classes": cfg["num_classes"]}
    model = load_float_model(cfg["model"], model_config, params)
    return build_int8_efficientnet(model, weight_bits=weight_bits, backend=cfg["engine"]["backend"], device=device)


def hook_units(engine, record: Callable[[str, int], None]) -> List:
    """Calls ``record("block<k>", 0)`` as block k starts and ``record(
    "block<k>", 1)`` as it ends, and the same for its parts under
    ``"block<k>.dw"`` and ``"block<k>.se"``; returns the hook handles."""
    handles = []
    for k in range(engine.num_blocks):
        block = getattr(engine, f"block{k}")
        for name, m in [(f"block{k}", block)] + [(f"block{k}.{p}", getattr(block, p)) for p in PARTS]:
            handles.append(m.register_forward_pre_hook(lambda mod, inp, n=name: record(n, 0)))
            handles.append(m.register_forward_hook(lambda mod, inp, out, n=name: record(n, 1)))
    return handles
