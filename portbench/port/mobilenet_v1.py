"""The program's int8-resident MobileNet-v1 (``build_int8_mobilenet``)
and its depthwise/pointwise pairs as units."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from portbench.port.common import build_kernels, load_float_model


def build(cfg, params: Dict[str, torch.Tensor], device, weight_bits: int):
    from quantized_tpu_torch.engine import build_int8_mobilenet

    build_kernels(device)
    model = load_float_model(cfg["model"], cfg["model_config"], params)
    return build_int8_mobilenet(model, weight_bits=weight_bits, backend=cfg["engine"]["backend"], device=device)


class _Handle:
    def __init__(self, obj, attr):
        self.obj, self.attr = obj, attr

    def remove(self):
        self.obj.__dict__.pop(self.attr, None)


def _wrap_run_q(conv, before, after) -> _Handle:
    inner = conv.run_q

    def run_q(*args, **kwargs):
        if before:
            before()
        out = inner(*args, **kwargs)
        if after:
            after()
        return out

    conv.run_q = run_q
    return _Handle(conv, "run_q")


def hook_units(engine, record: Callable[[str, int], None]) -> List:
    """Calls ``record("block<k>", 0)`` as pair k's depthwise conv starts and
    ``record("block<k>", 1)`` as its pointwise conv ends, fused or not;
    returns handles whose ``remove`` undoes it. Conv i of the chain is the
    stem (0), then pair k's depthwise (2k + 1) and pointwise (2k + 2) conv;
    a staged engine holds them in order, a fused pair as one stage of two."""
    handles = []
    if engine.fused_stages:
        i = 0
        for j in range(engine.num_fused_stages):
            st = getattr(engine, f"stage{j}")
            first, last = i, i + (1 if hasattr(st, "conv") else 2) - 1
            i = last + 1
            if first % 2 == 1:
                name = f"block{(first - 1) // 2}"
                handles.append(st.register_forward_pre_hook(lambda mod, inp, n=name: record(n, 0)))
            if last % 2 == 0 and last > 0:
                name = f"block{(last - 2) // 2}"
                handles.append(st.register_forward_hook(lambda mod, inp, out, n=name: record(n, 1)))
        return handles
    for i in range(1, engine.num_convs):
        conv, name = getattr(engine, f"conv{i}"), f"block{(i - 1) // 2}"
        if i % 2 == 1:
            handles.append(_wrap_run_q(conv, lambda n=name: record(n, 0), None))
        else:
            handles.append(_wrap_run_q(conv, None, lambda n=name: record(n, 1)))
    return handles
