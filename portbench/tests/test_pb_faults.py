"""``correct`` comes out false when the timed path is broken underneath a
run (the look for a card skipped, the rest of the run driven), and for the
control: the program's int4-weight path in place of the int8 one."""

from __future__ import annotations

import pytest
import torch

from portbench import cell as cellmod
from portbench import spec
from portbench.tests.conftest import SEED, TINY, cell

CELLS = ["mobilenet_v1.offline", "resnet50.offline", "resnet50.serve"]


def _patch(engine, change):
    inner = engine.run_u8

    def run_u8(u8, *a, **k):
        return change(inner, u8)

    engine.run_u8 = run_u8


def stale(engine):
    """Every batch returns the first batch's logits: state left unchanged."""
    first = {}

    def change(inner, u8):
        out = inner(u8)
        return first.setdefault(out.shape, out.clone())

    _patch(engine, change)


def half_batch(engine):
    """Only the first half of each batch is computed; the rest is left zero."""

    def change(inner, u8):
        n = max(1, u8.shape[0] // 2)
        out = inner(u8[:n])
        return torch.cat([out, out.new_zeros((u8.shape[0] - n, out.shape[1]))])

    _patch(engine, change)


def altered(engine):
    """Each batch's first answer swaps its largest and smallest logit."""

    def change(inner, u8):
        out = inner(u8).clone()
        hi, lo = out[0].argmax(), out[0].argmin()
        out[0, hi], out[0, lo] = out[0, lo].clone(), out[0, hi].clone()
        return out

    _patch(engine, change)


def _run(name, **over):
    r = cellmod.Run(cell(name), SEED, 1.0, False, "cpu", {**TINY, **over})
    return r.run()


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    v = _run(name)
    assert v["correct"], v["compared"]
    assert v["compared"]["logit_gap_max"]["value"] == 0.0  # the CPU engine is the reference's arithmetic


@pytest.mark.parametrize("fault", [stale, half_batch, altered], ids=["stale", "half_batch", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    v = _run(name, fault=fault)
    assert not v["correct"], v["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    v = _run(name, weight_bits=4)
    assert not v["correct"], v["compared"]
    assert v["compared"]["logit_gap_mean"]["value"] > v["compared"]["logit_gap_mean"]["limit"]


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(card):
    """The control at the cell's own size on the card (the limits tool runs
    it on three seeds or more when a limit is set)."""
    r = cellmod.Run(spec.cell("mobilenet_v1.offline"), SEED, 1.0, False, card, {"weight_bits": 4})
    v = r.run()
    assert not v["correct"], v["compared"]
