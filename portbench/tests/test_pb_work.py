"""The work counts against hand counts and the published totals."""

from __future__ import annotations

import pytest

from portbench import spec
from portbench.reference import mobilenet_v1, resnet
from portbench.work import counts


def _cfg(name):
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


def test_first_bottleneck_by_hand():
    u = resnet.units(_cfg("resnet50"))[0]  # layer1.0: 56x56x64 in, 64-64-256 and a 256 projection
    assert u["name"] == "layer1.0" and (u["in_side"], u["cin"], u["out_side"], u["cout"]) == (56, 64, 56, 256)
    macs = 56 * 56 * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256)
    weights = 64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256 + 8 * (64 + 64 + 256 + 256)
    assert counts.unit_work(u, 1) == (2 * macs, 56 * 56 * 64 + weights + 56 * 56 * 256)
    ops, nbytes = counts.unit_work(u, 128)
    assert ops == 128 * 2 * macs and nbytes == 128 * (56 * 56 * 64 + 56 * 56 * 256) + weights


def test_last_bottleneck_emits_float32():
    u = resnet.units(_cfg("resnet50"))[-1]
    assert u["name"] == "layer4.2" and u["out_bytes"] == 4 and (u["out_side"], u["cout"]) == (7, 2048)


def test_second_pair_by_hand():
    u = mobilenet_v1.units(_cfg("mobilenet_v1"))[1]  # dw 3x3/2 over 112x112x64, pw 64 -> 128
    macs = 56 * 56 * 9 * 64 + 56 * 56 * 64 * 128
    weights = 9 * 64 + 64 * 128 + 8 * (64 + 128)
    assert counts.unit_work(u, 1) == (2 * macs, 112 * 112 * 64 + weights + 56 * 56 * 128)


@pytest.mark.parametrize("name, published", [("resnet50", 4.09e9), ("mobilenet_v1", 569e6)])
def test_total_macs(name, published):
    """ResNet-50 with the stride in the 3x3 conv: 4.09 GMAC; MobileNet-v1
    1.0-224: 569 M mult-adds (Howard et al. 2017, Table 1); both with the fc."""
    cfg = _cfg(name)
    ref = resnet if cfg["arch"] == "resnet" else mobilenet_v1
    macs = counts.forward_macs(ref.layer_shapes(cfg), ref.fc_features(cfg), cfg["num_classes"])
    assert macs == pytest.approx(published, rel=2e-3)


def test_least_time_takes_the_larger_bound():
    pk = {"int8_ops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    assert counts.least_seconds(2e12, 1e6, pk) == 2.0 and counts.least_seconds(1e6, 3e9, pk) == 3.0
