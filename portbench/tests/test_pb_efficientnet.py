"""The EfficientNet-B0 cell: it resolves with its readers, the work counts
give the paper's total, the reference equals the program's CPU engine at a
small size, and the int4 control fails the limits that the program meets."""

from __future__ import annotations

import pytest
import torch

from portbench import cell as cellmod
from portbench import spec
from portbench.port import efficientnet_b0 as port
from portbench.reference import efficientnet_b0 as ref
from portbench.tests.conftest import SEED, TINY
from portbench.traffic import images
from portbench.work import counts, mbconv

CELL = "efficientnet_b0.offline"
PER_LAYER = {"dispatch_ms.efficientnet_b0", "mfu.efficientnet_b0", "forward_device_ms.efficientnet_b0",
             "idle.efficientnet_b0", "mbconv_roofline", "dw_roofline", "se_share.efficientnet_b0"}


def _cfg():
    return spec.load_json(spec.HERE / "configs" / "efficientnet_b0.json")


def test_the_cell_resolves():
    c = spec.cell(CELL)
    assert c.chips == 1 and c.config["arch"] == "efficientnet_b0" and c.traffic["batch"] == 128
    assert [m["name"] for m in c.end_to_end] == ["img_per_s.mobilenet_v1", "setup_s"]
    assert {m["name"] for m in c.per_layer} == PER_LAYER
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_total_macs_and_parameters():
    """386 M MAC an image at 224 (Tan & Le 2019, Table 1: 0.39 B FLOPs,
    counted as multiply-adds), the SE convs and the fc included; 5.3 M
    parameters."""
    cfg = _cfg()
    macs = counts.forward_macs(ref.layer_shapes(cfg), ref.fc_features(cfg), cfg["num_classes"])
    assert macs == pytest.approx(386e6, rel=0.01)
    units = ref.units(cfg)
    assert len(units) == 16 and sum(1 for b in ref.block_specs(cfg) if b["skip"]) == 9
    assert sum(1 for b in ref.block_specs(cfg) if b["dw"].k == 5) == 9
    weights = sum(counts.conv_weight_bytes(s) - 8 * s.cout for s, _ in ref.layer_shapes(cfg))
    assert weights + 1280 * 1000 == pytest.approx(5.3e6, rel=0.02)


def test_depthwise_work_by_hand():
    """Block 1's depthwise conv, 3x3/2 over 112x112x96: its MACs, and its
    input, weights and epilogue, int8 output and int32 sums."""
    name, spec_, side = mbconv.dw_layers(ref, _cfg())[1]
    assert name == "block1.dw" and side == 112 and (spec_.k, spec_.stride, spec_.cin) == (3, 2, 96)
    ops, nbytes = mbconv.dw_work(spec_, side, 2)
    assert ops == 2 * 2 * 56 * 56 * 96 * 9
    assert nbytes == 2 * 112 * 112 * 96 + (9 * 96 + 8 * 96) + 2 * 56 * 56 * 96 + 4 * 2 * 96


@pytest.mark.parametrize("side", [32, 64])
def test_reference_equals_the_cpu_engine(side):
    cfg = {**_cfg(), "image_size": side}
    seed = 2 ** 33 + side
    params = ref.make_params(cfg, seed, images.make(4, side, seed, images.CALIB, "cpu"))
    u8 = images.make(3, side, seed, images.POOL, "cpu")
    engine = port.build(cfg, params, "cpu", 8)
    with torch.no_grad():
        got = engine.run_u8(u8)
        want = ref.int8_forward(cfg, params, "cpu")(u8)
    assert got.shape == want.shape == (3, 1000)
    assert torch.equal(got, want)
    assert float(want.std()) > 0.0


def test_int4_control_fails_the_limits():
    c = spec.cell(CELL)
    sound = cellmod.Run(c, SEED, 1.0, False, "cpu", TINY)
    control = cellmod.Run(c, SEED, 1.0, False, "cpu", {**TINY, "weight_bits": 4})
    assert sound.run()["correct"]
    verdict = control.run()
    assert not verdict["correct"]
    limits = c.config["limits"]
    assert all(verdict["compared"][k]["value"] > limits[k] for k in limits), verdict["compared"]
