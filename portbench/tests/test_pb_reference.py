"""The plain reference's int8 forward equals the program's engine on the
CPU (the kernels' plain versions), logit for logit. This test may import
both; the reference itself imports nothing of the program."""

from __future__ import annotations

import pytest
import torch

from portbench import spec
from portbench.port import mobilenet_v1 as port_mobilenet
from portbench.port import resnet as port_resnet
from portbench.reference import mobilenet_v1, resnet
from portbench.traffic import images

CASES = [("resnet50", resnet, port_resnet), ("mobilenet_v1", mobilenet_v1, port_mobilenet)]


@pytest.mark.parametrize("name, ref, port", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("side", [32, 64])
def test_reference_equals_the_cpu_engine(name, ref, port, side):
    cfg = {**spec.load_json(spec.HERE / "configs" / f"{name}.json"), "image_size": side}
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


def test_calibration_spreads_every_grid():
    """Each observed range spans many int8 steps of the activations it grids."""
    cfg = {**spec.load_json(spec.HERE / "configs" / "mobilenet_v1.json"), "image_size": 64}
    params = mobilenet_v1.make_params(cfg, 5, images.make(4, 64, 5, images.CALIB, "cpu"))
    for s in mobilenet_v1.conv_specs(cfg):
        lo = float(params[f"{s.name}.quantize_input.running_min"])
        hi = float(params[f"{s.name}.quantize_input.running_max"])
        assert hi - lo > 1.0, s.name
