"""EfficientNet-B0 on the port against the plain reference, on the CPU.

The JAX package has no EfficientNet, so the port is held against the
benchmark's plain reference (``portbench/reference/efficientnet_b0.py``:
plain ``torch``, no kernel of the port, no JAX), which computes the
engine's integer scheme from the same seeded float parameters. At 32x32,
10 classes and one block of each kind (expansion 1, 3x3, stride 1, no skip;
expansion 6, 3x3, stride 2; expansion 6, 5x5, stride 1 with the skip) and
a narrow head:

- the engine's stored int8 activations at each block boundary equal the
  reference's, or differ by one step where the two round a value apart
  (the share of such values is recorded, and is 0 on the CPU, where both
  run the same float32 operations in the same order);
- its logits are within the configuration's limits of the reference's
  (``portbench.compare``), and equal on the CPU;
- the depthwise kernel's plain twin equals the reference's depthwise conv,
  its SiLU and requant, and its squeeze sums, exactly; its packed weights
  hold each tap once, in the groups the kernel multiplies;
- the engine's routes, spans and parts: every depthwise conv, squeeze and
  gate pass on the plain route here, each block a span with its four
  phases, module hooks on each block and part;
- the builder refuses every backend but pallas, and the bf16 conv and B6,
  which compute ReLU alone, refuse SiLU and the sigmoid;
- the float and quantized models run forward in both modes, with the
  depthwise observer only in the quantized one.
"""

import copy

import pytest
import torch

from portbench import compare, spec
from portbench.port import efficientnet_b0 as port
from portbench.reference import efficientnet_b0 as ref
from portbench.reference import quant
from portbench.traffic import images
from quantized_tpu_torch.engine import build_int8_efficientnet
from quantized_tpu_torch.engine.int8_resident import u8_to_stored
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.ops import dw_conv_plain, dw_weight_words
from quantized_tpu_torch.ops.int4 import int4_matmul_nk
from quantized_tpu_torch.ops.int8_matmul import ACT_SIGMOID, ACT_SILU
from quantized_tpu_torch.ops.mbconv import dw_tap_groups
from quantized_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SMALL = {"image_size": 32, "num_classes": 10, "head_width": 64, "calib_images": 4,
         "blocks": [[1, 3, 1, 16, 1], [6, 3, 2, 24, 1], [6, 5, 1, 24, 1]]}
SEED = 2 ** 33 + 24


@pytest.fixture(scope="module")
def small():
    """The small configuration, its seeded calibrated parameters, the engine
    built from them on the CPU, the reference, and six seeded images (built
    on one torch thread, as the tests run: see ``torch_threads``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = {**spec.load_json(spec.HERE / "configs" / "efficientnet_b0.json"), **SMALL}
        params = ref.make_params(cfg, SEED, images.make(cfg["calib_images"], 32, SEED, images.CALIB, "cpu"))
        engine = port.build(cfg, params, "cpu", 8)
        u8 = images.make(6, 32, SEED, images.POOL, "cpu")
        return cfg, params, engine, ref.int8_forward(cfg, params, "cpu"), u8
    finally:
        torch.set_num_threads(n)


def test_block_boundaries_equal_the_reference(small):
    cfg, _, engine, reference, u8 = small
    with torch.inference_mode():
        got = engine.block_outputs(u8_to_stored(u8, engine.input_grid))
        want = reference.block_outputs(u8)
    assert [tuple(g.shape) for g in got] == [(6, 16, 16, 32), (6, 16, 16, 16), (6, 8, 8, 24), (6, 8, 8, 24)]
    shares = []
    for g, w in zip(got, want):
        step = (g.to(torch.int32) - w.to(torch.int32)).abs()
        assert int(step.max()) <= 1
        shares.append(float((step > 0).float().mean()))
        assert len(torch.unique(w)) > 64  # the grids are spread, not collapsed onto a clip floor
    assert shares == [0.0] * 4  # the same float32 operations in the same order on one device


def test_logits_within_the_limits_of_the_reference(small):
    cfg, _, engine, reference, u8 = small
    with torch.inference_mode():
        got, want = engine.run_u8(u8), reference(u8)
    numbers = compare.numbers(got.numpy(), want.numpy())
    assert all(numbers[k] <= cfg["limits"][k] for k in numbers), numbers
    assert torch.equal(got, want) and float(want.std()) > 0.0


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_depthwise_twin_equals_the_reference(k, stride):
    g = torch.Generator().manual_seed(10 * k + stride)
    c = 32
    x = torch.randint(-128, 128, (2, 11, 11, c), generator=g, dtype=torch.int8)
    w = torch.randn((k, k, 1, c), generator=g)
    bn = (torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g) * 0.3, torch.randn(c, generator=g) * 0.1,
          torch.rand(c, generator=g) + 0.5)
    conv = quant.QConv(w, bn, 1e-3, (0.05, 97), 8, stride, k // 2, c, "cpu")
    out_grid = (0.03, 30)
    want = quant.quantize(ref.silu(conv.real(x, False)), out_grid)
    w_q = conv.weight.reshape(c, k, k).permute(1, 2, 0).to(torch.int8)
    got, sums = dw_conv_plain(x, w_q, conv.alpha, conv.beta, stride, 97 - 128, ACT_SILU, out_grid)
    assert torch.equal(got, want)
    assert torch.equal(sums, want.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32))


@pytest.mark.parametrize("k", [3, 5])
def test_weight_words_hold_every_tap_once(k):
    """The depthwise kernel's packed weights (``ops.mbconv.dw_weight_words``):
    each tap of the kernel in exactly one byte of its group's word, the
    slots without a tap zero; a dot of the words with the input's taps in
    the same groups gives the plain accumulator."""
    g = torch.Generator().manual_seed(k)
    w = torch.randint(-127, 128, (k, k, 16), generator=g, dtype=torch.int8)
    groups = dw_tap_groups(k)
    got = dw_weight_words(w).view(torch.int8).reshape(len(groups), 16, 4)
    taps = [t for group in groups for t in group if t is not None]
    assert sorted(taps) == [(r, c) for r in range(k) for c in range(k)]
    x = torch.randint(-128, 128, (k, k, 16), generator=g, dtype=torch.int8).to(torch.int32)
    acc = torch.zeros(16, dtype=torch.int32)
    for j, group in enumerate(groups):
        for i, tap in enumerate(group):
            if tap is None:
                assert not got[j, :, i].any()
            else:
                assert torch.equal(got[j, :, i], w[tap])
                acc += x[tap] * got[j, :, i].to(torch.int32)
    assert torch.equal(acc, (x * w.to(torch.int32)).sum(dim=(0, 1)))


def test_routes_spans_and_parts_on_the_cpu(small):
    _, _, engine, _, u8 = small
    profiling.enable()
    try:
        with torch.inference_mode():
            engine.run_u8(u8[:2])
    finally:
        profiling.disable()
    spans = profiling.take().spans
    assert engine.routes() == {"dw.sm90": 0, "dw.plain": 3, "squeeze.sm90": 0, "squeeze.plain": 3,
                               "gate.sm90": 0, "gate.plain": 3}
    blocks = [s for s in spans if s.name == "efficientnet.block"]
    assert len(blocks) == 3
    for b in blocks:
        phases = sorted((s for s in spans if s.parent == b.id), key=lambda s: s.start_ns)
        assert [s.name for s in phases] == ["efficientnet.expand", "efficientnet.dw", "efficientnet.se",
                                            "efficientnet.project"]
        assert phases[0].start_ns == b.start_ns and phases[-1].end_ns == b.end_ns
    seen = []
    handles = port.hook_units(engine, lambda name, which: seen.append((name, which)))
    try:
        with torch.inference_mode():
            engine.run_u8(u8[:1])
    finally:
        for h in handles:
            h.remove()
    assert seen[:6] == [("block0", 0), ("block0.dw", 0), ("block0.dw", 1), ("block0.se", 0), ("block0.se", 1),
                        ("block0", 1)]
    assert len(seen) == 3 * 6


@pytest.mark.parametrize("backend", ["bf16", "xla", "gemm"])
def test_engine_runs_on_pallas_alone(backend):
    """The other conv backends compute ReLU alone, so the builder refuses
    them, and the bf16 conv and B6 refuse SiLU and the sigmoid rather than
    read the code as ReLU."""
    model = get_model("efficientnet_quantized")(num_classes=10, blocks=SMALL["blocks"], head_width=64)
    with pytest.raises(ValueError, match="backend 'pallas' alone"):
        build_int8_efficientnet(model, backend=backend, device="cpu")


@pytest.mark.parametrize("act", [ACT_SILU, ACT_SIGMOID])
def test_relu_only_epilogues_refuse_other_activations(small, act):
    engine = small[2]
    conv = copy.deepcopy(engine.block1.expand)
    conv.set_backend("bf16")
    x = torch.zeros((1, 16, 16, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="computes ReLU alone"):
        conv.run_q(x, relu=act, out_requant=engine.block1.dw.grid)
    a, w = torch.zeros((2, 32), dtype=torch.int8), torch.zeros((8, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="computes ReLU alone"):
        int4_matmul_nk(a, w, torch.ones(8), torch.zeros(8), relu=act)


def test_float_and_quantized_models():
    cfg = {"num_classes": 10, "blocks": SMALL["blocks"], "head_width": 64}
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    for name, observers in (("efficientnet", 0), ("efficientnet_quantized", 3)):
        model = get_model(name)(generator=torch.Generator().manual_seed(2), **cfg)
        assert sum(k.endswith("dw_quant.running_min") for k in model.state_dict()) == observers
        assert [getattr(model, f"block{i}").skip for i in range(3)] == [False, False, True]
        for train in (True, False):
            model.train(train)
            with torch.no_grad():
                assert model(x).shape == (2, 10)
