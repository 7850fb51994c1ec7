"""The rematerialized train step of ``probes/train_step`` (the ``-remat``
suffix of ``bench/train_step.py``) on the CPU: each residual block under
``torch.utils.checkpoint``, its forward recomputed in the backward.

Two steps of the flagship ``resnet_quantized`` (8-bit gradients,
bi-precision: every block draws its gradient noise in the forward) and of
the float-BN model, CIFAR ResNet-8 at batch 4, ``f32-remat`` against
``f32`` from the same seed: the same parameters and buffers, bit for bit,
and the same grad-quant stream counts. A recomputation that updated the
observers or the BN statistics a second time, or advanced a stream, would
leave them apart.
"""

import pytest
import torch

from quantized_tpu_torch.models import layers as L
from quantized_tpu_torch.probes.train_step import build, make_step
from torch_threads import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _two_steps(name, dtype):
    model, x, y = build(4, name, 8, dtype, "cifar10", "full", device="cpu")
    step = make_step(model, x, y)
    losses = [float(step()) for _ in range(2)]
    streams = [m.grad_quant_rng.count for m in model.modules() if hasattr(m, "grad_quant_rng")]
    return model, losses, streams


@pytest.mark.parametrize("name", ["resnet_quantized", "resnet_quantized_float_bn"])
def test_remat_step_equals_the_plain_step(name):
    plain, plain_losses, plain_streams = _two_steps(name, "f32")
    remat, remat_losses, remat_streams = _two_steps(name, "f32-remat")
    assert remat_losses == plain_losses
    assert remat_streams == plain_streams and all(c == (2 if name == "resnet_quantized" else 0) for c in plain_streams)
    want = plain.state_dict()
    for k, v in remat.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_remat_wraps_every_block_and_refuses_a_model_without_one():
    model, _, _ = build(2, "resnet_quantized_float_bn", 8, "bf16-remat", "cifar10", "full", device="cpu")
    assert sum(1 for m in model.modules() if "_checkpointed" in repr(m.__dict__.get("forward"))) == 3
    assert all(m.compute_dtype == torch.bfloat16 for m in model.modules() if isinstance(m, L.QConv2d))
    with pytest.raises(ValueError, match="no residual block"):
        build(2, "mnist", 0, "f32-remat", "mnist", "full", device="cpu")
    with pytest.raises(ValueError, match="-remat"):
        build(2, "resnet", 8, "f16", "cifar10", "full", device="cpu")
