"""``convert_to_int`` (the module surgery the CLI's ``--convert-int`` reaches
without ``--resident``) against the JAX package's, on the CPU.

The float-BN and the RangeBN CIFAR ResNet-20, each calibrated on the port's
side by two train-mode passes on numpy-seeded images and carried to the JAX
model key for key, converted at weight bits 8 and 4 on the backends "xla",
"pallas" and "gemm" in both packages. Every conv layer emits f32, which the
port's K2 and K1 (their plain versions here) compute in the JAX "xla"
order, so the logits agree within float32 rounding: 1.2e-7 on logits of
magnitude about 2, the bound the last re-anchor measured.

The known gap: on the float-BN model, JAX's own "pallas" and "gemm"
engines run their Pallas kernels in interpret mode, where XLA contracts the
epilogue ``acc * alpha + beta`` into a fused multiply-add; its gather-K stem
(Cin 3) then differs from JAX's own XLA conv by up to hundreds of ulps near
zero, which the net carries to about 0.002-0.004 on the logits (at both
weight widths with this calibration). The port rounds each product and sum
once, as the XLA conv does. So those cases are held against JAX's "xla"
engine within 1.2e-7, and against JAX's same-backend engine within the
engine bound LOGIT_ATOL of ``tests/test_torch_resident.py``. On the RangeBN
model every conv carries the observer clamp, which JAX sends to its XLA
conv on every backend, so no such gap arises there.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu.engine import convert_to_int as j_convert_to_int
from quantized_tpu_torch.engine import convert_to_int
from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear
from quantized_tpu_torch.models import get_model
from torch_jax_twins import jax_model, load_flat_state

ATOL = 1.2e-7
LOGIT_ATOL = 0.25
MODELS = ("resnet_quantized_float_bn", "resnet_quantized")


@pytest.fixture(scope="module")
def calibrated():
    """{model name: (port model, its state)} and the test images."""
    rng = np.random.default_rng(7)
    out = {}
    for name in MODELS:
        tq = get_model(name)(dataset="cifar10", depth=20, generator=torch.Generator().manual_seed(0))
        tq.train()
        with torch.no_grad():
            for _ in range(2):
                tq(torch.from_numpy(rng.standard_normal((16, 32, 32, 3)).astype(np.float32)))
        out[name] = (tq.eval(), {k: v.numpy() for k, v in tq.state_dict().items()})
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    return out, x


def _jax_logits(name, state, bits, backend, x):
    jm = load_flat_state(jax_model(name, dataset="cifar10", depth=20), state)
    return np.asarray(j_convert_to_int(jm, weight_bits=bits, backend=backend)(jnp.asarray(x)))


@pytest.mark.parametrize("backend", ["xla", "pallas", "gemm"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", MODELS)
def test_convert_to_int_matches_jax(calibrated, name, bits, backend):
    models, x = calibrated
    tq, state = models[name]
    tint = convert_to_int(copy.deepcopy(tq), weight_bits=bits, backend=backend, device="cpu")
    convs = [m for m in tint.modules() if isinstance(m, IntConv2d)]
    assert len(convs) == 21 and all(c.backend == backend for c in convs)  # 19 convs, 2 downsample convs
    assert sum(isinstance(m, IntLinear) for m in tint.modules()) == 1
    with torch.no_grad():
        got = tint(torch.from_numpy(x)).numpy()
    gap = name == "resnet_quantized_float_bn" and backend != "xla"
    want = _jax_logits(name, state, bits, "xla" if gap else backend, x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if gap:
        np.testing.assert_allclose(got, _jax_logits(name, state, bits, backend, x), atol=LOGIT_ATOL, rtol=0)
