"""The port's float model families and int4 helpers against the JAX
package's: the float ``alexnet``, the float ``mobilenet`` (width 0.25 at
64x64) and ``mnist``, each drawn by ``torch_jax_twins`` on the JAX side and
carried over by the weight bridge, in eval mode, their logits within 1e-5
relative of JAX's (f32 convolutions summed in another order; no quantizer
in these models); the registry, the regimes and the metadata equal JAX's;
``mnist`` exported by ``export_reference_checkpoint`` equals JAX's export
key for key and value for value (fc1's columns permuted to the NCHW
flatten); ``int4_weight_qparams`` and ``quantize_int4`` bit-exact; dropout
in train mode repeats its mask from the same seed and keeps 50% within 3%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu.models import MODEL_REGISTRY as J_REGISTRY
from quantized_tpu.models.mobilenet import MOBILENET_REGIME as J_MOBILENET_REGIME
from quantized_tpu.models import resnet_common as j_common
from quantized_tpu.ops.int4 import int4_weight_qparams as j_qparams
from quantized_tpu.ops.int4 import quantize_int4 as j_quantize_int4
from quantized_tpu.utils.checkpoint import export_reference_checkpoint as j_export
from quantized_tpu_torch.ingest import load_jax_arrays
from quantized_tpu_torch.models import MODEL_REGISTRY, get_model
from quantized_tpu_torch.models.mobilenet import MOBILENET_REGIME
from quantized_tpu_torch.models import resnet_common as t_common
from quantized_tpu_torch.models.layers import Dropout
from quantized_tpu_torch.ops.int4 import int4_weight_qparams, quantize_int4
from quantized_tpu_torch.utils.checkpoint import export_reference_checkpoint
from torch_jax_twins import flat_state, jax_model
from torch_threads import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
CASES = {
    "alexnet": (dict(num_classes=10), (1, 224, 224, 3)),
    "mobilenet": (dict(num_classes=10, width_mult=0.25), (2, 64, 64, 3)),
    "mnist": (dict(num_classes=10), (4, 28, 28, 1)),
}


def _twins(name):
    cfg, shape = CASES[name]
    jm = jax_model(name, seed=2, **cfg)
    tm = get_model(name)(generator=torch.Generator().manual_seed(2), **cfg)
    load_jax_arrays(tm, flat_state(jm))
    return jm, tm.eval(), shape


@pytest.mark.parametrize("name", sorted(CASES))
def test_float_model_matches_jax(name):
    jm, tm, shape = _twins(name)
    assert (tm.regime, tm.input_size, tm.input_transform) == (jm.regime, jm.input_size, jm.input_transform)
    assert getattr(tm, "flatten_linear", None) == getattr(jm, "flatten_linear", None)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_registry_equals_jax():
    assert sorted(MODEL_REGISTRY) == sorted(J_REGISTRY)
    with pytest.raises(ValueError, match="unknown model"):
        get_model("nope")
    assert (t_common.IMAGENET_REGIME, t_common.CIFAR_REGIME, MOBILENET_REGIME) == (
        j_common.IMAGENET_REGIME, j_common.CIFAR_REGIME, J_MOBILENET_REGIME)
    assert get_model("resnet")(dataset="imagenet", depth=18).regime is t_common.IMAGENET_REGIME
    assert get_model("resnet_quantized")(dataset="cifar10", depth=8).regime is t_common.CIFAR_REGIME


def test_mnist_export_equals_jax(tmp_path):
    jm, tm, _ = _twins("mnist")
    j_export(jm, str(tmp_path / "jax.pth.tar"), {"model": "mnist"})
    export_reference_checkpoint(tm, str(tmp_path / "port.pth.tar"), {"model": "mnist"})
    want = torch.load(tmp_path / "jax.pth.tar", weights_only=False)["state_dict"]
    got = torch.load(tmp_path / "port.pth.tar", weights_only=True)["state_dict"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert tuple(got["fc1.weight"].shape) == (50, 320)


@pytest.mark.parametrize("shape", [(64, 32), (147, 10), (9, 1)])
def test_int4_helpers_bit_exact(shape):
    w = np.random.default_rng(shape[0]).standard_normal(shape).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero column takes the scale floor
    scale = int4_weight_qparams(w)
    np.testing.assert_array_equal(scale, j_qparams(w))
    q = quantize_int4(w, scale)
    np.testing.assert_array_equal(q, j_quantize_int4(w, scale))
    assert q.dtype == np.int8 and q.min() >= -7 and q.max() <= 7


def test_dropout_repeats_from_its_seed():
    x = torch.ones(64, 512)
    a, b = (Dropout(0.5, generator=torch.Generator().manual_seed(9)).train() for _ in range(2))
    ya, yb = a(x), b(x)
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)
    kept = float((ya != 0).float().mean())
    assert abs(kept - 0.5) < 0.03, kept
    assert set(torch.unique(ya).tolist()) <= {0.0, 2.0}  # kept values divided by the keep probability
    assert not torch.equal(a(x), ya)  # the stream moves on
    torch.testing.assert_close(a.eval()(x), x, rtol=0, atol=0)
    assert isinstance(a, torch.nn.Dropout) and a.p == 0.5
