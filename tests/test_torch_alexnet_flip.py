"""The port's int8-resident AlexNet, int8 and int4 weights, against the JAX
package's with every 7th BN scale of bn1, bn2 and bn5 negated, as
``tests/test_int8_resident.py`` does: those channels' folded BN factor is
negative, so they take the min-pool dual of the max-pool. The checks and
their tolerances are in ``tests/torch_alexnet_checks.py``; the model and
the engines as in ``tests/test_torch_alexnet.py``.
"""

import pytest
import torch_alexnet_checks as checks

from __graft_entry__ import _calibrated_model as j_calibrated_model


@pytest.fixture(scope="module")
def engines():
    return checks.build_engines(checks.flip_gamma(j_calibrated_model("alexnet_quantized")), flip=True)


def test_engine_layers_and_masks_equal_jax(engines):
    checks.check_layers_equal_jax(engines)
    assert all(getattr(engines["t8"], name).any() for name in ("neg1", "neg2", "neg5"))


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_matches_jax(engines, bits):
    checks.check_engine_matches_jax(engines, bits)


def test_run_u8_matches_f32_ingest(engines):
    checks.check_u8_ingest_matches_f32(engines)
