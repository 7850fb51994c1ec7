"""The port's int4 weight-only ResNet-50 (BASELINE config #4) against the
JAX package's, at 64x64 on two images: every block conv packed with JAX's
bytes, each block within 1 int step of the JAX engine's on its input, the
logits within 0.25, no block fused. The checks and their bounds are in
``tests/torch_int4_resnets.py``.
"""

import pytest
import torch_int4_resnets as checks


@pytest.fixture(scope="module")
def engines():
    return checks.build_engines("resnet50")


def test_int4_engine_weights_equal_jax(engines):
    checks.check_weights_equal_jax(engines)


def test_int4_engines_fuse_nothing(engines):
    checks.check_fuse_nothing(engines)


def test_int4_engine_matches_jax(engines):
    checks.check_engine_matches_jax(engines)
