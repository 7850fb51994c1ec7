"""Skip helper for the port's tests that need a CUDA GPU.

A test that launches a CUDA kernel carries ``@pytest.mark.cuda`` (registered
in pytest.ini) and takes the ``cuda_device`` fixture, which skips the test
where torch sees no GPU. The decision is made when the fixture runs, never
at import, so every test process collects the same tests.
"""

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's kernels are built with nvcc for sm_90a)")
    return torch.device("cuda")
