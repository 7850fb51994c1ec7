"""Fixture for the port's training tests: torch's CPU ops on one thread for
the test's duration, the thread count restored after it.

The suite runs in several pytest-xdist workers sharing a few cores. A
training step is thousands of small torch ops, each parallelised over every
core by default, and each then waits at its barrier for threads that the
other workers hold: such a test ran 50-130 times slower in the suite than
alone. One thread a worker keeps its ops serial and the suite's wall time
near the sum of its tests' times."""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
