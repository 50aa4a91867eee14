"""One torch CPU thread for a test module.

The suite runs in several pytest workers at once.  Each torch process
starts as many OpenMP threads as the machine has cores, and those
threads spin against every other worker's: six workers on eight cores
ran a lenet round about 50 times slower than one worker does.  With one
thread a round runs at its own speed whatever the other workers do.
Import the fixture into a test module to make it active there."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
