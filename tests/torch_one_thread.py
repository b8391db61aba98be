"""One intra-op thread for the port's tests, in their modules only.

The suite runs in several worker processes at once, and the OpenMP threads
of each would compete for the same cores. Each ``tests/test_torch_*.py``
imports ``one_torch_thread``; the fixture sets the count for that module's
tests and gives the old count back after them, so the other modules of the
same worker keep theirs.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
