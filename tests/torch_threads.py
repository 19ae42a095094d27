"""One intra-op thread for the PyTorch port's CPU tests.

The port's tensors in these tests are small: PyTorch's intra-op threads run
them no faster than one thread does, and under the parallel test runner
(several workers on one machine) they take the cores of the other workers.
Each ``tests/test_torch_*.py`` module imports the autouse fixture below.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
