"""pytest settings of the benchmark's own tests (``python -m pytest
vio_bench/tests``). Tests that need a CUDA card carry the ``card`` marker and
take the ``card`` fixture, which skips them where no card is present."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run the benchmark's tests on the machine with the card)")
    return torch.device("cuda")
