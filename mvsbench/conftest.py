"""pytest settings of the benchmark's own tests (``mvsbench/tests``): the
``card`` marker, for tests that need a CUDA device. Whether one is present is
decided inside the ``card`` fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see mvsbench/README.md)")
    return torch.device("cuda", 0)
