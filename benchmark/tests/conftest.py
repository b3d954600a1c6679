"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` (CPU), and on
the card ``python -m pytest benchmark/tests -q -m cuda``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """Skip, inside the test, where there is no card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
