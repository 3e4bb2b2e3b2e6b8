"""Fixtures of the benchmark's tests: the ``cuda`` marker, a card fixture
and the CPU-sized copy of the benchmark's files."""

import pytest

from portbench.tests.tiny import make_tiny


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny(tmp_path)
