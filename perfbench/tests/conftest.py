"""Tests of the benchmark harness. They run on the CPU at the rehearsal
sizes of each cell's files; a test that needs the card takes the `card`
fixture, which skips where torch sees no CUDA device."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped on the CPU")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.cuda.get_device_name(0)
