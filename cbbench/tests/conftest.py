"""The benchmark's own tests: CPU at tiny sizes; ``card`` marks the few
that need a CUDA card, which decide inside a fixture and skip without
one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest cbbench/tests "
                    "-m card on a machine with one)")
    return "cuda"
