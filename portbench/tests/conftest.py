"""The benchmark's own tests: CPU tests of its arithmetic, its files and
its check, and (marker `cuda`) the control and the faults at the cells'
own sizes on a card:

    python -m pytest -q portbench/tests                    # CPU, ~1 min
    python -m pytest -q -m cuda portbench/tests             # on the card
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc (skips without one; "
        "run on the card with `pytest -m cuda portbench/tests`)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch
