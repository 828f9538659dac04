"""pytest settings of the benchmark's own tests (``gpubench/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the
``cuda_card`` fixture, which skips them where no card is visible.  The
decision is made inside the fixture, never while a module is imported."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where none is visible "
        "(run on the card: python -m pytest gpubench/tests -m card)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return "cuda"
