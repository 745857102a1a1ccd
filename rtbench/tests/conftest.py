"""pytest settings of the benchmark's own tests (``rtbench/tests``).

    python -m pytest rtbench/tests -q                  # on the CPU
    python -m pytest rtbench/tests -q -m card          # the tests that need the card

Tests that need the CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them where there is none; whether there is
one is decided inside the fixture, never at import.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return "cuda"
