"""The benchmark's own tests (run them with ``python -m pytest
benchmark/tests`` from the checkout's root).  Tests that need a CUDA card
carry the ``card`` marker and ask for the ``card`` fixture, which skips
them where there is none; run them on a card with ``python -m pytest
benchmark/tests -m card``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only on the card")
    return "cuda"
