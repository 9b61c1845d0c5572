"""CPU tests of the port's benchmark: ``python -m pytest port_bench/tests``.

Tests that need a CUDA card are marked ``gpu`` and take the ``cuda``
fixture, which decides inside the test whether a card is there."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")
