"""The benchmark's own tests.

    python3 -m pytest benchmark/tests -q            # CPU; card tests skip
    python3 -m pytest benchmark/tests -q -m card -s # on a machine with a card

The `card` marker is for tests that drive the program on a CUDA card; they
decide inside the `card` fixture, never at import, whether there is one.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
