"""pytest settings of the benchmark's own tests (benchmark/tests/).

Tests that need the card carry the `card` marker and decide inside the
`card` fixture, never at import, whether there is one.
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (runs on the chip; skips "
        "elsewhere)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
