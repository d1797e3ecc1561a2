"""Test set-up for the benchmark's own tests (``python -m pytest -q bench``):
the benchmark's modules and the measured package on the path, and the
``cuda`` fixture that skips a card test where there is no card."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
