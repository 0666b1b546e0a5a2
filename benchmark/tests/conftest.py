"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
repository's root (the card's tests, marked `cuda`, skip without one)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA device, or a skip when this machine has none (decided when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
