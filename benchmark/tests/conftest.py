"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``cuda`` that decide inside a fixture whether a card is there.

    python -m pytest benchmark/tests -p no:cacheprovider
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
