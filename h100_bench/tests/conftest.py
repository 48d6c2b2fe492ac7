"""The benchmark's own tests: the repository's root on the path, and the
``cuda`` marker's tests skipped inside the test where there is no card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
