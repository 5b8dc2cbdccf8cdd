"""The benchmark's tests: the harness and the reference import as top-level
packages from ``portbench/``, the program from the repository's root. A
test that needs the card takes the ``cuda_device`` fixture, which skips
where there is none (decided when the test runs, never at import)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card only)")
    return torch.device("cuda", 0)
