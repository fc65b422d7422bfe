"""Shared fixtures of the benchmark's own tests (run from the repo root:
``python3 -m pytest portbench/tests``).  Whether there is a card is
decided inside a fixture, never while a module is imported."""
import pytest


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
