"""Fixtures of the benchmark's tests. Tests that need the card take the
`cuda` fixture, which skips them where there is none (decided when the
test runs, never at import), and carry the `cuda` marker."""

from __future__ import annotations

import pytest
import torch
from tinybench import copy_with_tiny_cells


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with the tiny cells added."""
    return copy_with_tiny_cells(str(tmp_path / "checkout"))


@pytest.fixture
def cuda():
    """Skips a test that needs the card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
