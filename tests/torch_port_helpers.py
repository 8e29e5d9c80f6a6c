"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are drawn with numpy from a stated seed and handed to both the
JAX function and its port; comparisons report the seed and the max and
mean differences when they fail, so a real divergence can be told from
noise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


def randn(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def t(x) -> torch.Tensor:
    """numpy (or JAX) array → float32/int CPU tensor."""
    return torch.from_numpy(np.array(x))


def assert_close(port, ref, tol: float, seed: int, rel: bool = False, what: str = ""):
    """max |port - ref| <= tol (or <= tol * max |ref| when `rel`)."""
    a = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port, np.float32)
    b = np.asarray(ref, np.float32)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    d = np.abs(a - b)
    limit = tol * max(float(np.abs(b).max()), 1e-30) if rel else tol
    assert np.isfinite(a).all(), f"{what}: non-finite port output (seed {seed})"
    assert d.max() <= limit, (
        f"{what}: seed {seed} max diff {d.max():.3g} mean diff {d.mean():.3g} "
        f"> {'rel ' if rel else ''}tol {tol} (limit {limit:.3g})"
    )


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread in a module that imports this fixture: under
    pytest-xdist every worker would otherwise start a thread per core, and
    their OpenMP barriers stall the many small ops of the tiny models by up
    to two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
