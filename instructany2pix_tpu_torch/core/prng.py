"""Per-row noise for batched serving, counterpart of the JAX package's
`core/prng.py::row_normal`.

The port draws from `torch.Generator`s rather than JAX keys (the streams
cannot be reproduced across the two), and every sampling site also takes
an injected tensor, so a test can feed the JAX draws.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def row_normal(source: Union[Sequence[torch.Generator], torch.Tensor, np.ndarray], shape,
               device=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal noise of `shape` (B, ...): from a list of B
    generators, row i from generator i alone (so a request's noise does
    not depend on what else is in its batch), or an injected tensor or
    array of that shape."""
    shape = tuple(shape)
    if isinstance(source, (list, tuple)):
        if len(source) != shape[0]:
            raise ValueError(f"{len(source)} generators for {shape[0]} rows")
        return torch.stack([
            torch.randn(shape[1:], generator=g, device=device if device is not None else g.device,
                        dtype=dtype)
            for g in source])
    t = source if isinstance(source, torch.Tensor) else torch.from_numpy(np.array(source))
    if tuple(t.shape) != shape:
        raise ValueError(f"injected noise shape {tuple(t.shape)} != {shape}")
    return t.to(device=device if device is not None else t.device, dtype=dtype)
