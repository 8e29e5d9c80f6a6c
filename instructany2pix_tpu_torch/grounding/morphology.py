"""Mask morphology on the device: erode, dilate, Gaussian blur. Counterpart
of the JAX package's `grounding/morphology.py`.

Erosion and dilation are min/max pools over a square window padded
`(size // 2, size - 1 - size // 2)` on each axis, so an even size pads one
more before than after (the JAX `reduce_window` padding); the pad value is
-inf for max and +inf for min, so padding never wins. The blur is a
separable Gaussian with zero padding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _pool2d(mask: torch.Tensor, size: int, op: str) -> torch.Tensor:
    """mask: (H, W) float; square structuring element."""
    if size <= 1:
        return mask
    lo, hi = size // 2, size - 1 - size // 2
    fill = float("-inf") if op == "max" else float("inf")
    x = F.pad(mask[None, None], (lo, hi, lo, hi), value=fill)
    if op == "max":
        return F.max_pool2d(x, size, stride=1)[0, 0]
    return -F.max_pool2d(-x, size, stride=1)[0, 0]


def dilate(mask: torch.Tensor, size: int) -> torch.Tensor:
    return _pool2d(mask, size, "max")


def erode(mask: torch.Tensor, size: int) -> torch.Tensor:
    return _pool2d(mask, size, "min")


def gaussian_kernel1d(size: int, sigma: float | None = None) -> np.ndarray:
    if size % 2 == 0:
        size += 1  # odd kernels, as cv2 requires
    if sigma is None:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8  # cv2's default
    x = np.arange(size) - size // 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(mask: torch.Tensor, size: int, sigma: float | None = None) -> torch.Tensor:
    """Separable Gaussian blur over (H, W), zero padding."""
    k = torch.as_tensor(gaussian_kernel1d(size, sigma), device=mask.device)
    n = k.shape[0]
    x = mask.float()[None, None]
    x = F.conv2d(x, k.view(1, 1, n, 1), padding=(n // 2, 0))
    x = F.conv2d(x, k.view(1, 1, 1, n), padding=(0, n // 2))
    return x[0, 0]


def refine_mask(mask: torch.Tensor, dilate_size: int = 40, erode_size: int = 10,
                blur_size: int = 21) -> torch.Tensor:
    """Erode small noise, dilate to cover the subject with a margin, feather
    the edges; clipped to [0, 1]."""
    m = mask.float()
    m = dilate(erode(m, erode_size), dilate_size)
    return gaussian_blur(m, blur_size).clamp(0.0, 1.0)
