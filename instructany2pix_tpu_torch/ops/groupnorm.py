"""GroupNorm(+SiLU) over the channel-last axis, in stock PyTorch.

Counterpart of the JAX package's `_group_norm_xla`: float32 statistics,
two-pass variance E[(x-mu)^2] (no E[x^2]-mu^2 cancellation), optional
fused SiLU, result cast back to the input dtype. The JAX package has no
GroupNorm kernel (its Pallas version was removed), so neither does the
port.
"""

from __future__ import annotations

import torch


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    silu: bool = False,
) -> torch.Tensor:
    """x: (B, H, W, C) or (B, L, C); normalized per (batch, group)."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    b = x.shape[0]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=(1, 3), keepdim=True)
    y = (xc * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * gamma.float() + beta.float()
    if silu:
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype)
