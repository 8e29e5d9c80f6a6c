"""Attention of the reference: a plain float32 softmax over (B, S, H, D)
tensors, with the operands through `layers.operand` (float8 under the
control's precision)."""

from __future__ import annotations

from typing import Optional

import torch

from .layers import operand

NEG_INF = -1e30


def dot_product_attention(q, k, v, *, mask: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """softmax(q·kᵀ/√d + masks)·v; `mask` (B, Sk) or (B, Sq, Sk) keeps
    True."""
    sq, d = q.shape[1], q.shape[3]
    sk = k.shape[1]
    qt, kt, vt = (operand(t).transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(qt, kt.transpose(-1, -2)) * d**-0.5
    if mask is not None:
        mask = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None, :, :]
        s = s.masked_fill(~mask.bool(), NEG_INF)
    if causal:
        cm = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill(~cm, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(operand(p), vt).transpose(1, 2)
