"""Attention dispatch for the port: K1 for unmasked attention, plain math
for the rest.

Counterpart of the JAX package's `ops/attention.py::dot_product_attention`
with the same (B, S, H, D) layout, default scale, grouped-query head
repeat, 2-D/3-D masks filled with -1e30 and causal masking aligned at the
end. Routing on the H100:
  * every call with no mask and head_dim <= 256 goes to K1 (UNet self,
    text cross and IP attention; on a CPU tensor K1's wrapper runs its
    plain version);
  * masked calls, head_dim > 256 (the VAE's single-head d=512 attention)
    and `impl="xla"` callers (the CLIP text towers) take stock PyTorch math,
    as they take XLA math in the JAX package.
The TPU's size thresholds are not carried over: the H100's own come from
measurements of K1 against the plain path.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import MAX_HEAD_DIM, NEG_INF, _reference_attention, flash_attention


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention over (B, S, H, D) tensors; returns (B, S, H, D).

    impl: "auto" routes as the module docstring says; "xla" forces plain
    math."""
    if impl not in ("auto", "xla"):
        raise ValueError(f"impl={impl!r}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d**-0.5

    if k.shape[2] != h:  # grouped-query attention: repeat kv heads
        rep = h // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if impl == "auto" and mask is None and d <= MAX_HEAD_DIM:
        return flash_attention(qt, kt, vt, causal, scale).transpose(1, 2)

    if mask is None:
        o = _reference_attention(qt, kt, vt, causal, scale)
    else:
        s = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
        if mask.dim() == 2:  # (B, Sk) key padding mask
            mask = mask[:, None, None, :]
        elif mask.dim() == 3:  # (B, Sq, Sk)
            mask = mask[:, None, :, :]
        s = s.masked_fill(~mask.bool(), NEG_INF)
        if causal:
            cm = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq)
            s = s.masked_fill(~cm, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(p.to(vt.dtype), vt)
    return o.transpose(1, 2).to(q.dtype)
