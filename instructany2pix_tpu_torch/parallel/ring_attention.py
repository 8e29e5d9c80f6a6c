"""Ring attention — sequence-parallel exact attention over a mesh axis,
counterpart of the JAX package's `parallel/ring_attention.py`.

Each rank holds (B, S/n, H, D) of q, k and v, its contiguous block of the
sequence on `axis`. K/V blocks rotate around the axis's group (rank i
sends to i + 1 by `batch_isend_irecv`, the JAX `ppermute`) while each
rank folds every block into a float32 online softmax over its local
queries: exact attention with O(S/n) memory per rank. The per-block
attention stays plain, as in the JAX package: no kernel is involved.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.mesh import DATA_AXIS, Mesh
from . import collectives as C

NEG_INF = -1e30


def ring_attention(
    q: torch.Tensor,  # (B, S_loc, H, D), this rank's block of the sequence
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention with the sequence sharded over `axis`; returns this
    rank's (B, S_loc, H, D) rows of the output in q's dtype."""
    group = mesh.group(axis)
    n = mesh.shape[axis]
    idx = mesh.axis_index(axis)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, s_loc, h, d = q.shape
    dev = q.device
    qf = q.float() * scale
    # global positions of the local q rows
    q_pos = idx * s_loc + torch.arange(s_loc, device=dev)
    acc = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=dev)
    m_prev = torch.full((b, s_loc, h, 1), NEG_INF, dtype=torch.float32, device=dev)
    l_prev = torch.zeros((b, s_loc, h, 1), dtype=torch.float32, device=dev)
    kb, vb = k, v
    for r in range(n):
        # kb holds the block that started on rank (idx - r) mod n
        src = (idx - r) % n
        k_pos = src * s_loc + torch.arange(s_loc, device=dev)
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kb.float())
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, :, None, :], s, torch.full_like(s, NEG_INF))
        m_cur = s.amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m_prev, m_cur)
        alpha = torch.exp(m_prev - m_new)
        p = torch.exp(s - m_new)
        l_prev = l_prev * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqhk,bkhd->bqhd", p, vb.float())
        m_prev = m_new
        if r + 1 < n:  # the JAX scan's last rotation returns the blocks home unused
            kb, vb = C.ring_shift([kb, vb], group)
    out = acc / torch.clamp(l_prev, min=1e-30)
    return out.to(q.dtype)
