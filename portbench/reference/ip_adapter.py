"""IP-Adapter image projection in global mode, as the edit runs it.

Stacked [global, local] image embeddings project to `num_crops *
num_tokens` context tokens, of which global mode keeps the global view's,
plus a learned per-view `raw_embed`; LayerNorm last. Unconditional tokens
are the projection of zeros. The attention half lives in the UNet
(`to_k_ip`/`to_v_ip`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from .checkpoint import KeyMap, Rule
from . import layers as L


@dataclasses.dataclass(frozen=True)
class ImageProjConfig:
    cross_attention_dim: int = 2048  # SDXL UNet context dim
    clip_embeddings_dim: int = 1024  # ImageBind / CLIP-H embed dim
    num_tokens: int = 4  # clip_extra_context_tokens
    num_crops: int = 2  # [global, local]


class ImageProj(nn.Module):
    def __init__(self, cfg: ImageProjConfig = ImageProjConfig()):
        super().__init__()
        self.cfg = cfg
        self.proj = nn.Linear(cfg.clip_embeddings_dim, cfg.num_tokens * cfg.cross_attention_dim)
        self.norm = nn.LayerNorm(cfg.cross_attention_dim)
        self.raw_embed = nn.Parameter(torch.zeros(2, cfg.cross_attention_dim))


def apply(params: ImageProj, image_embeds: torch.Tensor, cfg: ImageProjConfig) -> torch.Tensor:
    """Global-mode tokens (B, num_tokens, cross_attention_dim) of stacked
    (B, 2, clip_embeddings_dim) [global, local] embeddings: the global
    view's projection plus its learned `raw_embed`, then LayerNorm."""
    b = image_embeds.shape[0]
    tok = L.linear(params.proj, image_embeds).reshape(
        b, cfg.num_crops, cfg.num_tokens, cfg.cross_attention_dim
    )
    g = tok[:, :1] + params.raw_embed.to(tok.dtype)[0][None, None]
    return L.layer_norm(params.norm, g.reshape(b, -1, cfg.cross_attention_dim))


def get_image_embeds(params: ImageProj, cfg: ImageProjConfig,
                     clip_image_embeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (cond_tokens, uncond_tokens) in global mode from (B, D) global
    embeddings; the local view is zero-filled and uncond projects zeros."""
    w = params.proj.weight
    g = clip_image_embeds.to(device=w.device, dtype=w.dtype)
    stacked = torch.stack([g, torch.zeros_like(g)], dim=1)
    return apply(params, stacked, cfg), apply(params, torch.zeros_like(stacked), cfg)


# ------------------------------------------------------------ checkpoints


def image_proj_keymap() -> KeyMap:
    """The `image_proj.*` half of the IP-Adapter checkpoint ↔ `ImageProj`."""
    return KeyMap([Rule("image_proj.proj.weight", "proj.weight"),
                   Rule("image_proj.proj.bias", "proj.bias"),
                   Rule("image_proj.norm.weight", "norm.weight"),
                   Rule("image_proj.norm.bias", "norm.bias"),
                   Rule("image_proj.raw_embed", "raw_embed")])


def ip_attn_keymap(attn_paths) -> KeyMap:
    """The `ip_adapter.*` half ↔ the UNet's `to_k_ip`/`to_v_ip`: processor
    2i + 1 of diffusers' `attn_processors` order holds the i-th
    cross-attention of `attn_paths` (the even ones are self-attention
    processors without weights)."""
    rules = []
    for i, path in enumerate(attn_paths):
        for proj in ("to_k_ip", "to_v_ip"):
            rules.append(Rule(f"ip_adapter.{2 * i + 1}.{proj}.weight", f"{path}.{proj}.weight"))
    return KeyMap(rules)
