"""IP-Adapter image projection (2-view global/local), counterpart of the
JAX package's `diffusion/ip_adapter.py` for embedding inputs.

Stacked [global, local] image embeddings project to `num_crops *
num_tokens` context tokens; local tokens blend with global by
`scales[1]`; learned per-view `raw_embed`; LayerNorm last. Unconditional
tokens are the projection of zeros. The attention half lives in the UNet
(`to_k_ip`/`to_v_ip`). The CLIP image-encoder input path comes with the
vision tower.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..models import layers as L


@dataclasses.dataclass(frozen=True)
class ImageProjConfig:
    cross_attention_dim: int = 2048  # SDXL UNet context dim
    clip_embeddings_dim: int = 1024  # ImageBind / CLIP-H embed dim
    num_tokens: int = 4  # clip_extra_context_tokens
    num_crops: int = 2  # [global, local]

    @staticmethod
    def tiny(cross_attention_dim=32, clip_embeddings_dim=16) -> "ImageProjConfig":
        return ImageProjConfig(cross_attention_dim, clip_embeddings_dim)


class ImageProj(nn.Module):
    def __init__(self, cfg: ImageProjConfig = ImageProjConfig()):
        super().__init__()
        self.cfg = cfg
        self.proj = nn.Linear(cfg.clip_embeddings_dim, cfg.num_tokens * cfg.cross_attention_dim)
        self.norm = nn.LayerNorm(cfg.cross_attention_dim)
        self.raw_embed = nn.Parameter(torch.zeros(2, cfg.cross_attention_dim))


def apply(
    params: ImageProj,
    image_embeds: torch.Tensor,  # (B, 2, clip_embeddings_dim) [global, local]
    cfg: ImageProjConfig = ImageProjConfig(),
    mode: str = "global",
    scales: Tuple[float, float] = (1.0, 1.0),
) -> torch.Tensor:
    b = image_embeds.shape[0]
    tok = L.linear(params.proj, image_embeds).reshape(
        b, cfg.num_crops, cfg.num_tokens, cfg.cross_attention_dim
    )
    g, l = tok[:, :1], tok[:, 1:]
    l = g * (1.0 - scales[1]) + l * scales[1]
    raw = params.raw_embed.to(tok.dtype)
    g = g + raw[0][None, None]
    l = l + raw[1][None, None]
    if mode == "global":
        tok = g
    elif mode == "local":
        tok = l
    elif mode == "both":
        tok = torch.cat([g, l], dim=1)
    else:
        raise ValueError(f"Invalid Mode {mode}")
    return L.layer_norm(params.norm, tok.reshape(b, -1, cfg.cross_attention_dim))


def get_image_embeds(
    params: ImageProj,
    cfg: ImageProjConfig,
    clip_image_embeds: Optional[torch.Tensor] = None,  # (B, D) global
    clip_image_embeds_local: Optional[torch.Tensor] = None,  # (B, D) local
    mode: str = "global",
    scale_g: float = 1.0,
    scale_l: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (cond_tokens, uncond_tokens); a missing view is zero-filled and
    uncond always projects zeros."""
    if clip_image_embeds is None and clip_image_embeds_local is None:
        raise ValueError("get_image_embeds needs at least one embedding view")
    w = params.proj.weight
    if clip_image_embeds is not None:
        clip_image_embeds = clip_image_embeds.to(device=w.device, dtype=w.dtype)
    if clip_image_embeds_local is not None:
        clip_image_embeds_local = clip_image_embeds_local.to(device=w.device, dtype=w.dtype)
    if clip_image_embeds is None:
        clip_image_embeds = torch.zeros_like(clip_image_embeds_local)
    if clip_image_embeds_local is None:
        clip_image_embeds_local = torch.zeros_like(clip_image_embeds)
    stacked = torch.stack([clip_image_embeds, clip_image_embeds_local], dim=1)
    cond = apply(params, stacked, cfg, mode=mode, scales=(scale_g, scale_l))
    uncond = apply(params, torch.zeros_like(stacked), cfg, mode=mode)
    return cond, uncond
