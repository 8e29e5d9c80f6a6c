"""Vision towers for the LLM: the CLIP feature-extraction surface,
counterpart of the JAX package's `llm/vision_tower.py`.

A tower wraps a vision encoder and returns `select_feature` ∈ {patch,
cls_patch, projection} from hidden layer `select_layer`. The reference's
tower answers dict inputs with zeros (its media enter the LLM through the
embedding splice instead), so `apply(None)` gives zeros; the tower serves
vision-in-context training, not the edit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..models import clip as clip_lib
from ..models import imagebind as imagebind_lib
from ..models import layers as L


@dataclasses.dataclass(frozen=True)
class VisionTowerConfig:
    select_feature: str = "patch"  # patch | cls_patch | projection
    select_layer: int = -2
    clip: clip_lib.CLIPVisionConfig = clip_lib.CLIPVisionConfig.vit_h()

    @staticmethod
    def tiny() -> "VisionTowerConfig":
        return VisionTowerConfig(clip=clip_lib.CLIPVisionConfig.tiny())


def apply(params: clip_lib.CLIPVision, pixels: Optional[torch.Tensor], cfg: VisionTowerConfig,
          batch: int = 1) -> torch.Tensor:
    """pixels (B, H, W, 3) → features; None gives zeros (batch, 1, dim), as
    the reference's tower answers a dict input."""
    if pixels is None:
        dim = cfg.clip.projection_dim if cfg.select_feature == "projection" else cfg.clip.hidden_size
        w = params.patch_embedding.weight
        return torch.zeros((batch, 1, dim), device=w.device)
    out = clip_lib.vision_apply(params, pixels, cfg.clip)
    if cfg.select_feature == "projection":
        return out["image_embeds"][:, None, :]
    hidden = out["hidden_states"][cfg.select_layer]
    if cfg.select_feature == "patch":
        return hidden[:, 1:]
    if cfg.select_feature == "cls_patch":
        return hidden
    raise ValueError(cfg.select_feature)


def build_vision_tower(name: str, generator: torch.Generator, device="cpu",
                       dtype=torch.float32, **kwargs) -> Tuple[nn.Module, object]:
    """(random module, config) by tower name, as the reference picks its
    tower: a "languagebind" name gives ImageBind's vision ViT, any other a
    CLIP tower (`VisionTowerConfig(**kwargs)`)."""
    if "languagebind" in (name or "").lower():
        cfg = imagebind_lib.ViTConfig.imagebind_vision()
        make = lambda: imagebind_lib.ViT(cfg)  # noqa: E731
    else:
        cfg = VisionTowerConfig(**kwargs)
        make = lambda: clip_lib.CLIPVision(cfg.clip)  # noqa: E731
    with torch.device("meta"):
        m = make()
    m = L.init_(L.materialize(m, torch.device(device), dtype), generator)
    return m.eval().requires_grad_(False), cfg
