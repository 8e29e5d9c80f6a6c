"""IP-Adapter image projection (2-view global/local), counterpart of the
JAX package's `diffusion/ip_adapter.py`.

Stacked [global, local] image embeddings project to `num_crops *
num_tokens` context tokens; local tokens blend with global by
`scales[1]`; learned per-view `raw_embed`; LayerNorm last. Unconditional
tokens are the projection of zeros. The attention half lives in the UNet
(`to_k_ip`/`to_v_ip`). Raw images reach it through the CLIP image encoder
(`preprocess_clip_image`, `encode_clip_image`); `MLPProj` is the
reference's plain MLP projector; `aggregate_attn_maps` turns the UNet's
`capture_ip_attn` taps into per-token attention maps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..codecs import image_io
from ..core.checkpoint import KeyMap, Rule
from ..models import clip as clip_lib
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


CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_clip_image(image, image_size: int = 224) -> torch.Tensor:
    """CLIPImageProcessor semantics: shortest-side resize, center crop,
    rescale to [0, 1] (an integer image is divided by 255, whatever its
    values), CLIP mean/std. One HWC array or a list → (B, H, W, 3) float32
    on the CPU."""
    if not isinstance(image, (list, tuple)):
        image = [image]
    out = []
    for img in image:
        arr = np.asarray(img)
        is_int = np.issubdtype(arr.dtype, np.integer)
        arr = image_io.resize_center_crop(arr, image_size).astype(np.float32)
        if is_int:
            arr = arr / 255.0
        out.append((arr - np.asarray(CLIP_IMAGE_MEAN)) / np.asarray(CLIP_IMAGE_STD))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def encode_clip_image(vision: "clip_lib.CLIPVision", vision_cfg: "clip_lib.CLIPVisionConfig",
                      image) -> torch.Tensor:
    """Image(s) → projected CLIP image embeddings (B, projection_dim): the
    reference's `image_encoder(...).image_embeds`."""
    pixels = preprocess_clip_image(image, vision_cfg.image_size)
    return clip_lib.vision_apply(vision, pixels, vision_cfg)["image_embeds"]


def get_image_embeds(
    params: ImageProj,
    cfg: ImageProjConfig,
    clip_image_embeds: Optional[torch.Tensor] = None,  # (B, D) global
    clip_image_embeds_local: Optional[torch.Tensor] = None,  # (B, D) local
    mode: str = "global",
    scale_g: float = 1.0,
    scale_l: float = 1.0,
    image=None,  # raw image(s), encoded by `image_encoder`
    image_local=None,
    image_encoder: Optional[tuple] = None,  # (CLIPVision, CLIPVisionConfig)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (cond_tokens, uncond_tokens); raw images run through the CLIP
    image encoder first, a missing view is zero-filled and uncond always
    projects zeros."""
    for raw in (image, image_local):
        if raw is not None and image_encoder is None:
            raise ValueError("an image input needs image_encoder=(vision, vision_cfg)")
    if image is not None:
        clip_image_embeds = encode_clip_image(*image_encoder, image)
    if image_local is not None:
        clip_image_embeds_local = encode_clip_image(*image_encoder, image_local)
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


class MLPProj(nn.Module):
    """The reference's MLPProjModel (IPAdapterFull): Linear → GELU →
    Linear → LayerNorm over per-token features."""

    def __init__(self, clip_embeddings_dim: int = 1024, cross_attention_dim: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(clip_embeddings_dim, clip_embeddings_dim)
        self.fc2 = nn.Linear(clip_embeddings_dim, cross_attention_dim)
        self.norm = nn.LayerNorm(cross_attention_dim)


def mlp_proj_apply(params: MLPProj, image_embeds: torch.Tensor) -> torch.Tensor:
    h = L.linear(params.fc2, L.gelu(L.linear(params.fc1, image_embeds)))
    return L.layer_norm(params.norm, h)


def aggregate_attn_maps(taps: dict, image_hw, batch_index: int = 1) -> Optional[torch.Tensor]:
    """The reference's `get_net_attn_map`: per tapped layer take one batch
    row (a CFG half), average the heads, lay the pixel axis on its square
    grid, resize bilinearly to `image_hw` (half-pixel centres, as
    `jax.image.resize`; antialiased when it shrinks), softmax over the IP
    tokens, then average the layers → (n_ip, H, W) float32, or None when no
    layer has a square grid."""
    th, tw = image_hw
    total, n = None, 0
    for probs in taps.values():  # (B, heads, S, n_ip)
        m = probs[batch_index].float().mean(dim=0)  # (S, n_ip)
        s, n_ip = m.shape
        side = int(round(s**0.5))
        if side * side != s:
            continue
        grid = m.T.reshape(1, n_ip, side, side)
        up = F.interpolate(grid, size=(th, tw), mode="bilinear", align_corners=False,
                           antialias=th < side or tw < side)[0]
        sm = torch.softmax(up, dim=0)
        total = sm if total is None else total + sm
        n += 1
    return None if total is None else total / n


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
