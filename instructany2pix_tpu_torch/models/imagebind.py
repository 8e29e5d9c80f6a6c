"""ImageBind-class vision and audio encoders into the shared 1024-d space,
counterpart of the JAX package's `models/imagebind.py`.

  * vision: ViT-H/14 trunk (pre-LN, cls token, 257 tokens, head_dim 80) and
    the modality head (LayerNorm → Linear to 1024, no bias);
  * audio: 128 × 204 log-mel "images" cut into overlapping 16 × 16 patches
    at stride 10 by a ViT-B trunk (229 tokens, head_dim 64), the same head,
    a ×20 logit scale; clip embeddings are averaged by the caller.
The trunks' attention has no mask, so it reaches K1 through the router.
Checkpoints with `bias_k`/`bias_v` (torch MultiheadAttention
`add_bias_kv`, the official audio trunk) append one learned key/value
position; `ViT(bias_kv=True)` holds them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.attention import dot_product_attention
from . import layers as L


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    width: int = 1280
    layers: int = 32
    heads: int = 16
    patch: int = 14
    image_size: int = 224
    in_channels: int = 3
    out_dim: int = 1024
    mlp_ratio: float = 4.0
    pre_ln: bool = True
    stride: Optional[int] = None  # != patch → overlapping patches (audio)
    normalize_out: bool = True  # L2-normalize the joint-space embedding
    out_scale: float = 1.0  # the audio postprocessor's logit scale (20.0)

    @property
    def eff_stride(self) -> int:
        return self.stride or self.patch

    @staticmethod
    def imagebind_vision() -> "ViTConfig":
        return ViTConfig()

    @staticmethod
    def imagebind_audio() -> "ViTConfig":
        return ViTConfig(
            width=768, layers=12, heads=12, patch=16, image_size=0,
            in_channels=1, stride=10, out_scale=20.0,
        )

    @staticmethod
    def tiny(in_channels: int = 3) -> "ViTConfig":
        return ViTConfig(
            width=32, layers=2, heads=4, patch=14, image_size=28,
            in_channels=in_channels, out_dim=16,
        )


def audio_patches(cfg: ViTConfig, mel_bins: int = 128, frames: int = 204) -> int:
    """Patch count of the audio trunk over the mel grid."""
    s, p = cfg.eff_stride, cfg.patch
    return ((mel_bins - p) // s + 1) * ((frames - p) // s + 1)


class ViTBlock(nn.Module):
    def __init__(self, d: int, mlp: int, bias_kv: bool = False):
        super().__init__()
        self.ln1 = nn.LayerNorm(d)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.ln2 = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, mlp)
        self.fc2 = nn.Linear(mlp, d)
        if bias_kv:
            self.bias_k = nn.Parameter(torch.empty(1, d))
            self.bias_v = nn.Parameter(torch.empty(1, d))


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig, num_patches: Optional[int] = None, bias_kv: bool = False,
                 patch_norm: bool = False):
        super().__init__()
        d = cfg.width
        if num_patches is None:
            num_patches = (cfg.image_size // cfg.patch) ** 2
        self.patch_embed = nn.Conv2d(cfg.in_channels, d, cfg.patch, stride=cfg.eff_stride, bias=False)
        if patch_norm:  # the audio stem's LayerNorm, in checkpoints that have it
            self.patch_norm = nn.LayerNorm(d)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, num_patches + 1, d))
        if cfg.pre_ln:
            self.pre_ln = nn.LayerNorm(d)
        for i in range(cfg.layers):
            self.add_module(f"block_{i}", ViTBlock(d, int(d * cfg.mlp_ratio), bias_kv))
        self.head_ln = nn.LayerNorm(d)
        self.head_proj = nn.Linear(d, cfg.out_dim, bias=False)


def _block(p: ViTBlock, x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, d = x.shape
    hd = d // heads
    h = L.layer_norm(p.ln1, x)
    q, k, v = L.linear(p.qkv, h).chunk(3, dim=-1)
    if hasattr(p, "bias_k"):
        k = torch.cat([k, p.bias_k.to(k.dtype).expand(b, 1, d)], dim=1)
        v = torch.cat([v, p.bias_v.to(v.dtype).expand(b, 1, d)], dim=1)
    o = dot_product_attention(
        q.reshape(b, s, heads, hd), k.reshape(b, -1, heads, hd), v.reshape(b, -1, heads, hd)
    )
    x = x + L.linear(p.proj, o.reshape(b, s, d))
    h = L.layer_norm(p.ln2, x)
    return x + L.linear(p.fc2, L.gelu(L.linear(p.fc1, h)))


def apply(params: ViT, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """x: (B, H, W, C) preprocessed → (B, out_dim) joint-space embedding."""
    w = params.patch_embed.weight
    x = torch.as_tensor(x).to(device=w.device, dtype=w.dtype)
    b = x.shape[0]
    h = L.conv2d(params.patch_embed, x, stride=cfg.eff_stride, padding="VALID")
    h = h.reshape(b, -1, cfg.width)
    if hasattr(params, "patch_norm"):
        h = L.layer_norm(params.patch_norm, h)
    cls = params.cls_token.to(h.dtype).expand(b, 1, cfg.width)
    h = torch.cat([cls, h], dim=1)
    if h.shape[1] != params.pos_embed.shape[1]:
        raise ValueError(f"token count {h.shape[1]} != pos_embed {params.pos_embed.shape[1]}: "
                         "the input resolution does not match the encoder config")
    h = h + params.pos_embed.to(h.dtype)
    if hasattr(params, "pre_ln"):
        h = L.layer_norm(params.pre_ln, h)
    for i in range(cfg.layers):
        h = _block(getattr(params, f"block_{i}"), h, cfg.heads)
    pooled = L.layer_norm(params.head_ln, h[:, 0])
    out = L.linear(params.head_proj, pooled)
    if cfg.normalize_out:
        out = out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-9)
    return out * cfg.out_scale


# -------------------------------------------------------------- frontends

_V_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_V_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_vision(img: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 (H, W, 3) → normalized (1, size, size, 3)."""
    from ..codecs.image_io import resize_center_crop

    x = resize_center_crop(img, size).astype(np.float32) / 255.0
    x = (x - _V_MEAN) / _V_STD
    return x[None]


def preprocess_audio(
    wav: np.ndarray,
    sr: int = 16000,
    num_mel_bins: int = 128,
    target_frames: int = 204,
    clip_seconds: float = 2.0,
    num_clips: int = 3,
) -> np.ndarray:
    """waveform → (num_clips, 128, target_frames, 1) normalized log-mel
    clips (ImageBind samples 3 × 2 s clips and averages their embeddings)."""
    from ..codecs.processors import log_mel_spectrogram

    clip_len = int(sr * clip_seconds)
    total = max(len(wav), clip_len)
    wav = np.pad(wav, (0, max(0, total - len(wav))))
    starts = np.linspace(0, max(total - clip_len, 0), num_clips).astype(int)
    clips = []
    for s in starts:
        seg = wav[s: s + clip_len]
        mel = log_mel_spectrogram(
            seg, sr, n_fft=400, hop=clip_len // target_frames, n_mels=num_mel_bins
        )
        mel = mel[:, :target_frames]
        if mel.shape[1] < target_frames:
            mel = np.pad(mel, ((0, 0), (0, target_frames - mel.shape[1])))
        mel = (mel - mel.mean()) / (mel.std() + 1e-6)
        clips.append(mel[..., None])
    return np.stack(clips).astype(np.float32)
