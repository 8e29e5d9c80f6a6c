"""AutoencoderKL — the SDXL image VAE. NHWC at the boundary; GroupNorm
eps 1e-6 throughout. `encode` takes the posterior noise as a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import dot_product_attention
from . import layers as L


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025  # SDXL; SD1.5 uses 0.18215

class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3)
        if cin != cout:
            self.shortcut = nn.Conv2d(cin, cout, 1)


def _resnet(p: ResnetBlock, x):
    h = L.conv2d(p.conv1, L.group_norm(p.norm1, x, silu=True))
    h = L.conv2d(p.conv2, L.group_norm(p.norm2, h, silu=True))
    if hasattr(p, "shortcut"):
        x = L.conv2d(p.shortcut, x)
    return x + h


class AttnBlock(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.q = nn.Linear(c, c)
        self.k = nn.Linear(c, c)
        self.v = nn.Linear(c, c)
        self.o = nn.Linear(c, c)


def _attn(p: AttnBlock, x):
    b, h, w, c = x.shape
    y = L.group_norm(p.norm, x).reshape(b, h * w, c)
    q = L.linear(p.q, y)[:, :, None, :]
    k = L.linear(p.k, y)[:, :, None, :]
    v = L.linear(p.v, y)[:, :, None, :]
    o = dot_product_attention(q, k, v)[:, :, 0, :]
    return x + L.linear(p.o, o).reshape(b, h, w, c)


def _mid(c, groups):
    return nn.ModuleDict({
        "res_0": ResnetBlock(c, c, groups),
        "attn": AttnBlock(c, groups),
        "res_1": ResnetBlock(c, c, groups),
    })


class VAE(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        lc = cfg.latent_channels
        enc = nn.ModuleDict({"conv_in": nn.Conv2d(cfg.in_channels, ch[0], 3)})
        cin = ch[0]
        for i, cout in enumerate(ch):
            blk = nn.ModuleDict()
            c = cin
            for j in range(cfg.layers_per_block):
                blk[f"res_{j}"] = ResnetBlock(c, cout, g)
                c = cout
            if i < len(ch) - 1:
                blk["down"] = nn.Conv2d(cout, cout, 3)
            enc[f"down_{i}"] = blk
            cin = cout
        enc["mid"] = _mid(cin, g)
        enc["norm_out"] = nn.GroupNorm(g, cin, eps=1e-6)
        enc["conv_out"] = nn.Conv2d(cin, 2 * lc, 3)
        enc["quant_conv"] = nn.Conv2d(2 * lc, 2 * lc, 1)

        dec = nn.ModuleDict({
            "post_quant_conv": nn.Conv2d(lc, lc, 1),
            "conv_in": nn.Conv2d(lc, ch[-1], 3),
        })
        cin = ch[-1]
        dec["mid"] = _mid(cin, g)
        for i, cout in enumerate(reversed(ch)):
            blk = nn.ModuleDict()
            c = cin
            for j in range(cfg.layers_per_block + 1):
                blk[f"res_{j}"] = ResnetBlock(c, cout, g)
                c = cout
            if i < len(ch) - 1:
                blk["up"] = nn.Conv2d(cout, cout, 3)
            dec[f"up_{i}"] = blk
            cin = cout
        dec["norm_out"] = nn.GroupNorm(g, cin, eps=1e-6)
        dec["conv_out"] = nn.Conv2d(cin, cfg.in_channels, 3)
        self.encoder = enc
        self.decoder = dec


def _mid_apply(m, h):
    return _resnet(m["res_1"], _attn(m["attn"], _resnet(m["res_0"], h)))


def encode_moments(params: VAE, x: torch.Tensor, cfg: VAEConfig = VAEConfig()):
    """Image (B, H, W, 3) in [-1, 1] → (mean, logvar) latent moments."""
    p = params.encoder
    w = p["conv_in"].weight
    h = L.conv2d(p["conv_in"], x.to(device=w.device, dtype=w.dtype))
    for i in range(len(cfg.block_out_channels)):
        blk = p[f"down_{i}"]
        for j in range(cfg.layers_per_block):
            h = _resnet(blk[f"res_{j}"], h)
        if "down" in blk:
            # diffusers pads (0,1,0,1), then a VALID stride-2 conv
            h = F.pad(h, (0, 0, 0, 1, 0, 1))
            h = L.conv2d(blk["down"], h, stride=2, padding="VALID")
    h = _mid_apply(p["mid"], h)
    h = L.group_norm(p["norm_out"], h, silu=True)
    h = L.conv2d(p["quant_conv"], L.conv2d(p["conv_out"], h))
    mean, logvar = h.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def encode(
    params: VAE,
    x: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    cfg: VAEConfig = VAEConfig(),
):
    """→ scaled latents (B, H/f, W/f, C). With `noise` (shaped like the
    latents) the posterior is sampled, mean + std * noise; without it the
    mean is used."""
    mean, logvar = encode_moments(params, x, cfg)
    if noise is not None:
        z = mean + torch.exp(0.5 * logvar) * noise.to(device=mean.device, dtype=mean.dtype)
    else:
        z = mean
    return z * cfg.scaling_factor


def decode(params: VAE, z: torch.Tensor, cfg: VAEConfig = VAEConfig()):
    """Scaled latents → image (B, H, W, 3) in [-1, 1]."""
    p = params.decoder
    w = p["conv_in"].weight
    h = z.to(device=w.device, dtype=w.dtype) / cfg.scaling_factor
    h = L.conv2d(p["conv_in"], L.conv2d(p["post_quant_conv"], h))
    h = _mid_apply(p["mid"], h)
    for i in range(len(cfg.block_out_channels)):
        blk = p[f"up_{i}"]
        for j in range(cfg.layers_per_block + 1):
            h = _resnet(blk[f"res_{j}"], h)
        if "up" in blk:
            h = L.conv2d(blk["up"], L.upsample2x_nearest(h))
    h = L.group_norm(p["norm_out"], h, silu=True)
    return L.conv2d(p["conv_out"], h)
