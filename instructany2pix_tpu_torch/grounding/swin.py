"""Swin Transformer backbone (Swin-T), GroundingDINO's image encoder:
counterpart of the JAX package's `grounding/swin.py`. Four stages of
shifted-window attention with a relative position bias table and patch
merging between stages; returns the feature maps of `out_stages`.

For sizes that are not a multiple of the window, each block pads first and
then rolls the padded canvas (the order the shift mask is built for), and
undoes both on the way out. Window attention is plain math: 49 tokens per
window.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import KeyMap, Rule
from ..models import layers as L


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    patch: int = 4
    mlp_ratio: float = 4.0
    out_stages: Tuple[int, ...] = (1, 2, 3)

    @staticmethod
    def tiny() -> "SwinConfig":
        return SwinConfig(embed_dim=8, depths=(1, 1, 2), heads=(1, 2, 4), window=2,
                          out_stages=(1, 2))

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2**i)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, mlp: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_bias = nn.Parameter(torch.empty((2 * window - 1) ** 2, heads))
        self.ln2 = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, mlp)
        self.fc2 = nn.Linear(mlp, dim)


class Merge(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.ln = nn.LayerNorm(4 * dim)
        self.proj = nn.Linear(4 * dim, 2 * dim, bias=False)


class Swin(nn.Module):
    def __init__(self, cfg: SwinConfig = SwinConfig()):
        super().__init__()
        self.patch_embed = nn.Conv2d(3, cfg.embed_dim, cfg.patch, stride=cfg.patch)
        self.patch_ln = nn.LayerNorm(cfg.embed_dim)
        for s, depth in enumerate(cfg.depths):
            dim = cfg.stage_dim(s)
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}",
                                SwinBlock(dim, cfg.heads[s], cfg.window, int(dim * cfg.mlp_ratio)))
            if s < len(cfg.depths) - 1:
                self.add_module(f"merge_{s}", Merge(dim))
        for s in cfg.out_stages:
            self.add_module(f"out_ln_{s}", nn.LayerNorm(cfg.stage_dim(s)))


def _rel_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + window - 1
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def _shift_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """(windows, n, n) True where two tokens of a rolled window came from
    different regions of the canvas."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(hp // window, window, wp // window, window).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, window * window)
    return mw[:, :, None] != mw[:, None, :]


def _window_attn(p: SwinBlock, x, heads, window, shift, rel_idx):
    b, hh, ww, d = x.shape
    hd = d // heads
    pad_h = (window - hh % window) % window
    pad_w = (window - ww % window) % window
    xp = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = hh + pad_h, ww + pad_w
    if shift:
        xp = torch.roll(xp, (-shift, -shift), dims=(1, 2))
    n = window * window
    xw = xp.reshape(b, hp // window, window, wp // window, window, d)
    xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, n, d)
    nb = xw.shape[0]
    q, k, v = (t.reshape(nb, n, heads, hd) for t in L.linear(p.qkv, xw).chunk(3, dim=-1))
    attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (hd**-0.5)
    bias = p.rel_bias[torch.as_tensor(rel_idx, device=x.device)]  # (n, n, heads)
    attn = attn + bias.permute(2, 0, 1)[None].float()
    if shift:
        diff = torch.as_tensor(_shift_mask(hp, wp, window, shift), device=x.device)
        attn = attn - 1e9 * diff.repeat(b, 1, 1)[:, None].float()
    attn = torch.softmax(attn, dim=-1)
    o = torch.einsum("bhnm,bmhd->bnhd", attn.to(v.dtype), v).reshape(nb, n, d)
    o = L.linear(p.proj, o)
    o = o.reshape(b, hp // window, wp // window, window, window, d)
    o = o.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, d)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    return o[:, :hh, :ww]


def apply(params: Swin, x: torch.Tensor, cfg: SwinConfig = SwinConfig()) -> List[torch.Tensor]:
    """x: (B, H, W, 3) normalized → the feature maps of `cfg.out_stages`,
    [(B, H/8, W/8, 2C), (B, H/16, W/16, 4C), (B, H/32, W/32, 8C)] by default."""
    rel_idx = _rel_index(cfg.window)
    w = params.patch_embed.weight
    x = torch.as_tensor(x).to(device=w.device, dtype=w.dtype)
    h = L.layer_norm(params.patch_ln, L.conv2d(params.patch_embed, x, stride=cfg.patch,
                                               padding="VALID"))
    outs = {}
    for s, depth in enumerate(cfg.depths):
        for bi in range(depth):
            p = getattr(params, f"stage{s}_block{bi}")
            shift = 0 if bi % 2 == 0 else cfg.window // 2
            h = h + _window_attn(p, L.layer_norm(p.ln1, h), cfg.heads[s], cfg.window, shift,
                                 rel_idx)
            h = h + L.linear(p.fc2, L.gelu(L.linear(p.fc1, L.layer_norm(p.ln2, h))))
        if s in cfg.out_stages:
            outs[s] = L.layer_norm(getattr(params, f"out_ln_{s}"), h)
        if s < len(cfg.depths) - 1:
            _, hh, ww, _ = h.shape
            h = F.pad(h, (0, 0, 0, ww % 2, 0, hh % 2))
            h = torch.cat([h[:, 0::2, 0::2], h[:, 1::2, 0::2], h[:, 0::2, 1::2], h[:, 1::2, 1::2]],
                          dim=-1)
            m = getattr(params, f"merge_{s}")
            h = L.linear(m.proj, L.layer_norm(m.ln, h))
    return [outs[s] for s in cfg.out_stages]


# ------------------------------------------------------------ checkpoints


def keymap(cfg: SwinConfig) -> KeyMap:
    """Official Swin backbone keys ↔ `Swin`. The output norms are
    `norm1..normN`, one per entry of `cfg.out_stages`."""
    blk, ours = "layers.{s}.blocks.{b}", "stage{s}_block{b}"
    rules = [Rule(f"patch_embed.proj.{leaf}", f"patch_embed.{leaf}") for leaf in ("weight", "bias")]
    rules += [Rule(f"patch_embed.norm.{leaf}", f"patch_ln.{leaf}") for leaf in ("weight", "bias")]
    for ref, port in (("norm1", "ln1"), ("attn.qkv", "qkv"), ("attn.proj", "proj"),
                      ("norm2", "ln2"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
        for leaf in ("weight", "bias"):
            rules.append(Rule(f"{blk}.{ref}.{leaf}", f"{ours}.{port}.{leaf}"))
    rules.append(Rule(f"{blk}.attn.relative_position_bias_table", f"{ours}.rel_bias"))
    rules += [Rule(f"layers.{{s}}.downsample.norm.{leaf}", f"merge_{{s}}.ln.{leaf}")
              for leaf in ("weight", "bias")]
    rules.append(Rule("layers.{s}.downsample.reduction.weight", "merge_{s}.proj.weight"))
    for i, s in enumerate(cfg.out_stages):
        rules += [Rule(f"norm{i + 1}.{leaf}", f"out_ln_{s}.{leaf}") for leaf in ("weight", "bias")]
    ignore = [(r"layers\.\d+\.blocks\.\d+\.attn\.relative_position_index",
               "window index buffer, recomputed (_rel_index)"),
              (r"layers\.\d+\.blocks\.\d+\.attn_mask", "shift mask buffer, recomputed")]
    return KeyMap(rules, ignore)
