"""Perceiver Resampler, the IP-Adapter Plus image-token projector;
counterpart of the JAX package's `diffusion/resampler.py` (reference
diffusion/ip_adapter/resampler.py:34-147, IPAdapterPlus(XL) at
ip_adapter.py:359-491).

Learned latents cross-attend the CLIP image encoder's penultimate hidden
states (kv = [features, latents]) through `depth` perceiver layers, each
followed by a LayerNorm-MLP feedforward; an optional positional embedding
and mean-pooled extra latents. The attention is the split-scale form
(q·s)(k·s)ᵀ with s = dim_head^-1/4, a float32 softmax and plain products,
as the JAX einsums compute it: it is not routed to K1, whose rounding
differs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..core.checkpoint import Rule
from ..models import clip as clip_lib
from ..models import layers as L


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    dim: int = 1024
    depth: int = 8
    dim_head: int = 64
    heads: int = 16
    num_queries: int = 8
    embedding_dim: int = 768
    output_dim: int = 1024
    ff_mult: int = 4
    max_seq_len: int = 257
    apply_pos_emb: bool = False
    num_latents_mean_pooled: int = 0

    @staticmethod
    def plus_xl() -> "ResamplerConfig":
        # IPAdapterPlusXL: depth 4, heads 20, 16 queries, ctx 2048 out
        return ResamplerConfig(dim=1280, depth=4, heads=20, num_queries=16, embedding_dim=1280,
                               output_dim=2048)

    @staticmethod
    def tiny() -> "ResamplerConfig":
        return ResamplerConfig(dim=32, depth=2, dim_head=8, heads=4, num_queries=4,
                               embedding_dim=16, output_dim=24, ff_mult=2, max_seq_len=10)


class PerceiverLayer(nn.Module):
    """One perceiver attention (norm1 over the features, norm2 over the
    latents, to_q, to_kv, to_out) and its feedforward (ff_ln, ff1, ff2)."""

    def __init__(self, dim: int, dim_head: int, heads: int, ff_mult: int):
        super().__init__()
        inner = dim_head * heads
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.ff_ln = nn.LayerNorm(dim)
        self.ff1 = nn.Linear(dim, dim * ff_mult, bias=False)
        self.ff2 = nn.Linear(dim * ff_mult, dim, bias=False)


class MeanPooled(nn.Module):
    def __init__(self, dim: int, n: int):
        super().__init__()
        self.ln = nn.LayerNorm(dim)
        self.proj = nn.Linear(dim, dim * n)


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig = ResamplerConfig()):
        super().__init__()
        self.cfg = cfg
        self.latents = nn.Parameter(torch.empty(1, cfg.num_queries, cfg.dim))
        self.proj_in = nn.Linear(cfg.embedding_dim, cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.output_dim)
        self.norm_out = nn.LayerNorm(cfg.output_dim)
        if cfg.apply_pos_emb:
            self.pos_emb = nn.Embedding(cfg.max_seq_len, cfg.embedding_dim)
        if cfg.num_latents_mean_pooled > 0:
            self.mean_pooled = MeanPooled(cfg.dim, cfg.num_latents_mean_pooled)
        for i in range(cfg.depth):
            self.add_module(f"layer_{i}", PerceiverLayer(cfg.dim, cfg.dim_head, cfg.heads,
                                                         cfg.ff_mult))


def init(cfg: ResamplerConfig, generator: torch.Generator, device="cpu",
         dtype=torch.float32) -> Resampler:
    """A Resampler drawn from `generator` (the JAX initializers; the
    latents N(0, 1)/sqrt(dim))."""
    with torch.device("meta"):
        m = Resampler(cfg)
    m = L.init_(L.materialize(m, torch.device("cpu"), torch.float32), generator)
    with torch.no_grad():
        m.latents.normal_(generator=generator).div_(cfg.dim**0.5)
    return m.to(device=device, dtype=dtype).eval().requires_grad_(False)


def perceiver_attention(p: PerceiverLayer, x: torch.Tensor, latents: torch.Tensor, heads: int,
                        dim_head: int) -> torch.Tensor:
    xn = L.layer_norm(p.norm1, x)
    ln = L.layer_norm(p.norm2, latents)
    b, nl, _ = ln.shape
    q = L.linear(p.to_q, ln)
    k, v = L.linear(p.to_kv, torch.cat([xn, ln], dim=1)).chunk(2, dim=-1)

    def heads_first(t):
        return t.reshape(b, t.shape[1], heads, dim_head).transpose(1, 2)

    q, k, v = heads_first(q), heads_first(k), heads_first(v)
    scale = 1.0 / dim_head**0.25
    w = torch.matmul(q * scale, (k * scale).to(q.dtype).transpose(-1, -2))
    w = torch.softmax(w.float(), dim=-1).to(v.dtype)
    out = torch.matmul(w, v).transpose(1, 2).reshape(b, nl, heads * dim_head)
    return L.linear(p.to_out, out)


def feedforward(p: PerceiverLayer, latents: torch.Tensor) -> torch.Tensor:
    h = L.layer_norm(p.ff_ln, latents)
    return L.linear(p.ff2, L.gelu(L.linear(p.ff1, h)))


def apply(params: Resampler, x: torch.Tensor, cfg: ResamplerConfig = ResamplerConfig()) -> torch.Tensor:
    """x (B, N, embedding_dim) CLIP penultimate hidden states → (B,
    num_queries [+ mean-pooled], output_dim) IP tokens, in the weights'
    dtype."""
    w = params.proj_in.weight
    x = x.to(device=w.device, dtype=w.dtype)
    b, n, _ = x.shape
    if hasattr(params, "pos_emb"):
        x = x + L.embedding(params.pos_emb, torch.arange(n, device=x.device))[None]
    latents = params.latents.expand(b, -1, -1)
    x = L.linear(params.proj_in, x)
    if hasattr(params, "mean_pooled"):
        mp = params.mean_pooled
        extra = L.linear(mp.proj, L.layer_norm(mp.ln, x.mean(dim=1)))
        latents = torch.cat([extra.reshape(b, cfg.num_latents_mean_pooled, cfg.dim), latents], dim=1)
    for i in range(cfg.depth):
        p = getattr(params, f"layer_{i}")
        latents = perceiver_attention(p, x, latents, cfg.heads, cfg.dim_head) + latents
        latents = feedforward(p, latents) + latents
    return L.layer_norm(params.norm_out, L.linear(params.proj_out, latents))


def clip_penultimate(vision: clip_lib.CLIPVision, vision_cfg: clip_lib.CLIPVisionConfig,
                     pixels: torch.Tensor) -> torch.Tensor:
    """The CLIP image encoder's penultimate hidden states (B, 257, D) of
    preprocessed pixels (B, H, W, 3): the Plus adapters' input."""
    return clip_lib.vision_apply(vision, pixels, vision_cfg)["hidden_states"][-2]


@torch.inference_mode()
def get_image_embeds_plus(
    params: Resampler,
    cfg: ResamplerConfig,
    clip_hidden: Optional[torch.Tensor] = None,
    clip_hidden_uncond: Optional[torch.Tensor] = None,
    image=None,
    image_encoder: Optional[tuple] = None,  # (CLIPVision, CLIPVisionConfig)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IPAdapterPlus.get_image_embeds (reference ip_adapter.py:398-410):
    (cond, uncond) IP tokens from the CLIP penultimate hidden states. From
    a raw `image`, the states come from `image_encoder`, and the uncond
    states are those of a zero image (zeros in place of the preprocessed
    pixels)."""
    if image is not None:
        if image_encoder is None:
            raise ValueError("an image input needs image_encoder=(vision, vision_cfg)")
        from .ip_adapter import preprocess_clip_image

        vision, vision_cfg = image_encoder
        pixels = preprocess_clip_image(image, vision_cfg.image_size)
        clip_hidden = clip_penultimate(vision, vision_cfg, pixels)
        clip_hidden_uncond = clip_penultimate(vision, vision_cfg, torch.zeros_like(pixels))
    if clip_hidden is None or clip_hidden_uncond is None:
        raise ValueError("get_image_embeds_plus needs clip_hidden and clip_hidden_uncond, or image")
    return apply(params, clip_hidden, cfg), apply(params, clip_hidden_uncond, cfg)


# ------------------------------------------------------------ checkpoints


def perceiver_rules(ref: str, port: str, depth: int) -> List[Rule]:
    """The reference's `layers.{i}.0` (PerceiverAttention) and `layers.{i}.1`
    (FeedForward: LayerNorm, Linear, GELU, Linear) ↔ `layer_{i}`, for
    `depth` layers under the prefixes `ref` and `port`."""
    rules = []
    for i in range(depth):
        a, f, p = f"{ref}layers.{i}.0", f"{ref}layers.{i}.1", f"{port}layer_{i}"
        for n in ("norm1", "norm2"):
            rules += [Rule(f"{a}.{n}.{leaf}", f"{p}.{n}.{leaf}") for leaf in ("weight", "bias")]
        for n in ("to_q", "to_kv", "to_out"):
            rules.append(Rule(f"{a}.{n}.weight", f"{p}.{n}.weight"))
        rules += [Rule(f"{f}.0.{leaf}", f"{p}.ff_ln.{leaf}") for leaf in ("weight", "bias")]
        rules += [Rule(f"{f}.1.weight", f"{p}.ff1.weight"), Rule(f"{f}.3.weight", f"{p}.ff2.weight")]
    return rules
