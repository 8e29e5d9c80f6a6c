"""MPT decoder backbone (ALiBi attention, LPLayerNorm, tied embeddings),
counterpart of the JAX package's `models/mpt.py`:

  * ALiBi bias (`gen_slopes`, `build_alibi_bias`): the per-key form on the
    causal path, the full −|i−j| matrix for the prefix-LM path;
  * the fused `wqkv` projection, optional `qk_ln`, `clip_qkv`, a custom
    softmax scale;
  * LPLayerNorm: statistics and affine in float32, the result in the
    activation dtype (`b` absent under `no_bias`);
  * pre-norm blocks with an exact-GELU MLP at `expansion_ratio`;
  * tied `wte` logits, `logit_scale` (a float or "inv_sqrt_d_model"),
    the `embedding_fraction` shrink, learned positions when ALiBi is off;
  * a static KV cache (`init_cache`) written in place.

Attention is plain torch ops with float32 scores, as the JAX package
computes it (its XLA attention, not a kernel). `hf_keymap` reads the
official mosaicml checkpoint naming (`transformer.*`), the JAX
`convert_from_mpt`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
from torch import nn

from ..core.checkpoint import KeyMap, Rule
from . import layers as L


@dataclasses.dataclass(frozen=True)
class MPTConfig:
    d_model: int = 4096
    n_heads: int = 32
    n_layers: int = 32
    expansion_ratio: int = 4
    vocab_size: int = 50432
    max_seq_len: int = 2048
    alibi: bool = True
    alibi_bias_max: float = 8.0
    no_bias: bool = True
    qk_ln: bool = False
    clip_qkv: Optional[float] = None
    softmax_scale: Optional[float] = None
    logit_scale: Optional[Union[float, str]] = None
    embedding_fraction: float = 1.0
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def mpt_7b() -> "MPTConfig":
        return MPTConfig()

    @staticmethod
    def tiny() -> "MPTConfig":
        return MPTConfig(d_model=32, n_heads=4, n_layers=2, expansion_ratio=2,
                         vocab_size=100, max_seq_len=64)


def gen_slopes(n_heads: int, alibi_bias_max: float = 8.0, device=None) -> torch.Tensor:
    """The power-of-two ladder; a head count that is not a power of two
    interleaves the odd and even halves of the next power's ladder."""
    n2 = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, n2 + 1, dtype=torch.float32, device=device) * (alibi_bias_max / n2)
    slopes = 1.0 / torch.pow(2.0, m)
    if n2 != n_heads:
        slopes = torch.cat([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes


def build_alibi_bias(n_heads: int, seq_len: int, full: bool = False,
                     alibi_bias_max: float = 8.0, device=None) -> torch.Tensor:
    """(1, H, 1 or s, s) bias. The causal path takes the per-key form (a
    row's constant cancels in the softmax); `full` builds −|i−j|."""
    k = torch.arange(1 - seq_len, 1, dtype=torch.float32, device=device)[None, None, None, :]
    bias = -torch.abs(k - k.reshape(1, 1, seq_len, 1)) if full else k
    return bias * gen_slopes(n_heads, alibi_bias_max, device).reshape(1, n_heads, 1, 1)


class LPLayerNorm(nn.Module):
    """Gain `g` and, unless `no_bias`, bias `b` (the JAX tree's names)."""

    def __init__(self, d: int, bias: bool):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d))
        if bias:
            self.b = nn.Parameter(torch.zeros(d))


def _lp_layer_norm(p: LPLayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * p.g.float()
    if hasattr(p, "b"):
        y = y + p.b.float()
    return y.to(x.dtype)


class MPTBlock(nn.Module):
    def __init__(self, cfg: MPTConfig):
        super().__init__()
        d, bias = cfg.d_model, not cfg.no_bias
        self.norm_1 = LPLayerNorm(d, bias)
        self.wqkv = nn.Linear(d, 3 * d, bias=bias)
        self.out_proj = nn.Linear(d, d, bias=bias)
        self.norm_2 = LPLayerNorm(d, bias)
        self.up_proj = nn.Linear(d, cfg.expansion_ratio * d, bias=bias)
        self.down_proj = nn.Linear(cfg.expansion_ratio * d, d, bias=bias)
        if cfg.qk_ln:
            self.q_ln = LPLayerNorm(d, bias)
            self.k_ln = LPLayerNorm(d, bias)


class MPT(nn.Module):
    def __init__(self, cfg: MPTConfig = MPTConfig.tiny()):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model)
        if not cfg.alibi:
            self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", MPTBlock(cfg))
        self.norm_f = LPLayerNorm(cfg.d_model, not cfg.no_bias)


@dataclasses.dataclass
class MPTCache:
    k: torch.Tensor  # (L, B, H, max_len, Dh), written in place
    v: torch.Tensor
    length: int  # tokens cached


def init_cache(cfg: MPTConfig, batch: int, max_len: int, dtype=torch.float32,
               device="cpu") -> MPTCache:
    shape = (cfg.n_layers, batch, cfg.n_heads, max_len, cfg.head_dim)
    return MPTCache(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device), 0)


def _attn(blk: MPTBlock, x, cfg: MPTConfig, bias, key_mask, cache: Optional[MPTCache] = None,
          layer: int = 0):
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    qkv = L.linear(blk.wqkv, x)
    if cfg.clip_qkv:
        qkv = qkv.clamp(-cfg.clip_qkv, cfg.clip_qkv)
    q, k, v = qkv.chunk(3, dim=-1)
    if cfg.qk_ln:
        q = _lp_layer_norm(blk.q_ln, q, cfg.ln_eps)
        k = _lp_layer_norm(blk.k_ln, k, cfg.ln_eps)
    q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2) for t in (q, k, v))
    if cache is not None:
        n = cache.length
        cache.k[layer, :, :, n:n + s] = k.to(cache.k.dtype)
        cache.v[layer, :, :, n:n + s] = v.to(cache.v.dtype)
        k, v = cache.k[layer], cache.v[layer]
    scale = cfg.softmax_scale or 1.0 / math.sqrt(hd)
    w = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    s_k = k.shape[2]
    if bias is not None:
        # the last s_q rows and last s_k columns of the max-length table
        bq = max(0, bias.shape[2] - s)
        bk = max(0, bias.shape[3] - s_k)
        w = w + bias[:, :, bq:, bk:].float()
    neg = torch.finfo(torch.float32).min
    if key_mask is not None:
        w = w.masked_fill(~key_mask[:, None, None, :], neg)
    if cache is None:
        if s > 1:
            cm = torch.ones((s, s_k), dtype=torch.bool, device=w.device).tril(s_k - s)
            w = w.masked_fill(~cm[None, None], neg)
    else:
        # against the static cache, keys past cache length + row are invalid
        qpos = cache.length + torch.arange(s, device=w.device)
        kpos = torch.arange(s_k, device=w.device)
        w = w.masked_fill(~(kpos[None, :] <= qpos[:, None])[None, None], neg)
    a = torch.softmax(w, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", a, v).transpose(1, 2).reshape(b, s, d)
    return L.linear(blk.out_proj, out)


def forward(params: MPT, cfg: MPTConfig, input_ids: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None, prefix_lm_full_bias: bool = False,
            cache: Optional[MPTCache] = None):
    """Returns {"logits", "hidden"}, and "cache" when given one (the same
    tensors, written at positions [length, length + s), with the length
    advanced): wte (· embedding_fraction shrink) → blocks over the ALiBi
    bias → norm_f → tied-wte logits (· logit_scale)."""
    if (input_ids is None) == (inputs_embeds is None):
        raise ValueError("pass exactly one of input_ids and inputs_embeds")
    dev = params.wte.weight.device
    x = inputs_embeds.to(dev) if inputs_embeds is not None else L.embedding(params.wte,
                                                                             input_ids.to(dev))
    b, s, _ = x.shape
    if cfg.embedding_fraction != 1.0:
        x = x * cfg.embedding_fraction + x.detach() * (1 - cfg.embedding_fraction)
    start = cache.length if cache is not None else 0
    if not cfg.alibi:
        x = x + L.embedding(params.wpe, torch.arange(s, device=dev)[None, :] + start)
    s_total = cache.k.shape[3] if cache is not None else s
    bias = (build_alibi_bias(cfg.n_heads, s_total, full=prefix_lm_full_bias,
                             alibi_bias_max=cfg.alibi_bias_max, device=dev)
            if cfg.alibi else None)
    key_mask = attention_mask.to(dev).bool() if attention_mask is not None else None
    for i in range(cfg.n_layers):
        blk = getattr(params, f"block_{i}")
        x = x + _attn(blk, _lp_layer_norm(blk.norm_1, x, cfg.ln_eps), cfg, bias, key_mask, cache,
                      i)
        m = _lp_layer_norm(blk.norm_2, x, cfg.ln_eps)
        x = x + L.linear(blk.down_proj, L.gelu(L.linear(blk.up_proj, m)))
    hidden = _lp_layer_norm(params.norm_f, x, cfg.ln_eps)
    logits = hidden @ params.wte.weight.t().to(hidden.dtype)
    scale = cfg.logit_scale
    if scale == "inv_sqrt_d_model":
        scale = 1.0 / math.sqrt(cfg.d_model)
    if scale:
        logits = logits * scale
    out = {"logits": logits, "hidden": hidden}
    if cache is not None:
        out["cache"] = MPTCache(cache.k, cache.v, cache.length + s)
    return out


def hf_keymap() -> KeyMap:
    """The official mosaicml MPT keys (`transformer.*`) ↔ `MPT`. Linears
    keep PyTorch's (out, in) layout; norms' `weight`/`bias` are `g`/`b`."""
    blk = "transformer.blocks.{i}"
    rules = [Rule("transformer.wte.weight", "wte.weight"),
             Rule("transformer.wpe.weight", "wpe.weight"),
             Rule("transformer.norm_f.weight", "norm_f.g"),
             Rule("transformer.norm_f.bias", "norm_f.b")]
    for ref, port in (("norm_1", "norm_1"), ("attn.q_ln", "q_ln"), ("attn.k_ln", "k_ln"),
                      ("norm_2", "norm_2")):
        rules += [Rule(f"{blk}.{ref}.weight", "block_{i}." + f"{port}.g"),
                  Rule(f"{blk}.{ref}.bias", "block_{i}." + f"{port}.b")]
    for ref, port in (("attn.Wqkv", "wqkv"), ("attn.out_proj", "out_proj"),
                      ("ffn.up_proj", "up_proj"), ("ffn.down_proj", "down_proj")):
        rules += [Rule(f"{blk}.{ref}.{leaf}", "block_{i}." + f"{port}.{leaf}")
                  for leaf in ("weight", "bias")]
    return KeyMap(rules)


@torch.no_grad()
def init_(module: MPT, generator: torch.Generator) -> MPT:
    """Random weights with the JAX package's initializers (`layers.init_`),
    the LPLayerNorm gains at one and biases at zero."""
    L.init_(module, generator)
    for m in module.modules():
        if isinstance(m, LPLayerNorm):
            m.g.fill_(1.0)
            if hasattr(m, "b"):
                m.b.zero_()
    return module
