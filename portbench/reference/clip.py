"""CLIP text towers (SDXL's CLIP ViT-L/14 and OpenCLIP bigG, the prior's
ViT-H).

`CLIPText` holds the weights; `text_apply` returns every hidden state,
the final-LN output, the pooled EOS state and, when the config has one,
the projected `text_embeds`. Attention is plain and causal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .attention import dot_product_attention
from .checkpoint import KeyMap, Rule
from . import layers as L


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = None  # text_projection if set
    eos_token_id: int = 49407


def _act(name):
    return {"quick_gelu": L.quick_gelu, "gelu": L.gelu}[name]


class CLIPLayer(nn.Module):
    def __init__(self, dim: int, inter: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.o = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, inter)
        self.fc2 = nn.Linear(inter, dim)


def _layer(p: CLIPLayer, x, heads, act, causal, mask=None):
    b, s, d = x.shape
    hd = d // heads
    h = L.layer_norm(p.ln1, x)
    q = L.linear(p.q, h).reshape(b, s, heads, hd)
    k = L.linear(p.k, h).reshape(b, s, heads, hd)
    v = L.linear(p.v, h).reshape(b, s, heads, hd)
    o = dot_product_attention(q, k, v, causal=causal, mask=mask)
    x = x + L.linear(p.o, o.reshape(b, s, d))
    h = L.layer_norm(p.ln2, x)
    return x + L.linear(p.fc2, act(L.linear(p.fc1, h)))


class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)
        self.final_ln = nn.LayerNorm(cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg.hidden_size, cfg.intermediate_size))
        if cfg.projection_dim:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, input_ids, attention_mask=None):
        return text_apply(self, input_ids, self.cfg, attention_mask)


def text_apply(
    params: CLIPText,
    input_ids: torch.Tensor,  # (B, S) integer ids
    cfg: CLIPTextConfig,
    attention_mask: Optional[torch.Tensor] = None,
):
    """Returns `hidden_states` (embeddings and every layer output),
    `last_hidden_state` (final LN), `pooled` (final-LN state at the first
    EOS, else the last position) and `text_embeds` (projected pooled)."""
    b, s = input_ids.shape
    dev = params.token_embedding.weight.device
    input_ids = input_ids.to(dev)
    x = L.embedding(params.token_embedding, input_ids)
    x = x + L.embedding(params.position_embedding, torch.arange(s, device=dev))[None]
    act = _act(cfg.hidden_act)
    hidden = [x]
    for i in range(cfg.num_layers):
        x = _layer(getattr(params, f"layer_{i}"), x, cfg.num_heads, act, causal=True,
                   mask=attention_mask)
        hidden.append(x)
    last = L.layer_norm(params.final_ln, x)
    is_eos = (input_ids == cfg.eos_token_id).int()
    has_eos = is_eos.any(dim=1)
    eos_pos = torch.where(has_eos, is_eos.argmax(dim=1), torch.full_like(has_eos, s - 1, dtype=torch.long))
    pooled = last[torch.arange(b, device=dev), eos_pos]
    out = {"hidden_states": tuple(hidden), "last_hidden_state": last, "pooled": pooled}
    if cfg.projection_dim:
        out["text_embeds"] = L.linear(params.text_projection, pooled)
    return out


# ------------------------------------------------------------ checkpoints


def _layer_rules(lay: str):
    rules = []
    for ref, port in (("layer_norm1", "ln1"), ("layer_norm2", "ln2"), ("self_attn.q_proj", "q"),
                      ("self_attn.k_proj", "k"), ("self_attn.v_proj", "v"),
                      ("self_attn.out_proj", "o"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
        for leaf in ("weight", "bias"):
            rules.append(Rule(f"{lay}.{ref}.{leaf}", "layer_{i}." + f"{port}.{leaf}"))
    return rules


def text_keymap() -> KeyMap:
    """HF `CLIPTextModel` / `CLIPTextModelWithProjection` keys ↔ `CLIPText`."""
    lay = "text_model.encoder.layers.{i}"
    rules = [
        Rule("text_model.embeddings.token_embedding.weight", "token_embedding.weight"),
        Rule("text_model.embeddings.position_embedding.weight", "position_embedding.weight"),
        Rule("text_model.final_layer_norm.weight", "final_ln.weight"),
        Rule("text_model.final_layer_norm.bias", "final_ln.bias"),
        Rule("text_projection.weight", "text_projection.weight"),
    ] + _layer_rules(lay)
    ignore = [(r"text_model\.embeddings\.position_ids", "position ids, a buffer of 0..n-1")]
    return KeyMap(rules, ignore)
