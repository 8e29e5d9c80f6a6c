"""BERT encoder, GroundingDINO's text tower (bert-base-uncased): counterpart
of the JAX package's `grounding/bert.py`. Post-LN transformer with learned
position and token-type embeddings; its attention is plain math (masked),
as the JAX tower's `impl="xla"`."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..core.checkpoint import KeyMap, Rule
from ..models import layers as L
from ..ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(
            vocab_size=100, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, max_positions=32,
        )


class BertLayer(nn.Module):
    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.o = nn.Linear(d, d)
        self.attn_ln = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.out_ln = nn.LayerNorm(d)


class Bert(nn.Module):
    def __init__(self, cfg: BertConfig = BertConfig.tiny()):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_positions, d)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab, d)
        self.embed_ln = nn.LayerNorm(d)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(d, cfg.intermediate_size))


def forward(
    params: Bert,
    cfg: BertConfig,
    input_ids: torch.Tensor,  # (B, S)
    attention_mask: Optional[torch.Tensor] = None,  # (B, S) 1 = keep
    self_attn_mask: Optional[torch.Tensor] = None,  # (B, S, S) phrase-local mask
) -> torch.Tensor:
    b, s = input_ids.shape
    dev = params.word_embeddings.weight.device
    input_ids = torch.as_tensor(input_ids, device=dev)
    x = L.embedding(params.word_embeddings, input_ids)
    x = x + L.embedding(params.position_embeddings, torch.arange(s, device=dev))[None]
    x = x + params.token_type_embeddings.weight[0][None, None]
    x = L.layer_norm(params.embed_ln, x, cfg.ln_eps)

    mask = None
    if self_attn_mask is not None:
        mask = torch.as_tensor(self_attn_mask, device=dev).bool()
        if attention_mask is not None:
            mask = mask & torch.as_tensor(attention_mask, device=dev).bool()[:, None, :]
    elif attention_mask is not None:
        mask = torch.as_tensor(attention_mask, device=dev).bool()

    hd = cfg.hidden_size // cfg.num_heads
    for i in range(cfg.num_layers):
        p = getattr(params, f"layer_{i}")
        q = L.linear(p.q, x).reshape(b, s, cfg.num_heads, hd)
        k = L.linear(p.k, x).reshape(b, s, cfg.num_heads, hd)
        v = L.linear(p.v, x).reshape(b, s, cfg.num_heads, hd)
        o = dot_product_attention(q, k, v, mask=mask, impl="xla").reshape(b, s, -1)
        x = L.layer_norm(p.attn_ln, x + L.linear(p.o, o), cfg.ln_eps)
        h = L.linear(p.fc2, L.gelu(L.linear(p.fc1, x)))
        x = L.layer_norm(p.out_ln, x + h, cfg.ln_eps)
    return x


# ------------------------------------------------------------ checkpoints


def hf_keymap() -> KeyMap:
    """HF `BertModel` keys ↔ `Bert` (the JAX `convert_from_hf` rules)."""
    lay = "encoder.layer.{i}"
    rules = [Rule(f"embeddings.{a}.weight", f"{a}.weight")
             for a in ("word_embeddings", "position_embeddings", "token_type_embeddings")]
    rules += [Rule(f"embeddings.LayerNorm.{leaf}", f"embed_ln.{leaf}") for leaf in ("weight", "bias")]
    for ref, port in (("attention.self.query", "q"), ("attention.self.key", "k"),
                      ("attention.self.value", "v"), ("attention.output.dense", "o"),
                      ("attention.output.LayerNorm", "attn_ln"), ("intermediate.dense", "fc1"),
                      ("output.dense", "fc2"), ("output.LayerNorm", "out_ln")):
        for leaf in ("weight", "bias"):
            rules.append(Rule(f"{lay}.{ref}.{leaf}", "layer_{i}." + f"{port}.{leaf}"))
    ignore = [(r"pooler\..*", "the pooled output, which grounding does not read"),
              (r"embeddings\.(position_ids|token_type_ids)", "index buffers")]
    return KeyMap(rules, ignore)
