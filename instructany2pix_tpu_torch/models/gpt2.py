"""GPT-2 core, the backbone of the diffusion prior; counterpart of the JAX
package's `models/gpt2.py`. Pre-LN blocks, learned positions, gelu_new
MLP, causal attention with an optional key-padding mask (plain path, as
the JAX package forces `impl="xla"`). The prior feeds `inputs_embeds`
only, so there is no token table."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..core.checkpoint import KeyMap, Rule, transpose
from . import layers as L


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    hidden_size: int = 1024  # gpt2-medium
    num_layers: int = 24
    num_heads: int = 16
    max_positions: int = 1024
    ln_eps: float = 1e-5

    @staticmethod
    def medium() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def tiny() -> "GPT2Config":
        return GPT2Config(hidden_size=32, num_layers=2, num_heads=4, max_positions=64)


class GPT2Layer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d)
        self.attn_qkv = nn.Linear(d, 3 * d)
        self.attn_out = nn.Linear(d, d)
        self.ln2 = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)


class GPT2(nn.Module):
    def __init__(self, cfg: GPT2Config = GPT2Config.tiny()):
        super().__init__()
        d = cfg.hidden_size
        self.wpe = nn.Embedding(cfg.max_positions, d)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", GPT2Layer(d))
        self.ln_f = nn.LayerNorm(d)


def forward(
    params: GPT2,
    cfg: GPT2Config,
    inputs_embeds: torch.Tensor,  # (B, S, D)
    attention_mask: Optional[torch.Tensor] = None,  # (B, S)
) -> torch.Tensor:
    b, s, d = inputs_embeds.shape
    dev = inputs_embeds.device
    pos = torch.arange(s, device=dev)
    x = inputs_embeds + L.embedding(params.wpe, pos)[None].to(inputs_embeds.dtype)
    mask = attention_mask.bool() if attention_mask is not None else None
    hd = d // cfg.num_heads
    for i in range(cfg.num_layers):
        p = getattr(params, f"layer_{i}")
        h = L.layer_norm(p.ln1, x, cfg.ln_eps)
        q, k, v = L.linear(p.attn_qkv, h).chunk(3, dim=-1)
        o = dot_product_attention(
            q.reshape(b, s, cfg.num_heads, hd), k.reshape(b, s, cfg.num_heads, hd),
            v.reshape(b, s, cfg.num_heads, hd), mask=mask, causal=True, impl="xla",
        )
        x = x + L.linear(p.attn_out, o.reshape(b, s, d))
        h = L.layer_norm(p.ln2, x, cfg.ln_eps)
        x = x + L.linear(p.fc2, F.gelu(L.linear(p.fc1, h), approximate="tanh"))
    return L.layer_norm(params.ln_f, x, cfg.ln_eps)


# ------------------------------------------------------------ checkpoints


def hf_keymap() -> KeyMap:
    """HF `GPT2Model` keys ↔ `GPT2`'s parameters. HF's Conv1D stores
    (in, out), so its weights are transposed into `nn.Linear`'s (out, in)."""
    h = "h.{i}"
    rules = [Rule("wpe.weight", "wpe.weight"), Rule("ln_f.weight", "ln_f.weight"),
             Rule("ln_f.bias", "ln_f.bias")]
    for ref, port, tr in (("ln_1", "ln1", None), ("attn.c_attn", "attn_qkv", transpose),
                          ("attn.c_proj", "attn_out", transpose), ("ln_2", "ln2", None),
                          ("mlp.c_fc", "fc1", transpose), ("mlp.c_proj", "fc2", transpose)):
        rules.append(Rule(f"{h}.{ref}.weight", "layer_{i}." + port + ".weight", tr, tr))
        rules.append(Rule(f"{h}.{ref}.bias", "layer_{i}." + port + ".bias"))
    ignore = [
        (r"wte\.weight", "token embeddings: the prior feeds inputs_embeds only"),
        (r"h\.\d+\.attn\.(bias|masked_bias)", "causal-mask buffers"),
    ]
    return KeyMap(rules, ignore)
