"""Exact self-speculative greedy decoding: an early-exit draft and a
batched verify, counterpart of the JAX package's `llm/speculative.py`.

The draft is the model's own first `draft_layers` layers, through the
shared final norm and `lm_head` (`llama.forward(..., layers=L)`). Each
round makes `k_draft - 1` draft steps, then one full forward over the
k-token window [tok, d_1 .. d_{k-1}]. The full model's greedy tokens
g_0 .. g_{k-1} at those positions are the candidates: the round accepts
the leading drafts with d_{i+1} == g_i and emits g_0 .. g_j, stopping at
the first EOS among them, so every emitted token is the full model's own
argmax and the output equals plain greedy `generate(temperature=0)` on
the same arithmetic. The draft shares the KV cache: it writes the slots of
layers < L past the cached length, which the verify then rewrites; the
draft carries its own length and leaves the verify's alone.

On the card the draft runs K2 at M = 1 through its L layers (4 launches a
layer a step) and the verify K2 at M = k_draft (4 launches a layer). The
accepted count decides the next round, so it is read back once per round.
Single-row only, as in the JAX package; the batched server keeps its plain
decode.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models import llama
from .generate import GenerateResult


@torch.inference_mode()
def generate_speculative(
    params: llama.Llama,
    cfg: llama.LlamaConfig,
    inputs_embeds: torch.Tensor,  # (1, S, D), already multimodal-spliced
    max_new_tokens: int = 100,
    eos_id: int = 2,
    draft_layers: int = 4,
    k_draft: int = 4,
    max_len: Optional[int] = None,
    rounds: Optional[List[int]] = None,
) -> GenerateResult:
    """Greedy decode in draft/verify rounds; exact against `generate(...,
    temperature=0.0)`. `rounds`, when a list, receives the number of
    tokens each round emitted."""
    b, s, d = inputs_embeds.shape
    if b != 1:
        raise ValueError(f"speculative decode is single-row, not a batch of {b}")
    L = draft_layers
    if not 0 < L < cfg.num_layers:
        raise ValueError(f"draft_layers={L} of a {cfg.num_layers}-layer model")
    if k_draft < 2:
        raise ValueError(f"k_draft={k_draft}: a round drafts at least one token")
    dev = inputs_embeds.device
    # slack: the last verify may write k_draft - 1 slots past the last token
    max_len = max_len or (s + max_new_tokens + k_draft)
    cache = llama.KVCache.create(cfg, b, max_len=max_len, dtype=inputs_embeds.dtype, device=dev)
    out = llama.forward(params, cfg, inputs_embeds=inputs_embeds, cache=cache)
    cache = out["cache"]
    tok = out["logits"][:, -1].argmax(dim=-1)

    buf = max_new_tokens + k_draft  # a round's writes may overhang; trimmed below
    tokens = torch.full((b, buf), eos_id, dtype=torch.long, device=dev)
    hiddens = torch.zeros((b, buf, d), dtype=out["hidden_norm"].dtype, device=dev)
    tokens[:, 0] = tok
    hiddens[:, 0] = out["hidden_norm"][:, -1]
    n_out = 1
    done = bool(tok[0] == eos_id)
    idx = torch.arange(k_draft, device=dev)
    while n_out < max_new_tokens and not done:
        # draft: k_draft - 1 early-exit steps over the first L layers' cache
        dcache = llama.KVCache(cache.k[:L], cache.v[:L], cache.length)
        window = [tok]
        dt = tok
        for _ in range(k_draft - 1):
            dout = llama.forward(params, cfg, inputs_embeds=llama.embed(params, dt[:, None]),
                                 cache=dcache, layers=L)
            dcache = dout["cache"]
            dt = dout["logits"][:, -1].argmax(dim=-1)
            window.append(dt)
        # verify: one full forward over [tok, d_1 .. d_{k-1}]
        w_ids = torch.stack(window, dim=1)  # (1, k)
        vout = llama.forward(params, cfg, inputs_embeds=llama.embed(params, w_ids), cache=cache)
        g = vout["logits"].argmax(dim=-1)  # (1, k): the full model's greedy tokens
        acc = (w_ids[:, 1:] == g[:, :-1]).int()
        j = acc.cumprod(dim=1).sum(dim=1)[0]  # accepted drafts, 0 .. k-1
        is_eos = (g[0] == eos_id) & (idx <= j)
        first_eos = torch.where(is_eos.any(), is_eos.int().argmax(), torch.full_like(j, k_draft))
        # one read-back a round: how many tokens it emits, and whether EOS stops it
        n_emit, stop = (int(v) for v in torch.stack([torch.minimum(j + 1, first_eos + 1),
                                                     is_eos.any().long()]).tolist())
        tokens[:, n_out:n_out + k_draft] = g
        hiddens[:, n_out:n_out + k_draft] = vout["hidden_norm"]
        # cached history: the old tokens, tok and the accepted drafts; the
        # correction g_{n_emit - 1} is fed next round. Stale slots past the
        # length are masked and rewritten.
        cache = llama.KVCache(cache.k, cache.v, cache.length + n_emit)
        tok = g[:, n_emit - 1]
        n_out += n_emit
        done = bool(stop)
        if rounds is not None:
            rounds.append(n_emit)
    tokens = tokens[:, :max_new_tokens]
    hiddens = hiddens[:, :max_new_tokens]
    # past n_out the buffer holds the last window's overhang: EOS, as in generate()
    col = torch.arange(max_new_tokens, device=dev)[None, :]
    tokens = torch.where(col < n_out, tokens, torch.full_like(tokens, eos_id))
    stopped = tokens == eos_id
    done_at = torch.where(stopped.any(dim=1), stopped.int().argmax(dim=1),
                          torch.full((b,), max_new_tokens, device=dev))
    return GenerateResult(tokens, hiddens, done_at)
