"""KV-cached sampling loop with per-step hidden-state capture,
counterpart of the JAX package's `llm/generate.py`.

One prefill, then a Python decode loop, one token per `llama.forward`
call; `hiddens[:, i]` is the post-final-norm state that sampled
`tokens[:, i]`. EOS stops a row, and so does any of `stop_sequences`
(token-id suffixes, `keyword_stop_sequences`) matched on a rolling window
of the last K ids: `done_at` is the index of EOS or of the keyword's last
token, so the keyword survives into the decoded text, as the reference's
`KeywordsStoppingCriteria` (llm/mm_utils.py:77-107) stops after it. Without
`dynamic_stop` the loop runs all `max_new_tokens` steps with a done flag
(rows past their stop emit EOS); with it the loop ends once every row has
stopped, at the cost of one host sync per token.

Prompts: `bucket` left-pads the batch to a multiple of it; `prefix_pads`
(B,) says how far the caller already left-padded each row (the batched
server pads prompts of different lengths to one length). Pad slots are
masked out of attention and not numbered.

Sampling: temperature 0 is argmax; otherwise Gumbel-max over
logits / temperature, with the Gumbel noise drawn from `generator` (one
for the batch, or a list of one per row: row i's draws then depend only on
generator i, whatever else is in the batch) or taken from `gumbel`
(B, max_new_tokens, V), which lets a test feed the draws of
`jax.random.categorical`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..models import llama
from ..parallel import sharding as tp


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (B, T) sampled ids (EOS after a row stops)
    hiddens: torch.Tensor  # (B, T, D) hidden that predicted tokens[:, i]
    done_at: torch.Tensor  # (B,) index of the first stop token (T if none)


def keyword_stop_sequences(tokenizer, keywords: Sequence[str]) -> Tuple[Tuple[int, ...], ...]:
    """Keyword strings → token-id suffixes for `generate(stop_sequences=)`:
    each keyword encoded, a leading BOS dropped (reference mm_utils.py:84-92)."""
    out = []
    for kw in keywords:
        ids = list(tokenizer.encode(kw) if hasattr(tokenizer, "encode") else tokenizer(kw).input_ids)
        bos = getattr(tokenizer, "bos_token_id", None)
        if len(ids) > 1 and bos is not None and ids[0] == bos:
            ids = ids[1:]
        if ids:
            out.append(tuple(int(i) for i in ids))
    return tuple(out)


@torch.inference_mode()
def generate(
    params: llama.Llama,
    cfg: llama.LlamaConfig,
    inputs_embeds: torch.Tensor,  # (B, S, D), already multimodal-spliced
    generator: Union[None, torch.Generator, List[torch.Generator]] = None,
    max_new_tokens: int = 100,
    temperature: float = 0.3,
    eos_id: int = 2,
    bucket: Optional[int] = None,
    dynamic_stop: bool = False,
    gumbel: Optional[torch.Tensor] = None,
    prefix_pads=None,
    stop_sequences: Tuple[Tuple[int, ...], ...] = (),
) -> GenerateResult:
    b, s, d = inputs_embeds.shape
    dev = inputs_embeds.device
    prefix_pad = None
    if prefix_pads is not None:
        prefix_pad = torch.as_tensor(prefix_pads, device=dev).reshape(b)
    elif bucket is not None:
        # left-pad the prompt to a multiple of `bucket` (the JAX package
        # bounds its compiled graphs this way)
        pp = -(-s // bucket) * bucket - s
        if pp:
            inputs_embeds = torch.nn.functional.pad(inputs_embeds, (0, 0, pp, 0))
            s += pp
            prefix_pad = pp
    cache = llama.KVCache.create(cfg, b, max_len=s + max_new_tokens, dtype=inputs_embeds.dtype,
                                 device=dev, kv_heads=llama.local_kv_heads(params, cfg))
    out = llama.forward(params, cfg, inputs_embeds=inputs_embeds, cache=cache, prefix_pad=prefix_pad)
    cache = out["cache"]
    per_row = isinstance(generator, (list, tuple))
    if per_row and len(generator) != b:
        raise ValueError(f"{len(generator)} generators for a batch of {b}")

    def sample(logits, i):
        if temperature == 0.0:
            return tp.model_broadcast(logits.argmax(dim=-1))
        lg = logits.float() / temperature
        if gumbel is not None:
            g = gumbel[:, i].to(device=dev, dtype=torch.float32)
        else:
            if per_row:
                u = torch.stack([torch.rand(lg.shape[1:], generator=gen, device=dev)
                                 for gen in generator])
            else:
                u = torch.rand(lg.shape, generator=generator, device=dev)
            g = -torch.log(-torch.log(u.clamp_(min=1e-20)))
        # under tensor parallelism every model rank must feed the same token
        # back: model-rank 0's, not a trust in bitwise-equal logits
        return tp.model_broadcast((lg + g).argmax(dim=-1))

    # rolling window of the last K emitted ids for keyword matching
    k_win = max((len(sq) for sq in stop_sequences), default=0)
    stop_ids = [torch.tensor(sq, device=dev) for sq in stop_sequences]
    recent = torch.full((b, max(k_win, 1)), -1, dtype=torch.long, device=dev)

    def match_stop(tok):
        """True where `tok` is EOS or completes a keyword."""
        nonlocal recent
        m = tok == eos_id
        if k_win:
            recent = torch.cat([recent[:, 1:], tok[:, None]], dim=1)
            for sq in stop_ids:
                m = m | (recent[:, k_win - len(sq):] == sq).all(dim=1)
        return m

    tokens = torch.full((b, max_new_tokens), eos_id, dtype=torch.long, device=dev)
    hiddens = torch.zeros((b, max_new_tokens, d), dtype=out["hidden_norm"].dtype, device=dev)
    stopped = torch.zeros((b, max_new_tokens), dtype=torch.bool, device=dev)

    tok = sample(out["logits"][:, -1], 0)
    hiddens[:, 0] = out["hidden_norm"][:, -1]
    tokens[:, 0] = tok
    done = match_stop(tok)
    stopped[:, 0] = done
    for i in range(1, max_new_tokens):
        if dynamic_stop and bool(done.all()):
            break
        emb = llama.embed(params, tok[:, None])
        out = llama.forward(params, cfg, inputs_embeds=emb, cache=cache, prefix_pad=prefix_pad)
        cache = out["cache"]
        nxt = torch.where(done, torch.full_like(tok, eos_id), sample(out["logits"][:, -1], i))
        stop = match_stop(nxt)
        tokens[:, i] = nxt
        hiddens[:, i] = out["hidden_norm"][:, -1]
        stopped[:, i] = stop & ~done
        done = done | stop
        tok = nxt
    any_stop = stopped.any(dim=1)
    done_at = torch.where(any_stop, stopped.int().argmax(dim=1),
                          torch.full((b,), max_new_tokens, device=dev))
    return GenerateResult(tokens, hiddens, done_at)
