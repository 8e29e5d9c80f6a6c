"""KV-cached sampling loop with per-step hidden-state capture,
counterpart of the JAX package's `llm/generate.py`.

One prefill, then a Python decode loop, one token per `llama.forward`
call; `hiddens[:, i]` is the post-final-norm state that sampled
`tokens[:, i]`. EOS stops a row. Without `dynamic_stop` the loop runs all
`max_new_tokens` steps with a done flag (rows past their stop emit EOS);
with it the loop ends once every row has stopped, at the cost of one host
sync per token. (The JAX function's keyword stops and per-row pads serve
its batched server, which is not ported yet.)

Sampling: temperature 0 is argmax; otherwise Gumbel-max over
logits / temperature, with the Gumbel noise drawn from `generator` or
taken from `gumbel` (B, max_new_tokens, V), which lets a test feed the
draws of `jax.random.categorical`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models import llama


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (B, T) sampled ids (EOS after a row stops)
    hiddens: torch.Tensor  # (B, T, D) hidden that predicted tokens[:, i]
    done_at: torch.Tensor  # (B,) index of the first stop token (T if none)


@torch.inference_mode()
def generate(
    params: llama.Llama,
    cfg: llama.LlamaConfig,
    inputs_embeds: torch.Tensor,  # (B, S, D), already multimodal-spliced
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 100,
    temperature: float = 0.3,
    eos_id: int = 2,
    bucket: Optional[int] = None,
    dynamic_stop: bool = False,
    gumbel: Optional[torch.Tensor] = None,
) -> GenerateResult:
    b, s, d = inputs_embeds.shape
    dev = inputs_embeds.device
    # left-pad the prompt to a multiple of `bucket` (the JAX package bounds
    # its compiled graphs this way); pad slots are masked and not numbered
    prefix_pad = None
    if bucket is not None:
        pp = -(-s // bucket) * bucket - s
        if pp:
            inputs_embeds = torch.nn.functional.pad(inputs_embeds, (0, 0, pp, 0))
            s += pp
            prefix_pad = pp
    cache = llama.KVCache.create(cfg, b, max_len=s + max_new_tokens, dtype=inputs_embeds.dtype,
                                 device=dev)
    out = llama.forward(params, cfg, inputs_embeds=inputs_embeds, cache=cache, prefix_pad=prefix_pad)
    cache = out["cache"]

    def sample(logits, i):
        if temperature == 0.0:
            return logits.argmax(dim=-1)
        lg = logits.float() / temperature
        if gumbel is not None:
            g = gumbel[:, i].to(device=dev, dtype=torch.float32)
        else:
            u = torch.rand(lg.shape, generator=generator, device=dev).clamp_(min=1e-20)
            g = -torch.log(-torch.log(u))
        return (lg + g).argmax(dim=-1)

    tokens = torch.full((b, max_new_tokens), eos_id, dtype=torch.long, device=dev)
    hiddens = torch.zeros((b, max_new_tokens, d), dtype=out["hidden_norm"].dtype, device=dev)
    stopped = torch.zeros((b, max_new_tokens), dtype=torch.bool, device=dev)

    tok = sample(out["logits"][:, -1], 0)
    hiddens[:, 0] = out["hidden_norm"][:, -1]
    tokens[:, 0] = tok
    done = tok == eos_id
    stopped[:, 0] = done
    for i in range(1, max_new_tokens):
        if dynamic_stop and bool(done.all()):
            break
        emb = llama.embed(params, tok[:, None])
        out = llama.forward(params, cfg, inputs_embeds=emb, cache=cache, prefix_pad=prefix_pad)
        cache = out["cache"]
        nxt = torch.where(done, torch.full_like(tok, eos_id), sample(out["logits"][:, -1], i))
        stop = nxt == eos_id
        tokens[:, i] = nxt
        hiddens[:, i] = out["hidden_norm"][:, -1]
        stopped[:, i] = stop & ~done
        done = done | stop
        tok = nxt
    any_stop = stopped.any(dim=1)
    done_at = torch.where(any_stop, stopped.int().argmax(dim=1),
                          torch.full((b,), max_new_tokens, device=dev))
    return GenerateResult(tokens, hiddens, done_at)
