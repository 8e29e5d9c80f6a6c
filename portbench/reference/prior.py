"""The InstructAny2Pix diffusion prior: GPT-2 over multimodal token
sequences, refining the LLM's predicted embedding in ImageBind space.

The edit runs `generate_diffusion` by its no-diffusion path: one
single-step x0-space CFG, x0_u + g·(x0_c − x0_u), over the assembled
prompt [src_type, SOS|imagebind|EOS, SOS|text|EOS, SOS|score|EOS] (the
reference project's key-list quirk keeps the noise level and target type
out of it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .checkpoint import KeyMap, Rule
from . import gpt2
from . import layers as L


class MODALITY:
    IMAGE = 0
    AUDIO = 1
    TEXT = 2
    VIDEO = 3


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    embed_dim: int = 1024
    output_dim: int = 1024
    sequence_gen_length: int = 1
    imagebind_dim: int = 1024
    text_dim: int = 1024  # CLIP-ViT-H hidden size
    score_dim: int = 512
    text_len: int = 77
    gpt2: gpt2.GPT2Config = gpt2.GPT2Config()
    # (key, input_dim) in sequence order; dim 0 → no projection
    sequence_input_key: Tuple[Tuple[str, int], ...] = (
        ("src_type", 0),
        ("imagebind", 1024),
        ("crossattn_clip", 1024),
        ("score", 512),
        ("noisy_inputs", 0),
    )

class Prior(nn.Module):
    """`output_proj` exists when `output_dim` differs from `embed_dim`, or
    as `output_proj` says (a checkpoint that carries one)."""

    def __init__(self, cfg: PriorConfig = PriorConfig(), output_proj: Optional[bool] = None):
        super().__init__()
        d = cfg.embed_dim
        self.sos = nn.Embedding(32, d)
        self.eos = nn.Embedding(32, d)
        self.modality_embedding = nn.Embedding(10, d)
        self.gpt2 = gpt2.GPT2(cfg.gpt2)
        for name, dim in cfg.sequence_input_key:
            if dim > 0:
                self.add_module(f"proj_{name}", nn.Linear(dim, d))
        if cfg.output_dim != cfg.embed_dim if output_proj is None else output_proj:
            self.output_proj = nn.Linear(d, cfg.output_dim)


def _with_sos_eos(params: Prior, kid: int, seq: torch.Tensor, mask: torch.Tensor):
    b, _, d = seq.shape
    sos = params.sos.weight[kid].to(seq.dtype).expand(b, 1, d)
    eos = params.eos.weight[kid].to(seq.dtype).expand(b, 1, d)
    one = torch.ones((b, 1), dtype=mask.dtype, device=mask.device)
    return torch.cat([sos, seq, eos], dim=1), torch.cat([one, mask, one], dim=1)


def assemble_sequence(params: Prior, cfg: PriorConfig, cond: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(input_embeds, attn_mask) in `sequence_input_key` order; keys absent
    from `cond` are skipped. cond: src_type (B,) or (B, 1) ids; imagebind
    (B, 1, D); crossattn_clip a (hidden (B, T, text_dim), mask (B, T))
    pair; score (B, 1, score_dim); noisy_inputs (B, L, embed_dim)."""
    embeds, masks = [], []
    dev = params.sos.weight.device
    for kid, (name, dim) in enumerate(cfg.sequence_input_key):
        if name not in cond:
            continue
        val = cond[name]
        if name in ("src_type", "tgt_type"):
            ids = val.reshape(val.shape[0], -1).to(dev)
            embeds.append(L.embedding(params.modality_embedding, ids))
            masks.append(torch.ones(ids.shape, dtype=torch.float32, device=dev))
            continue
        if isinstance(val, (tuple, list)):
            seq, m = val
        else:
            seq = val
            m = torch.ones(seq.shape[:2], dtype=torch.float32, device=dev)
        seq, m = seq.to(dev), m.to(dev)
        if dim > 0:
            seq = L.linear(getattr(params, f"proj_{name}"), seq)
        seq, m = _with_sos_eos(params, kid, seq, m)
        embeds.append(seq)
        masks.append(m)
    dt = params.sos.weight.dtype
    emb = torch.cat([e.to(dt) for e in embeds], dim=1)
    mask = torch.cat(masks, dim=1)
    max_len = cfg.gpt2.max_positions - cfg.sequence_gen_length
    return emb[:, :max_len], mask[:, :max_len]


def _ar_decode(params: Prior, cfg: PriorConfig, emb, mask, steps: int) -> torch.Tensor:
    """GPT-2 decode of `steps` continuous tokens: a full re-forward per
    token, appending the last hidden state."""
    outs = []
    for _ in range(steps):
        h = gpt2.forward(params.gpt2, cfg.gpt2, emb, attention_mask=mask)
        nxt = h[:, -1:]
        outs.append(nxt)
        emb = torch.cat([emb, nxt], dim=1)
        mask = torch.cat([mask, torch.ones((mask.shape[0], 1), dtype=mask.dtype, device=mask.device)],
                         dim=1)
    return torch.cat(outs, dim=1)


def _project_out(params: Prior, x: torch.Tensor) -> torch.Tensor:
    return L.linear(params.output_proj, x) if hasattr(params, "output_proj") else x


def score_embedding(score: float, dim: int = 512, device="cpu") -> torch.Tensor:
    """Aesthetic-score conditioning as a sinusoidal embedding (1, 1, dim)."""
    t = torch.tensor([score], dtype=torch.float32, device=device)
    return L.timestep_embedding(t, dim, flip_sin_to_cos=True, downscale_freq_shift=0.0).reshape(1, 1, dim)


@torch.inference_mode()
def generate_diffusion(
    params: Prior,
    cfg: PriorConfig,
    src_type: int,
    tgt_type: int,
    src: torch.Tensor,  # (B, imagebind_dim)
    text_hidden: torch.Tensor,  # (B, T, text_dim): CLIP hidden of the "" prompt
    text_mask: torch.Tensor,  # (B, T)
    guidance_scale: float = 5.0,
    score: float = 6.8,
    negative_score: float = 2.0,
) -> torch.Tensor:
    """The refined embedding (B, sequence_gen_length, output_dim) by the
    no-diffusion path the edit takes: one step at t = 0, where the noisy
    seed cancels, leaving CFG in x0 space."""
    dev = params.sos.weight.device
    src = src.to(dev)
    b = src.shape[0]
    score_emb = score_embedding(score, cfg.score_dim, dev).repeat(b, 1, 1)
    neg_score_emb = score_embedding(negative_score, cfg.score_dim, dev).repeat(b, 1, 1)

    # CFG layout: cond half first, uncond half second
    def dup(c, u):
        return torch.cat([c, u], dim=0)

    imagebind = src.reshape(b, 1, -1)
    st = torch.full((b, 1), src_type, dtype=torch.long, device=dev)
    cond = {
        "src_type": dup(st, st),
        "imagebind": dup(imagebind, torch.zeros_like(imagebind)),
        "crossattn_clip": (dup(text_hidden, text_hidden), dup(text_mask, text_mask)),
        "score": dup(score_emb, neg_score_emb),
    }
    emb, mask = assemble_sequence(params, cfg, cond)
    out = _ar_decode(params, cfg, emb, mask, cfg.sequence_gen_length)
    x0_c, x0_u = out.chunk(2, dim=0)
    return _project_out(params, x0_u + guidance_scale * (x0_c - x0_u))


SEQUENCE_KEY_ORDER = ("src_type", "imagebind", "crossattn_clip", "score", "noisy_inputs")


def keymap() -> KeyMap:
    """`prior/model.bin` ↔ `Prior`: GPT-2 under `model.`, the start, end and
    modality tables, one input projection per sequence key in
    `SEQUENCE_KEY_ORDER`, and the output projection."""
    rules = [Rule("start_of_sequence_tokens.weight", "sos.weight"),
             Rule("end_of_sequence_tokens.weight", "eos.weight"),
             Rule("modality_embedding.weight", "modality_embedding.weight"),
             Rule("output_proj.weight", "output_proj.weight"),
             Rule("output_proj.bias", "output_proj.bias")]
    for i, name in enumerate(SEQUENCE_KEY_ORDER):
        for leaf in ("weight", "bias"):
            rules.append(Rule(f"input_sequence_embed_linear.{i}.{leaf}", f"proj_{name}.{leaf}"))
    return gpt2.hf_keymap().prefixed(ref="model.", port="gpt2.") + KeyMap(rules)
