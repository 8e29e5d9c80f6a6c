"""Llama-class decoder (the Vicuna-7B backbone) with a KV cache,
counterpart of the JAX package's `models/llama.py`.

`Llama` holds the weights under the JAX tree's names. Its linears are
`nn.Linear` (float) or `QLinear` (weight-only int8/int4, `ops/quant.py`),
and `fuse_projections` joins q|k|v into `qkv` and gate|up into `gate_up`;
`forward` dispatches on what each layer holds, so float,
quantized, fused and unfused models share one code path. With quantized
fused weights every decode step runs four K2 launches per layer, with the
RMSNorms, the SwiGLU and both residuals fused into them.

The KV cache is preallocated for the whole generation and updated in place:
`forward` writes this call's keys and values into `cache.k`/`cache.v` at
`cache.length` and returns a `KVCache` over the same storage with the
length advanced. Attention against the cache is masked against the padded
buffer (`_decode_mask`) and takes the plain path, as the JAX package forces
`impl="xla"` there.

Training (`forward` without a cache, with the collator's right-padding
`attention_mask`): the 2-D mask is turned into per-row key counts
(`kv_len`) once per forward, after one host check that every row is a
prefix of ones, and each layer's causal attention goes to the
differentiable flash path (K1 forward, K4 backward on the card). Any
other mask keeps the plain masked path. With `cfg.remat` each decoder layer
is checkpointed (`torch.utils.checkpoint`, non-reentrant): `remat_policy`
"full" recomputes the whole layer in the backward, "dots" saves the outputs
of the linear projections' matrix products (`aten.mm`/`aten.addmm`, the
dots without batch dimensions) and recomputes attention and the
elementwise work, the counterpart of JAX's
`dots_with_no_batch_dims_saveable`. The JAX package's `stack_layers` and
`lax.scan` over layers shrink its compiled program; eager PyTorch compiles
nothing, so they have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt_lib

from ..ops import quant as Q
from ..ops.attention import dot_product_attention
from ..core.checkpoint import KeyMap, Rule
from . import layers as L


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32009  # 32000 + 9 special generation tokens
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6  # Vicuna-7B (Llama-1) ships 1e-6
    remat: bool = False  # checkpoint each decoder layer in the no-cache forward
    remat_policy: str = "full"  # "full" recomputes everything; "dots" saves matmul outputs

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def vicuna_7b(vocab_size: int = 32009) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size)

    @staticmethod
    def tiny(vocab_size: int = 128) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=4,
            max_seq_len=128,
        )


@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor  # (layers, B, max_len, kv_heads, head_dim), written in place
    v: torch.Tensor
    length: int  # tokens currently cached

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
               dtype=torch.bfloat16, device="cpu") -> "KVCache":
        max_len = max_len or cfg.max_seq_len
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device), 0)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self.input_norm = L.RMSNorm(d)
        self.q = nn.Linear(d, cfg.num_heads * hd, bias=False)
        self.k = nn.Linear(d, cfg.num_kv_heads * hd, bias=False)
        self.v = nn.Linear(d, cfg.num_kv_heads * hd, bias=False)
        self.o = nn.Linear(cfg.num_heads * hd, d, bias=False)
        self.post_norm = L.RMSNorm(d)
        self.gate = nn.Linear(d, cfg.intermediate_size, bias=False)
        self.up = nn.Linear(d, cfg.intermediate_size, bias=False)
        self.down = nn.Linear(cfg.intermediate_size, d, bias=False)


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig = LlamaConfig.tiny()):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", LlamaLayer(cfg))
        self.final_norm = L.RMSNorm(cfg.hidden_size)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)


def _rope_tables(positions: torch.Tensor, half: int, theta: float):
    """cos/sin tables (B, S, 1, half), built once per forward."""
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=positions.device) / half))
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def embed(params: Llama, input_ids: torch.Tensor) -> torch.Tensor:
    return L.embedding(params.embed_tokens, input_ids.to(params.embed_tokens.weight.device))


def _cat_linears(parts) -> nn.Module:
    """Join linears of one format along the output axis."""
    if isinstance(parts[0], nn.Linear):
        w = torch.cat([p.weight for p in parts], dim=0)
        out = nn.Linear(w.shape[1], w.shape[0], bias=False, device=w.device, dtype=w.dtype)
        out.weight.data = w
        return out.requires_grad_(False)
    qs = [p.q for p in parts]
    key = "w_q4" if "w_q4" in qs[0] else "w_q"
    out = {key: torch.cat([q[key] for q in qs], dim=1)}
    if "scale" in qs[0]:
        out["scale"] = torch.cat([q["scale"] for q in qs])
    if "gscale" in qs[0]:
        out["gscale"] = torch.cat([q["gscale"] for q in qs], dim=1)
    return Q.QLinear(out)


def _fusable(parts) -> bool:
    # one format for all, and no biases (they would be dropped)
    def fmt(p):
        if isinstance(p, nn.Linear):
            return None if p.bias is not None else "w"
        q = p.q
        if "b" in q:
            return None
        return "int8" if "w_q" in q else ("int4g" if "gscale" in q else "int4")

    fmts = [fmt(p) for p in parts]
    return None not in fmts and len(set(fmts)) == 1


@torch.no_grad()
def fuse_projections(params: Llama) -> Llama:
    """In place: q|k|v → `qkv` and gate|up → `gate_up` in every layer whose
    parts share one format, so decode runs four matvecs per layer instead of
    seven. Scales join with their columns. Preserves the forward."""
    for i in range(params.cfg.num_layers):
        lay = getattr(params, f"layer_{i}")
        if all(hasattr(lay, n) for n in ("q", "k", "v")):
            parts = [lay.q, lay.k, lay.v]
            if _fusable(parts):
                lay.qkv = _cat_linears(parts)
                del lay.q, lay.k, lay.v
        if hasattr(lay, "gate") and hasattr(lay, "up"):
            parts = [lay.gate, lay.up]
            if _fusable(parts):
                lay.gate_up = _cat_linears(parts)
                del lay.gate, lay.up
    return params


def _decode_mask(b: int, s: int, max_len: int, cache_len: int, prefix_pad=None, device="cpu"):
    """Absolute-position causal mask against the padded KV buffer: query
    row i (position cache_len + i) sees keys 0..cache_len + i; with a
    left-padded prompt the pad slots [0, prefix_pad) are never seen.
    `prefix_pad` is an int or a (B,) tensor."""
    row = cache_len + torch.arange(s, device=device)[:, None]
    col = torch.arange(max_len, device=device)[None, :]
    valid = (col <= row)[None].expand(b, s, max_len)
    if prefix_pad is not None:
        pp = torch.as_tensor(prefix_pad, device=device).reshape(-1, 1, 1)
        valid = valid & (col[None] >= pp)
    return valid


def prefix_lengths(mask: torch.Tensor) -> Optional[torch.Tensor]:
    """int32 (B,) key counts when every row of a 2-D mask is a prefix of
    ones of length >= 1 (right padding, as the training collator builds
    it), else None. One host synchronization."""
    if mask.dim() != 2:
        return None
    m = mask.bool()
    n = m.sum(1)
    prefix = torch.arange(m.shape[1], device=m.device)[None, :] < n[:, None]
    if not bool(((m == prefix).all() & (n >= 1).all()).item()):
        return None
    return n.to(torch.int32)


def _dots_policy(ctx, op, *args, **kwargs):
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    return (ckpt_lib.CheckpointPolicy.MUST_SAVE if op in saved
            else ckpt_lib.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """`fn` under activation checkpointing with the JAX package's policies."""
    if policy == "full":
        return functools.partial(ckpt_lib.checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        context = functools.partial(ckpt_lib.create_selective_checkpoint_contexts, _dots_policy)
        return functools.partial(ckpt_lib.checkpoint, fn, use_reentrant=False, context_fn=context)
    raise ValueError(f"remat_policy={policy!r}: 'full' or 'dots'")


def _block(p: LlamaLayer, x, cfg: LlamaConfig, mask, rope_cs, cache_kv=None, cache_len=0,
           kv_len=None):
    """One decoder layer; with `cache_kv` this call's keys and values are
    written into it in place. `kv_len` stands for a right-padding mask."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    in_norm = (p.input_norm.g, cfg.rms_eps)
    if hasattr(p, "qkv"):
        qkv = L.linear(p.qkv, x, norm=in_norm)
        nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        q = qkv[..., :nq].reshape(b, s, cfg.num_heads, hd)
        k = qkv[..., nq:nq + nkv].reshape(b, s, cfg.num_kv_heads, hd)
        v = qkv[..., nq + nkv:].reshape(b, s, cfg.num_kv_heads, hd)
    else:
        h = L.rms_norm(p.input_norm.g, x, cfg.rms_eps)
        q = L.linear(p.q, h).reshape(b, s, cfg.num_heads, hd)
        k = L.linear(p.k, h).reshape(b, s, cfg.num_kv_heads, hd)
        v = L.linear(p.v, h).reshape(b, s, cfg.num_kv_heads, hd)
    q = _rope_apply(q, *rope_cs)
    k = _rope_apply(k, *rope_cs)
    if cache_kv is not None:
        ck, cv = cache_kv
        ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
        o = dot_product_attention(q, ck.to(q.dtype), cv.to(q.dtype), mask=mask, impl="xla")
    else:
        o = dot_product_attention(q, k, v, mask=mask, causal=True, kv_len=kv_len)
    x = L.linear(p.o, o.reshape(b, s, cfg.num_heads * hd), residual=x)
    post_norm = (p.post_norm.g, cfg.rms_eps)
    if hasattr(p, "gate_up"):
        gu = L.linear(p.gate_up, x, norm=post_norm)
        return L.linear(p.down, gu, swiglu=True, residual=x)
    h = L.rms_norm(p.post_norm.g, x, cfg.rms_eps)
    return x + L.linear(p.down, L.silu(L.linear(p.gate, h)) * L.linear(p.up, h))


def forward(
    params: Llama,
    cfg: LlamaConfig,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    prefix_pad=None,
):
    """Full forward, or with `cache` an incremental one that appends this
    chunk at `cache.length` (prefill or one decode step).

    Returns a dict: `logits` (B, S, V), `hidden` (the raw residual stream)
    and `hidden_norm` (after the final norm, HF's last hidden state), plus
    `cache` when one was given."""
    if (input_ids is None) == (inputs_embeds is None):
        raise ValueError("pass exactly one of input_ids and inputs_embeds")
    x = inputs_embeds if inputs_embeds is not None else embed(params, input_ids)
    dev = x.device
    b, s, _ = x.shape
    if positions is None:
        start = cache.length if cache is not None else 0
        positions = torch.arange(s, device=dev)[None, :] + start
        if prefix_pad is not None:
            # left-padded prompt: content starts at prefix_pad, pad slots
            # clamp to position 0 (they are masked out of attention)
            pp = torch.as_tensor(prefix_pad, device=dev).reshape(-1, 1)
            positions = torch.clamp(positions - pp, min=0)
        positions = positions.expand(b, s)
    rope_cs = _rope_tables(positions, cfg.head_dim // 2, cfg.rope_theta)
    mask, kv_len = attention_mask, None
    if cache is not None:
        mask = _decode_mask(b, s, cache.k.shape[2], cache.length, prefix_pad, dev)
    elif mask is not None:
        kv_len = prefix_lengths(mask.to(dev))
        if kv_len is not None:
            mask = None
    for i in range(cfg.num_layers):
        layer = getattr(params, f"layer_{i}")
        if cache is not None:
            x = _block(layer, x, cfg, mask, rope_cs, (cache.k[i], cache.v[i]), cache.length)
        elif cfg.remat and torch.is_grad_enabled():
            x = _remat(functools.partial(_block, layer, cfg=cfg, mask=mask, rope_cs=rope_cs,
                                         kv_len=kv_len), cfg.remat_policy)(x)
        else:
            x = _block(layer, x, cfg, mask, rope_cs, kv_len=kv_len)
    hidden_norm = L.rms_norm(params.final_norm.g, x, cfg.rms_eps)
    logits = L.linear(params.lm_head, hidden_norm)
    out = {"logits": logits, "hidden": x, "hidden_norm": hidden_norm}
    if cache is not None:
        out["cache"] = KVCache(cache.k, cache.v, cache.length + s)
    return out


# ------------------------------------------------------------ checkpoints


def hf_keymap() -> KeyMap:
    """HF Llama's state-dict keys ↔ `Llama`'s parameters (the rules of the
    JAX `convert_from_hf`). HF keeps q and k in its `rotate_half` layout,
    the one `_rope_apply` takes, so no row is permuted."""
    lay = "model.layers.{i}"
    rules = [
        Rule("model.embed_tokens.weight", "embed_tokens.weight"),
        Rule(f"{lay}.input_layernorm.weight", "layer_{i}.input_norm.g"),
        Rule(f"{lay}.self_attn.q_proj.weight", "layer_{i}.q.weight"),
        Rule(f"{lay}.self_attn.k_proj.weight", "layer_{i}.k.weight"),
        Rule(f"{lay}.self_attn.v_proj.weight", "layer_{i}.v.weight"),
        Rule(f"{lay}.self_attn.o_proj.weight", "layer_{i}.o.weight"),
        Rule(f"{lay}.post_attention_layernorm.weight", "layer_{i}.post_norm.g"),
        Rule(f"{lay}.mlp.gate_proj.weight", "layer_{i}.gate.weight"),
        Rule(f"{lay}.mlp.up_proj.weight", "layer_{i}.up.weight"),
        Rule(f"{lay}.mlp.down_proj.weight", "layer_{i}.down.weight"),
        Rule("model.norm.weight", "final_norm.g"),
        Rule("lm_head.weight", "lm_head.weight"),
    ]
    ignore = [
        (r"model\.rotary_emb\..*", "rotary frequencies, recomputed from rope_theta"),
        (r"model\.layers\.\d+\.self_attn\.rotary_emb\.inv_freq",
         "rotary frequencies, recomputed from rope_theta"),
    ]
    return KeyMap(rules, ignore)
