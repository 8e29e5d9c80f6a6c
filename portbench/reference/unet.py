"""UNet2DCondition — the SDXL denoiser (base with IP-Adapter K/V, and the
refiner).

`UNet` holds the weights under path names such as `down_1.attn_0.
block_0.attn2.to_k_ip`, which `unet_convert.unet_keymap` maps from the
published diffusers keys. `apply` takes an NHWC `sample`, optional
IP-Adapter tokens added with `ip_scale`, and `cross_kv` from
`precompute_cross_kv` in place of the per-step text/IP projections. Every
attention is the plain softmax of `attention.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .attention import dot_product_attention
from . import layers as L


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20)
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    addition_embed_type: Optional[str] = "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    num_time_ids: int = 6  # SDXL base; refiner uses 5 (incl. aesthetic score)
    use_linear_projection: bool = True
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    with_ip: bool = False  # allocate to_k_ip/to_v_ip in cross-attn
    ip_num_tokens: int = 4

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def pooled_dim(self) -> int:
        return (
            self.projection_class_embeddings_input_dim
            - self.num_time_ids * self.addition_time_embed_dim
        )


# ------------------------------------------------------------------ blocks


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, temb_dim, groups):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-5)
        self.conv1 = nn.Conv2d(cin, cout, 3)
        self.time_emb = nn.Linear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3)
        if cin != cout:
            self.shortcut = nn.Conv2d(cin, cout, 1)


def _resnet(p: ResnetBlock, x, temb):
    h = L.group_norm(p.norm1, x, silu=True)
    h = L.conv2d(p.conv1, h)
    t = L.linear(p.time_emb, L.silu(temb))
    h = h + t[:, None, None, :].to(h.dtype)
    h = L.group_norm(p.norm2, h, silu=True)
    h = L.conv2d(p.conv2, h)
    if hasattr(p, "shortcut"):
        x = L.conv2d(p.shortcut, x)
    return x + h


def _heads(t: torch.Tensor, hd: int) -> torch.Tensor:
    """(B, S, heads·hd) → (B, S, heads, hd)."""
    return t.reshape(t.shape[0], t.shape[1], -1, hd)


class Attention(nn.Module):
    def __init__(self, dim, ctx_dim, with_ip=False):
        super().__init__()
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.Linear(dim, dim)
        if with_ip:
            self.to_k_ip = nn.Linear(ctx_dim, dim, bias=False)
            self.to_v_ip = nn.Linear(ctx_dim, dim, bias=False)


def _attn(p: Attention, x, ctx, heads, ip_tokens=None, ip_scale=1.0, kv_pre=None):
    b, s, d = x.shape
    hd = d // heads
    q = _heads(L.linear(p.to_q, x), hd)
    if kv_pre is not None:
        k, v = kv_pre["k"], kv_pre["v"]
    else:
        k = _heads(L.linear(p.to_k, ctx), hd)
        v = _heads(L.linear(p.to_v, ctx), hd)
    o = dot_product_attention(q, k, v).reshape(b, s, -1)
    if kv_pre is not None and "k_ip" in kv_pre:
        k_ip, v_ip = kv_pre["k_ip"], kv_pre["v_ip"]
        o = o + ip_scale * dot_product_attention(q, k_ip, v_ip).reshape(b, s, -1)
    elif ip_tokens is not None and hasattr(p, "to_k_ip"):
        k_ip = _heads(L.linear(p.to_k_ip, ip_tokens), hd)
        v_ip = _heads(L.linear(p.to_v_ip, ip_tokens), hd)
        o = o + ip_scale * dot_product_attention(q, k_ip, v_ip).reshape(b, s, -1)
    return L.linear(p.to_out, o)


class TBlock(nn.Module):
    def __init__(self, dim, ctx_dim, with_ip):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, ctx_dim, with_ip=with_ip)
        self.norm3 = nn.LayerNorm(dim)
        self.ff_in = nn.Linear(dim, dim * 8)  # geglu: value half, then gate half
        self.ff_out = nn.Linear(dim * 4, dim)


def _tblock(p: TBlock, x, ctx, heads, ip_tokens, ip_scale, kv_pre=None):
    h = L.layer_norm(p.norm1, x)
    x = x + _attn(p.attn1, h, h, heads)
    h = L.layer_norm(p.norm2, x)
    x = x + _attn(p.attn2, h, ctx, heads, ip_tokens, ip_scale, kv_pre=kv_pre)
    h = L.layer_norm(p.norm3, x)
    a, g = L.linear(p.ff_in, h).chunk(2, dim=-1)
    return x + L.linear(p.ff_out, a * L.gelu(g))


class Transformer2D(nn.Module):
    def __init__(self, c, ctx_dim, depth, groups, with_ip, use_linear):
        super().__init__()
        # diffusers Transformer2DModel hardcodes GroupNorm eps=1e-6
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.proj_in = nn.Linear(c, c) if use_linear else nn.Conv2d(c, c, 1)
        self.proj_out = nn.Linear(c, c) if use_linear else nn.Conv2d(c, c, 1)
        for i in range(depth):
            self.add_module(f"block_{i}", TBlock(c, ctx_dim, with_ip))
        self.depth = depth


def _transformer(p: Transformer2D, x, ctx, heads, ip_tokens, ip_scale, kv_tree=None):
    b, hh, ww, c = x.shape
    res = x
    h = L.group_norm(p.norm, x)
    # NHWC flattens row-major over (H, W), the JAX token order
    if isinstance(p.proj_in, nn.Linear):
        h = L.linear(p.proj_in, h.reshape(b, hh * ww, c))
    else:
        h = L.conv2d(p.proj_in, h).reshape(b, hh * ww, c)
    for i in range(p.depth):
        h = _tblock(
            getattr(p, f"block_{i}"), h, ctx, heads, ip_tokens, ip_scale,
            kv_pre=kv_tree[f"block_{i}"] if kv_tree is not None else None,
        )
    if isinstance(p.proj_out, nn.Linear):
        h = L.linear(p.proj_out, h).reshape(b, hh, ww, c)
    else:
        h = L.conv2d(p.proj_out, h.reshape(b, hh, ww, c))
    return h + res


# ------------------------------------------------------------------ model


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_out_channels
        ted = cfg.time_embed_dim
        g = cfg.norm_num_groups

        def xformer(c, heads_i):
            return Transformer2D(
                c, cfg.cross_attention_dim, cfg.transformer_layers_per_block[heads_i],
                g, cfg.with_ip, cfg.use_linear_projection,
            )

        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3)
        self.time_embed = nn.ModuleDict({"fc1": nn.Linear(ch[0], ted), "fc2": nn.Linear(ted, ted)})
        if cfg.addition_embed_type == "text_time":
            self.add_embed = nn.ModuleDict({
                "fc1": nn.Linear(cfg.projection_class_embeddings_input_dim, ted),
                "fc2": nn.Linear(ted, ted),
            })
        skip_ch = [ch[0]]
        cin = ch[0]
        for i, btype in enumerate(cfg.down_block_types):
            cout = ch[i]
            blk = nn.ModuleDict()
            for j in range(cfg.layers_per_block):
                blk[f"res_{j}"] = ResnetBlock(cin if j == 0 else cout, cout, ted, g)
                if btype == "CrossAttnDownBlock2D":
                    blk[f"attn_{j}"] = xformer(cout, i)
                skip_ch.append(cout)
            if i < len(ch) - 1:
                blk["down"] = nn.Conv2d(cout, cout, 3)
                skip_ch.append(cout)
            self.add_module(f"down_{i}", blk)
            cin = cout

        # diffusers UNet2DConditionModel always uses UNetMidBlock2DCrossAttn
        self.mid = nn.ModuleDict({
            "res_0": ResnetBlock(cin, cin, ted, g),
            "res_1": ResnetBlock(cin, cin, ted, g),
            "attn": xformer(cin, len(ch) - 1),
        })

        n = len(ch)
        for i, btype in enumerate(reversed(cfg.down_block_types)):
            cout = ch[n - 1 - i]
            blk = nn.ModuleDict()
            for j in range(cfg.layers_per_block + 1):
                res_in = (cin if j == 0 else cout) + skip_ch.pop()
                blk[f"res_{j}"] = ResnetBlock(res_in, cout, ted, g)
                if btype == "CrossAttnDownBlock2D":
                    blk[f"attn_{j}"] = xformer(cout, n - 1 - i)
            if i < n - 1:
                blk["up"] = nn.Conv2d(cout, cout, 3)
            self.add_module(f"up_{i}", blk)
            cin = cout

        self.norm_out = nn.GroupNorm(g, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3)

    def forward(self, sample, timestep, encoder_hidden_states, **kw):
        return apply(self, sample, timestep, encoder_hidden_states, self.cfg, **kw)


# -------------------------------------------------------- cross-attn K/V


def _cross_kv_one(p: Attention, ctx, heads, ip_tokens):
    hd = p.to_q.in_features // heads
    out = {
        "k": _heads(L.linear(p.to_k, ctx), hd),
        "v": _heads(L.linear(p.to_v, ctx), hd),
    }
    if ip_tokens is not None and hasattr(p, "to_k_ip"):
        out["k_ip"] = _heads(L.linear(p.to_k_ip, ip_tokens), hd)
        out["v_ip"] = _heads(L.linear(p.to_v_ip, ip_tokens), hd)
    return out


def _xformer_kv(t: Transformer2D, ctx, heads, ip_tokens):
    return {
        f"block_{k}": _cross_kv_one(getattr(t, f"block_{k}").attn2, ctx, heads, ip_tokens)
        for k in range(t.depth)
    }


def precompute_cross_kv(params: UNet, cfg: UNetConfig, encoder_hidden_states, ip_tokens=None):
    """Project the text (and IP) context through every cross-attention's
    to_k/to_v once; the context is constant over a whole denoise loop.
    Pass the result as `apply(..., cross_kv=...)`; its batch must match
    the sample's. Same tree as the JAX function's."""
    dtype = params.conv_in.weight.dtype
    ctx = encoder_hidden_states.to(dtype)
    ip_tokens = ip_tokens.to(dtype) if ip_tokens is not None else None
    out = {}
    for i, btype in enumerate(cfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            blk = getattr(params, f"down_{i}")
            out[f"down_{i}"] = {
                f"attn_{j}": _xformer_kv(blk[f"attn_{j}"], ctx, cfg.num_attention_heads[i], ip_tokens)
                for j in range(cfg.layers_per_block)
            }
    out["mid"] = _xformer_kv(params.mid["attn"], ctx, cfg.num_attention_heads[-1], ip_tokens)
    rev_heads = list(reversed(cfg.num_attention_heads))
    for i, btype in enumerate(reversed(cfg.down_block_types)):
        if btype == "CrossAttnDownBlock2D":
            blk = getattr(params, f"up_{i}")
            out[f"up_{i}"] = {
                f"attn_{j}": _xformer_kv(blk[f"attn_{j}"], ctx, rev_heads[i], ip_tokens)
                for j in range(cfg.layers_per_block + 1)
            }
    return out


# ---------------------------------------------------------------- forward


def apply(
    params: UNet,
    sample: torch.Tensor,  # (B, H, W, in_channels)
    timestep,  # (B,) or scalar
    encoder_hidden_states: torch.Tensor,  # (B, S, cross_attention_dim)
    cfg: UNetConfig = UNetConfig(),
    pooled_text: Optional[torch.Tensor] = None,  # (B, pooled_dim)
    time_ids: Optional[torch.Tensor] = None,  # (B, num_time_ids)
    ip_tokens: Optional[torch.Tensor] = None,  # (B, n_ip, cross_attention_dim)
    ip_scale: float = 1.0,
    cross_kv: Optional[dict] = None,  # precompute_cross_kv output
):
    """ε prediction (B, H, W, out_channels) in the weights' dtype. When
    `cross_kv` carries k_ip/v_ip, `ip_tokens` is unused."""
    dtype = params.conv_in.weight.dtype
    dev = params.conv_in.weight.device
    sample = sample.to(device=dev, dtype=dtype)
    b = sample.shape[0]
    t = torch.as_tensor(timestep, device=dev).reshape(-1).expand(b)

    temb = L.timestep_embedding(
        t, cfg.block_out_channels[0],
        flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift,
    ).to(dtype)
    te = params.time_embed
    temb = L.linear(te["fc2"], L.silu(L.linear(te["fc1"], temb)))

    if cfg.addition_embed_type == "text_time":
        if pooled_text is None or time_ids is None:
            raise ValueError("text_time conditioning needs pooled_text and time_ids")
        tid = L.timestep_embedding(
            time_ids.to(dev).reshape(-1), cfg.addition_time_embed_dim,
            flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift,
        ).reshape(b, -1)
        pooled_text = pooled_text.to(dev)
        add = torch.cat([pooled_text, tid.to(pooled_text.dtype)], dim=-1).to(dtype)
        ae = params.add_embed
        temb = temb + L.linear(ae["fc2"], L.silu(L.linear(ae["fc1"], add)))

    ctx = encoder_hidden_states.to(device=dev, dtype=dtype)
    if ip_tokens is not None:
        ip_tokens = ip_tokens.to(device=dev, dtype=dtype)
    h = L.conv2d(params.conv_in, sample)
    skips = [h]
    for i, btype in enumerate(cfg.down_block_types):
        blk = getattr(params, f"down_{i}")
        for j in range(cfg.layers_per_block):
            h = _resnet(blk[f"res_{j}"], h, temb)
            if btype == "CrossAttnDownBlock2D":
                h = _transformer(
                    blk[f"attn_{j}"], h, ctx, cfg.num_attention_heads[i], ip_tokens, ip_scale,
                    kv_tree=cross_kv[f"down_{i}"][f"attn_{j}"] if cross_kv else None,
                )
            skips.append(h)
        if "down" in blk:
            # diffusers Downsample2D: symmetric padding 1 (the VAE pads (0,1))
            h = L.conv2d(blk["down"], h, stride=2, padding=[(1, 1), (1, 1)])
            skips.append(h)

    mid = params.mid
    h = _resnet(mid["res_0"], h, temb)
    h = _transformer(
        mid["attn"], h, ctx, cfg.num_attention_heads[-1], ip_tokens, ip_scale,
        kv_tree=cross_kv["mid"] if cross_kv else None,
    )
    h = _resnet(mid["res_1"], h, temb)

    rev_heads = list(reversed(cfg.num_attention_heads))
    for i, btype in enumerate(reversed(cfg.down_block_types)):
        blk = getattr(params, f"up_{i}")
        for j in range(cfg.layers_per_block + 1):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _resnet(blk[f"res_{j}"], h, temb)
            if btype == "CrossAttnDownBlock2D":
                h = _transformer(
                    blk[f"attn_{j}"], h, ctx, rev_heads[i], ip_tokens, ip_scale,
                    kv_tree=cross_kv[f"up_{i}"][f"attn_{j}"] if cross_kv else None,
                )
        if "up" in blk:
            h = L.conv2d(blk["up"], L.upsample2x_nearest(h))

    h = L.group_norm(params.norm_out, h, silu=True)
    out = L.conv2d(params.conv_out, h)
    return out
