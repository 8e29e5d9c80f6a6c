"""Segment Anything (SAM), box-prompted mask prediction: counterpart of the
JAX package's `grounding/sam.py`.

  * image encoder: ViT with windowed attention (global attention at the
    configured blocks), decomposed relative position bias and a 2-conv
    neck → (B, g, g, out_chans) image embedding. Every block of a bf16
    encoder on the card, global and windowed, runs K3
    (`ops/flash_attention.py::flash_attention_relpos2d`, `csrc/flash_fwd.cu`;
    `k3_routed`); on the CPU and in float32 the attention takes the plain
    math;
  * prompt encoder: random-Fourier positional encoding plus learned corner
    embeddings for boxes;
  * mask decoder: two-way transformer, IoU head, hypernetwork MLPs over a
    4x upscaled embedding.

Modules carry the JAX tree's key names (`convert.sam` loads a JAX tree).
Linears and einsums promote mixed dtypes as JAX does: the bf16 segmentor's
token path runs in float32 on bf16 weights, as the JAX one does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import KeyMap, Rule
from ..models import layers as L
from ..ops.attention import dot_product_attention
from ..ops.flash_attention import _reference_relpos2d, flash_attention_relpos2d

# bf16 calls on the card with at least this many tokens go to K3. On an
# H100 K3 beat the plain version at every grid chip_smoke.py times, down
# to the smallest, g = 9 (PERF.md): SAM's 14 x 14 windows take it too.
K3_MIN_TOKENS = 81


def k3_routed(device_type: str, dtype: torch.dtype, n: int) -> bool:
    """Whether the rel-pos attention of `n` tokens runs K3: bf16 on the
    card from K3_MIN_TOKENS on; the plain version on the CPU and in
    float32."""
    return device_type == "cuda" and dtype == torch.bfloat16 and n >= K3_MIN_TOKENS


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch: int = 16
    embed_dim: int = 1280  # vit-h
    depth: int = 32
    heads: int = 16
    window: int = 14
    global_blocks: Tuple[int, ...] = (7, 15, 23, 31)
    out_chans: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp: int = 2048
    num_mask_tokens: int = 4  # 1 + 3 multimask

    @staticmethod
    def vit_h() -> "SAMConfig":
        return SAMConfig()

    @staticmethod
    def tiny() -> "SAMConfig":
        return SAMConfig(
            img_size=64, patch=16, embed_dim=32, depth=2, heads=4, window=2,
            global_blocks=(1,), out_chans=16, decoder_mlp=32,
        )


# ---------------------------------------------------------------- modules


class EncBlock(nn.Module):
    def __init__(self, d: int, heads: int, rel_n: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.ln2 = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)
        self.rel_pos_h = nn.Parameter(torch.empty(rel_n, d // heads))
        self.rel_pos_w = nn.Parameter(torch.empty(rel_n, d // heads))


class Encoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        e, tokens = cfg.embed_dim, cfg.img_size // cfg.patch
        self.patch_embed = nn.Conv2d(3, e, cfg.patch, stride=cfg.patch)
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, tokens, e))
        self.neck_conv1 = nn.Conv2d(e, cfg.out_chans, 1, bias=False)
        self.neck_ln1 = nn.LayerNorm(cfg.out_chans)
        self.neck_conv2 = nn.Conv2d(cfg.out_chans, cfg.out_chans, 3, padding=1, bias=False)
        self.neck_ln2 = nn.LayerNorm(cfg.out_chans)
        for i in range(cfg.depth):
            g = tokens if i in cfg.global_blocks else cfg.window
            self.add_module(f"block_{i}", EncBlock(e, cfg.heads, 2 * g - 1))


class Prompt(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.out_chans
        self.pe_gaussian = nn.Parameter(torch.empty(2, d // 2))
        self.point_embed_0 = nn.Parameter(torch.empty(d))  # box corner 1
        self.point_embed_1 = nn.Parameter(torch.empty(d))  # box corner 2
        self.not_a_point = nn.Parameter(torch.empty(d))
        self.no_mask = nn.Parameter(torch.empty(d))


class XAttn(nn.Module):
    def __init__(self, d: int, internal: int):
        super().__init__()
        self.q = nn.Linear(d, internal)
        self.k = nn.Linear(d, internal)
        self.v = nn.Linear(d, internal)
        self.o = nn.Linear(internal, d)


class ConvT2x(nn.Module):
    """A 2x2 stride-2 transposed conv holding the JAX layout: `w` (2, 2,
    out, in) as `lax.conv_transpose` takes it, `b` (out,)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(2, 2, c_out, c_in))
        self.b = nn.Parameter(torch.empty(c_out))


class MLP(nn.Module):
    def __init__(self, dims):
        super().__init__()
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"fc{i}", nn.Linear(a, b))


class DecLayer(nn.Module):
    def __init__(self, d: int, mlp: int):
        super().__init__()
        self.self_attn = XAttn(d, d)
        self.ln1 = nn.LayerNorm(d)
        self.cross_t2i = XAttn(d, d // 2)
        self.ln2 = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, mlp)
        self.fc2 = nn.Linear(mlp, d)
        self.ln3 = nn.LayerNorm(d)
        self.cross_i2t = XAttn(d, d // 2)
        self.ln4 = nn.LayerNorm(d)


class Decoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d, m = cfg.out_chans, cfg.num_mask_tokens
        self.iou_token = nn.Parameter(torch.empty(1, d))
        self.mask_tokens = nn.Parameter(torch.empty(m, d))
        self.final_attn = XAttn(d, d // 2)
        self.final_ln = nn.LayerNorm(d)
        self.up_conv1 = ConvT2x(d, d // 4)
        self.up_ln = nn.LayerNorm(d // 4)
        self.up_conv2 = ConvT2x(d // 4, d // 8)
        self.iou_head = MLP([d, d, d, m])
        for i in range(m):
            self.add_module(f"hyper_{i}", MLP([d, d, d, d // 8]))
        for i in range(cfg.decoder_depth):
            self.add_module(f"layer_{i}", DecLayer(d, cfg.decoder_mlp))


class SAM(nn.Module):
    def __init__(self, cfg: SAMConfig = SAMConfig.tiny()):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.prompt = Prompt(cfg)
        self.decoder = Decoder(cfg)


@torch.no_grad()
def init_(m: SAM, gen: torch.Generator) -> SAM:
    """Random weights with the JAX `sam.init` recipe: linears and convs as
    `layers.init_` draws them, zero positional and rel-pos tables, N(0, 1)
    Fourier features, N(0, 0.02) prompt embeddings, tokens and transposed
    convs."""
    L.init_(m, gen)
    m.prompt.pe_gaussian.normal_(generator=gen)
    small = [m.prompt.point_embed_0, m.prompt.point_embed_1, m.prompt.not_a_point,
             m.prompt.no_mask, m.decoder.iou_token, m.decoder.mask_tokens,
             m.decoder.up_conv1.w, m.decoder.up_conv2.w]
    for p in small:
        p.normal_(generator=gen).mul_(0.02)
    return m


# ---------------------------------------------------------------- helpers


def _promote(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`x @ w + b` in the promoted dtype of x and w, as JAX computes it."""
    x, w = _promote(x, p.weight)
    return F.linear(x, w, p.bias.to(w.dtype) if p.bias is not None else None)


def _mlp(p: MLP, x, act=F.relu):
    layers = list(p.children())
    for i, fc in enumerate(layers):
        x = _linear(fc, x)
        if i < len(layers) - 1:
            x = act(x)
    return x


# ------------------------------------------------------------ image encoder


def _get_rel_pos(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    coords = (torch.arange(q_size)[:, None] - torch.arange(k_size)[None, :] + (k_size - 1))
    return rel_pos[coords.to(rel_pos.device)]


def _attn_with_relpos(q, k, v, p: EncBlock, hw: int, heads: int):
    """q, k, v: (B*, N, H, D) over an hw x hw token grid with decomposed
    relative position bias → (B*, N, H, D). The bias einsums take operands
    in q's dtype and accumulate in float32 (exact products, as JAX's
    `preferred_element_type`). Calls that `k3_routed` names run K3; every
    other call the plain version."""
    b, n, h, d = q.shape
    scale = d**-0.5
    rh = _get_rel_pos(p.rel_pos_h, hw, hw).to(q.dtype).float()  # (hw, hw, d)
    rw = _get_rel_pos(p.rel_pos_w, hw, hw).to(q.dtype).float()
    qg = q.reshape(b, hw, hw, h, d).float()
    bias_h = torch.einsum("byxhd,yud->bhyxu", qg, rh).reshape(b, h, n, hw)
    bias_w = torch.einsum("byxhd,xvd->bhyxv", qg, rw).reshape(b, h, n, hw)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if k3_routed(q.device.type, q.dtype, n):
        o = flash_attention_relpos2d(qt, kt, vt, bias_h, bias_w, scale=scale)
    else:
        o = _reference_relpos2d(qt, kt, vt, bias_h, bias_w, scale)
    return o.transpose(1, 2)


def _window_partition(x, w):
    b, hh, ww, c = x.shape
    pad_h = (w - hh % w) % w
    pad_w = (w - ww % w) % w
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = hh + pad_h, ww + pad_w
    x = x.reshape(b, hp // w, w, wp // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, c)
    return x, (hp, wp)


def _window_unpartition(x, w, pad_hw, hw):
    hp, wp = pad_hw
    b = x.shape[0] // (hp // w * wp // w)
    x = x.reshape(b, hp // w, wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, : hw[0], : hw[1]]


def _enc_block(p: EncBlock, x, cfg: SAMConfig, is_global: bool):
    b, hh, ww, d = x.shape
    heads = cfg.heads
    hd = d // heads
    shortcut = x
    h = L.layer_norm(p.ln1, x)
    if not is_global:
        h, pad_hw = _window_partition(h, cfg.window)
        grid = cfg.window
    else:
        grid = hh
    hb = h.shape[0]
    q, k, v = _linear(p.qkv, h.reshape(hb, -1, d)).chunk(3, dim=-1)
    q, k, v = (t.reshape(hb, -1, heads, hd) for t in (q, k, v))
    o = _attn_with_relpos(q, k, v, p, grid, heads).reshape(hb, -1, d)
    o = _linear(p.proj, o)
    if not is_global:
        o = _window_unpartition(o.reshape(hb, cfg.window, cfg.window, d), cfg.window, pad_hw,
                                (hh, ww))
    else:
        o = o.reshape(b, hh, ww, d)
    x = shortcut + o
    h = L.layer_norm(p.ln2, x)
    return x + _linear(p.fc2, L.gelu(_linear(p.fc1, h)))


def encoder_apply(params: Encoder, x: torch.Tensor, cfg: SAMConfig) -> torch.Tensor:
    """x: (B, img, img, 3) normalized → (B, img/16, img/16, out_chans), in
    the encoder's weight dtype."""
    w = params.patch_embed.weight
    x = torch.as_tensor(x).to(device=w.device, dtype=w.dtype)
    h = L.conv2d(params.patch_embed, x, stride=cfg.patch, padding="VALID")
    h = h + params.pos_embed.to(h.dtype)
    for i in range(cfg.depth):
        h = _enc_block(getattr(params, f"block_{i}"), h, cfg, i in cfg.global_blocks)
    h = L.layer_norm(params.neck_ln1, L.conv2d(params.neck_conv1, h))
    return L.layer_norm(params.neck_ln2, L.conv2d(params.neck_conv2, h))


# ----------------------------------------------------------- prompt encoder


def _pe_encode(coords: torch.Tensor, gaussian: torch.Tensor) -> torch.Tensor:
    """coords in [0, 1] → random-Fourier features."""
    c, gm = _promote(2.0 * coords - 1.0, gaussian)
    proj = c @ gm * (2.0 * np.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def encode_box(params: Prompt, box_xyxy: torch.Tensor, img_size: int) -> torch.Tensor:
    """box (B, 4) pixels → sparse prompt tokens (B, 2, out_chans)."""
    b = box_xyxy.shape[0]
    corners = (box_xyxy.reshape(b, 2, 2) + 0.5) / img_size
    pe = _pe_encode(corners, params.pe_gaussian)
    corner = torch.stack([params.point_embed_0, params.point_embed_1]).to(pe.dtype)
    return pe + corner[None]


def dense_pe(params: Prompt, grid: int) -> torch.Tensor:
    dev = params.pe_gaussian.device
    ys = (torch.arange(grid, device=dev, dtype=torch.float32) + 0.5) / grid
    coords = torch.stack(torch.meshgrid(ys, ys, indexing="xy"), dim=-1)  # (g, g, 2): (x, y)
    return _pe_encode(coords, params.pe_gaussian)


# -------------------------------------------------------------- mask decoder


def _xattn(p: XAttn, q_in, kv, heads, v_in=None):
    """Multi-head attention with separate q/k/v inputs (positional
    embeddings ride q and k; values stay raw), plain math."""
    b, nq, _ = q_in.shape
    q = _linear(p.q, q_in)
    k = _linear(p.k, kv)
    v = _linear(p.v, kv if v_in is None else v_in)
    d = q.shape[-1]
    hd = d // heads
    q, k = _promote(q, k)
    o = dot_product_attention(
        q.reshape(b, nq, heads, hd), k.reshape(b, -1, heads, hd), v.reshape(b, -1, heads, hd),
        impl="xla",
    ).reshape(b, nq, d)
    return _linear(p.o, o)


def _conv_transpose2x(p: ConvT2x, x: torch.Tensor) -> torch.Tensor:
    """NHWC `lax.conv_transpose(x, w, (2, 2), "SAME")` with w in (2, 2, out,
    in): out[2i+a, 2j+c] = x[i, j] . w[1-a, 1-c] + b."""
    w = p.w.to(x.dtype).flip(0, 1).permute(3, 2, 0, 1)  # (in, out, kh, kw)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, p.b.to(x.dtype), stride=2)
    return y.permute(0, 2, 3, 1)


def decoder_apply(params: Decoder, img_embed, img_pe, sparse_prompt, cfg: SAMConfig):
    """img_embed (B, g, g, C); sparse_prompt (B, Np, C) → (masks (B,
    num_mask_tokens, 4g, 4g) float32 logits, iou (B, num_mask_tokens))."""
    b, g, _, c = img_embed.shape
    tokens = torch.cat(
        _promote(params.iou_token[None].expand(b, -1, -1),
                 params.mask_tokens[None].expand(b, -1, -1), sparse_prompt),
        dim=1,
    )
    src = img_embed.reshape(b, g * g, c)
    pos = img_pe.reshape(1, g * g, c)
    q = tokens
    heads = cfg.decoder_heads
    # the first layer's self-attention replaces the queries; pe rides q and
    # k only, values stay raw
    for i in range(cfg.decoder_depth):
        p = getattr(params, f"layer_{i}")
        if i == 0:
            q = _xattn(p.self_attn, q, q, heads)
        else:
            qt = q + tokens
            q = q + _xattn(p.self_attn, qt, qt, heads, v_in=q)
        q = L.layer_norm(p.ln1, q)
        q = q + _xattn(p.cross_t2i, q + tokens, src + pos, heads, v_in=src)
        q = L.layer_norm(p.ln2, q)
        q = q + _linear(p.fc2, F.relu(_linear(p.fc1, q)))
        q = L.layer_norm(p.ln3, q)
        src = src + _xattn(p.cross_i2t, src + pos, q + tokens, heads, v_in=q)
        src = L.layer_norm(p.ln4, src)
    q = q + _xattn(params.final_attn, q + tokens, src + pos, heads, v_in=src)
    q = L.layer_norm(params.final_ln, q)

    iou = _mlp(params.iou_head, q[:, 0])
    mask_tok = q[:, 1: 1 + cfg.num_mask_tokens]

    up = _conv_transpose2x(params.up_conv1, src.reshape(b, g, g, c))
    up = L.gelu(L.layer_norm(params.up_ln, up))
    up = L.gelu(_conv_transpose2x(params.up_conv2, up))  # (b, 4g, 4g, c/8)

    hyper = torch.stack(
        [_mlp(getattr(params, f"hyper_{i}"), mask_tok[:, i]) for i in range(cfg.num_mask_tokens)],
        dim=1,
    )  # (b, M, c/8)
    masks = torch.einsum("bmc,bhwc->bmhw", hyper.float(), up.float())
    return masks, iou


# ---------------------------------------------------------------- full SAM

_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def preprocess(img: np.ndarray, cfg: SAMConfig) -> Tuple[np.ndarray, float]:
    """uint8 (H, W, 3) → padded normalized (1, S, S, 3) and the scale."""
    from ..codecs.image_io import _bilinear_resize

    h, w = img.shape[:2]
    scale = cfg.img_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = (_bilinear_resize(img, nh, nw) - _PIXEL_MEAN) / _PIXEL_STD
    out = np.zeros((cfg.img_size, cfg.img_size, 3), np.float32)
    out[:nh, :nw] = x
    return out[None], scale


def _resize(m: torch.Tensor, size, antialias: bool) -> torch.Tensor:
    """(H, W) float bilinear resize with half-pixel centres, as
    `jax.image.resize(..., "bilinear")`."""
    return F.interpolate(m[None, None], size=size, mode="bilinear", align_corners=False,
                         antialias=antialias)[0, 0]


def _predict(params: SAM, cfg: SAMConfig, x: torch.Tensor, box: torch.Tensor, scale: float):
    """Encoder, prompt and decoder → the (4g, 4g) float32 logits of the
    best of the three multimask outputs (SamPredictor's default)."""
    emb = encoder_apply(params.encoder, x, cfg)
    g = emb.shape[1]
    sparse = encode_box(params.prompt, box * scale, cfg.img_size)
    pe = dense_pe(params.prompt, g)
    # no mask prompt: the dense embedding is the broadcast no_mask
    # embedding, added to the image embedding
    emb = emb + params.prompt.no_mask.to(emb.dtype)
    masks, iou = decoder_apply(params.decoder, emb, pe, sparse, cfg)
    best = int(torch.argmax(iou[0, 1:]).item()) + 1
    return masks[0, best].float()


@torch.inference_mode()
def predict_box_mask(params: SAM, cfg: SAMConfig, img: np.ndarray, box_xyxy) -> np.ndarray:
    """Full box→mask query (SamPredictor.predict with a box prompt), the
    eager reference path: a {0, 1} float mask at the image's resolution."""
    dev = params.prompt.pe_gaussian.device
    x, scale = preprocess(img, cfg)
    box = torch.as_tensor(np.asarray(box_xyxy, np.float32), device=dev).reshape(1, 4)
    m = _predict(params, cfg, torch.as_tensor(x, device=dev), box, scale)
    h, w = img.shape[:2]
    nh, nw = int(round(h * scale)), int(round(w * scale))
    full = _resize(m, (cfg.img_size, cfg.img_size), antialias=True)[:nh, :nw]
    full = _resize(full, (h, w), antialias=True)
    return (full > 0.0).float().cpu().numpy()


def make_segmentor(params: SAM, cfg: SAMConfig, dtype=torch.bfloat16):
    """Serving-path segmentor(image, box_xyxy) → (H, W) float32 {0, 1} mask.
    The module is cast to `dtype` in place (bf16 by default: the mask is
    thresholded at 0; `dtype=None` keeps the weights' precision) and kept
    as `segmentor.params`. Pre- and post-processing run on the module's
    device."""
    if dtype is not None:
        params.to(dtype)
    dev = params.prompt.pe_gaussian.device
    compute_dtype = dtype or torch.float32
    mean = torch.as_tensor(_PIXEL_MEAN, device=dev)
    std = torch.as_tensor(_PIXEL_STD, device=dev)

    @torch.inference_mode()
    def segmentor(image: np.ndarray, box_xyxy) -> np.ndarray:
        img = torch.as_tensor(np.ascontiguousarray(image), device=dev)
        h, w = img.shape[:2]
        scale = cfg.img_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        x = F.interpolate(img.float().permute(2, 0, 1)[None], size=(nh, nw), mode="bilinear",
                          align_corners=False)[0].permute(1, 2, 0)
        x = F.pad((x - mean) / std, (0, 0, 0, cfg.img_size - nw, 0, cfg.img_size - nh))
        box = torch.as_tensor(np.asarray(box_xyxy, np.float32), device=dev).reshape(1, 4)
        m = _predict(params, cfg, x[None].to(compute_dtype), box, scale)
        full = _resize(m, (cfg.img_size, cfg.img_size), antialias=False)[:nh, :nw]
        if (nh, nw) != (h, w):
            full = _resize(full, (h, w), antialias=False)
        return (full > 0.0).float().cpu().numpy()

    segmentor.params = params
    return segmentor


# ------------------------------------------------------------ checkpoints


def _convt_to_port(w: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose2d (in, out, kh, kw) → the JAX layout the port
    keeps, (kh, kw, out, in) with the taps mirrored."""
    return w.permute(2, 3, 1, 0).flip(0, 1)


def _convt_to_ref(w: torch.Tensor) -> torch.Tensor:
    return w.flip(0, 1).permute(3, 2, 0, 1).contiguous()


def _row(t: torch.Tensor) -> torch.Tensor:
    return t[0]


def _as_row(t: torch.Tensor) -> torch.Tensor:
    return t[None]


def keymap(cfg: SAMConfig) -> KeyMap:
    """`sam_vit_h_4b8939.pth` keys ↔ `SAM` (the JAX `convert_from_sam` rules)."""
    def wb(ref, port, leaves=("weight", "bias")):
        return [Rule(f"{ref}.{leaf}", f"{port}.{leaf}") for leaf in leaves]

    enc, blk = "image_encoder", "image_encoder.blocks.{i}"
    rules = wb(f"{enc}.patch_embed.proj", "encoder.patch_embed")
    rules.append(Rule(f"{enc}.pos_embed", "encoder.pos_embed"))
    for ref, port in (("norm1", "ln1"), ("attn.qkv", "qkv"), ("attn.proj", "proj"),
                      ("norm2", "ln2"), ("mlp.lin1", "fc1"), ("mlp.lin2", "fc2")):
        rules += wb(f"{blk}.{ref}", "encoder.block_{i}." + port)
    rules += [Rule(f"{blk}.attn.rel_pos_h", "encoder.block_{i}.rel_pos_h"),
              Rule(f"{blk}.attn.rel_pos_w", "encoder.block_{i}.rel_pos_w")]
    rules += wb(f"{enc}.neck.0", "encoder.neck_conv1", ("weight",)) + \
        wb(f"{enc}.neck.1", "encoder.neck_ln1") + \
        wb(f"{enc}.neck.2", "encoder.neck_conv2", ("weight",)) + wb(f"{enc}.neck.3", "encoder.neck_ln2")
    pe = "prompt_encoder"
    rules.append(Rule(f"{pe}.pe_layer.positional_encoding_gaussian_matrix", "prompt.pe_gaussian"))
    for ref, port in (("point_embeddings.2", "point_embed_0"), ("point_embeddings.3", "point_embed_1"),
                      ("not_a_point_embed", "not_a_point"), ("no_mask_embed", "no_mask")):
        rules.append(Rule(f"{pe}.{ref}.weight", f"prompt.{port}", _row, _as_row))
    md, lay = "mask_decoder", "mask_decoder.transformer.layers.{i}"
    rules += [Rule(f"{md}.iou_token.weight", "decoder.iou_token"),
              Rule(f"{md}.mask_tokens.weight", "decoder.mask_tokens")]
    projs = (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "o"))
    for ref, port in (("self_attn", "self_attn"), ("cross_attn_token_to_image", "cross_t2i"),
                      ("cross_attn_image_to_token", "cross_i2t")):
        for a, b in projs:
            rules += wb(f"{lay}.{ref}.{a}", "decoder.layer_{i}." + f"{port}.{b}")
    for j in range(1, 5):
        rules += wb(f"{lay}.norm{j}", "decoder.layer_{i}." + f"ln{j}")
    rules += wb(f"{lay}.mlp.lin1", "decoder.layer_{i}.fc1") + wb(f"{lay}.mlp.lin2", "decoder.layer_{i}.fc2")
    for a, b in projs:
        rules += wb(f"{md}.transformer.final_attn_token_to_image.{a}", f"decoder.final_attn.{b}")
    rules += wb(f"{md}.transformer.norm_final_attn", "decoder.final_ln")
    for ref, port in (("0", "up_conv1"), ("3", "up_conv2")):
        rules += [Rule(f"{md}.output_upscaling.{ref}.weight", f"decoder.{port}.w",
                       _convt_to_port, _convt_to_ref),
                  Rule(f"{md}.output_upscaling.{ref}.bias", f"decoder.{port}.b")]
    rules += wb(f"{md}.output_upscaling.1", "decoder.up_ln")
    rules += wb(f"{md}.output_hypernetworks_mlps.{{h}}.layers.{{j}}", "decoder.hyper_{h}.fc{j}")
    rules += wb(f"{md}.iou_prediction_head.layers.{{j}}", "decoder.iou_head.fc{j}")
    ignore = [(r"prompt_encoder\.point_embeddings\.[01]\.weight",
               "point-prompt label embeddings: the segmentor prompts with boxes only"),
              (r"prompt_encoder\.mask_downscaling\..*", "mask prompts, which are not used"),
              (r"(pixel_mean|pixel_std)", "normalization constants, fixed in preprocess")]
    return KeyMap(rules, ignore)
