"""GroundingDINO, open-vocabulary phrase-grounded detection: counterpart of
the JAX package's `grounding/gdino.py`, over the port's Swin
(`grounding/swin.py`) and BERT (`grounding/bert.py`) towers.

  * multi-scale deformable attention: `F.grid_sample` per level (bilinear,
    zero padding, half-pixel centres; the JAX package's gather formulation
    has the same semantics), weighted by the softmaxed attention weights;
  * feature enhancer: deformable image self-attention, text self-attention
    and a bidirectional image-text cross-attention fusion;
  * language-guided query selection (top-k by the largest text
    similarity), then a deformable decoder with box refinement;
  * contrastive class logits: query . text-token similarity.
Every attention here is plain PyTorch math, as in the JAX package (no
Pallas kernel on this path).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import KeyMap, Rule
from ..models import layers as L
from ..ops.attention import dot_product_attention
from . import bert as bert_lib
from . import swin as swin_lib


@dataclasses.dataclass(frozen=True)
class GDinoConfig:
    d_model: int = 256
    heads: int = 8
    levels: int = 4  # 3 swin stages + 1 extra stride-2
    points: int = 4
    enc_layers: int = 6
    dec_layers: int = 6
    ffn: int = 2048
    num_queries: int = 900
    max_text_len: int = 256
    swin: swin_lib.SwinConfig = swin_lib.SwinConfig()
    bert: bert_lib.BertConfig = bert_lib.BertConfig.base()

    @staticmethod
    def swint() -> "GDinoConfig":
        return GDinoConfig()

    @staticmethod
    def tiny() -> "GDinoConfig":
        return GDinoConfig(
            d_model=16, heads=2, levels=3, points=2, enc_layers=1, dec_layers=1, ffn=32,
            num_queries=12, max_text_len=16, swin=swin_lib.SwinConfig.tiny(),
            bert=bert_lib.BertConfig.tiny(),
        )

    @property
    def gn_groups(self) -> int:
        return 32 if self.d_model % 32 == 0 else 8


# ---------------------------------------------------------------- modules


class Deform(nn.Module):
    def __init__(self, d: int, heads: int, levels: int, points: int):
        super().__init__()
        self.sampling_offsets = nn.Linear(d, heads * levels * points * 2)
        self.attn_weights = nn.Linear(d, heads * levels * points)
        self.value_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class Attn(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.o = nn.Linear(d, d)


class FFN(nn.Module):
    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.ln = nn.LayerNorm(d)


class Fusion(nn.Module):
    """BiAttentionBlock: one image-text logits matrix drives both
    directions, with layer-scale gammas."""

    def __init__(self, d: int):
        super().__init__()
        self.ln_v = nn.LayerNorm(d)
        self.ln_l = nn.LayerNorm(d)
        for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj", "out_v_proj",
                     "out_l_proj"):
            self.add_module(name, nn.Linear(d, d))
        self.gamma_v = nn.Parameter(torch.empty(d))
        self.gamma_l = nn.Parameter(torch.empty(d))


class BoxMLP(nn.Module):
    def __init__(self, dims):
        super().__init__()
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"fc{i}", nn.Linear(a, b))


class EncLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        d = cfg.d_model
        self.img_deform = Deform(d, cfg.heads, cfg.levels, cfg.points)
        self.img_ln = nn.LayerNorm(d)
        self.img_ffn = FFN(d, cfg.ffn)
        self.txt_attn = Attn(d)
        self.txt_ln = nn.LayerNorm(d)
        self.txt_ffn = FFN(d, cfg.ffn // 2)
        self.fusion = Fusion(d)


class DecLayer(nn.Module):
    def __init__(self, cfg: GDinoConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = Attn(d)
        self.ln1 = nn.LayerNorm(d)
        self.txt_cross = Attn(d)
        self.ln2 = nn.LayerNorm(d)
        self.img_deform = Deform(d, cfg.heads, cfg.levels, cfg.points)
        self.ln3 = nn.LayerNorm(d)
        self.ffn = FFN(d, cfg.ffn)
        self.box_mlp = BoxMLP([d, d, d, 4])


class InputProj(nn.Module):
    def __init__(self, c_in: int, d: int, kernel: int, groups: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, d, kernel)
        self.gn = nn.GroupNorm(groups, d, eps=1e-5)


class GDino(nn.Module):
    def __init__(self, cfg: GDinoConfig = GDinoConfig.tiny()):
        super().__init__()
        d = cfg.d_model
        self.swin = swin_lib.Swin(cfg.swin)
        self.bert = bert_lib.Bert(cfg.bert)
        self.text_proj = nn.Linear(cfg.bert.hidden_size, d)
        self.level_embed = nn.Parameter(torch.empty(cfg.levels, d))
        self.enc_out_ln = nn.LayerNorm(d)
        self.enc_out_proj = nn.Linear(d, d)
        self.tgt_embed = nn.Parameter(torch.empty(cfg.num_queries, d))
        self.ref_point_head = BoxMLP([2 * d, d, d])
        self.enc_bbox = BoxMLP([d, d, d, 4])
        n_stages = len(cfg.swin.out_stages)
        for i, s in enumerate(cfg.swin.out_stages):
            self.add_module(f"input_proj_{i}", InputProj(cfg.swin.stage_dim(s), d, 1, cfg.gn_groups))
        if cfg.levels > n_stages:
            self.input_proj_extra = InputProj(cfg.swin.stage_dim(cfg.swin.out_stages[-1]), d, 3,
                                              cfg.gn_groups)
        for i in range(cfg.enc_layers):
            self.add_module(f"enc_{i}", EncLayer(cfg))
        for i in range(cfg.dec_layers):
            self.add_module(f"dec_{i}", DecLayer(cfg))


@torch.no_grad()
def init_(m: GDino, cfg: GDinoConfig, gen: torch.Generator) -> GDino:
    """Random weights with the JAX `gdino.init` recipe: `layers.init_`,
    then N(0, 1e-3) sampling offsets, attention weights and last box
    layers, N(0, 0.02) level and query embeddings, gammas of 1e-4; Swin's
    bias tables stay zero."""
    L.init_(m, gen)
    small = [m.enc_bbox.fc2.weight]
    for mod in m.modules():
        if isinstance(mod, Deform):
            small += [mod.sampling_offsets.weight, mod.attn_weights.weight]
        elif isinstance(mod, DecLayer):
            small.append(mod.box_mlp.fc2.weight)
        elif isinstance(mod, Fusion):
            mod.gamma_v.fill_(1e-4)
            mod.gamma_l.fill_(1e-4)
    for p in small:
        p.normal_(generator=gen).mul_(1e-3)
    for p in (m.level_embed, m.tgt_embed):
        p.normal_(generator=gen).mul_(0.02)
    return m


# -------------------------------------------------- deformable attention


def deformable_attention(
    p: Deform,
    query: torch.Tensor,  # (B, Nq, d)
    ref_points: torch.Tensor,  # (B, Nq, 2) or (B, Nq, 4) normalized cxcy(wh)
    value: torch.Tensor,  # (B, sum HW, d)
    shapes: List[Tuple[int, int]],
    heads: int,
    points: int,
) -> torch.Tensor:
    b, nq, d = query.shape
    levels = len(shapes)
    hd = d // heads
    v = L.linear(p.value_proj, value).reshape(b, -1, heads, hd)
    off = L.linear(p.sampling_offsets, query).float().reshape(b, nq, heads, levels, points, 2)
    aw = torch.softmax(L.linear(p.attn_weights, query).reshape(b, nq, heads, levels * points), -1)
    aw = aw.reshape(b, nq, heads, levels, points)
    ref = ref_points.float()[:, :, None, None, None, :]
    if ref_points.shape[-1] == 4:
        loc = ref[..., :2] + off * (ref[..., 2:] / (2.0 * points))
    else:
        wh = torch.tensor([[w, h] for (h, w) in shapes], dtype=torch.float32, device=query.device)
        loc = ref + off / wh[:, None, :]
    grid = (2.0 * loc - 1.0).to(v.dtype)  # grid_sample's [-1, 1], align_corners=False
    out = 0
    start = 0
    for li, (h, w) in enumerate(shapes):
        vl = v[:, start: start + h * w].permute(0, 2, 3, 1).reshape(b * heads, hd, h, w)
        start += h * w
        gl = grid[:, :, :, li].permute(0, 2, 1, 3, 4).reshape(b * heads, nq, points, 2)
        s = F.grid_sample(vl, gl, mode="bilinear", padding_mode="zeros", align_corners=False)
        wl = aw[:, :, :, li].permute(0, 2, 1, 3).reshape(b * heads, 1, nq, points)
        out = out + (s * wl.to(s.dtype)).sum(-1)  # (B*heads, hd, Nq)
    out = out.reshape(b, heads, hd, nq).permute(0, 3, 1, 2).reshape(b, nq, d)
    return L.linear(p.out_proj, out)


# ------------------------------------------------------------- sub-layers


def _mha(p: Attn, q_in, k_in, v_in, heads, mask=None):
    b, nq, d = q_in.shape
    hd = d // heads
    q = L.linear(p.q, q_in).reshape(b, nq, heads, hd)
    k = L.linear(p.k, k_in).reshape(b, -1, heads, hd)
    v = L.linear(p.v, v_in).reshape(b, -1, heads, hd)
    o = dot_product_attention(q, k, v, mask=mask, impl="xla").reshape(b, nq, d)
    return L.linear(p.o, o)


def _ffn(p: FFN, x):
    return L.layer_norm(p.ln, x + L.linear(p.fc2, F.relu(L.linear(p.fc1, x))))


def _bi_attention(p: Fusion, img, txt, heads, text_mask):
    """Bidirectional cross-attention: logits computed once (clamped to
    +-50000), softmaxed along each direction."""
    b, nv, d = img.shape
    nl = txt.shape[1]
    hd = d // heads
    v_in = L.layer_norm(p.ln_v, img)
    l_in = L.layer_norm(p.ln_l, txt)
    q = (L.linear(p.v_proj, v_in) * hd**-0.5).reshape(b, nv, heads, hd)
    k = L.linear(p.l_proj, l_in).reshape(b, nl, heads, hd)
    vv = L.linear(p.values_v_proj, v_in).reshape(b, nv, heads, hd)
    vl = L.linear(p.values_l_proj, l_in).reshape(b, nl, heads, hd)
    logits = torch.einsum("bvhd,blhd->bhvl", q.float(), k.float()).clamp(-50000, 50000)
    # vision attends text (padded text tokens masked)
    attn_v = torch.softmax(logits.masked_fill(~text_mask[:, None, None, :], -1e9), dim=-1)
    out_v = torch.einsum("bhvl,blhd->bvhd", attn_v.to(vl.dtype), vl)
    # text attends vision, stabilized by subtracting the max
    attn_l = torch.softmax(logits - logits.amax(dim=2, keepdim=True), dim=2)
    out_l = torch.einsum("bhvl,bvhd->blhd", attn_l.to(vv.dtype), vv)
    dv = L.linear(p.out_v_proj, out_v.reshape(b, nv, d))
    dl = L.linear(p.out_l_proj, out_l.reshape(b, nl, d))
    return img + p.gamma_v * dv, txt + p.gamma_l * dl


def _inv_sigmoid(x):
    x = x.clamp(1e-5, 1 - 1e-5)
    return torch.log(x / (1 - x))


def _box_mlp(p: BoxMLP, x):
    h = F.relu(L.linear(p.fc0, x))
    h = F.relu(L.linear(p.fc1, h))
    return L.linear(p.fc2, h)


def _dec_layer(p: DecLayer, q, boxes, txt, img, shapes, heads, points, tmask, pos):
    """self-attn (q = k = tgt + pos, v = tgt) → text cross-attn → deformable
    image cross-attn (reference = the current boxes) → FFN; then the box
    refinement sigmoid(inv_sigmoid(ref) + bbox_embed(output))."""
    qp = q + pos
    q = L.layer_norm(p.ln1, q + _mha(p.self_attn, qp, qp, q, heads))
    q = L.layer_norm(p.ln2, q + _mha(p.txt_cross, q + pos, txt, txt, heads, mask=tmask))
    q = L.layer_norm(p.ln3, q + deformable_attention(p.img_deform, q + pos, boxes, img, shapes,
                                                     heads, points))
    q = _ffn(p.ffn, q)
    boxes = torch.sigmoid(_inv_sigmoid(boxes) + _box_mlp(p.box_mlp, q))
    return q, boxes


# ------------------------------------------------------------------ model


def _sine(v, dim_t):
    vv = v[..., None] * 2 * math.pi / dim_t
    return torch.cat([torch.sin(vv), torch.cos(vv)], dim=-1)


def _dim_t(n: int, denom: int, device) -> torch.Tensor:
    return 10000 ** (2 * torch.arange(n, device=device) / denom)


def _sine_pos_1d(n: int, d: int, device) -> torch.Tensor:
    """Sinusoidal features over the token index (the text branch)."""
    return _sine(torch.arange(n, device=device) + 0.5, _dim_t(d // 2, d, device))  # (n, d)


def _sine_pos(h: int, w: int, d: int, device) -> torch.Tensor:
    ys = (torch.arange(h, device=device) + 0.5) / h
    xs = (torch.arange(w, device=device) + 0.5) / w
    dim_t = _dim_t(d // 4, d // 2, device)
    py = _sine(ys, dim_t)[:, None, :].expand(h, w, -1)
    px = _sine(xs, dim_t)[None, :, :].expand(h, w, -1)
    return torch.cat([py, px], dim=-1)  # (h, w, d)


def _box_sine_embed(boxes, d):
    """cxcywh box → sine features, 4 coords x d/2 → (..., 2d)."""
    half = d // 2
    dim_t = _dim_t(half // 2, half, boxes.device)
    return torch.cat([_sine(boxes[..., i], dim_t) for i in range(4)], dim=-1)


def _ref_pos(params: GDino, boxes, d):
    h = F.relu(L.linear(params.ref_point_head.fc0, _box_sine_embed(boxes, d)))
    return L.linear(params.ref_point_head.fc1, h)


def _conv_same(p: nn.Conv2d, x, stride: int):
    """NHWC conv with XLA's "SAME" padding: (total // 2, total - total // 2)
    per axis, so an even size at stride 2 pads one after and none before."""
    k = p.weight.shape[-1]
    pads = []
    for n in (x.shape[2], x.shape[1]):  # F.pad order: W, then H
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return L.conv2d(p, F.pad(x, (0, 0, *pads)), stride=stride, padding="VALID")


def forward(params: GDino, cfg: GDinoConfig, image, input_ids, text_mask):
    """image (B, H, W, 3) normalized; input_ids, text_mask (B, T) →
    (boxes (B, Nq, 4) cxcywh in [0, 1], logits (B, Nq, T))."""
    dev = params.level_embed.device
    image = torch.as_tensor(image, device=dev)
    input_ids = torch.as_tensor(input_ids, device=dev)
    tmask = torch.as_tensor(text_mask, device=dev).bool()
    b = image.shape[0]
    d = cfg.d_model

    feats = swin_lib.apply(params.swin, image, cfg.swin)
    maps = []
    for i, f in enumerate(feats):
        p = getattr(params, f"input_proj_{i}")
        maps.append(L.group_norm(p.gn, L.conv2d(p.conv, f)))
    if hasattr(params, "input_proj_extra"):
        p = params.input_proj_extra
        maps.append(L.group_norm(p.gn, _conv_same(p.conv, feats[-1], 2)))

    shapes = [(m.shape[1], m.shape[2]) for m in maps]
    toks, poss, refs, whs = [], [], [], []
    for li, (m, (h, w)) in enumerate(zip(maps, shapes)):
        toks.append(m.reshape(b, h * w, d))
        pos = _sine_pos(h, w, d, dev).to(m.dtype) + params.level_embed[li]
        poss.append(pos.reshape(1, h * w, d))
        # each token's own grid centre; the proposal's wh grows with the level
        ys = (torch.arange(h, device=dev) + 0.5) / h
        xs = (torch.arange(w, device=dev) + 0.5) / w
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")
        refs.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        whs.append(torch.full((h * w, 2), 0.05 * 2.0**li, device=dev))
    img = torch.cat(toks, dim=1)
    img_pos = torch.cat(poss, dim=1)  # added to deformable queries, never to values
    img_refs = torch.cat(refs)[None].expand(b, -1, -1)
    img_whs = torch.cat(whs)[None].expand(b, -1, -1)

    txt = L.linear(params.text_proj, bert_lib.forward(params.bert, cfg.bert, input_ids, tmask))
    txt_pos = _sine_pos_1d(txt.shape[1], d, dev)[None].to(txt.dtype)

    for i in range(cfg.enc_layers):
        p = getattr(params, f"enc_{i}")
        img, txt = _bi_attention(p.fusion, img, txt, cfg.heads, tmask)
        img = L.layer_norm(p.img_ln, img + deformable_attention(
            p.img_deform, img + img_pos, img_refs, img, shapes, cfg.heads, cfg.points))
        img = _ffn(p.img_ffn, img)
        tq = txt + txt_pos
        txt = L.layer_norm(p.txt_ln, txt + _mha(p.txt_attn, tq, tq, txt, cfg.heads, mask=tmask))
        txt = _ffn(p.txt_ffn, txt)

    # language-guided query selection
    mem = L.layer_norm(params.enc_out_ln, L.linear(params.enc_out_proj, img))
    sim = torch.einsum("bnd,btd->bnt", mem, txt).masked_fill(~tmask[:, None, :], -1e9)
    k = min(cfg.num_queries, mem.shape[1])
    top = torch.topk(sim.amax(dim=-1), k, dim=1).indices  # (B, k), by descending score

    def take(x):
        return torch.gather(x, 1, top[..., None].expand(-1, -1, x.shape[-1]))

    prop = torch.cat([take(img_refs), take(img_whs)], dim=-1)
    boxes = torch.sigmoid(_inv_sigmoid(prop) + _box_mlp(params.enc_bbox, take(mem)))
    q = params.tgt_embed[:k][None].expand(b, -1, -1)
    for i in range(cfg.dec_layers):
        pos = _ref_pos(params, boxes, d)
        q, boxes = _dec_layer(getattr(params, f"dec_{i}"), q, boxes, txt, img, shapes, cfg.heads,
                              cfg.points, tmask, pos)
    logits = torch.einsum("bqd,btd->bqt", q, txt).masked_fill(~tmask[:, None, :], -1e9)
    return boxes, logits


# ---------------------------------------------------------------- predict

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess(img: np.ndarray, size: int = 800, device="cpu") -> torch.Tensor:
    """uint8 (H, W, 3) → (1, h, w, 3): shorter side resized to `size`
    (bilinear, half-pixel centres, no antialiasing), snapped down to a
    multiple of 32, ImageNet-normalized; resized on `device`."""
    h, w = img.shape[:2]
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    nh, nw = max(nh // 32 * 32, 32), max(nw // 32 * 32, 32)
    x = torch.as_tensor(np.ascontiguousarray(img), device=device).float().permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    mean = torch.as_tensor(_IMAGENET_MEAN, device=device)
    std = torch.as_tensor(_IMAGENET_STD, device=device)
    return ((x / 255.0 - mean) / std)[None]


def simple_tokenize(caption: str, vocab_size: int) -> Tuple[np.ndarray, List[str]]:
    """Hash tokenizer for checkpoint-free runs (real checkpoints use the
    BERT vocab). It uses Python's `hash`, so its ids hold within one
    process only (they depend on PYTHONHASHSEED)."""
    words = [w for w in caption.lower().replace(".", " . ").split() if w]
    cls_id, sep_id = vocab_size - 2, vocab_size - 1
    ids = [cls_id] + [abs(hash(w)) % (vocab_size - 12) + 10 for w in words] + [sep_id]
    return np.asarray([ids], np.int64), ["[CLS]"] + words + ["[SEP]"]


def make_grounder(params: GDino, cfg: GDinoConfig, tokenizer=None):
    """→ grounder(image, caption, box_threshold, text_threshold) → (boxes
    (N, 4) cxcywh, best probabilities (N,), phrases), as
    `grounding.lib.subject_consistency` takes it; the module is kept as
    `grounder.params`."""
    dev = params.level_embed.device

    @torch.inference_mode()
    def grounder(image, caption, box_threshold=0.35, text_threshold=0.25):
        x = preprocess(image, device=dev).to(params.level_embed.dtype)
        if tokenizer is not None:
            enc = tokenizer(caption)
            ids = np.asarray([enc.input_ids], np.int64)
            tokens = tokenizer.convert_ids_to_tokens(enc.input_ids)
        else:
            ids, tokens = simple_tokenize(caption, cfg.bert.vocab_size)
        ids = ids[:, : cfg.max_text_len]
        tokens = tokens[: cfg.max_text_len]
        boxes, logits = forward(params, cfg, x, ids, np.ones_like(ids))
        probs = torch.sigmoid(logits.float())[0].cpu().numpy()  # (Nq, T)
        best = probs.max(axis=-1)
        keep = best > box_threshold
        phrases = []
        for row in probs[keep]:
            words = [tokens[t] for t in range(min(len(tokens), row.shape[0]))
                     if row[t] > text_threshold and tokens[t] not in ("[CLS]", "[SEP]", ".")]
            phrases.append(" ".join(words))
        return boxes[0].float().cpu().numpy()[keep], best[keep], phrases

    grounder.params = params
    return grounder


# ------------------------------------------------------------ checkpoints


def _key_wb(ref: str, port: str):
    return [Rule(f"{ref}.{leaf}", f"{port}.{leaf}") for leaf in ("weight", "bias")]


def _key_mha(ref: str, port: str):
    """nn.MultiheadAttention's packed in_proj, split into q, k and v."""
    return [Rule(f"{ref}.in_proj_weight", tuple(f"{port}.{p}.weight" for p in "qkv")),
            Rule(f"{ref}.in_proj_bias", tuple(f"{port}.{p}.bias" for p in "qkv"))] + \
        _key_wb(f"{ref}.out_proj", f"{port}.o")


def _key_deform(ref: str, port: str):
    return [r for a, b in (("sampling_offsets", "sampling_offsets"),
                           ("attention_weights", "attn_weights"), ("value_proj", "value_proj"),
                           ("output_proj", "out_proj")) for r in _key_wb(f"{ref}.{a}", f"{port}.{b}")]


def keymap(cfg: GDinoConfig) -> KeyMap:
    """Official `groundingdino_swint_ogc.pth` keys ↔ `GDino` (the JAX
    `convert_from_torch` mapping). A `module.` prefix is dropped. In the
    decoder the official norms are named out of op order: norm2 follows the
    self-attention (ln1), catext_norm the text cross-attention (ln2), norm1
    the deformable attention (ln3) and norm3 the FFN (ffn.ln)."""
    n = len(cfg.swin.out_stages)
    rules = _key_wb("feat_map", "text_proj") + [Rule("transformer.level_embed", "level_embed"),
                                            Rule("transformer.tgt_embed.weight", "tgt_embed")]
    for i in range(n):
        rules += _key_wb(f"input_proj.{i}.0", f"input_proj_{i}.conv") + \
            _key_wb(f"input_proj.{i}.1", f"input_proj_{i}.gn")
    rules += _key_wb(f"input_proj.{n}.0", "input_proj_extra.conv") + \
        _key_wb(f"input_proj.{n}.1", "input_proj_extra.gn")
    e, t, f = ("transformer.encoder.layers.{i}", "transformer.encoder.text_layers.{i}",
               "transformer.encoder.fusion_layers.{i}")
    rules += _key_deform(f"{e}.self_attn", "enc_{i}.img_deform") + _key_wb(f"{e}.norm1", "enc_{i}.img_ln")
    rules += _key_wb(f"{e}.linear1", "enc_{i}.img_ffn.fc1") + _key_wb(f"{e}.linear2", "enc_{i}.img_ffn.fc2")
    rules += _key_wb(f"{e}.norm2", "enc_{i}.img_ffn.ln")
    rules += _key_mha(f"{t}.self_attn", "enc_{i}.txt_attn") + _key_wb(f"{t}.norm1", "enc_{i}.txt_ln")
    rules += _key_wb(f"{t}.linear1", "enc_{i}.txt_ffn.fc1") + _key_wb(f"{t}.linear2", "enc_{i}.txt_ffn.fc2")
    rules += _key_wb(f"{t}.norm2", "enc_{i}.txt_ffn.ln")
    rules += _key_wb(f"{f}.layer_norm_v", "enc_{i}.fusion.ln_v") + \
        _key_wb(f"{f}.layer_norm_l", "enc_{i}.fusion.ln_l")
    for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj", "out_v_proj", "out_l_proj"):
        rules += _key_wb(f"{f}.attn.{name}", "enc_{i}.fusion." + name)
    rules += [Rule(f"{f}.gamma_v", "enc_{i}.fusion.gamma_v"),
              Rule(f"{f}.gamma_l", "enc_{i}.fusion.gamma_l")]
    d = "transformer.decoder.layers.{i}"
    rules += _key_mha(f"{d}.self_attn", "dec_{i}.self_attn") + _key_wb(f"{d}.norm2", "dec_{i}.ln1")
    rules += _key_mha(f"{d}.ca_text", "dec_{i}.txt_cross") + _key_wb(f"{d}.catext_norm", "dec_{i}.ln2")
    rules += _key_deform(f"{d}.cross_attn", "dec_{i}.img_deform") + _key_wb(f"{d}.norm1", "dec_{i}.ln3")
    rules += _key_wb(f"{d}.linear1", "dec_{i}.ffn.fc1") + _key_wb(f"{d}.linear2", "dec_{i}.ffn.fc2")
    rules += _key_wb(f"{d}.norm3", "dec_{i}.ffn.ln")
    rules += _key_wb("bbox_embed.{i}.layers.{j}", "dec_{i}.box_mlp.fc{j}")
    rules += _key_wb("transformer.enc_output", "enc_out_proj") + \
        _key_wb("transformer.enc_output_norm", "enc_out_ln")
    rules += _key_wb("transformer.decoder.ref_point_head.layers.{j}", "ref_point_head.fc{j}")
    rules += _key_wb("transformer.enc_out_bbox_embed.layers.{j}", "enc_bbox.fc{j}")
    km = (swin_lib.keymap(cfg.swin).prefixed(ref="backbone.0.", port="swin.")
          + bert_lib.hf_keymap().prefixed(ref="bert.", port="bert.") + KeyMap(rules))
    km.aliases = [(re.compile(r"module\.(.*)"), r"\1"),
                  # the decoder's box heads are the top-level ones (shared modules)
                  (re.compile(r"transformer\.decoder\.bbox_embed\.(.*)"), r"bbox_embed.\1")]
    km.ignore += [(re.compile(r"transformer\.decoder\.norm\..*"),
                   "the decoder's final LayerNorm, which the reference package's decoder does "
                   "not apply")]
    return km
