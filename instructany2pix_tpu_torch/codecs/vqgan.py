"""Conv VQ-GAN codecs — image (2D) and audio-spectrogram variants,
counterpart of the JAX package's `codecs/vqgan.py`.

  * `VQModel`: conv encoder and decoder (resnet blocks, attention at the
    configured levels and in the middle, stride-2 down, nearest-2x up),
    the codebook with a straight-through estimator, pre/post quant 1×1
    convs. NHWC at the boundary, GroupNorm eps 1e-6 (taming's Normalize).
  * `VQGANCodec.encode_seq`/`decode_seq` — the LLM codec interface:
    encode returns (quantized latents, flat codebook indices, grid shape).
  * `vq_losses` — L1 reconstruction + codebook + β·commitment.
  * `taming_keymap(cfg)` — a taming-transformers `VQModel` state dict read
    raw (the JAX `convert_from_taming`): the 1×1-conv attention projections
    become linears, the decoder's `up.{lvl}` levels are mirrored.

The attention block is one head over all `c` channels (512 at 16×16 in
`image_f16`), which the flash kernel does not serve: it stays plain torch
ops with float32 scores, as the JAX einsum does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import KeyMap, Rule
from ..models import layers as L


@dataclasses.dataclass(frozen=True)
class VQConfig:
    in_channels: int = 3
    base_ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 256
    embed_dim: int = 256
    n_embed: int = 1024
    attn_at_mid: bool = True
    # down-level indices carrying attention after each res block (taming
    # `attn_resolutions`; f16 at 256 px puts it at the 16 px level, the
    # last down level); the decoder mirrors them
    attn_levels: Tuple[int, ...] = (4,)
    norm_groups: int = 32

    @staticmethod
    def image_f16() -> "VQConfig":
        return VQConfig()

    @staticmethod
    def audio_spec() -> "VQConfig":
        # 1-channel mel spectrogram codec (SpecVQGAN-style)
        return VQConfig(in_channels=1, ch_mult=(1, 1, 2, 2, 4))

    @staticmethod
    def tiny(in_channels: int = 3) -> "VQConfig":
        return VQConfig(
            in_channels=in_channels,
            base_ch=8,
            ch_mult=(1, 2),
            num_res_blocks=1,
            z_channels=8,
            embed_dim=8,
            n_embed=32,
            attn_levels=(1,),
            norm_groups=4,
        )


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3)
        if cin != cout:
            self.shortcut = nn.Conv2d(cin, cout, 1)


def _res(p: ResBlock, x: torch.Tensor) -> torch.Tensor:
    h = L.conv2d(p.conv1, L.group_norm(p.norm1, x, silu=True))
    h = L.conv2d(p.conv2, L.group_norm(p.norm2, h, silu=True))
    if hasattr(p, "shortcut"):
        x = L.conv2d(p.shortcut, x)
    return x + h


class AttnBlock(nn.Module):
    """taming's AttnBlock: Normalize and 1×1 conv q/k/v/proj_out, held as
    linears (a 1×1 conv is a per-pixel linear)."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.q = nn.Linear(c, c)
        self.k = nn.Linear(c, c)
        self.v = nn.Linear(c, c)
        self.proj_out = nn.Linear(c, c)


def _attn(p: AttnBlock, x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    y = L.group_norm(p.norm, x).reshape(b, h * w, c)
    q, k, v = L.linear(p.q, y), L.linear(p.k, y), L.linear(p.v, y)
    s = torch.einsum("bqc,bkc->bqk", q, k).float() / math.sqrt(float(c))
    a = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bqk,bkc->bqc", a, v)
    return x + L.linear(p.proj_out, o).reshape(b, h, w, c)


class Encoder(nn.Module):
    def __init__(self, cfg: VQConfig):
        super().__init__()
        g, n = cfg.norm_groups, len(cfg.ch_mult)
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.base_ch, 3)
        cin = cfg.base_ch
        for i, m in enumerate(cfg.ch_mult):
            cout = cfg.base_ch * m
            blk = nn.Module()
            c = cin
            for j in range(cfg.num_res_blocks):
                blk.add_module(f"res_{j}", ResBlock(c, cout, g))
                if i in cfg.attn_levels:
                    blk.add_module(f"attn_{j}", AttnBlock(cout, g))
                c = cout
            if i < n - 1:
                blk.down = nn.Conv2d(cout, cout, 3)
            self.add_module(f"down_{i}", blk)
            cin = cout
        self.mid_res_0 = ResBlock(cin, cin, g)
        if cfg.attn_at_mid:
            self.mid_attn = AttnBlock(cin, g)
        self.mid_res_1 = ResBlock(cin, cin, g)
        self.norm_out = nn.GroupNorm(g, cin, eps=1e-6)
        self.conv_out = nn.Conv2d(cin, cfg.z_channels, 3)


class Decoder(nn.Module):
    def __init__(self, cfg: VQConfig):
        super().__init__()
        g, n = cfg.norm_groups, len(cfg.ch_mult)
        cin = cfg.base_ch * cfg.ch_mult[-1]
        # taming's decoder: conv_in takes z_channels (post_quant_conv maps
        # embed_dim to z_channels)
        self.conv_in = nn.Conv2d(cfg.z_channels, cin, 3)
        self.mid_res_0 = ResBlock(cin, cin, g)
        if cfg.attn_at_mid:
            self.mid_attn = AttnBlock(cin, g)
        self.mid_res_1 = ResBlock(cin, cin, g)
        for i, m in enumerate(reversed(cfg.ch_mult)):
            lvl = n - 1 - i  # taming's up.{lvl}
            cout = cfg.base_ch * m
            blk = nn.Module()
            c = cin
            for j in range(cfg.num_res_blocks + 1):
                blk.add_module(f"res_{j}", ResBlock(c, cout, g))
                if lvl in cfg.attn_levels:
                    blk.add_module(f"attn_{j}", AttnBlock(cout, g))
                c = cout
            if i < n - 1:
                blk.up = nn.Conv2d(cout, cout, 3)
            self.add_module(f"up_{i}", blk)
            cin = cout
        self.norm_out = nn.GroupNorm(g, cin, eps=1e-6)
        self.conv_out = nn.Conv2d(cin, cfg.in_channels, 3)


class VQModel(nn.Module):
    def __init__(self, cfg: VQConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(cfg.z_channels, cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)
        self.codebook = nn.Embedding(cfg.n_embed, cfg.embed_dim)


def _blocks(blk: nn.Module, n: int):
    for j in range(n):
        yield getattr(blk, f"res_{j}"), getattr(blk, f"attn_{j}", None)


def encode_z(params: VQModel, x: torch.Tensor, cfg: VQConfig) -> torch.Tensor:
    """(B, H, W, C) image → pre-quant latents (B, H/f, W/f, embed_dim)."""
    p = params.encoder
    h = L.conv2d(p.conv_in, x)
    for i in range(len(cfg.ch_mult)):
        blk = getattr(p, f"down_{i}")
        for res, attn in _blocks(blk, cfg.num_res_blocks):
            h = _res(res, h)
            if attn is not None:
                h = _attn(attn, h)
        if hasattr(blk, "down"):
            h = F.pad(h, (0, 0, 0, 1, 0, 1))
            h = L.conv2d(blk.down, h, stride=2, padding="VALID")
    h = _res(p.mid_res_0, h)
    if hasattr(p, "mid_attn"):
        h = _attn(p.mid_attn, h)
    h = _res(p.mid_res_1, h)
    h = L.conv2d(p.conv_out, L.group_norm(p.norm_out, h, silu=True))
    return L.conv2d(params.quant_conv, h)


def quantize(params: nn.Module, z: torch.Tensor):
    """Nearest entry of `params.codebook` with straight-through gradients.
    The distance is the JAX formula ‖z‖² − 2 z·cb + ‖cb‖² in float32 (a
    `cdist` breaks ties otherwise). Returns (z_q, indices, (codebook_loss,
    commit_loss))."""
    codebook = params.codebook.weight
    flat = z.reshape(-1, z.shape[-1]).float()
    cb = codebook.float()
    d = (flat.pow(2).sum(1, keepdim=True) - 2 * flat @ cb.t() + cb.pow(2).sum(1)[None])
    idx = d.argmin(dim=1)
    zq = codebook[idx].reshape(z.shape).to(z.dtype)
    codebook_loss = torch.mean((z.detach() - zq) ** 2)
    commit_loss = torch.mean((z - zq.detach()) ** 2)
    zq = z + (zq - z).detach()  # straight-through
    return zq, idx.reshape(z.shape[:-1]), (codebook_loss, commit_loss)


def decode_z(params: VQModel, zq: torch.Tensor, cfg: VQConfig) -> torch.Tensor:
    p = params.decoder
    h = L.conv2d(params.post_quant_conv, zq)
    h = L.conv2d(p.conv_in, h)
    h = _res(p.mid_res_0, h)
    if hasattr(p, "mid_attn"):
        h = _attn(p.mid_attn, h)
    h = _res(p.mid_res_1, h)
    for i in range(len(cfg.ch_mult)):
        blk = getattr(p, f"up_{i}")
        for res, attn in _blocks(blk, cfg.num_res_blocks + 1):
            h = _res(res, h)
            if attn is not None:
                h = _attn(attn, h)
        if hasattr(blk, "up"):
            h = L.conv2d(blk.up, L.upsample2x_nearest(h))
    h = L.group_norm(p.norm_out, h, silu=True)
    return L.conv2d(p.conv_out, h)


def vq_losses(params: VQModel, x: torch.Tensor, cfg: VQConfig, beta: float = 0.25):
    z = encode_z(params, x, cfg)
    zq, idx, (cb_loss, commit) = quantize(params, z)
    recon = decode_z(params, zq, cfg)
    rec_loss = torch.mean(torch.abs(x - recon))
    total = rec_loss + cb_loss + beta * commit
    return total, {
        "rec_loss": rec_loss,
        "codebook_loss": cb_loss,
        "commit_loss": commit,
        "recon": recon,
        "indices": idx,
    }


class VQGANCodec:
    """LLM codec interface over a trained `VQModel`."""

    def __init__(self, params: VQModel, cfg: VQConfig):
        self.params = params
        self.cfg = cfg
        self.embed_dim = cfg.embed_dim
        self.n_embed = cfg.n_embed

    def _device(self):
        return self.params.codebook.weight.device

    def encode_seq(self, x, model=None):
        w = self.params.codebook.weight
        x = torch.as_tensor(x).to(device=w.device, dtype=w.dtype)
        z = encode_z(self.params, x, self.cfg)
        zq, idx, _ = quantize(self.params, z)
        b, h, w_, c = zq.shape
        return zq.reshape(b, h * w_, c), idx.reshape(b, -1), (h, w_)

    def decode_seq(self, ind, target_shape):
        h, w = target_shape
        ind = torch.as_tensor(ind).to(self._device())
        cb = self.params.codebook.weight
        zq = cb[ind.reshape(-1)].reshape(ind.shape[0], h, w, -1)
        return decode_z(self.params, zq, self.cfg)


# -------------------------------------------------------------- checkpoint


def _squeeze_1x1(t: torch.Tensor) -> torch.Tensor:
    return t[:, :, 0, 0]


def _unsqueeze_1x1(t: torch.Tensor) -> torch.Tensor:
    return t[:, :, None, None]


def _res_rules(ref: str, port: str):
    rules = []
    for a, b in (("norm1", "norm1"), ("conv1", "conv1"), ("norm2", "norm2"), ("conv2", "conv2"),
                 ("nin_shortcut", "shortcut")):
        for leaf in ("weight", "bias"):
            rules.append(Rule(f"{ref}.{a}.{leaf}", f"{port}.{b}.{leaf}"))
    return rules


def _attn_rules(ref: str, port: str):
    rules = [Rule(f"{ref}.norm.{leaf}", f"{port}.norm.{leaf}") for leaf in ("weight", "bias")]
    for proj in ("q", "k", "v", "proj_out"):
        rules.append(Rule(f"{ref}.{proj}.weight", f"{port}.{proj}.weight",
                          _squeeze_1x1, _unsqueeze_1x1))
        rules.append(Rule(f"{ref}.{proj}.bias", f"{port}.{proj}.bias"))
    return rules


def _plain(ref: str, port: str):
    return [Rule(f"{ref}.{leaf}", f"{port}.{leaf}") for leaf in ("weight", "bias")]


def taming_keymap(cfg: VQConfig) -> KeyMap:
    """taming-transformers `VQModel` keys ↔ `VQModel`: the rules of the JAX
    `convert_from_taming`. Convolutions keep their OIHW layout; the 1×1
    attention convs drop their spatial axes; the port's decoder `up_{i}` is
    taming's `up.{n-1-i}`. The training loss's modules in the file
    (`loss.*`: discriminator, LPIPS) are not part of the codec."""
    n = len(cfg.ch_mult)
    rules = _plain("encoder.conv_in", "encoder.conv_in")
    rules += _res_rules("encoder.down.{i}.block.{j}", "encoder.down_{i}.res_{j}")
    rules += _attn_rules("encoder.down.{i}.attn.{j}", "encoder.down_{i}.attn_{j}")
    rules += _plain("encoder.down.{i}.downsample.conv", "encoder.down_{i}.down")
    for side in ("encoder", "decoder"):
        rules += _res_rules(f"{side}.mid.block_1", f"{side}.mid_res_0")
        rules += _attn_rules(f"{side}.mid.attn_1", f"{side}.mid_attn")
        rules += _res_rules(f"{side}.mid.block_2", f"{side}.mid_res_1")
        rules += _plain(f"{side}.norm_out", f"{side}.norm_out")
        rules += _plain(f"{side}.conv_out", f"{side}.conv_out")
    rules += _plain("decoder.conv_in", "decoder.conv_in")
    for i in range(n):
        lvl = n - 1 - i
        rules += _res_rules(f"decoder.up.{lvl}.block.{{j}}", f"decoder.up_{i}.res_{{j}}")
        rules += _attn_rules(f"decoder.up.{lvl}.attn.{{j}}", f"decoder.up_{i}.attn_{{j}}")
        rules += _plain(f"decoder.up.{lvl}.upsample.conv", f"decoder.up_{i}.up")
    rules += _plain("quant_conv", "quant_conv") + _plain("post_quant_conv", "post_quant_conv")
    rules.append(Rule("quantize.embedding.weight", "codebook.weight"))
    return KeyMap(rules, ignore=[(r"loss\..*", "the training loss's discriminator and LPIPS")])
