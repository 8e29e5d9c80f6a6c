"""Audio codec stack: the 1D VQ model, the MelGAN vocoder and the LPAPS
perceptual loss, counterpart of the JAX package's `codecs/audio.py`.

Activations are channel-last at the boundary, (B, T, C) for the 1D models
and (B, F, T) mels for LPAPS, as in JAX; convolutions run on channel-first
views. Weights are PyTorch's own layouts: `nn.Conv1d` (cout, cin, k) and
`nn.ConvTranspose1d` (cin, cout, k), so a MelGAN state dict loads as it is
once its weight norm is folded (`fold_weight_norm`: w = g·v/‖v‖ over every
dim but 0). Together with `codecs.processors.AudioVAEProcessor`
(wav → log-mel) this closes mel → VQ codes → mel → waveform.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import KeyMap, Rule
from ..models import layers as L
from . import vqgan

# --------------------------------------------------------------- conv1d


def conv1d(p: nn.Conv1d, x: torch.Tensor, stride: int = 1, padding="SAME",
           dilation: int = 1) -> torch.Tensor:
    """(B, T, C) conv. "SAME" is symmetric (k−1)·dilation/2 padding (odd
    kernels at stride 1, the only SAME convs here); "VALID" pads nothing."""
    k = p.weight.shape[-1]
    if padding == "SAME":
        if stride != 1 or k % 2 == 0:
            raise ValueError("SAME padding is only symmetric for stride-1 odd kernels")
        pad = (k - 1) * dilation // 2
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(padding)
    y = F.conv1d(x.to(p.weight.dtype).transpose(1, 2), p.weight, p.bias, stride, pad, dilation)
    return y.transpose(1, 2)


def conv1d_transpose(p: nn.ConvTranspose1d, x: torch.Tensor, stride: int, pad: int,
                     outpad: int = 0) -> torch.Tensor:
    """torch ConvTranspose1d: out_len = (T−1)·stride − 2·pad + k + outpad."""
    y = F.conv_transpose1d(x.to(p.weight.dtype).transpose(1, 2), p.weight, p.bias, stride,
                           pad, outpad)
    return y.transpose(1, 2)


def _reflect_pad_w(x: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(x.transpose(1, 2), (n, n), mode="reflect").transpose(1, 2)


def _leaky(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


# ----------------------------------------------------------- 1D VQ model


@dataclasses.dataclass(frozen=True)
class VQ1DConfig:
    """SpecVQGAN's `VQModel1d`: mel features (B, T, mel_bins) as a 1D
    sequence with mel bins as channels, strided-conv downsampling, the
    shared codebook quantizer."""

    in_channels: int = 80  # mel bins
    base_ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 256
    embed_dim: int = 256
    n_embed: int = 1024
    norm_groups: int = 32

    @staticmethod
    def tiny() -> "VQ1DConfig":
        return VQ1DConfig(
            in_channels=8, base_ch=8, ch_mult=(1, 2), num_res_blocks=1,
            z_channels=8, embed_dim=8, n_embed=32, norm_groups=4,
        )


class Res1D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        # the JAX block normalizes with the helper's default eps, 1e-5
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-5)
        self.conv1 = nn.Conv1d(cin, cout, 3)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-5)
        self.conv2 = nn.Conv1d(cout, cout, 3)
        if cin != cout:
            self.shortcut = nn.Conv1d(cin, cout, 1)


def _res1d(p: Res1D, x: torch.Tensor) -> torch.Tensor:
    h = conv1d(p.conv1, L.group_norm(p.norm1, x, silu=True))
    h = conv1d(p.conv2, L.group_norm(p.norm2, h, silu=True))
    if hasattr(p, "shortcut"):
        x = conv1d(p.shortcut, x)
    return x + h


class VQ1D(nn.Module):
    def __init__(self, cfg: VQ1DConfig):
        super().__init__()
        self.cfg = cfg
        g, n = cfg.norm_groups, len(cfg.ch_mult)
        enc = nn.Module()
        enc.conv_in = nn.Conv1d(cfg.in_channels, cfg.base_ch, 3)
        cin = cfg.base_ch
        for i, m in enumerate(cfg.ch_mult):
            cout = cfg.base_ch * m
            blk = nn.Module()
            c = cin
            for j in range(cfg.num_res_blocks):
                blk.add_module(f"res_{j}", Res1D(c, cout, g))
                c = cout
            if i < n - 1:
                blk.down = nn.Conv1d(cout, cout, 3)
            enc.add_module(f"down_{i}", blk)
            cin = cout
        enc.mid_res_0 = Res1D(cin, cin, g)
        enc.mid_res_1 = Res1D(cin, cin, g)
        enc.norm_out = nn.GroupNorm(g, cin, eps=1e-5)
        enc.conv_out = nn.Conv1d(cin, cfg.z_channels, 3)

        dec = nn.Module()
        dec.conv_in = nn.Conv1d(cfg.embed_dim, cin, 3)
        dec.mid_res_0 = Res1D(cin, cin, g)
        dec.mid_res_1 = Res1D(cin, cin, g)
        for i, m in enumerate(reversed(cfg.ch_mult)):
            cout = cfg.base_ch * m
            blk = nn.Module()
            c = cin
            for j in range(cfg.num_res_blocks + 1):
                blk.add_module(f"res_{j}", Res1D(c, cout, g))
                c = cout
            if i < n - 1:
                blk.up = nn.Conv1d(cout, cout, 3)
            dec.add_module(f"up_{i}", blk)
            cin = cout
        dec.norm_out = nn.GroupNorm(g, cin, eps=1e-5)
        dec.conv_out = nn.Conv1d(cin, cfg.in_channels, 3)
        self.encoder, self.decoder = enc, dec
        self.quant_conv = nn.Conv1d(cfg.z_channels, cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv1d(cfg.embed_dim, cfg.embed_dim, 1)
        self.codebook = nn.Embedding(cfg.n_embed, cfg.embed_dim)


def vq1d_encode(params: VQ1D, x: torch.Tensor, cfg: VQ1DConfig) -> torch.Tensor:
    """mel (B, T, mel_bins) → pre-quant latents (B, T', embed_dim)."""
    p = params.encoder
    h = conv1d(p.conv_in, x)
    for i in range(len(cfg.ch_mult)):
        blk = getattr(p, f"down_{i}")
        for j in range(cfg.num_res_blocks):
            h = _res1d(getattr(blk, f"res_{j}"), h)
        if hasattr(blk, "down"):
            h = F.pad(h, (0, 0, 0, 1))
            h = conv1d(blk.down, h, stride=2, padding="VALID")
    h = _res1d(p.mid_res_0, h)
    h = _res1d(p.mid_res_1, h)
    h = conv1d(p.conv_out, L.group_norm(p.norm_out, h, silu=True))
    return conv1d(params.quant_conv, h)


def vq1d_decode(params: VQ1D, zq: torch.Tensor, cfg: VQ1DConfig) -> torch.Tensor:
    p = params.decoder
    h = conv1d(params.post_quant_conv, zq)
    h = conv1d(p.conv_in, h)
    h = _res1d(p.mid_res_0, h)
    h = _res1d(p.mid_res_1, h)
    for i in range(len(cfg.ch_mult)):
        blk = getattr(p, f"up_{i}")
        for j in range(cfg.num_res_blocks + 1):
            h = _res1d(getattr(blk, f"res_{j}"), h)
        if hasattr(blk, "up"):
            h = conv1d(blk.up, h.repeat_interleave(2, dim=1))
    h = L.group_norm(p.norm_out, h, silu=True)
    return conv1d(p.conv_out, h)


class VQ1DCodec:
    """LLM codec interface: encode_seq → (quantized frames, indices, frame
    count); decode_seq → mel."""

    def __init__(self, params: VQ1D, cfg: VQ1DConfig):
        self.params = params
        self.cfg = cfg
        self.embed_dim = cfg.embed_dim
        self.n_embed = cfg.n_embed

    def encode_seq(self, mel):
        w = self.params.codebook.weight
        z = vq1d_encode(self.params, torch.as_tensor(mel).to(device=w.device, dtype=w.dtype),
                        self.cfg)
        zq, idx, _ = vqgan.quantize(self.params, z)
        return zq, idx, zq.shape[1]

    def decode_seq(self, codes, info=None):
        """codes: (B, T', embed_dim) quantized frames or (B, T') integer
        codebook indices."""
        w = self.params.codebook.weight
        codes = torch.as_tensor(codes).to(w.device)
        if not codes.is_floating_point():
            codes = w[codes.long()]
        return vq1d_decode(self.params, codes.to(w.dtype), self.cfg)


def vq1d_losses(params: VQ1D, x: torch.Tensor, cfg: VQ1DConfig, beta: float = 0.25):
    z = vq1d_encode(params, x, cfg)
    zq, idx, (cb_loss, commit) = vqgan.quantize(params, z)
    recon = vq1d_decode(params, zq, cfg)
    rec = torch.mean(torch.abs(x - recon))
    return rec + cb_loss + beta * commit, {
        "rec_loss": rec, "codebook_loss": cb_loss, "commit_loss": commit,
        "recon": recon, "indices": idx,
    }


# ------------------------------------------------------- MelGAN vocoder


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """MelGAN Generator: mel → waveform, ×256 upsampling through the
    ratios (8, 8, 2, 2)."""

    n_mel_channels: int = 80
    ngf: int = 32
    n_residual_layers: int = 3
    ratios: Tuple[int, ...] = (8, 8, 2, 2)

    @staticmethod
    def tiny() -> "VocoderConfig":
        return VocoderConfig(n_mel_channels=8, ngf=4, n_residual_layers=1, ratios=(2, 2))

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.ratios:
            out *= r
        return out


def _up_padding(r: int) -> Tuple[int, int]:
    """(pad, outpad) of the stage with ratio r."""
    return r // 2 + r % 2, r % 2


class Vocoder(nn.Module):
    def __init__(self, cfg: VocoderConfig):
        super().__init__()
        self.cfg = cfg
        mult = 2 ** len(cfg.ratios)
        self.conv_in = nn.Conv1d(cfg.n_mel_channels, mult * cfg.ngf, 7)
        for i, r in enumerate(cfg.ratios):
            st = nn.Module()
            dim = mult * cfg.ngf // 2
            pad, outpad = _up_padding(r)
            st.up = nn.ConvTranspose1d(mult * cfg.ngf, dim, r * 2, r, pad, outpad)
            for j in range(cfg.n_residual_layers):
                rb = nn.Module()
                rb.conv1 = nn.Conv1d(dim, dim, 3, dilation=3**j)
                rb.conv2 = nn.Conv1d(dim, dim, 1)
                rb.shortcut = nn.Conv1d(dim, dim, 1)
                st.add_module(f"res_{j}", rb)
            self.add_module(f"stage_{i}", st)
            mult //= 2
        self.conv_out = nn.Conv1d(cfg.ngf, 1, 7)


def vocoder_apply(params: Vocoder, mel: torch.Tensor, cfg: VocoderConfig) -> torch.Tensor:
    """mel (B, T, n_mel) → waveform (B, T · hop_length)."""
    h = conv1d(params.conv_in, _reflect_pad_w(mel.to(params.conv_in.weight.dtype), 3),
               padding="VALID")
    for i, r in enumerate(cfg.ratios):
        st = getattr(params, f"stage_{i}")
        pad, outpad = _up_padding(r)
        h = conv1d_transpose(st.up, _leaky(h), stride=r, pad=pad, outpad=outpad)
        for j in range(cfg.n_residual_layers):
            rb = getattr(st, f"res_{j}")
            dil = 3**j
            x = _reflect_pad_w(_leaky(h), dil)
            x = conv1d(rb.conv1, x, padding="VALID", dilation=dil)
            x = conv1d(rb.conv2, _leaky(x))
            h = conv1d(rb.shortcut, h) + x
    h = _reflect_pad_w(_leaky(h), 3)
    h = conv1d(params.conv_out, h, padding="VALID")
    return torch.tanh(h)[..., 0]


def fold_weight_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`weight_g`/`weight_v` pairs → `weight` = g·v/(‖v‖ + 1e-12), the norm
    over every dim but 0 (torch's default dim=0), in float32; other keys
    pass as they are."""
    out = {}
    for key, t in sd.items():
        if key.endswith(".weight_v"):
            continue
        if key.endswith(".weight_g"):
            pre = key[: -len(".weight_g")]
            g = t.float()
            v = sd[pre + ".weight_v"].float()
            nrm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
            out[pre + ".weight"] = g * v / (nrm + 1e-12)
        else:
            out[key] = t
    return out


def vocoder_keymap(cfg: VocoderConfig) -> KeyMap:
    """MelGAN Generator keys (one `nn.Sequential` under `model.*`, weight
    norm folded by `fold_weight_norm`) ↔ `Vocoder`. The sequence is
    [pad, conv, (leaky, convT, resblock × n) × len(ratios), leaky, pad,
    conv, tanh]; a resblock is `block` [leaky, pad, conv, leaky, conv] plus
    a `shortcut` conv. Layouts are PyTorch's on both sides."""
    rules = []

    def conv(ref, port):
        rules.extend(Rule(f"{ref}.{leaf}", f"{port}.{leaf}") for leaf in ("weight", "bias"))

    idx = 1  # model.0 is the ReflectionPad
    conv(f"model.{idx}", "conv_in")
    idx += 1
    for i in range(len(cfg.ratios)):
        idx += 1  # LeakyReLU
        conv(f"model.{idx}", f"stage_{i}.up")
        idx += 1
        for j in range(cfg.n_residual_layers):
            conv(f"model.{idx}.block.2", f"stage_{i}.res_{j}.conv1")
            conv(f"model.{idx}.block.4", f"stage_{i}.res_{j}.conv2")
            conv(f"model.{idx}.shortcut", f"stage_{i}.res_{j}.shortcut")
            idx += 1
    idx += 2  # LeakyReLU, ReflectionPad
    conv(f"model.{idx}", "conv_out")
    return KeyMap(rules)


# ------------------------------------------------------- LPAPS (VGGishish)

VGGISH_LAYERS: Tuple = (
    64, 64, "MP", 128, 128, "MP", 256, 256, 256, "MP", 512, 512, 512, "MP",
    512, 512, 512,
)
LPAPS_CHANNELS = (64, 128, 256, 512, 512)  # feature taps after each slice


@dataclasses.dataclass(frozen=True)
class LPAPSConfig:
    conv_layers: Tuple = VGGISH_LAYERS
    chns: Tuple[int, ...] = LPAPS_CHANNELS

    @staticmethod
    def tiny() -> "LPAPSConfig":
        return LPAPSConfig(conv_layers=(4, "MP", 8, "MP", 8), chns=(4, 8, 8))


class LPAPS(nn.Module):
    """The VGGishish convolutions, the 1×1 per-tap channel weights (`lins`,
    (1, c, 1, 1) as in the file) and the spectrogram scaling statistics
    `shift`/`scale` (`n_stats` values: 1 for the identity default, one per
    mel bin from a file)."""

    def __init__(self, cfg: LPAPSConfig = LPAPSConfig(), n_stats: int = 1):
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList()
        cin = 1
        for v in cfg.conv_layers:
            if v == "MP":
                continue
            self.convs.append(nn.Conv2d(cin, int(v), 3))
            cin = int(v)
        self.lins = nn.ModuleList(nn.Conv2d(c, 1, 1, bias=False) for c in cfg.chns)
        self.shift = nn.Parameter(torch.zeros(n_stats))
        self.scale = nn.Parameter(torch.ones(n_stats))


@torch.no_grad()
def lpaps_init_(module: LPAPS, generator: torch.Generator) -> LPAPS:
    """Random weights as the JAX `lpaps_init` draws them: convolutions with
    `layers.init_`, per-tap weights |N(0, 1)| · 0.1, identity statistics
    (shift 0, scale 1)."""
    L.init_(module, generator)
    for lin in module.lins:
        lin.weight.normal_(generator=generator).abs_().mul_(0.1)
    module.shift.zero_()
    module.scale.fill_(1.0)
    return module


def _vggish_features(params: LPAPS, x: torch.Tensor, cfg: LPAPSConfig):
    """x: (B, F, T) mel in [-1, 1] → the feature map (B, F', T', C) at each
    tap: each ReLU before a maxpool, and the last one."""
    h = x[..., None]
    feats = []
    ci = 0
    last = None
    for v in cfg.conv_layers:
        if v == "MP":
            feats.append(last)
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        else:
            h = torch.relu(L.conv2d(params.convs[ci], h))
            last = h
            ci += 1
    feats.append(last)
    return feats[: len(cfg.chns)]


def lpaps_loss(params: LPAPS, x: torch.Tensor, y: torch.Tensor,
               cfg: Optional[LPAPSConfig] = None) -> torch.Tensor:
    """Perceptual distance between two mel spectrograms (B, F, T): each
    tap's channels unit-normalized, squared difference, the learned 1×1
    weights, spatial mean, summed over taps → (B,)."""
    cfg = cfg or params.cfg
    shift = params.shift.reshape(1, -1, 1)  # per-frequency statistics
    scale = params.scale.reshape(1, -1, 1)
    fx = _vggish_features(params, (x - shift) / scale, cfg)
    fy = _vggish_features(params, (y - shift) / scale, cfg)
    total = 0.0
    for fa, fb, lin in zip(fx, fy, params.lins):
        na = fa / (torch.linalg.vector_norm(fa, dim=-1, keepdim=True) + 1e-10)
        nb = fb / (torch.linalg.vector_norm(fb, dim=-1, keepdim=True) + 1e-10)
        diff = (na - nb) ** 2
        w = torch.sum(diff * lin.weight.reshape(1, 1, 1, -1), dim=-1)
        total = total + torch.mean(w, dim=(1, 2))
    return total


def lpaps_keymap(cfg: LPAPSConfig = LPAPSConfig()) -> KeyMap:
    """LPAPS state dict keys ↔ `LPAPS`: the VGGishish convolutions under
    `net.features.{i}` (a conv and its ReLU take two places, a maxpool one),
    the per-tap weights `lin{k}.model.1.weight`, and the scaling statistics
    `scaling_layer.shift`/`.scale`, stored (1, F, 1) and flattened here."""
    rules = []
    fi = ci = 0
    for v in cfg.conv_layers:
        if v == "MP":
            fi += 1
            continue
        rules += [Rule(f"net.features.{fi}.{leaf}", f"convs.{ci}.{leaf}")
                  for leaf in ("weight", "bias")]
        fi += 2
        ci += 1
    rules += [Rule(f"lin{k}.model.1.weight", f"lins.{k}.weight") for k in range(len(cfg.chns))]
    rules += [Rule(f"scaling_layer.{s}", s, lambda t: t.reshape(-1), lambda t: t.reshape(1, -1, 1))
              for s in ("shift", "scale")]
    return KeyMap(rules)
