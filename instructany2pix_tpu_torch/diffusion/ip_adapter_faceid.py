"""IP-Adapter FaceID family, identity-conditioned generation; counterpart
of the JAX package's `diffusion/ip_adapter_faceid.py` (reference
diffusion/ip_adapter/ip_adapter_faceid.py: MLPProjModel :64-83,
ProjPlusModel :86-117, IPAdapterFaceID :120-255, IPAdapterFaceIDPlus
:258-380; attention_processor_faceid.py LoRAAttnProcessor :9-92 and
LoRAIPAttnProcessor :95-209).

A 512-d face-recognition embedding projects to `num_tokens` context
tokens; the Plus variant refines them with the CLIP penultimate hidden
states of the face crop through a small perceiver. Every UNet attention
(self and cross) carries rank-128 LoRA adapters on to_q/to_k/to_v/to_out:
`attach_faceid_lora` adds them to the existing linears (`layers.add_lora`)
and `layers.linear` applies them, in the cross-attention K/V precompute
too. The face tokens ride the UNet's `ip_tokens` through the
cross-attentions' `to_k_ip`/`to_v_ip`, which the FaceID checkpoint
replaces (`merge_faceid_weights`).

The checkpoint is the reference's {"image_proj": ..., "ip_adapter": ...}:
`faceid_keymap` maps it (flattened to `image_proj.*` / `ip_adapter.*`) to
the projector and to the UNet's attentions, whose processor index is the
attention's place in `unet_convert.all_attn_paths`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.checkpoint import KeyMap, Rule
from ..models import layers as L
from ..models import unet as unet_lib
from ..models import unet_convert
from .resampler import PerceiverLayer, feedforward, perceiver_attention, perceiver_rules

FACEID_RANK = 128
LORA_PROJ = ("to_q", "to_k", "to_v", "to_out")


@dataclasses.dataclass(frozen=True)
class FaceProjConfig:
    cross_attention_dim: int = 2048  # SDXL; SD1.5 uses 768
    id_embeddings_dim: int = 512
    clip_embeddings_dim: int = 1280
    num_tokens: int = 4
    plus: bool = False  # ProjPlusModel (FaceID-Plus checkpoints)
    depth: int = 4  # FacePerceiverResampler layers
    dim_head: int = 64
    ff_mult: int = 4

    @property
    def heads(self) -> int:
        return self.cross_attention_dim // self.dim_head

    @staticmethod
    def tiny(plus: bool = False) -> "FaceProjConfig":
        return FaceProjConfig(cross_attention_dim=32, id_embeddings_dim=16,
                              clip_embeddings_dim=24, num_tokens=2, plus=plus, depth=2,
                              dim_head=8, ff_mult=2)


class FaceResampler(nn.Module):
    def __init__(self, cfg: FaceProjConfig):
        super().__init__()
        ca = cfg.cross_attention_dim
        self.proj_in = nn.Linear(cfg.clip_embeddings_dim, ca)
        self.proj_out = nn.Linear(ca, ca)
        self.norm_out = nn.LayerNorm(ca)
        for i in range(cfg.depth):
            self.add_module(f"layer_{i}", PerceiverLayer(ca, cfg.dim_head, cfg.heads, cfg.ff_mult))


class FaceProj(nn.Module):
    """MLPProjModel (fc1 → GELU → fc2 → LayerNorm per token), plus the
    FacePerceiverResampler with `cfg.plus`."""

    def __init__(self, cfg: FaceProjConfig = FaceProjConfig()):
        super().__init__()
        self.cfg = cfg
        idd, ca = cfg.id_embeddings_dim, cfg.cross_attention_dim
        self.fc1 = nn.Linear(idd, idd * 2)
        self.fc2 = nn.Linear(idd * 2, ca * cfg.num_tokens)
        self.norm = nn.LayerNorm(ca)
        if cfg.plus:
            self.resampler = FaceResampler(cfg)


def apply(params: FaceProj, id_embeds: torch.Tensor, cfg: FaceProjConfig = FaceProjConfig(),
          clip_embeds: Optional[torch.Tensor] = None, shortcut: bool = False,
          scale: float = 1.0) -> torch.Tensor:
    """id_embeds (B, id_embeddings_dim) → (B, num_tokens,
    cross_attention_dim) face IP tokens in the weights' dtype. With
    `cfg.plus`, `clip_embeds` (B, N, clip_embeddings_dim) refine them;
    `shortcut`/`scale` give ProjPlusModel's `x + scale · out` (the v2
    checkpoints)."""
    w = params.fc1.weight
    ca = cfg.cross_attention_dim
    x = L.linear(params.fc2, L.gelu(L.linear(params.fc1, id_embeds.to(device=w.device,
                                                                        dtype=w.dtype))))
    x = L.layer_norm(params.norm, x.reshape(-1, cfg.num_tokens, ca))
    if not cfg.plus:
        return x
    if clip_embeds is None:
        raise ValueError("FaceID-Plus needs clip_embeds")
    r = params.resampler
    h = L.linear(r.proj_in, clip_embeds.to(device=w.device, dtype=w.dtype))
    latents = x
    for i in range(cfg.depth):
        lp = getattr(r, f"layer_{i}")
        latents = perceiver_attention(lp, h, latents, cfg.heads, cfg.dim_head) + latents
        latents = feedforward(lp, latents) + latents
    out = L.layer_norm(r.norm_out, L.linear(r.proj_out, latents))
    return x + scale * out if shortcut else out


@torch.inference_mode()
def get_image_embeds(params: FaceProj, cfg: FaceProjConfig, faceid_embeds: torch.Tensor,
                     clip_embeds: Optional[torch.Tensor] = None,
                     clip_embeds_uncond: Optional[torch.Tensor] = None, shortcut: bool = False,
                     s_scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cond, uncond) tokens. The uncond side projects zero id embeddings
    (reference ip_adapter_faceid.py:187-189) and, for Plus, the CLIP states
    of a zero image, which the caller passes as `clip_embeds_uncond`
    (zeros in their place otherwise)."""
    cond = apply(params, faceid_embeds, cfg, clip_embeds, shortcut, s_scale)
    if clip_embeds_uncond is None and clip_embeds is not None:
        clip_embeds_uncond = torch.zeros_like(clip_embeds)
    uncond = apply(params, torch.zeros_like(faceid_embeds), cfg, clip_embeds_uncond, shortcut,
                   s_scale)
    return cond, uncond


# ------------------------------------------------------- LoRA transform


def _attentions(unet: unet_lib.UNet):
    return [(n, m) for n, m in unet.named_modules() if isinstance(m, unet_lib.Attention)]


def attach_faceid_lora(unet: unet_lib.UNet, generator: Optional[torch.Generator] = None,
                       rank: int = FACEID_RANK, network_alpha: Optional[float] = None):
    """Add zero-initialized adapters (`lora_b` = 0, so the UNet's output is
    unchanged) to to_q/to_k/to_v/to_out of every attention, attn1 and attn2
    alike, in place: the reference's LoRAAttnProcessor swap
    (ip_adapter_faceid.py:144-166, rank 128). The scale is
    network_alpha / rank, 1 by default. Returns `unet`."""
    alpha = network_alpha if network_alpha is not None else float(rank)
    for _, attn in _attentions(unet):
        for name in LORA_PROJ:
            L.add_lora(getattr(attn, name), rank, alpha, generator)
    return unet


# ------------------------------------------------------------ checkpoints


def flatten_state(sd: Dict) -> Dict[str, torch.Tensor]:
    """A nested state dict ({"image_proj": {...}, "ip_adapter": {...}}) as
    one flat {`image_proj.k`: tensor} dict; a flat one is returned as is."""
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in flatten_state(v).items()})
        else:
            out[k] = v
    return out


def faceid_keymap(unet_cfg: unet_lib.UNetConfig, cfg: FaceProjConfig) -> KeyMap:
    """The reference FaceID checkpoint (flattened) ↔ port names: the
    projector under `image_proj.` (`FaceProj`), and each attention's
    adapters and face K/V under its UNet path. Processor i of
    `all_attn_paths` holds `{i}.{proj}_lora.down.weight` (A, (r, in)) and
    `.up.weight` (B, (out, r)) for to_q/to_k/to_v/to_out, and, for a
    cross-attention, `{i}.to_k_ip.weight`/`to_v_ip.weight`
    (the JAX `convert_faceid_from_torch`)."""
    ip, pp = "image_proj.", "image_proj."
    rules = [Rule(f"{ip}proj.0.{leaf}", f"{pp}fc1.{leaf}") for leaf in ("weight", "bias")]
    rules += [Rule(f"{ip}proj.2.{leaf}", f"{pp}fc2.{leaf}") for leaf in ("weight", "bias")]
    rules += [Rule(f"{ip}norm.{leaf}", f"{pp}norm.{leaf}") for leaf in ("weight", "bias")]
    if cfg.plus:
        r, pr = f"{ip}perceiver_resampler.", f"{pp}resampler."
        for n in ("proj_in", "proj_out", "norm_out"):
            rules += [Rule(f"{r}{n}.{leaf}", f"{pr}{n}.{leaf}") for leaf in ("weight", "bias")]
        rules += perceiver_rules(r, pr, cfg.depth)
    for i, path in enumerate(unet_convert.all_attn_paths(unet_cfg)):
        for proj in LORA_PROJ:
            rules.append(Rule(f"ip_adapter.{i}.{proj}_lora.down.weight", f"{path}.{proj}.lora_a"))
            rules.append(Rule(f"ip_adapter.{i}.{proj}_lora.up.weight", f"{path}.{proj}.lora_b"))
        if path.endswith("attn2"):
            for proj in ("to_k_ip", "to_v_ip"):
                rules.append(Rule(f"ip_adapter.{i}.{proj}.weight", f"{path}.{proj}.weight"))
    return KeyMap(rules)


def convert_faceid(state_dict: Dict, unet_cfg: unet_lib.UNetConfig,
                   cfg: FaceProjConfig) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(projector tensors, UNet tensors) of a reference FaceID state dict,
    under port names (`fc1.weight`, ...; `up_0.attn_0.block_0.attn1.to_q.lora_a`,
    ...). Every key must map; every attention's adapters must be there."""
    mapped = faceid_keymap(unet_cfg, cfg).to_port(flatten_state(state_dict), what="FaceID")
    proj = {n[len("image_proj."):]: t for n, t in mapped.items() if n.startswith("image_proj.")}
    attn = {n: t for n, t in mapped.items() if not n.startswith("image_proj.")}
    want = {f"{p}.{proj}.lora_{ab}" for p in unet_convert.all_attn_paths(unet_cfg)
            for proj in LORA_PROJ for ab in "ab"}
    missing = sorted(want - attn.keys())
    if missing:
        raise KeyError(f"FaceID: {len(missing)} adapters missing, e.g. {missing[:4]}")
    return proj, attn


@torch.no_grad()
def merge_faceid_weights(unet: unet_lib.UNet, attn_tensors: Dict[str, torch.Tensor]) -> unet_lib.UNet:
    """Install converted adapters (scale 1: LoRALinearLayer without
    network_alpha) and the face `to_k_ip`/`to_v_ip`, which replace the main
    IP-Adapter's, into `unet` in place; adapters are attached where a
    linear has none yet. Returns `unet`."""
    mods = dict(unet.named_modules())
    w0 = unet.conv_in.weight
    for name, t in sorted(attn_tensors.items()):
        owner, _, leaf = name.rpartition(".")
        if leaf in ("lora_a", "lora_b"):
            lin = mods[owner]
            if not L.has_lora(lin):
                rank = t.shape[0] if leaf == "lora_a" else t.shape[1]
                L.add_lora(lin, rank, float(rank))
            getattr(lin, leaf).copy_(t)
            lin.lora_scale.fill_(1.0)
        elif leaf == "weight" and owner.endswith(("to_k_ip", "to_v_ip")):
            attn_path, _, proj = owner.rpartition(".")
            attn = mods[attn_path]
            if not hasattr(attn, proj):
                setattr(attn, proj, nn.Linear(t.shape[1], t.shape[0], bias=False, device=w0.device,
                                              dtype=w0.dtype).requires_grad_(False))
            getattr(attn, proj).weight.copy_(t)
        else:
            raise KeyError(f"{name}: not a FaceID adapter or face K/V")
    return unet


def build_proj(tensors: Dict[str, torch.Tensor], cfg: FaceProjConfig, device,
               dtype: torch.dtype) -> FaceProj:
    """A FaceProj loaded strictly from port tensors (`convert_faceid`)."""
    from ..core import checkpoint as ckpt_lib

    with torch.device("meta"):
        m = FaceProj(cfg)
    m = L.materialize(m, torch.device(device), dtype)
    ckpt_lib.load_module(m, tensors, "FaceID image_proj")
    return m.eval().requires_grad_(False)
