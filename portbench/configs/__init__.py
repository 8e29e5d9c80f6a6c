"""Model configurations: `<name>.json` beside this file, one per
configuration, found by the name that `BENCHMARK.json` gives it."""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, f"{name}.json")) as f:
        return json.load(f)


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def dataclasses_of(cfg: dict, unet_cls, vae_cls, clip_cls, prior_cls, gpt2_cls,
                   image_proj_cls) -> Dict[str, object]:
    """component → its configuration dataclass, built from the file's
    fields by the given classes (the program's or the reference's)."""
    def make(cls, d):
        return cls(**{k: _tuples(v) for k, v in d.items()})

    prior = dict(cfg["prior"])
    prior["gpt2"] = make(gpt2_cls, prior["gpt2"])
    return {
        "unet": make(unet_cls, cfg["unet"]),
        "refiner": make(unet_cls, cfg["refiner"]),
        "vae": make(vae_cls, cfg["vae"]),
        "text1": make(clip_cls, cfg["text1"]),
        "text2": make(clip_cls, cfg["text2"]),
        "prior_text": make(clip_cls, cfg["prior_text"]),
        "prior": prior_cls(**{k: (v if k == "gpt2" else _tuples(v)) for k, v in prior.items()}),
        "image_proj": make(image_proj_cls, cfg["image_proj"]),
        "prior_output_proj": bool(cfg.get("prior_output_proj", False)),
        "image_size": int(cfg["image_size"]),
        "dtype": torch_dtype(cfg),
    }


def reference_cfgs(cfg: dict) -> Dict[str, object]:
    from ..reference import clip, gpt2, ip_adapter, prior, unet, vae

    return dataclasses_of(cfg, unet.UNetConfig, vae.VAEConfig, clip.CLIPTextConfig,
                          prior.PriorConfig, gpt2.GPT2Config, ip_adapter.ImageProjConfig)


def latent_side(cfgs: Dict[str, object]) -> int:
    """The latent's side: the image's over the VAE's downsampling."""
    return cfgs["image_size"] // 2 ** (len(cfgs["vae"].block_out_channels) - 1)


def torch_dtype(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
