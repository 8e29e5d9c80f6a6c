"""CLIP-score quality harness, counterpart of the JAX package's
`utils/clip_score.py`: the standard CLIP-score (torchmetrics' convention,
100 · max(cos(image_embed, text_embed), 0)) through the port's CLIP
encoders, and a recorded-prompt regression kit whose JSON file is the JAX
kit's format.

The image path is `preprocess_clip_image` and `clip.vision_apply` (at
ViT-H/14 its attention is K1 on the card). `load_scoring_clip` reads the
reference's layout: the text tower from `clip-vit-h`, the vision tower from
the IP-Adapter image encoder directory `sdxl/image_encoder`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..models import clip as clip_lib


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def clip_text_embed(params: clip_lib.CLIPText, cfg, tokenizer,
                    prompts: Sequence[str]) -> torch.Tensor:
    ids = []
    for p in prompts:
        row = tokenizer.encode(p) if hasattr(tokenizer, "encode") else tokenizer(p).input_ids
        row = list(row)[: cfg.max_positions]
        if not row or row[-1] != cfg.eos_token_id and len(row) < cfg.max_positions:
            row.append(cfg.eos_token_id)
        row += [0] * (cfg.max_positions - len(row))
        ids.append(row)
    out = clip_lib.text_apply(params, torch.as_tensor(np.asarray(ids, np.int64)), cfg)
    return _normalize(out.get("text_embeds", out["pooled"]).float())


def clip_image_embed(params: clip_lib.CLIPVision, cfg,
                     images: Sequence[np.ndarray]) -> torch.Tensor:
    from ..diffusion.ip_adapter import preprocess_clip_image

    pixels = torch.cat([preprocess_clip_image(img, cfg.image_size) for img in images])
    out = clip_lib.vision_apply(params, pixels, cfg)
    return _normalize(out.get("image_embeds", out["pooled"]).float())


@torch.inference_mode()
def clip_score(text_params, text_cfg, tokenizer, vision_params, vision_cfg,
               images: Sequence[np.ndarray], prompts: Sequence[str]) -> np.ndarray:
    """Per-pair CLIP-score, 100 · max(cos, 0), for (images[i], prompts[i]);
    images are (H, W, 3) uint8 or float arrays."""
    t = clip_text_embed(text_params, text_cfg, tokenizer, prompts)
    v = clip_image_embed(vision_params, vision_cfg, images).to(t.device)
    cos = torch.sum(t * v, dim=-1)
    return (100.0 * torch.clamp(cos, min=0.0)).cpu().numpy()


class RegressionKit:
    """Recorded-prompt CLIP-score regression: record the scores of a fixed
    (prompt → edit image) set once, then `check` flags every score more
    than `tolerance` below its recording. The file is a JSON object of
    key → score, indent 1, keys sorted (the JAX kit's format)."""

    def __init__(self, path: str, tolerance: float = 1.0):
        self.path = path
        self.tolerance = tolerance
        self.records: Dict[str, float] = {}
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                self.records = json.load(f)

    def record(self, scores: Dict[str, float]) -> None:
        self.records.update({k: float(v) for k, v in scores.items()})
        with open(self.path, "w", encoding="utf-8") as f:
            json.dump(self.records, f, indent=1, sort_keys=True)

    def check(self, scores: Dict[str, float]) -> List[str]:
        """The keys whose score regressed."""
        return [k for k, v in scores.items()
                if k in self.records and v < self.records[k] - self.tolerance]


class _HashWordTokenizer:
    """Deterministic word → id tokenizer (crc32, the same ids in every
    process) for the tiny scorer: no BPE files needed."""

    def __init__(self, vocab_size: int, eos_id: int):
        self.vocab_size, self.eos_id = vocab_size, eos_id

    def encode(self, text: str):
        import zlib

        return [1 + zlib.crc32(w.encode()) % (self.vocab_size - 2) for w in text.lower().split()]


def make_tiny_scoring_clip(seed: int = 0, device=None):
    """A seeded tiny scoring CLIP: tiny towers (text projection 16) drawn
    from a `torch.Generator` and the crc32 word tokenizer. Its scores pin
    the metric's plumbing, not model quality; the weights are the port's
    own draws, not the JAX package's."""
    from ..core.device import resolve_device
    from ..models import layers as L

    dev = resolve_device(device)
    tcfg = dataclasses.replace(clip_lib.CLIPTextConfig.tiny(), projection_dim=16)
    vcfg = clip_lib.CLIPVisionConfig.tiny()
    gen = torch.Generator(dev).manual_seed(seed)
    towers = []
    for make in (lambda: clip_lib.CLIPText(tcfg), lambda: clip_lib.CLIPVision(vcfg)):
        with torch.device("meta"):
            m = make()
        towers.append(L.init_(L.materialize(m, dev, torch.float32), gen).eval()
                      .requires_grad_(False))
    return {
        "text_params": towers[0],
        "text_cfg": tcfg,
        "tokenizer": _HashWordTokenizer(tcfg.vocab_size, tcfg.eos_token_id),
        "vision_params": towers[1],
        "vision_cfg": vcfg,
        "tiny_pin": True,
    }


def load_scoring_clip(ckpt: str = "ckpts", device=None, dtype=torch.float32):
    """A full ViT-H/14 CLIP (text + vision) from the reference's layout, or
    None when either tower or the text tokenizer is absent: text from
    `clip-vit-h` (its tokenizer from `clip-vit-h/tokenizer` or the directory
    itself), vision from `sdxl/image_encoder`."""
    from .. import loaders
    from ..core.device import resolve_device
    from ..llm.clip_tokenizer import load_clip_tokenizer

    text_dir = os.path.join(ckpt, "clip-vit-h")
    vis_dir = os.path.join(ckpt, "sdxl", "image_encoder")
    if not (os.path.isdir(text_dir) and os.path.isdir(vis_dir)):
        return None
    tok = load_clip_tokenizer(os.path.join(text_dir, "tokenizer")) or load_clip_tokenizer(text_dir)
    if tok is None:
        return None
    dev = resolve_device(device)
    tcfg, vcfg = clip_lib.CLIPTextConfig.vit_h(), clip_lib.CLIPVisionConfig.vit_h()
    return {
        "text_params": loaders.load_clip_text(text_dir, tcfg, dev, dtype),
        "text_cfg": tcfg,
        "tokenizer": tok,
        "vision_params": loaders.load_clip_vision(vis_dir, vcfg, dev, dtype),
        "vision_cfg": vcfg,
    }
