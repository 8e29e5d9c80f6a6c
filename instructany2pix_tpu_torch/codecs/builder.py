"""Embedding-codec layer: the `VQVAE` wrapper and its YAML-config builder,
counterpart of the JAX package's `codecs/builder.py`.

The production config is `vq-npz` (this package's `vq-npz.yaml`, a copy of
the JAX package's): a passthrough codec. The LLM reads precomputed 1024-d
ImageBind/CLIP embeddings from `.npz` files (`train/data_preparation.py`
writes them); the conv VQ-GAN stacks (`vqgan.py`, `audio.py`) are
training-era machinery the shipped checkpoints never run. Codec contract:

  encode_seq(x) -> (quant, indices, info)   # info None → continuous
  decode_seq(indices, target_shape) -> reconstruction

Configs are resolved from this package directory by name. They are read by
`_load_yaml`, a reader of the YAML subset the codec configs use (block
mappings of scalars, YAML 1.1 booleans such as `on`), so no YAML package is
needed.
"""

from __future__ import annotations

import pathlib
import re
from typing import Any, Optional

import numpy as np

from ..core.config import instantiate_from_config

CURR_PATH = pathlib.Path(__file__).parent.resolve()


class TensorLoader:
    """Identity codec over precomputed embeddings."""

    def __init__(self, embed_dim, n_embed, *args, **kwargs):
        self.embed_dim = embed_dim
        self.n_embed = n_embed

    def encode_seq(self, x, model=None):
        return x, None, None

    def decode_seq(self, ind, target_shape=None):
        return ind


class NpzLoader:
    """Reads the `state` array of a feature file that the offline ImageBind
    extraction writes (`train/data_preparation.py`)."""

    def __call__(self, path):
        return np.load(path)["state"]


class ClipVisionCodec:
    """The CLIP image embedding as a codec: `clip.vision_apply` over a
    `CLIPVision` module (`params`), whose attention is K1 on the card at
    ViT-H/14. encode_seq(pixels (B, H, W, 3), CLIP-normalized) → image
    embeds (B, D, 1, 1)."""

    def __init__(self, embed_dim=1024, n_embed=1024, params=None, cfg=None):
        from ..models import clip as clip_lib

        self.embed_dim = embed_dim
        self.n_embed = n_embed
        self._params = params
        self._cfg = cfg or clip_lib.CLIPVisionConfig.vit_h()

    def encode_seq(self, pixels, model=None):
        from ..models import clip as clip_lib

        if self._params is None:
            raise ValueError("ClipVisionCodec needs loaded weights (params=)")
        out = clip_lib.vision_apply(self._params, pixels, self._cfg)
        return out["image_embeds"][..., None, None], None, None

    def decode_seq(self, ind, target_shape=None):
        return ind


# target-string aliases, so the reference's YAML configs resolve here
_TARGET_ALIASES = {
    "instructany2pix.llm.model.vae.clip.TensorLoader": TensorLoader,
    "instructany2pix.llm.model.vae.clip.ClipVisionModelInterfaceForLLM": ClipVisionCodec,
}


def _instantiate(model_config):
    target = model_config.get("target", "")
    if target in _TARGET_ALIASES:
        return _TARGET_ALIASES[target](**model_config.get("params", {}))
    return instantiate_from_config(model_config)


_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_INT = re.compile(r"[-+]?[0-9][0-9_]*$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")


def _scalar(text: str) -> Any:
    """A plain or quoted YAML 1.1 scalar, resolved as PyYAML's safe loader
    resolves it: null, bool (on/off, yes/no, true/false), int, float, else
    a string."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    low = text.lower()
    if text in ("", "~") or low == "null":
        return None
    if low in _BOOL and (text.islower() or text.istitle() or text.isupper()):
        return _BOOL[low]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    return text


def _load_yaml(text: str) -> dict:
    """Block mappings of scalars, nested by indentation; comments and blank
    lines skipped. Anything else (sequences, flow collections, anchors,
    multi-line scalars) raises ValueError."""
    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping)
    for n, raw in enumerate(text.splitlines(), 1):
        line = re.sub(r"(^|\s)#.*$", "", raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith(("- ", "[", "{", "&", "*", "|", ">")) or ":" not in body:
            raise ValueError(f"line {n}: {raw!r} is outside the YAML subset this reader takes")
        key, _, value = body.partition(":")
        key, value = key.strip(), value.strip()
        if value.startswith(("[", "{", "&", "*", "|", ">")):
            raise ValueError(f"line {n}: {raw!r} is outside the YAML subset this reader takes")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if value:
            parent[key] = _scalar(value)
        else:
            parent[key] = {}
            stack.append((indent, parent[key]))
    # a key with nothing nested under it is null, as in YAML
    def nulls(d):
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = nulls(v) if v else None
        return d

    return nulls(root)


def build_vae(config_name: str, modality: str):
    """Load `<config_name>.yaml` from this package directory and build
    (codec, processor)."""
    with open(CURR_PATH / f"{config_name}.yaml") as f:
        config = _load_yaml(f.read())
    model = _instantiate(config["model"])
    processor: Any
    if config.get("processor") == "npz":
        processor = NpzLoader()
    elif modality == "image":
        from .processors import ImageVAEProcessor

        processor = ImageVAEProcessor(config.get("image_size", 256))
    else:
        from .processors import AudioVAEProcessor

        processor = AudioVAEProcessor(
            config.get("data", {}).get("params", {}).get("sample_rate", 22050)
        )
    return model, processor


class VQVAEProcessor:
    def __init__(self, image_proc, audio_proc):
        self.image_vae_processor = image_proc
        self.audio_vae_processor = audio_proc

    def __call__(self, x, modality):
        if modality == "image":
            return self.image_vae_processor(x)
        if modality == "audio":
            return self.audio_vae_processor(x)
        raise NotImplementedError(modality)


class VQVAE:
    """The frozen multimodal codec pair."""

    def __init__(self, image_vae: Optional[str], audio_vae: Optional[str]):
        self.image_vae = None
        self.audio_vae = None
        self.image_vae_processor = None
        self.audio_vae_processor = None
        self.embed_dim_image = 1
        self.embed_dim_audio = 1
        self.vocab_size_image = 1
        self.vocab_size_audio = 1
        if image_vae:
            self.image_vae, self.image_vae_processor = build_vae(image_vae, "image")
            self.embed_dim_image = self.image_vae.embed_dim
            self.vocab_size_image = self.image_vae.n_embed
        if audio_vae:
            self.audio_vae, self.audio_vae_processor = build_vae(audio_vae, "audio")
            self.embed_dim_audio = self.audio_vae.embed_dim
            self.vocab_size_audio = self.audio_vae.n_embed
        self.processor = VQVAEProcessor(self.image_vae_processor, self.audio_vae_processor)

    def __call__(self, x: dict) -> dict:
        out = {}
        if "image" in x and self.image_vae is not None:
            out["image"] = self.image_vae.encode_seq(x["image"])
        if "audio" in x and self.audio_vae is not None:
            out["audio"] = self.audio_vae.encode_seq(x["audio"])
        return out
