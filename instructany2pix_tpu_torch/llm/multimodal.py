"""Any2Pix multimodal LM: the Llama backbone plus the codec projectors and
predictors, counterpart of the JAX package's `llm/multimodal.py`
(inference half; the training losses come with training).

  * `vae_projector_image/audio`: mlp2x_gelu codec → hidden projectors.
  * `vae_predictor_image/audio`: mlp2x_gelu hidden → codec predictors.
  * `splice_input_embeds`: the j-th `<video>` token's embedding is replaced
    by the projected j-th conditioning row (INPUT-type rows only).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..models import layers as L
from ..models import llama
from .constants import REPLACEMENT_TYPE


@dataclasses.dataclass(frozen=True)
class Any2PixLMConfig:
    llama: llama.LlamaConfig = llama.LlamaConfig.vicuna_7b()
    image_codec_dim: int = 1024  # ImageBind/CLIP embedding dim
    audio_codec_dim: int = 768
    image_vocab_size: Optional[int] = None
    audio_vocab_size: Optional[int] = None
    video_token_id: int = 32004  # <video>, 5th of the 9 added tokens
    im_gen_token_id: int = 32000
    audio_gen_token_id: int = 32001
    audio_token_id: int = 32005
    base_token_id: int = 32007

    @staticmethod
    def tiny(token_ids: Optional[Dict[str, int]] = None) -> "Any2PixLMConfig":
        ids = token_ids or {}
        return Any2PixLMConfig(
            llama=llama.LlamaConfig.tiny(vocab_size=280),
            image_codec_dim=16,
            audio_codec_dim=8,
            video_token_id=ids.get("<video>", 263),
            im_gen_token_id=ids.get("<im_gen>", 259),
            audio_gen_token_id=ids.get("<audio_gen>", 260),
            audio_token_id=ids.get("<audio>", 264),
            base_token_id=ids.get("<base>", 266),
        )

    def with_token_ids(self, token_ids: Dict[str, int]) -> "Any2PixLMConfig":
        """The same model with the special-token ids a tokenizer assigned."""
        return dataclasses.replace(
            self,
            video_token_id=token_ids["<video>"],
            im_gen_token_id=token_ids["<im_gen>"],
            audio_gen_token_id=token_ids["<audio_gen>"],
            audio_token_id=token_ids["<audio>"],
            base_token_id=token_ids["<base>"],
        )


class MLP2(nn.Module):
    """mlp2x_gelu: Linear → GELU → Linear."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int):
        super().__init__()
        self.fc1 = nn.Linear(d_in, d_hidden)
        self.fc2 = nn.Linear(d_hidden, d_out)


def _mlp2(p: MLP2, x: torch.Tensor) -> torch.Tensor:
    return L.linear(p.fc2, L.gelu(L.linear(p.fc1, x)))


class Any2PixLM(nn.Module):
    def __init__(self, cfg: Any2PixLMConfig):
        super().__init__()
        d = cfg.llama.hidden_size
        self.llama = llama.Llama(cfg.llama)
        self.vae_projector_image = MLP2(cfg.image_codec_dim, d, d)
        self.vae_projector_audio = MLP2(cfg.audio_codec_dim, d, d)
        self.vae_predictor_image = MLP2(d, d, cfg.image_vocab_size or cfg.image_codec_dim)
        self.vae_predictor_audio = MLP2(d, d, cfg.audio_vocab_size or cfg.audio_codec_dim)


def predict_image_embedding(params: Any2PixLM, hidden: torch.Tensor) -> torch.Tensor:
    """vae_predictor_image readout."""
    return _mlp2(params.vae_predictor_image, hidden)


def splice_input_embeds(
    params: Any2PixLM,
    cfg: Any2PixLMConfig,
    input_ids: torch.Tensor,  # (B, S)
    replacement_data: Optional[torch.Tensor] = None,  # (R, image_codec_dim)
    replacement_types: Optional[torch.Tensor] = None,  # (R,) REPLACEMENT_TYPE
) -> torch.Tensor:
    """Token embeddings with `<video>` slots overwritten by projected
    conditioning embeddings (INPUT-type rows only)."""
    embeds = llama.embed(params.llama, input_ids)
    if replacement_data is None or replacement_data.shape[0] == 0:
        return embeds
    dev = embeds.device
    input_ids = input_ids.to(dev)
    proj = _mlp2(params.vae_projector_image, replacement_data.to(dev))  # (R, D)
    r = proj.shape[0]
    is_vid = input_ids == cfg.video_token_id
    order = torch.cumsum(is_vid.long(), dim=1) - 1  # j-th <video> → row j
    safe = order.clamp(0, r - 1)
    rows = proj[safe]  # (B, S, D)
    types = (replacement_types.to(dev) if replacement_types is not None
             else torch.full((r,), REPLACEMENT_TYPE.INPUT, dtype=torch.int32, device=dev))
    use = is_vid & (order < r) & (types[safe] == REPLACEMENT_TYPE.INPUT)
    return torch.where(use[..., None], rows.to(embeds.dtype), embeds)
