"""Any2Pix multimodal LM: the Llama backbone plus the codec projectors and
predictors, counterpart of the JAX package's `llm/multimodal.py`.

  * `vae_projector_image/audio`: mlp2x_gelu codec → hidden projectors.
  * `vae_predictor_image/audio`: mlp2x_gelu hidden → codec predictors.
  * `splice_input_embeds`: the j-th `<video>` token's embedding is replaced
    by the projected j-th conditioning row (INPUT-type rows only).
  * `train_forward`: the training loss over the collator's dense batch (the
    LM cross-entropy in logsumexp-minus-gather form, the codec heads as
    MSE×dim or CE, the L1 `loss_extra`), with the per-loss dict;
    `preview_generations` is the trainer's periodic generation preview.
  * `init` draws a trainable model from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.checkpoint import KeyMap, Rule
from ..models import layers as L
from ..models import llama
from .constants import IGNORE_INDEX, REPLACEMENT_TYPE


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


def init(cfg: Any2PixLMConfig, generator: torch.Generator, device="cpu",
         dtype=torch.float32) -> Any2PixLM:
    """A trainable Any2PixLM with every parameter drawn from `generator`
    (the JAX package's initializers, `layers.init_`)."""
    with torch.device("meta"):
        m = Any2PixLM(cfg)
    return L.init_(L.materialize(m, torch.device(device), dtype), generator).train()


def predict_image_embedding(params: Any2PixLM, hidden: torch.Tensor) -> torch.Tensor:
    """vae_predictor_image readout."""
    return _mlp2(params.vae_predictor_image, hidden)


def predict_audio_embedding(params: Any2PixLM, hidden: torch.Tensor) -> torch.Tensor:
    """vae_predictor_audio readout."""
    return _mlp2(params.vae_predictor_audio, hidden)


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


def splice_audio_inputs(
    params: Any2PixLM,
    cfg: Any2PixLMConfig,
    input_ids: torch.Tensor,  # (B, S)
    embeds: torch.Tensor,  # (B, S, D)
    audio_frames: Optional[torch.Tensor] = None,  # (B, F, audio_codec_dim)
) -> torch.Tensor:
    """`extra_inputs` audio: the j-th `<audio>` token of row b takes the
    projected codec frame `audio_frames[b, j]`; the frame order restarts in
    every row."""
    if audio_frames is None or audio_frames.shape[1] == 0:
        return embeds
    f = audio_frames.shape[1]
    proj = _mlp2(params.vae_projector_audio, audio_frames)  # (B, F, D)
    is_aud = input_ids == cfg.audio_token_id
    order = torch.cumsum(is_aud.long(), dim=1) - 1  # per-row frame index
    safe = order.clamp(0, f - 1)
    rows = torch.gather(proj, 1, safe[..., None].expand(-1, -1, proj.shape[-1]))  # (B, S, D)
    use = is_aud & (order < f)
    return torch.where(use[..., None], rows.to(embeds.dtype), embeds)


def _train_embeds(params: Any2PixLM, cfg: Any2PixLMConfig, batch: Dict[str, torch.Tensor]):
    """The dense batch's embedding splice (shared by `train_forward` and
    `preview_generations`): token embeds with INPUT-type `<video>` rows,
    gen-target rows and `<audio>` input frames projected in."""
    ids = batch["input_ids"]
    embeds = llama.embed(params.llama, ids)
    rep_type = batch.get("replacement_type")
    if rep_type is not None:
        is_input = (rep_type == REPLACEMENT_TYPE.INPUT)[..., None]
        proj = _mlp2(params.vae_projector_image, batch["replacement_data"])
        embeds = torch.where(is_input, proj.to(embeds.dtype), embeds)
    if "gen_target_image" in batch:
        proj = _mlp2(params.vae_projector_image, batch["gen_target_image"])
        embeds = torch.where(batch["gen_mask_image"][..., None], proj.to(embeds.dtype), embeds)
    if "gen_target_audio" in batch:
        proj = _mlp2(params.vae_projector_audio, batch["gen_target_audio"])
        embeds = torch.where(batch["gen_mask_audio"][..., None], proj.to(embeds.dtype), embeds)
    if "extra_audio_frames" in batch:
        embeds = splice_audio_inputs(params, cfg, ids, embeds, batch["extra_audio_frames"])
    return embeds


@torch.no_grad()
def preview_generations(params: Any2PixLM, cfg: Any2PixLMConfig,
                        batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The trainer's generation preview: for each row, the image predictor's
    output at p - 1 for the row's first `<im_gen>` position p, beside the
    target row at p. Returns `pred` (B, D), `src` (B, D) and `has_gen`
    (B,); rows without an image-gen token (or with one at position 0,
    which no hidden state predicts) carry zeros."""
    embeds = _train_embeds(params, cfg, batch)
    out = llama.forward(params.llama, cfg.llama, inputs_embeds=embeds,
                        attention_mask=batch.get("attention_mask"))
    pred_img = predict_image_embedding(params, out["hidden_norm"][:, :-1])
    mask = batch["gen_mask_image"]
    pos = torch.argmax(mask.int(), dim=1)  # first gen position per row
    has_gen = mask.any(dim=1) & (pos > 0)
    prev = (pos - 1).clamp(0, pred_img.shape[1] - 1)
    idx = lambda p, t: p[:, None, None].expand(-1, 1, t.shape[-1])  # noqa: E731
    pred = torch.gather(pred_img, 1, idx(prev, pred_img))[:, 0]
    src = torch.gather(batch["gen_target_image"], 1, idx(pos, batch["gen_target_image"]))[:, 0]
    zero = torch.zeros_like(pred)
    return {"pred": torch.where(has_gen[:, None], pred, zero),
            "src": torch.where(has_gen[:, None], src.to(pred.dtype), zero),
            "has_gen": has_gen}


def _head_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Continuous codec head: MSE over the masked positions times dim."""
    tgt = target[:, 1:]
    m = mask[:, 1:].float()[..., None]
    d = tgt.shape[-1]
    se = (pred.float() - tgt.float()).square() * m
    denom = torch.clamp(m.sum() * d, min=1.0)
    return se.sum() / denom * d


def _ce_head_loss(logits: torch.Tensor, indices: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Discrete codec head: cross-entropy over codebook logits (no ×dim)."""
    logits = logits.float()
    tgt = indices[:, 1:]
    m = mask[:, 1:].float()
    logp = torch.log_softmax(logits, dim=-1)
    safe = tgt.long().clamp(0, logits.shape[-1] - 1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def train_forward(
    params: Any2PixLM,
    cfg: Any2PixLMConfig,
    batch: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss over the collator's dense batch (`train/data.py`):
    input_ids, labels, attention_mask (B, S); replacement_data
    (B, S, image_codec_dim) with replacement_type (B, S) (-1 = none);
    gen_target_image/gen_mask_image and gen_target_audio/gen_mask_audio;
    optionally extra_audio_frames and discrete gen_index_image/audio.
    The hidden state at p - 1 predicts the target at p. Returns (loss,
    individual losses)."""
    labels = batch["labels"]
    embeds = _train_embeds(params, cfg, batch)
    rep_type = batch.get("replacement_type")
    out = llama.forward(params.llama, cfg.llama, inputs_embeds=embeds,
                        attention_mask=batch.get("attention_mask"))
    logits, hidden = out["logits"], out["hidden_norm"]
    individual: Dict[str, torch.Tensor] = {}

    # LM cross-entropy (shifted), logsumexp minus the gathered logit: only
    # (B, S) reductions and one float32 copy of the logits, no (B, S, V)
    # log-softmax
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe_labels = torch.where(valid, shift_labels, torch.zeros_like(shift_labels)).long()
    lse = torch.logsumexp(shift_logits, dim=-1)
    picked = torch.gather(shift_logits, -1, safe_labels[..., None])[..., 0]
    loss_lang = ((lse - picked) * valid).sum() / torch.clamp(valid.sum(), min=1)
    individual["loss_lang"] = loss_lang
    loss = loss_lang

    # the image predictor feeds the continuous image head and loss_extra:
    # one pass over the sequence
    need_img_pred = ("gen_target_image" in batch and "gen_index_image" not in batch) or (
        rep_type is not None)
    pred_img = predict_image_embedding(params, hidden[:, :-1]) if need_img_pred else None

    if "gen_index_image" in batch:
        li = _ce_head_loss(predict_image_embedding(params, hidden[:, :-1]),
                           batch["gen_index_image"], batch["gen_mask_image"])
        individual["loss_img"] = li
        loss = loss + li
    elif "gen_target_image" in batch:
        li = _head_loss(pred_img, batch["gen_target_image"], batch["gen_mask_image"])
        individual["loss_img"] = li
        loss = loss + li
    if "gen_index_audio" in batch:
        la = _ce_head_loss(predict_audio_embedding(params, hidden[:, :-1]),
                           batch["gen_index_audio"], batch["gen_mask_audio"])
        individual["loss_aud"] = la
        loss = loss + la
    elif "gen_target_audio" in batch:
        la = _head_loss(predict_audio_embedding(params, hidden[:, :-1]),
                        batch["gen_target_audio"], batch["gen_mask_audio"])
        individual["loss_aud"] = la
        loss = loss + la

    # loss_extra: L1 at BASE/GEN <video> positions
    if rep_type is not None:
        extra = (rep_type == REPLACEMENT_TYPE.BASE) | (rep_type == REPLACEMENT_TYPE.GEN)
        m = extra[:, 1:].float()[..., None]
        ae = (pred_img.float() - batch["replacement_data"][:, 1:].float()).abs() * m
        denom = torch.clamp(m.sum() * pred_img.shape[-1], min=1.0)
        loss_extra = ae.sum() / denom
        individual["loss_extra"] = loss_extra
        loss = loss + loss_extra
    return loss, individual


# ------------------------------------------------------------ checkpoints

HEADS = ("vae_projector_image", "vae_projector_audio", "vae_predictor_image",
         "vae_predictor_audio")


def heads_keymap() -> KeyMap:
    """The projector and predictor heads, stored under the meta-model as
    `model.<head>.{0,2}.*` (an MLP: linear, GELU, linear)."""
    rules = []
    for name in HEADS:
        for ref_i, port in (("0", "fc1"), ("2", "fc2")):
            for leaf in ("weight", "bias"):
                rules.append(Rule(f"model.{name}.{ref_i}.{leaf}", f"{name}.{port}.{leaf}"))
    ignore = [(r"vae_.*", "heads outside `model.`, which the reference loader does not read")]
    return KeyMap(rules, ignore)


def keymap() -> KeyMap:
    """An Any2Pix LLM directory: HF Llama's keys under `llama.`, and the heads."""
    return llama.hf_keymap().prefixed(port="llama.") + heads_keymap()
