"""Training data: instruction JSON plus npz media features → the dense
batches `llm.multimodal.train_forward` consumes. Counterpart of the JAX
package's `train/data.py`, which rebuilds the reference's
`LazySupervisedDataset` and `DataCollatorForSupervisedDataset`; the same
records, the same numpy RandomState and the same tokenizer give
byte-identical arrays.

  * media_map: caption → .npz feature file; embeddings renormed to 20;
    missing media → zero embedding.
  * any2any task rewriting: bracketed `[...]` captions in human turns
    become `<video>` INPUT replacements with prob `video_prob` (0.8); the
    base caption becomes `<base>` (or `<base_null>` with 20% drop); gpt-turn
    brackets mark BASE/GEN replacements; `additions:` suffixes append
    subject gen tokens.
  * generation tasks: image targets expand to `<im_gen_start> <im_gen>`,
    audio targets to 8 `<audio_gen>` frames.
  * vicuna_v1 templating with human turns masked to IGNORE_INDEX.
  * the collator emits per-position replacement_data/replacement_type/
    gen_target masks, right-padded to the longest row.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List

import numpy as np

from ..llm import constants as C
from ..llm.conversation import conv_templates


@dataclasses.dataclass
class DataConfig:
    max_length: int = 2048
    video_prob: float = 0.8
    base_drop_prob: float = 0.2
    embed_norm: float = 20.0
    audio_gen_len: int = 8
    image_gen_len: int = 1
    audio_codec_dim: int = 768


class MediaMap:
    """caption → embedding lookup over npz feature files."""

    def __init__(self, mapping: Dict[str, str], root: str = "", dim: int = 1024):
        self.mapping = mapping
        self.root = root
        self.dim = dim

    def get(self, caption: str, norm: float = 20.0) -> np.ndarray:
        path = self.mapping.get(caption)
        if path is None:
            return np.zeros((self.dim,), np.float32)
        full = os.path.join(self.root, path)
        if not os.path.exists(full):
            return np.zeros((self.dim,), np.float32)
        x = np.load(full)["state"].astype(np.float32).reshape(-1)
        n = np.linalg.norm(x)
        return x / (n + 1e-9) * norm if n > 0 else x

    def get_frames(
        self, caption: str, frames: int, dim: int, norm: float = 20.0
    ) -> np.ndarray:
        """Frame-sequence lookup (audio codec path): the stored feature
        reshaped/resized to (frames, dim), each frame renormed."""
        path = self.mapping.get(caption)
        if path is None or not os.path.exists(os.path.join(self.root, path)):
            return np.zeros((frames, dim), np.float32)
        x = np.load(os.path.join(self.root, path))["state"].astype(np.float32)
        x = np.resize(x.reshape(-1), (frames, dim))
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        return np.where(n > 0, x / (n + 1e-9) * norm, x)

    def get_batch(self, captions, norm: float = 20.0) -> np.ndarray:
        """Batched lookup through the native threaded loader (numpy when
        native/libia2p_loader.so is not built). Unknown captions and
        unreadable files give zero rows."""
        from .native_loader import load_feature_batch

        paths = [
            os.path.join(self.root, self.mapping[c]) if c in self.mapping
            else os.path.join(self.root, "__missing__.npz")
            for c in captions
        ]
        out = load_feature_batch(paths, self.dim)
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return np.where(norms > 0, out / (norms + 1e-9) * norm, out)


_BRACKET = re.compile(r"\[([^\]]+)\]")


def rewrite_example(
    example: Dict[str, Any],
    media: MediaMap,
    cfg: DataConfig,
    rng: np.random.RandomState,
) -> Dict[str, Any]:
    """One instruction example → (prompt pieces, replacement records).

    Returns dict with `conversations` (rewritten turns), `replacements`
    [(embedding, REPLACEMENT_TYPE)] in `<video>`-occurrence order, and
    `gen_modality` ('image'|'audio'|None) + `gen_target`.
    """
    replacements: List = []
    turns = []
    base_caption = example.get("base", None)
    # `multimodal_input` audio clip (reference train.py:455-466): the
    # human turn's single `<audio>` marker expands to 8 `<audio>` tokens
    # whose embeddings are the clip's codec frames (`extra_inputs`)
    extra_audio = None
    mm_in = example.get("multimodal_input")
    if mm_in is not None and mm_in.get("type") == "audio":
        extra_audio = media.get_frames(
            mm_in.get("src", ""), cfg.audio_gen_len, cfg.audio_codec_dim,
            cfg.embed_norm,
        )
    for turn in example["conversations"]:
        text = turn["value"]
        if extra_audio is not None and turn["from"] == "human":
            text = text.replace(
                C.DEFAULT_AUDIO_TOKEN, C.DEFAULT_AUDIO_TOKEN * cfg.audio_gen_len
            )
        if turn["from"] == "human":
            def sub_human(m):
                cap = m.group(1)
                if rng.rand() < cfg.video_prob:
                    replacements.append(
                        (media.get(cap, cfg.embed_norm), C.REPLACEMENT_TYPE.INPUT)
                    )
                    return C.DEFAULT_VIDEO_TOKEN
                return m.group(0)

            text = _BRACKET.sub(sub_human, text)
        else:
            # gpt turn: base marker + GEN replacements
            if base_caption is not None and rng.rand() >= cfg.base_drop_prob:
                replacements.append(
                    (media.get(base_caption, cfg.embed_norm), C.REPLACEMENT_TYPE.BASE)
                )
                base_tok = C.DEFAULT_BASE_TOKEN + C.DEFAULT_VIDEO_TOKEN
            else:
                base_tok = C.DEFAULT_BASE_NULL_TOKEN
            gen_tok = ""
            modality = example.get("modality", "image")
            if modality == "image":
                gen_tok = C.DEFAULT_IM_GEN_START_TOKEN + C.DEFAULT_IM_GEN_TOKEN
            elif modality == "audio":
                gen_tok = C.DEFAULT_AUDIO_GEN_START_TOKEN + (
                    C.DEFAULT_AUDIO_GEN_TOKEN * cfg.audio_gen_len
                )
            suffix = ""
            for add in example.get("additions", []):
                replacements.append(
                    (media.get(add, cfg.embed_norm), C.REPLACEMENT_TYPE.GEN)
                )
                suffix += f"{add}:{C.DEFAULT_VIDEO_TOKEN}."
            if suffix:
                suffix = "additions:" + suffix
            text = base_tok + gen_tok + text + suffix
        turns.append({"from": turn["from"], "value": text})

    gen_target = None
    if example.get("target") is not None:
        gen_target = media.get(example["target"], cfg.embed_norm)
    return {
        "conversations": turns,
        "replacements": replacements,
        "gen_modality": example.get("modality", "image"),
        "gen_target": gen_target,
        "extra_audio": extra_audio,
    }


def build_prompt_and_labels(turns: List[dict], tokenizer, token_ids: Dict[str, int]):
    """vicuna_v1 prompt; labels mask everything except gpt responses."""
    conv = conv_templates["vicuna_v1"].copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    for t in turns:
        conv.append_message(roles[t["from"]], t["value"])
    prompt = conv.get_prompt() + conv.sep2  # terminate last gpt turn
    ids = np.asarray(tokenizer(prompt).input_ids, np.int64)
    labels = ids.copy()
    # mask human rounds: split on sep2 boundaries like the reference's
    # round-splitting (train.py:300-334); here we mask every position up
    # to and including each "ASSISTANT:" marker
    text_marker = f"{conv.roles[1]}:"
    marker_ids = tokenizer(text_marker, add_special_tokens=False)
    marker = marker_ids.input_ids if hasattr(marker_ids, "input_ids") else marker_ids
    marker = list(marker)
    n = len(marker)
    in_response = False
    i = 0
    while i < len(ids):
        if not in_response:
            labels[i] = C.IGNORE_INDEX
            if n and list(ids[i - n + 1 : i + 1]) == marker:
                in_response = True
        else:
            if ids[i] == tokenizer.eos_token_id:
                in_response = False
        i += 1
    return ids, labels


def collate(
    examples: List[Dict[str, Any]],
    tokenizer,
    token_ids: Dict[str, int],
    cfg: DataConfig,
    codec_dim: int,
) -> Dict[str, np.ndarray]:
    """→ dense arrays for llm.multimodal.train_forward. The audio
    codec dim comes from `cfg.audio_codec_dim` — the same source
    `rewrite_example` builds `extra_audio` with, so the two can never
    diverge."""
    audio_codec_dim = cfg.audio_codec_dim
    b = len(examples)
    seqs, labs = [], []
    for ex in examples:
        ids, labels = build_prompt_and_labels(ex["conversations"], tokenizer, token_ids)
        seqs.append(ids[: cfg.max_length])
        labs.append(labels[: cfg.max_length])
    s = max(len(x) for x in seqs)
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0

    input_ids = np.full((b, s), pad_id, np.int64)
    labels = np.full((b, s), C.IGNORE_INDEX, np.int64)
    attn = np.zeros((b, s), bool)
    rep_data = np.zeros((b, s, codec_dim), np.float32)
    rep_type = np.full((b, s), -1, np.int64)
    gen_t_img = np.zeros((b, s, codec_dim), np.float32)
    gen_m_img = np.zeros((b, s), bool)
    gen_t_aud = np.zeros((b, s, audio_codec_dim), np.float32)
    gen_m_aud = np.zeros((b, s), bool)
    extra_aud = np.zeros((b, cfg.audio_gen_len, audio_codec_dim), np.float32)
    any_extra_aud = False

    vid_id = token_ids[C.DEFAULT_VIDEO_TOKEN]
    im_gen_id = token_ids[C.DEFAULT_IM_GEN_TOKEN]
    aud_gen_id = token_ids[C.DEFAULT_AUDIO_GEN_TOKEN]

    for bi, (ex, ids, lab) in enumerate(zip(examples, seqs, labs)):
        n = len(ids)
        input_ids[bi, :n] = ids
        labels[bi, :n] = lab
        attn[bi, :n] = True
        vid_pos = np.where(ids == vid_id)[0]
        for j, (emb, rtype) in enumerate(ex["replacements"]):
            if j >= len(vid_pos):
                break
            p = vid_pos[j]
            rep_data[bi, p, : len(emb)] = emb[:codec_dim]
            rep_type[bi, p] = rtype
        if ex["gen_target"] is not None:
            tgt = ex["gen_target"]
            if ex["gen_modality"] == "image":
                for p in np.where(ids == im_gen_id)[0]:
                    gen_t_img[bi, p, : len(tgt)] = tgt[:codec_dim]
                    gen_m_img[bi, p] = True
            else:
                frames = np.asarray(tgt, np.float32).reshape(-1)
                frames = np.resize(frames, (cfg.audio_gen_len, audio_codec_dim))
                for k, p in enumerate(np.where(ids == aud_gen_id)[0]):
                    gen_t_aud[bi, p] = frames[min(k, cfg.audio_gen_len - 1)]
                    gen_m_aud[bi, p] = True
        if ex.get("extra_audio") is not None:
            extra_aud[bi] = np.asarray(ex["extra_audio"], np.float32)[
                : cfg.audio_gen_len, :audio_codec_dim
            ]
            any_extra_aud = True
        # gen tokens are splice targets, not CE targets
        labels[bi][input_ids[bi] == im_gen_id] = C.IGNORE_INDEX
        labels[bi][input_ids[bi] == aud_gen_id] = C.IGNORE_INDEX

    out = {
        "input_ids": input_ids,
        "labels": labels,
        "attention_mask": attn,
        "replacement_data": rep_data,
        "replacement_type": rep_type,
        "gen_target_image": gen_t_img,
        "gen_mask_image": gen_m_img,
        "gen_target_audio": gen_t_aud,
        "gen_mask_audio": gen_m_aud,
    }
    if any_extra_aud:
        out["extra_audio_frames"] = extra_aud
    return out


class InstructionDataset:
    """Lazy instruction dataset with length/modality grouping hooks; each
    item is rewritten with the dataset's own numpy RandomState, in access
    order."""

    def __init__(
        self,
        data_path: str,
        media_map: MediaMap,
        tokenizer,
        token_ids: Dict[str, int],
        cfg: DataConfig = DataConfig(),
        seed: int = 0,
    ):
        with open(data_path) as f:
            self.records = json.load(f)
        self.media = media_map
        self.tokenizer = tokenizer
        self.token_ids = token_ids
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return rewrite_example(self.records[idx], self.media, self.cfg, self.rng)

    @property
    def lengths(self) -> List[int]:
        """Token-count estimates for length-grouped sampling."""
        return [
            sum(len(t["value"].split()) for t in r["conversations"])
            for r in self.records
        ]

    @property
    def modality_lengths(self) -> List[int]:
        """Positive for image-target examples, negative for audio (the
        modality-grouping convention)."""
        out = []
        for r, l in zip(self.records, self.lengths):
            out.append(l if r.get("modality", "image") == "image" else -l)
        return out


def length_grouped_indices(
    lengths: List[int], batch_size: int, rng: np.random.RandomState
) -> np.ndarray:
    """Length-grouped order with modality grouping: shuffle, chunk into
    megabatches, sort each by |length| keeping same-sign (same-modality)
    examples adjacent."""
    idx = rng.permutation(len(lengths))
    mega = 50 * batch_size
    out = []
    for i in range(0, len(idx), mega):
        chunk = idx[i : i + mega]
        chunk = sorted(chunk, key=lambda j: (np.sign(lengths[j]) < 0, -abs(lengths[j])))
        out.extend(chunk)
    return np.asarray(out)
