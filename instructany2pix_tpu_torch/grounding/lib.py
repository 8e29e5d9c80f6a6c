"""Grounding and subject consistency: counterpart of the JAX package's
`grounding/lib.py`.

Phrase-grounded boxes (GroundingDINO) → SAM masks → per-subject
IP-Adapter local-mode inpainting. `build_segmentator` loads both models
from their `.pth` files; the grounder and segmentor are callables, so the
checkpoint-free fallbacks stand in for the models where no files are:
  grounder(image, caption, box_threshold, text_threshold)
      -> (boxes (N, 4) cxcywh in [0, 1], logits (N,), phrases [N str])
  segmentor(image, box_xyxy) -> mask (H, W) float in [0, 1]
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .morphology import refine_mask

BOX_THRESHOLD = 0.35
TEXT_THRESHOLD = 0.25


def boxes_cxcywh_to_xyxy(boxes: np.ndarray, h: int, w: int) -> np.ndarray:
    cx, cy, bw, bh = np.asarray(boxes).T
    return np.stack(
        [(cx - bw / 2) * w, (cy - bh / 2) * h, (cx + bw / 2) * w, (cy + bh / 2) * h], axis=1
    )


def match_phrase_to_box(phrases: Sequence[str], target: str) -> Optional[int]:
    """Exact phrase match first, then substring either way."""
    target = target.strip().lower()
    for i, p in enumerate(phrases):
        if p.strip().lower() == target:
            return i
    for i, p in enumerate(phrases):
        if target in p.strip().lower() or p.strip().lower() in target:
            return i
    return None


def get_mask(phrase: str, boxes: np.ndarray, phrases: Sequence[str], segmentor: Callable,
             image: np.ndarray, dilate_size: int = 40, erode_size: int = 10,
             blur_size: int = 21, device=None) -> Optional[np.ndarray]:
    """phrase → box → segmentor mask → erode/dilate/blur on `device` (the
    CPU when None). Returns an (H, W) float32 mask, or None when no box
    matches the phrase."""
    idx = match_phrase_to_box(phrases, phrase)
    if idx is None or len(boxes) == 0:
        return None
    h, w = image.shape[:2]
    box = boxes_cxcywh_to_xyxy(boxes[idx: idx + 1], h, w)[0]
    mask = torch.as_tensor(np.asarray(segmentor(image, box), np.float32), device=device)
    return refine_mask(mask, dilate_size, erode_size, blur_size).cpu().numpy()


def subject_consistency(
    subject_data: List[dict],  # [{"name": str, "embed": (D,) array}, ...]
    caption: str,
    image: np.ndarray,  # (H, W, 3) uint8, the current edit
    segmentor: Callable,
    grounder: Callable,
    inpaint_fn: Callable,  # (image, mask, subject_embed, prompt) -> image
    strength: float = 0.7,
    device=None,
) -> Tuple[np.ndarray, dict]:
    """Ground every subject phrase at once, then inpaint each subject's
    region conditioned on its embedding."""
    text = " . ".join(s["name"] for s in subject_data)
    boxes, logits, phrases = grounder(
        image, text, box_threshold=BOX_THRESHOLD, text_threshold=TEXT_THRESHOLD
    )
    annotations = {"boxes": boxes, "logits": logits, "phrases": phrases}
    out = image
    for subject in subject_data:
        mask = get_mask(subject["name"], boxes, phrases, segmentor, out, device=device)
        if mask is None:
            continue
        out = inpaint_fn(out, mask, subject["embed"], caption)
    return out, annotations


def cosine_fallback_grounder(embed_fn: Optional[Callable]):
    """Checkpoint-free grounder: one whole-image box per phrase (subject
    consistency then inpaints the whole image)."""

    def grounder(image, caption, box_threshold=0.35, text_threshold=0.25):
        phrases = [p.strip() for p in caption.split(".") if p.strip()]
        n = len(phrases)
        boxes = np.tile(np.asarray([[0.5, 0.5, 1.0, 1.0]], np.float32), (n, 1))
        return boxes, np.ones((n,), np.float32), phrases

    return grounder


def box_fill_segmentor(image: np.ndarray, box_xyxy: np.ndarray) -> np.ndarray:
    """Checkpoint-free segmentor: the box, filled."""
    h, w = image.shape[:2]
    x0, y0, x1, y1 = [int(round(v)) for v in box_xyxy]
    mask = np.zeros((h, w), np.float32)
    mask[max(y0, 0): min(y1, h), max(x0, 0): min(x1, w)] = 1.0
    return mask


def _load_bert_tokenizer(ckpt_dir: str):
    """The caption tokenizer for a real `gdino.pth`: the wordpiece vocab
    `vocab.txt` beside it. Without it the hash tokenizer would give ids the
    trained text encoder does not know, so a missing vocab raises."""
    vocab_path = os.path.join(ckpt_dir, "vocab.txt")
    if not os.path.exists(vocab_path):
        raise FileNotFoundError(
            f"GroundingDINO checkpoint found but no BERT vocab at {vocab_path}; copy "
            "bert-base-uncased's vocab.txt next to gdino.pth (grounding captions must be "
            "wordpiece-encoded for the trained text encoder)")
    from .bert_tokenizer import BertWordpieceTokenizer

    return BertWordpieceTokenizer(vocab_path)


def build_segmentator(ckpt_dir: str = "ckpts/gdino", sam_cfg=None, dino_cfg=None, device=None,
                      times=None):
    """(segmentor, grounder) for a checkpoint directory. With
    `sam_vit_h_4b8939.pth` and `gdino.pth` there: SAM (`sam_cfg`, ViT-H by
    default) in bf16, so its encoder blocks go to K3 on the card, and
    GroundingDINO (`dino_cfg`, Swin-T by default) in float32 with the
    wordpiece captions of `vocab.txt`, both on `device` (the card unless
    the caller asks for the CPU). Without them: the box-fill segmentor and
    the whole-image grounder. `times` accumulates load seconds as
    `loaders` does."""
    sam_path = os.path.join(ckpt_dir, "sam_vit_h_4b8939.pth")
    dino_path = os.path.join(ckpt_dir, "gdino.pth")
    if not (os.path.exists(sam_path) and os.path.exists(dino_path)):
        return box_fill_segmentor, cosine_fallback_grounder(None)
    from .. import loaders
    from ..core.device import resolve_device
    from . import gdino as gdino_lib
    from . import sam as sam_lib

    device = resolve_device(device)
    tokenizer = _load_bert_tokenizer(ckpt_dir)
    sam_cfg = sam_cfg or sam_lib.SAMConfig.vit_h()
    dino_cfg = dino_cfg or gdino_lib.GDinoConfig.swint()
    sam_t = sam_lib.keymap(sam_cfg).to_port(loaders.read(sam_path, times), what=sam_path)
    sam = loaders.build(lambda: sam_lib.SAM(sam_cfg), sam_t, device, torch.bfloat16, sam_path,
                        times)
    dino_t = gdino_lib.keymap(dino_cfg).to_port(loaders.read(dino_path, times), what=dino_path)
    dino = loaders.build(lambda: gdino_lib.GDino(dino_cfg), dino_t, device, torch.float32,
                         dino_path, times)
    return (sam_lib.make_segmentor(sam, sam_cfg),
            gdino_lib.make_grounder(dino, dino_cfg, tokenizer=tokenizer))
