"""Multimodal tokenization and stopping helpers, a copy of the JAX
package's `llm/mm_utils.py` (pure Python and numpy):
`tokenizer_image_token` splices IMAGE_TOKEN_INDEX (-200) at each
`<image>`; `KeywordsStoppingCriteria` stops when the output ends in a
keyword's tokens or its text holds the keyword; `expand2square` and
`process_images` are the LLaVA-style image preprocessors.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..codecs.image_io import resize_center_crop
from .constants import IMAGE_TOKEN_INDEX


def tokenizer_image_token(prompt: str, tokenizer, image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> np.ndarray:
    """Tokenize, replacing each `<image>` with the sentinel index."""
    chunks = [tokenizer(c).input_ids if c else [] for c in prompt.split("<image>")]
    ids: List[int] = []
    for i, chunk in enumerate(chunks):
        chunk = list(chunk)
        if i > 0:
            # the BOS the tokenizer adds again mid-string is dropped
            if chunk and chunk[0] == getattr(tokenizer, "bos_token_id", 1):
                chunk = chunk[1:]
            ids.append(image_token_index)
        ids.extend(chunk)
    return np.asarray(ids, np.int64)


class KeywordsStoppingCriteria:
    """Host-side stop check over generated ids: the output's tail matches a
    keyword's token ids, or its decoded text contains the keyword."""

    def __init__(self, keywords: Sequence[str], tokenizer, input_len: int = 0):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.input_len = input_len
        self.keyword_ids = []
        for kw in keywords:
            ids = tokenizer(kw, add_special_tokens=False)
            ids = list(ids.input_ids if hasattr(ids, "input_ids") else ids)
            if ids and ids[0] == getattr(tokenizer, "bos_token_id", None):
                ids = ids[1:]
            self.keyword_ids.append(ids)

    def __call__(self, output_ids: Sequence[int]) -> bool:
        out = list(output_ids)[self.input_len:]
        for kw_ids in self.keyword_ids:
            if kw_ids and out[-len(kw_ids):] == kw_ids:
                return True
        text = self.tokenizer.decode(out)
        return any(kw in text for kw in self.keywords)


def expand2square(img: np.ndarray, background_color=(122, 116, 104)) -> np.ndarray:
    """Pad to a square of the background color, the image centred."""
    h, w = img.shape[:2]
    if h == w:
        return img
    size = max(h, w)
    out = np.empty((size, size, 3), img.dtype)
    out[...] = np.asarray(background_color, img.dtype)
    top, left = (size - h) // 2, (size - w) // 2
    out[top:top + h, left:left + w] = img
    return out


def process_images(images: Sequence[np.ndarray], image_size: int = 224) -> np.ndarray:
    """Square-pad, then resize and centre-crop each image → (B, S, S, 3) float32."""
    out = [resize_center_crop(expand2square(np.asarray(im)), image_size) for im in images]
    return np.stack(out).astype(np.float32)
