"""Tokenizer loading + special-token registration.

The reference loads the Vicuna tokenizer from a `tokenizer` subfolder
and registers 9 generation tokens, caching their ids on the model
(reference pipeline.py:22-37, llm/model/any2pix_arch.py:240-299).

Two backends:
  * HF fast tokenizer (tokenizer.json) when a real checkpoint is on
    disk.
  * `ByteTokenizer` — a deterministic byte-level fallback with the same
    special-token semantics, used for tests and checkpoint-free runs
    (this environment ships no model weights or sentencepiece).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Sequence

from .constants import SPECIAL_GEN_TOKENS


class ByteTokenizer:
    """Byte-level tokenizer with Llama-style ids 0..2 reserved.

    ids: 0 <unk>, 1 <s>, 2 </s>, 3..258 bytes, then special tokens in
    registration order.
    """

    def __init__(self):
        self.unk_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.pad_token_id = 0
        self.eos_token = "</s>"
        self._byte_offset = 3
        self._specials: Dict[str, int] = {}
        self._special_pattern = None

    @property
    def vocab_size(self) -> int:
        return self._byte_offset + 256 + len(self._specials)

    def __len__(self) -> int:
        return self.vocab_size

    def add_tokens(self, tokens: Sequence[str], special_tokens: bool = True) -> int:
        added = 0
        for t in tokens:
            if t not in self._specials:
                self._specials[t] = self.vocab_size
                added += 1
        pat = "|".join(re.escape(t) for t in sorted(self._specials, key=len, reverse=True))
        self._special_pattern = re.compile(f"({pat})") if pat else None
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self._specials:
            return self._specials[token]
        if token == "</s>":
            return self.eos_token_id
        if token == "<s>":
            return self.bos_token_id
        b = token.encode()
        return self._byte_offset + b[0] if len(b) == 1 else self.unk_token_id

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = [self.bos_token_id] if add_special_tokens else []
        chunks = self._special_pattern.split(text) if self._special_pattern else [text]
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self._specials:
                ids.append(self._specials[chunk])
            elif chunk == "</s>":
                ids.append(self.eos_token_id)
            else:
                ids.extend(self._byte_offset + b for b in chunk.encode())
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True, **kw):
        class _Out:
            pass

        o = _Out()
        o.input_ids = self.encode(text, add_special_tokens)
        return o

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        rev = {v: k for k, v in self._specials.items()}
        out: List[str] = []
        buf = bytearray()

        def flush():
            if buf:
                out.append(buf.decode(errors="replace"))
                buf.clear()

        for i in ids:
            i = int(i)
            if self._byte_offset <= i < self._byte_offset + 256:
                buf.append(i - self._byte_offset)
            else:
                flush()
                if i in rev:
                    if not skip_special_tokens:
                        out.append(rev[i])
                elif i == self.eos_token_id and not skip_special_tokens:
                    out.append("</s>")
                elif i == self.bos_token_id and not skip_special_tokens:
                    out.append("<s>")
        flush()
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = False):
        return [self.decode(ids, skip_special_tokens) for ids in batch]


def load_tokenizer(path: str | None = None):
    """The HF fast tokenizer of a checkpoint's tokenizer directory, else
    (no directory) the ByteTokenizer. A directory that is there but cannot
    be read raises: byte ids would mean nothing to the trained LLM."""
    if not (path and os.path.isdir(path)):
        return ByteTokenizer()
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"{path} holds the LLM's tokenizer, and reading it needs the `transformers` "
            "package, which is not installed") from e
    return AutoTokenizer.from_pretrained(path, use_fast=True)


def initialize_vision_tokenizer(tokenizer) -> Dict[str, int]:
    """Register the 9 generation tokens and return their ids — the
    `DEFAULT_*_IDX` cache of reference any2pix_arch.py:290-298."""
    tokenizer.add_tokens(list(SPECIAL_GEN_TOKENS), special_tokens=True)
    return {t: tokenizer.convert_tokens_to_ids(t) for t in SPECIAL_GEN_TOKENS}
