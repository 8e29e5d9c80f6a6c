"""BERT wordpiece tokenizer for GroundingDINO captions.

The reference encodes grounding captions with HF's bert-base-uncased
tokenizer (reference gdino/lib.py:74-81 via the groundingdino package's
`get_tokenlizer`). This is a dependency-free reimplementation of the
same algorithm — BasicTokenizer (lowercase, NFD accent strip,
punctuation split, CJK spacing) followed by greedy longest-match
wordpiece — loading a standard `vocab.txt`. Parity-tested token-id by
token-id against `transformers.BertTokenizer` built from the same vocab
file (tests/test_gdino_parity.py).

A copy of the JAX package's `grounding/bert_tokenizer.py` (pure Python),
so the port imports nothing of that package. `gdino.make_grounder` takes
it as its `tokenizer`.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass
from typing import Dict, List


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            vocab[tok] = i
    return vocab


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even when unicode doesn't
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    # clean: drop control chars / NUL / U+FFFD, normalize whitespace
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        cleaned.append(" " if _is_whitespace(ch) else ch)
    text = "".join(cleaned)
    # CJK chars become standalone tokens
    spaced = []
    for ch in text:
        if _is_cjk(ord(ch)):
            spaced.append(f" {ch} ")
        else:
            spaced.append(ch)
    tokens: List[str] = []
    for word in "".join(spaced).split():
        if lowercase:
            word = word.lower()
            word = "".join(
                c for c in unicodedata.normalize("NFD", word)
                if unicodedata.category(c) != "Mn"
            )
        # split on punctuation
        cur: List[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


def wordpiece(token: str, vocab: Dict[str, int], unk: str = "[UNK]",
              max_chars: int = 100) -> List[str]:
    if len(token) > max_chars:
        return [unk]
    out: List[str] = []
    start = 0
    while start < len(token):
        end = len(token)
        piece = None
        while start < end:
            sub = token[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                piece = sub
                break
            end -= 1
        if piece is None:
            return [unk]
        out.append(piece)
        start = end
    return out


@dataclass
class Encoding:
    input_ids: List[int]
    tokens: List[str]


class BertWordpieceTokenizer:
    """Callable with the subset of the HF tokenizer interface that
    `gdino.make_grounder` uses: `tok(text).input_ids` and
    `tok.convert_ids_to_tokens(ids)`."""

    def __init__(self, vocab_path: str, lowercase: bool = True):
        self.vocab = load_vocab(vocab_path)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.unk_id = self.vocab["[UNK]"]

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for tok in basic_tokenize(text, self.lowercase):
            pieces.extend(wordpiece(tok, self.vocab))
        return pieces

    def __call__(self, text: str) -> Encoding:
        toks = ["[CLS]"] + self.tokenize(text) + ["[SEP]"]
        ids = [self.vocab.get(t, self.unk_id) for t in toks]
        return Encoding(input_ids=ids, tokens=toks)

    def convert_ids_to_tokens(self, ids) -> List[str]:
        return [self.ids_to_tokens.get(int(i), "[UNK]") for i in ids]
