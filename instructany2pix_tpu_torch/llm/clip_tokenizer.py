"""CLIP byte-pair-encoding tokenizer (pure Python, offline).

The reference feeds prompts to three CLIP text encoders — SDXL's two
(diffusers `tokenizer`/`tokenizer_2`) and the prior's CLIP-ViT-H
conditioner (reference prior/model.py:29-44) — all of which use the
OpenAI CLIP BPE scheme: lowercase + whitespace normalisation, word-level
regex split, byte→unicode remap, BPE merges with `</w>` end-of-word
markers, and `<|startoftext|>`/`<|endoftext|>` wrapping.

This implementation matches `transformers.CLIPTokenizer` in this
environment (where `ftfy` is absent, transformers normalises through its
BERT BasicTokenizer with `strip_accents=False, do_split_on_punc=False`;
we mirror that path exactly — see tests/test_clip_tokenizer.py for the
id-level parity check). Vocab/merges are data, not code: they load from
a checkpoint directory (`vocab.json` + `merges.txt`, the HF layout) at
runtime; no vocabulary is vendored.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple


@functools.lru_cache(maxsize=1)
def _word_pat():
    """The CLIP word-split pattern. `regex` (for \\p{L}/\\p{N}) is only
    needed once a vocab is on disk, so it is imported here rather than at
    module top: checkpoint-free runs never load it."""
    import regex

    return regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        regex.IGNORECASE,
    )


BOS = "<|startoftext|>"
EOS = "<|endoftext|>"


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte→printable-unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


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


def basic_clean(text: str) -> str:
    """The no-ftfy normalisation transformers' CLIPTokenizer applies:
    control-char strip, CJK spacing, NFC, whitespace split+rejoin,
    per-token lowercase (accents preserved)."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        elif _is_whitespace(ch):
            out.append(" ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


class CLIPBPETokenizer:
    """Minimal-surface CLIP tokenizer: encode/decode/pad to 77."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        pad_token: str = EOS,
        max_positions: int = 77,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = self.encoder[BOS]
        self.eos_token_id = self.encoder[EOS]
        self.unk_token_id = self.encoder[EOS]
        self.pad_token_id = self.encoder.get(pad_token, self.eos_token_id)
        self.max_positions = max_positions
        self.eos_token = EOS
        self._cache: Dict[str, str] = {BOS: BOS, EOS: EOS}

    # ---------------------------------------------------------- loading

    @classmethod
    def from_dir(cls, path: str, **kw) -> "CLIPBPETokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            # same slice transformers uses: drop the header line, cap at
            # the 49152-256-2 learned merges of the CLIP release
            lines = f.read().strip().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines]
        # SDXL's tokenizer_2 (OpenCLIP bigG) pads with "!" (id 0); the
        # HF layout records that in special_tokens_map/tokenizer_config
        pad = EOS
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            pt = cfg.get("pad_token")
            if isinstance(pt, dict):
                pt = pt.get("content")
            if isinstance(pt, str):
                pad = pt
        kw.setdefault("pad_token", pad)
        return cls(vocab, merges, **kw)

    # ------------------------------------------------------------- BPE

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        text = basic_clean(text)
        toks: List[str] = []
        for tok in _word_pat().findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            toks.extend(self._bpe(mapped).split(" "))
        return toks

    # ------------------------------------------------------- public API

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.encoder.get(t, self.unk_token_id) for t in self.tokenize(text)]
        if add_special_tokens:
            return [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    def encode_padded(self, text: str, length: Optional[int] = None) -> List[int]:
        """bos + tokens (truncated) + eos, padded to `length` — the
        sequence diffusers feeds SDXL text encoders
        (`padding="max_length", truncation=True, max_length=77`)."""
        length = length or self.max_positions
        body = self.encode(text, add_special_tokens=False)[: length - 2]
        ids = [self.bos_token_id] + body + [self.eos_token_id]
        return ids + [self.pad_token_id] * (length - len(ids))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        specials = {self.bos_token_id, self.eos_token_id, self.pad_token_id}
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in specials:
                continue
            toks.append(self.decoder.get(i, ""))
        text = "".join(toks)
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, text: str, **kw):
        class _Out:
            pass

        o = _Out()
        o.input_ids = self.encode(text)
        return o

    def __len__(self) -> int:
        return len(self.encoder)


def load_clip_tokenizer(path: Optional[str], **kw) -> Optional[CLIPBPETokenizer]:
    """CLIP tokenizer from an HF-layout dir, or None when absent (the
    checkpoint-free tiny path keeps the byte-tokenizer fallback)."""
    if path and os.path.isfile(os.path.join(path, "vocab.json")) and os.path.isfile(
        os.path.join(path, "merges.txt")
    ):
        return CLIPBPETokenizer.from_dir(path, **kw)
    return None


def make_tiny_clip_vocab(words: Sequence[str] = ()) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Deterministic miniature CLIP-style vocab/merges for tests: the
    full byte alphabet (plain + `</w>` forms) plus greedy 2-char merges
    derived from `words` — structurally identical to the real release
    (byte symbols first, then merged symbols, then BOS/EOS)."""
    btu = bytes_to_unicode()
    alphabet = [btu[b] for b in range(256)]
    vocab: Dict[str, int] = {}
    for ch in alphabet:
        vocab[ch] = len(vocab)
    for ch in alphabet:
        vocab[ch + "</w>"] = len(vocab)
    merges: List[Tuple[str, str]] = []
    for w in words:
        sym = [btu[b] for b in w.encode("utf-8")]
        if not sym:
            continue
        sym[-1] += "</w>"
        while len(sym) > 1:
            pair = (sym[0], sym[1])
            if pair not in merges:
                merges.append(pair)
            joined = pair[0] + pair[1]
            if joined not in vocab:
                vocab[joined] = len(vocab)
            sym = [joined] + sym[2:]
    vocab[BOS] = len(vocab)
    vocab[EOS] = len(vocab)
    return vocab, merges
