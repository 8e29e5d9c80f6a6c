"""Tokenizer loading + special-token registration.

The reference loads the Vicuna tokenizer from a `tokenizer` subfolder
and registers 9 generation tokens, caching their ids on the model
(reference pipeline.py:22-37, llm/model/any2pix_arch.py:240-299).

Two backends:
  * `JsonTokenizer` — a reader of HF's `tokenizer.json` (the file a fast
    tokenizer saves) with no `transformers` or `tokenizers` import, when
    a checkpoint's tokenizer directory is on disk. It covers Llama's
    SentencePiece BPE (byte fallback, `Prepend("▁")` + `Replace(" ", "▁")`
    normalizer, `Replace`/`ByteFallback`/`Fuse`/`Strip` decoder) and
    WordLevel over the `Whitespace` pre-tokenizer; any other component
    raises and names itself rather than give other ids.
  * `ByteTokenizer` — a deterministic byte-level fallback with the same
    special-token semantics, used for tests and checkpoint-free runs.
"""

from __future__ import annotations

import json
import os
import re
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

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


# ------------------------------------------------------ tokenizer.json


# transformers' `clean_up_tokenization` (applied when the tokenizer's
# config sets `clean_up_tokenization_spaces`)
_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
            (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))
_BYTE_PIECE = re.compile(r"<0x([0-9A-Fa-f]{2})>")


def _string_pattern(pattern: dict) -> str:
    if set(pattern) != {"String"}:
        raise NotImplementedError(f"tokenizer.json: a Replace pattern {pattern} (only String)")
    return pattern["String"]


def _normalizer_steps(spec: Optional[dict]) -> List[Tuple[str, str, str]]:
    """("prepend", p, "") and ("replace", a, b) steps of a normalizer."""
    if spec is None:
        return []
    kind = spec["type"]
    if kind == "Sequence":
        return [st for sub in spec["normalizers"] for st in _normalizer_steps(sub)]
    if kind == "Prepend":
        return [("prepend", spec["prepend"], "")]
    if kind == "Replace":
        return [("replace", _string_pattern(spec["pattern"]), spec["content"])]
    raise NotImplementedError(f"tokenizer.json: normalizer {kind} is not read")


def _decoder_steps(spec: Optional[dict]) -> List[dict]:
    if spec is None:
        return []
    if spec["type"] == "Sequence":
        return [st for sub in spec["decoders"] for st in _decoder_steps(sub)]
    if spec["type"] not in ("Replace", "ByteFallback", "Fuse", "Strip"):
        raise NotImplementedError(f"tokenizer.json: decoder {spec['type']} is not read")
    return [spec]


def _byte_fallback(tokens: List[str]) -> List[str]:
    """Runs of `<0xNN>` pieces → their UTF-8 text, one U+FFFD per byte when
    a run is not valid UTF-8 (tokenizers' ByteFallback decoder)."""
    out: List[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(run))
            run.clear()

    for tok in tokens:
        m = _BYTE_PIECE.fullmatch(tok) if len(tok) == 6 else None
        if m:
            run.append(int(m.group(1), 16))
        else:
            flush()
            out.append(tok)
    flush()
    return out


def _strip(tok: str, content: str, start: int, stop: int) -> str:
    a, b = 0, len(tok)
    while a < min(start, len(tok)) and tok[a] == content:
        a += 1
    n = 0
    while n < stop and b > a and tok[b - 1] == content:
        b -= 1
        n += 1
    return tok[a:b]


def _token_content(tok) -> Optional[str]:
    """A special token of tokenizer_config.json: a string or {"content": ...}."""
    return tok.get("content") if isinstance(tok, dict) else tok


class JsonTokenizer:
    """Encode and decode as HF's fast tokenizer does from the same
    `tokenizer.json` and `tokenizer_config.json`.

    Encoding: added tokens (the file's `added_tokens` and `add_tokens`)
    split the text first, leftmost-longest; each remaining piece is
    normalized and tokenized on its own (so Llama's `Prepend("▁")` starts
    every piece with "▁", as in `tokenizers`). BPE pieces start as single
    characters, a character outside the vocabulary becomes its UTF-8 byte
    pieces `<0xNN>` (byte fallback) or `<unk>` (fused), and the pair of
    lowest merge rank, leftmost first, is merged until none is left.
    `LlamaTokenizerFast` adds BOS (and EOS) per `add_bos_token`
    (`add_eos_token`); other classes apply the file's `TemplateProcessing`.
    """

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = config or {}
        model = spec["model"]
        kind = model.get("type") or ("BPE" if "merges" in model else "WordLevel")
        if kind not in ("BPE", "WordLevel"):
            raise NotImplementedError(f"tokenizer.json: model {kind} is not read")
        self._kind = kind
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self._id_to_piece = {i: t for t, i in self.vocab.items()}
        unk = model.get("unk_token")
        self._unk_id = self.vocab.get(unk) if unk is not None else None
        if kind == "BPE":
            for key in ("continuing_subword_prefix", "end_of_word_suffix"):
                if model.get(key):
                    raise NotImplementedError(f"tokenizer.json: BPE {key} is not read")
            if model.get("dropout"):
                raise NotImplementedError("tokenizer.json: BPE dropout is not read")
            self._byte_fallback = bool(model.get("byte_fallback"))
            self._fuse_unk = bool(model.get("fuse_unk"))
            self._ignore_merges = bool(model.get("ignore_merges"))
            self._merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
            for rank, m in enumerate(model["merges"]):
                a, b = m.split(" ", 1) if isinstance(m, str) else m
                self._merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self._normalize = _normalizer_steps(spec.get("normalizer"))
        pre = spec.get("pre_tokenizer")
        if pre is not None and pre["type"] != "Whitespace":
            raise NotImplementedError(f"tokenizer.json: pre-tokenizer {pre['type']} is not read")
        self._whitespace = pre is not None
        self._decoders = _decoder_steps(spec.get("decoder"))

        # added tokens: content → id; normalized ones match after normalization
        self._added: Dict[str, int] = {}
        self._added_normalized: Dict[str, bool] = {}
        self._strips: Dict[str, Tuple[bool, bool]] = {}
        self._special: set = set()
        self._added_ids: Dict[int, str] = {}
        for a in spec.get("added_tokens", []):
            if a.get("single_word"):
                raise NotImplementedError(f"tokenizer.json: single_word added token {a['content']!r}")
            self._register(a["content"], a["id"], bool(a.get("special")),
                           bool(a.get("normalized")), bool(a.get("lstrip")), bool(a.get("rstrip")))

        self.bos_token = _token_content(config.get("bos_token"))
        self.eos_token = _token_content(config.get("eos_token"))
        self.unk_token = _token_content(config.get("unk_token", unk))
        self.pad_token = _token_content(config.get("pad_token"))
        self.bos_token_id = self._lookup(self.bos_token)
        self.eos_token_id = self._lookup(self.eos_token)
        self.unk_token_id = self._lookup(self.unk_token)
        self.pad_token_id = self._lookup(self.pad_token)
        self._cleanup = bool(config.get("clean_up_tokenization_spaces", False))
        # the ids a single sequence is wrapped in
        if config.get("tokenizer_class") in ("LlamaTokenizerFast", "LlamaTokenizer"):
            add_bos, add_eos = config.get("add_bos_token", True), config.get("add_eos_token", False)
            self._prefix = [self.bos_token_id] if add_bos and self.bos_token_id is not None else []
            self._suffix = [self.eos_token_id] if add_eos and self.eos_token_id is not None else []
        else:
            self._prefix, self._suffix = self._template(spec.get("post_processor"))

    @classmethod
    def from_dir(cls, path: str) -> "JsonTokenizer":
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config: dict = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            p = os.path.join(path, name)
            if os.path.isfile(p):
                with open(p, encoding="utf-8") as f:
                    config.update(json.load(f))
        return cls(spec, config)

    def _template(self, spec: Optional[dict]) -> Tuple[List[int], List[int]]:
        if spec is None:
            return [], []
        if spec["type"] != "TemplateProcessing":
            raise NotImplementedError(f"tokenizer.json: post-processor {spec['type']} is not read")
        prefix: List[int] = []
        suffix: List[int] = []
        seen_a = False
        for item in spec["single"]:
            if "Sequence" in item:
                seen_a = True
                continue
            ids = spec["special_tokens"][item["SpecialToken"]["id"]]["ids"]
            (suffix if seen_a else prefix).extend(ids)
        return prefix, suffix

    def _register(self, content: str, idx: int, special: bool, normalized: bool,
                  lstrip: bool = False, rstrip: bool = False):
        self._added[content] = idx
        self._added_normalized[content] = normalized
        self._strips[content] = (lstrip, rstrip)
        if special:
            self._special.add(content)
        self._added_ids[idx] = content
        self._pattern_cache: dict = {}

    def _lookup(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        return self._added.get(token, self.vocab.get(token))

    # ---------------------------------------------------------- interface

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def __len__(self) -> int:
        return len(set(self.vocab) | set(self._added))

    def add_tokens(self, tokens: Sequence[str], special_tokens: bool = False) -> int:
        """Register added tokens (transformers' `add_tokens`): special ones
        match before normalization and are skipped by
        `decode(skip_special_tokens=True)`. New ids follow the largest."""
        added = 0
        for t in tokens:
            if t in self._added:
                if special_tokens:
                    self._special.add(t)
                continue
            idx = self.vocab.get(t)
            if idx is None:
                top = max(self._added.values(), default=-1)
                idx = top + 1 if top >= len(self.vocab) else len(self.vocab)
                added += 1
            self._register(t, idx, special_tokens, normalized=not special_tokens)
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        idx = self._lookup(token)
        return self.unk_token_id if idx is None else idx

    def convert_ids_to_tokens(self, ids) -> List[str]:
        return [self._id_to_piece.get(int(i)) for i in ids]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        for piece, is_added in self._split(text, normalized=False):
            if is_added:
                ids.append(self._added[piece])
                continue
            for sub, sub_added in self._split(self._normalized(piece), normalized=True):
                ids.extend([self._added[sub]] if sub_added else self._model(sub))
        return self._prefix + ids + self._suffix if add_special_tokens else ids

    def __call__(self, text: str, add_special_tokens: bool = True, **kw):
        return SimpleNamespace(input_ids=self.encode(text, add_special_tokens))

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        if hasattr(ids, "tolist"):
            ids = ids.tolist()
        tokens = []
        for i in ids:
            tok = self._added_ids.get(int(i), self._id_to_piece.get(int(i)))
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            tokens.append(tok)
        for st in self._decoders:
            kind = st["type"]
            if kind == "Replace":
                pat = _string_pattern(st["pattern"])
                tokens = [t.replace(pat, st["content"]) for t in tokens]
            elif kind == "ByteFallback":
                tokens = _byte_fallback(tokens)
            elif kind == "Fuse":
                tokens = ["".join(tokens)]
            else:
                tokens = [_strip(t, st["content"], st["start"], st["stop"]) for t in tokens]
        # without a decoder, tokenizers joins the tokens with spaces
        text = "".join(tokens) if self._decoders else " ".join(tokens)
        if self._cleanup:
            for a, b in _CLEANUP:
                text = text.replace(a, b)
        return text

    def batch_decode(self, batch, skip_special_tokens: bool = False) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    # ---------------------------------------------------------- internals

    def _pattern(self, normalized: bool):
        if normalized not in self._pattern_cache:
            toks = [t for t in self._added if self._added_normalized[t] == normalized]
            toks.sort(key=len, reverse=True)  # longest first: leftmost-longest
            alts = []
            for t in toks:  # one group per token: `lastindex` names the match
                lstrip, rstrip = self._strips[t]
                alts.append((r"\s*" if lstrip else "") + f"({re.escape(t)})"
                            + (r"\s*" if rstrip else ""))
            self._pattern_cache[normalized] = (re.compile("|".join(alts)), toks) if alts else None
        return self._pattern_cache[normalized]

    def _split(self, text: str, normalized: bool):
        """(piece, is_added_token) in order; empty pieces dropped."""
        found = self._pattern(normalized)
        if found is None:
            return [(text, False)] if text else []
        pat, toks = found
        out, pos = [], 0
        for m in pat.finditer(text):
            if m.start() > pos:
                out.append((text[pos:m.start()], False))
            out.append((toks[m.lastindex - 1], True))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], False))
        return out

    def _normalized(self, text: str) -> str:
        for kind, a, b in self._normalize:
            if kind == "prepend":
                text = a + text if text else text
            else:
                text = text.replace(a, b)
        return text

    def _model(self, text: str) -> List[int]:
        words = re.findall(r"\w+|[^\w\s]+", text) if self._whitespace else [text]
        ids: List[int] = []
        for w in words:
            if self._kind == "WordLevel":
                idx = self.vocab.get(w, self._unk_id)
                if idx is None:
                    raise ValueError(f"{w!r} is not in the vocabulary and there is no unk token")
                ids.append(idx)
            else:
                ids.extend(self._bpe(w))
        return ids

    def _bpe(self, word: str) -> List[int]:
        if not word:
            return []
        if self._ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms: List[int] = []
        unk = None  # a pending (fused) unk
        for ch in word:
            idx = self.vocab.get(ch)
            if idx is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(idx)
                continue
            if self._byte_fallback:
                pieces = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(p is not None for p in pieces):
                    syms.extend(pieces)
                    continue
            if self._unk_id is None:
                raise ValueError(f"{ch!r} is not in the vocabulary and there is no unk token")
            if unk is not None and not self._fuse_unk:
                syms.append(unk)
            unk = self._unk_id
        if unk is not None:
            syms.append(unk)
        while len(syms) > 1:
            best = None
            for i in range(len(syms) - 1):
                m = self._merges.get((syms[i], syms[i + 1]))
                if m is not None and (best is None or m[0] < best[0]):
                    best = (m[0], i, m[1])
            if best is None:
                break
            _, i, new = best
            syms[i:i + 2] = [new]
        return syms


def load_tokenizer(path: str | None = None):
    """The checkpoint's tokenizer directory read from its `tokenizer.json`
    (`JsonTokenizer`, no `transformers` needed), else (no directory) the
    ByteTokenizer. A directory without a `tokenizer.json` raises: byte ids
    would mean nothing to the trained LLM."""
    if not (path and os.path.isdir(path)):
        return ByteTokenizer()
    if not os.path.isfile(os.path.join(path, "tokenizer.json")):
        have = sorted(os.listdir(path))
        raise FileNotFoundError(
            f"{path} holds the LLM's tokenizer but no tokenizer.json (it holds {have}); the "
            "port reads HF's tokenizer.json only, not SentencePiece's tokenizer.model")
    return JsonTokenizer.from_dir(path)


def initialize_vision_tokenizer(tokenizer) -> Dict[str, int]:
    """Register the 9 generation tokens and return their ids — the
    `DEFAULT_*_IDX` cache of reference any2pix_arch.py:290-298."""
    tokenizer.add_tokens(list(SPECIAL_GEN_TOKENS), special_tokens=True)
    return {t: tokenizer.convert_tokens_to_ids(t) for t in SPECIAL_GEN_TOKENS}
