"""Tokenizer loading + special-token registration.

The reference loads the Vicuna tokenizer from a `tokenizer` subfolder
and registers 9 generation tokens, caching their ids on the model
(reference pipeline.py:22-37, llm/model/any2pix_arch.py:240-299).

Two backends:
  * `JsonTokenizer` — a reader of HF's `tokenizer.json` (the file a fast
    tokenizer saves) with no `transformers` or `tokenizers` import, when
    a checkpoint's tokenizer directory is on disk. It covers Llama's
    SentencePiece BPE (byte fallback, `Prepend("▁")` + `Replace(" ", "▁")`
    normalizer or a `Metaspace` pre-tokenizer, `Replace`/`ByteFallback`/
    `Fuse`/`Strip`/`Metaspace` decoder) and WordLevel over the
    `Whitespace` pre-tokenizer; any other component raises and names
    itself rather than give other ids. A directory that holds only
    SentencePiece's `tokenizer.model` is read too, with no `sentencepiece`
    or `protobuf` import: `read_sentencepiece` decodes the protobuf by hand
    and `sentencepiece_spec` builds from it the `tokenizer.json` spec that
    transformers' `LlamaConverter` builds (`AutoTokenizer` converts such a
    directory that way).
  * `ByteTokenizer` — a deterministic byte-level fallback with the same
    special-token semantics, used for tests and checkpoint-free runs.
"""

from __future__ import annotations

import json
import os
import re
import struct
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
    if spec["type"] not in ("Replace", "ByteFallback", "Fuse", "Strip", "Metaspace"):
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


def _metaspace(spec: dict) -> Tuple[str, str, bool]:
    """(replacement, prepend scheme, split) of a Metaspace pre-tokenizer or
    decoder; files written before `prepend_scheme` carry `add_prefix_space`."""
    scheme = spec.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in ("always", "first", "never"):
        raise NotImplementedError(f"tokenizer.json: Metaspace prepend_scheme {scheme!r}")
    return spec.get("replacement", "▁"), scheme, bool(spec.get("split", True))


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
        if pre is not None and pre["type"] not in ("Whitespace", "Metaspace"):
            raise NotImplementedError(f"tokenizer.json: pre-tokenizer {pre['type']} is not read")
        self._pre = None if pre is None else pre["type"]
        if self._pre == "Metaspace":
            self._metaspace = _metaspace(pre)
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
        """The directory's `tokenizer.json`, else its `tokenizer.model`
        converted as `AutoTokenizer` converts it for Llama."""
        config: dict = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            p = os.path.join(path, name)
            if os.path.isfile(p):
                with open(p, encoding="utf-8") as f:
                    config.update(json.load(f))
        if os.path.isfile(os.path.join(path, "tokenizer.json")):
            with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
                return cls(json.load(f), config)
        with open(os.path.join(path, "tokenizer.model"), "rb") as f:
            model = read_sentencepiece(f.read())
        config = {**LLAMA_DEFAULTS, **config}
        if config["tokenizer_class"] not in ("LlamaTokenizerFast", "LlamaTokenizer"):
            raise NotImplementedError(
                f"tokenizer.model of a {config['tokenizer_class']}: only Llama's conversion is read")
        return cls(sentencepiece_spec(model, config), config)

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
        for start, piece, is_added in self._split(text, normalized=False):
            if is_added:
                ids.append(self._added[piece])
                continue
            for sub_start, sub, sub_added in self._split(self._normalized(piece), normalized=True):
                # `first`: the piece starts the text (Metaspace's "first" scheme)
                ids.extend([self._added[sub]] if sub_added
                           else self._model(sub, first=start == 0 and sub_start == 0))
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
            elif kind == "Metaspace":
                # a replacement becomes a space, and is dropped from the
                # first token unless the scheme never prepends
                repl, scheme, _ = _metaspace(st)
                tokens = [t.replace(repl, "" if i == 0 and scheme != "never" else " ")
                          for i, t in enumerate(tokens)]
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
        """(start, piece, is_added_token) in order; empty pieces dropped."""
        found = self._pattern(normalized)
        if found is None:
            return [(0, text, False)] if text else []
        pat, toks = found
        out, pos = [], 0
        for m in pat.finditer(text):
            if m.start() > pos:
                out.append((pos, text[pos:m.start()], False))
            out.append((m.start(), toks[m.lastindex - 1], True))
            pos = m.end()
        if pos < len(text):
            out.append((pos, text[pos:], False))
        return out

    def _normalized(self, text: str) -> str:
        for kind, a, b in self._normalize:
            if kind == "prepend":
                text = a + text if text else text
            else:
                text = text.replace(a, b)
        return text

    def _pretokenized(self, text: str, first: bool) -> List[str]:
        if self._pre == "Whitespace":
            return re.findall(r"\w+|[^\w\s]+", text)
        if self._pre == "Metaspace":
            repl, scheme, split = self._metaspace
            text = text.replace(" ", repl)
            if (scheme == "always" or (scheme == "first" and first)) and not text.startswith(repl):
                text = repl + text
            # split: each replacement starts a word (merged with the next)
            return [w for w in re.split(f"(?={re.escape(repl)})", text) if w] if split else [text]
        return [text]

    def _model(self, text: str, first: bool = False) -> List[int]:
        words = self._pretokenized(text, first)
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


# ------------------------------------------------- SentencePiece tokenizer.model

# what LlamaTokenizerFast assumes where tokenizer_config.json says nothing
LLAMA_DEFAULTS = {"tokenizer_class": "LlamaTokenizerFast", "bos_token": "<s>", "eos_token": "</s>",
                  "unk_token": "<unk>", "add_bos_token": True, "add_eos_token": False,
                  "clean_up_tokenization_spaces": False}
# sentencepiece_model.proto's SentencePiece.Type values read here (also
# UNKNOWN 2, UNUSED 5 and BYTE 6, which convert as normal pieces)
SP_NORMAL, SP_CONTROL, SP_USER_DEFINED = 1, 3, 4
# TrainerSpec and NormalizerSpec fields read: number → (name, kind)
_TRAINER_FIELDS = {3: ("model_type", "int"), 35: ("byte_fallback", "bool"), 40: ("unk_id", "int"),
                   41: ("bos_id", "int"), 42: ("eos_id", "int"), 43: ("pad_id", "int"),
                   45: ("unk_piece", "str"), 46: ("bos_piece", "str"), 47: ("eos_piece", "str"),
                   48: ("pad_piece", "str")}
_NORMALIZER_FIELDS = {1: ("name", "str"), 2: ("precompiled_charsmap", "bytes"),
                      3: ("add_dummy_prefix", "bool"), 4: ("remove_extra_whitespaces", "bool"),
                      5: ("escape_whitespaces", "bool")}


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("tokenizer.model: a varint runs past the end")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of one protobuf message in order:
    an int for a varint, the bytes otherwise."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            val, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"tokenizer.model: wire type {wire} of field {num} is not read")
        if pos > len(buf):
            raise ValueError(f"tokenizer.model: field {num} runs past the end")
        yield num, wire, val


def _spec_fields(buf: bytes, table: dict, out: dict) -> dict:
    for num, wire, val in _fields(buf):
        if num not in table:
            continue  # a field the conversion does not read
        name, kind = table[num]
        if kind == "str":
            out[name] = val.decode("utf-8")
        elif kind == "bytes":
            out[name] = bytes(val)
        elif kind == "bool":
            out[name] = bool(val)
        else:  # int32: negative values come as 64-bit two's complement
            out[name] = val - (1 << 64) if val >= 1 << 63 else val
    return out


def read_sentencepiece(data: bytes) -> dict:
    """SentencePiece's `ModelProto` (a `tokenizer.model` file) →
    {"pieces": [(piece, score, type)], "trainer_spec": {...},
    "normalizer_spec": {...}}, decoded from the protobuf wire format with
    the proto's defaults; unknown fields are skipped."""
    pieces = []
    trainer = {"model_type": 1, "byte_fallback": False, "unk_id": 0, "bos_id": 1, "eos_id": 2,
               "pad_id": -1, "unk_piece": "<unk>", "bos_piece": "<s>", "eos_piece": "</s>",
               "pad_piece": "<pad>"}
    normalizer = {"name": "", "precompiled_charsmap": b"", "add_dummy_prefix": True,
                  "remove_extra_whitespaces": True, "escape_whitespaces": True}
    for num, wire, val in _fields(data):
        if wire != 2:
            continue
        if num == 1:
            piece, score, kind = "", 0.0, SP_NORMAL
            for n, w, v in _fields(val):
                if n == 1 and w == 2:
                    piece = v.decode("utf-8")
                elif n == 2 and w == 5:
                    score = struct.unpack("<f", v)[0]
                elif n == 3 and w == 0:
                    kind = v
            pieces.append((piece, score, kind))
        elif num == 2:
            _spec_fields(val, _TRAINER_FIELDS, trainer)
        elif num == 3:
            _spec_fields(val, _NORMALIZER_FIELDS, normalizer)
    return {"pieces": pieces, "trainer_spec": trainer, "normalizer_spec": normalizer}


def _generate_merges(vocab: Dict[str, int], scores: Dict[str, float]) -> List[Tuple[str, str]]:
    """Merges in transformers' order (`convert_slow_tokenizer.generate_merges`
    with piece scores): every split of a piece into two pieces of the
    vocabulary, by id within a piece, then by the merged piece's score,
    then the lengths of the halves, highest first, stable."""
    merges = []
    for merge, score in scores.items():
        local = [(merge[:i], merge[i:], score) for i in range(1, len(merge))
                 if merge[:i] in vocab and merge[i:] in vocab]
        local.sort(key=lambda m: (vocab[m[0]], vocab[m[1]]))
        merges.extend(local)
    merges.sort(key=lambda m: (m[2], len(m[0]), len(m[1])), reverse=True)
    return [(a, b) for a, b, _ in merges]


def sentencepiece_spec(model: dict, config: Optional[dict] = None) -> dict:
    """The `tokenizer.json` spec that transformers' `LlamaConverter` builds
    from a SentencePiece BPE model (`read_sentencepiece`), with the special
    tokens `LlamaTokenizerFast` adds on top. `legacy` (default true) and
    `add_prefix_space` (default true) of the tokenizer config choose the
    form: legacy takes a `Prepend("▁")` (with a prefix space) and
    `Replace(" ", "▁")` normalizer, non-legacy a `Metaspace` pre-tokenizer
    that prepends to the first piece only (or never)."""
    config = config or {}
    if model["trainer_spec"]["model_type"] != 2:
        raise NotImplementedError("tokenizer.model: only a BPE model (Llama's) is converted, "
                                  f"not model_type {model['trainer_spec']['model_type']}")
    legacy = config.get("legacy")
    legacy = True if legacy is None else bool(legacy)
    prefix = config.get("add_prefix_space")
    prefix = True if prefix is None else bool(prefix)
    pieces = model["pieces"]
    # LlamaConverter.vocab: the first three pieces score 0
    scores: Dict[str, float] = {}
    for i, (p, s, _) in enumerate(pieces):
        scores[p] = 0.0 if i < 3 else s
    vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
    added = [{"id": i, "content": p, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": t == SP_CONTROL}
             for i, (p, _, t) in enumerate(pieces) if t in (SP_CONTROL, SP_USER_DEFINED)]
    have = {a["content"] for a in added}
    for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
        tok = _token_content(config.get(key))
        if tok is not None and tok in vocab and tok not in have:
            added.append({"id": vocab[tok], "content": tok, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True})
            have.add(tok)
    replace = {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}
    normalizer = pre = None
    if legacy:
        steps = ([{"type": "Prepend", "prepend": "▁"}] if prefix else []) + [replace]
        normalizer = {"type": "Sequence", "normalizers": steps}
    else:
        pre = {"type": "Metaspace", "replacement": "▁", "split": False,
               "prepend_scheme": "first" if prefix else "never"}
    decoders = [{"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
                {"type": "ByteFallback"}, {"type": "Fuse"}]
    if prefix:
        decoders.append({"type": "Strip", "content": " ", "start": 1, "stop": 0})
    return {
        "added_tokens": added, "normalizer": normalizer, "pre_tokenizer": pre,
        "post_processor": None, "decoder": {"type": "Sequence", "decoders": decoders},
        "model": {"type": "BPE", "dropout": None, "unk_token": model["trainer_spec"]["unk_piece"],
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in _generate_merges(vocab, scores)]},
    }


def load_tokenizer(path: str | None = None):
    """The checkpoint's tokenizer directory read from its `tokenizer.json`,
    else from SentencePiece's `tokenizer.model` (`JsonTokenizer`; no
    `transformers`, `sentencepiece` or `protobuf` needed), else (no
    directory) the ByteTokenizer. A directory with neither file raises:
    byte ids would mean nothing to the trained LLM."""
    if not (path and os.path.isdir(path)):
        return ByteTokenizer()
    if not any(os.path.isfile(os.path.join(path, f)) for f in ("tokenizer.json", "tokenizer.model")):
        have = sorted(os.listdir(path))
        raise FileNotFoundError(
            f"{path} holds the LLM's tokenizer but neither tokenizer.json nor tokenizer.model "
            f"(it holds {have})")
    return JsonTokenizer.from_dir(path)


def initialize_vision_tokenizer(tokenizer) -> Dict[str, int]:
    """Register the 9 generation tokens and return their ids — the
    `DEFAULT_*_IDX` cache of reference any2pix_arch.py:290-298."""
    tokenizer.add_tokens(list(SPECIAL_GEN_TOKENS), special_tokens=True)
    return {t: tokenizer.convert_tokens_to_ids(t) for t in SPECIAL_GEN_TOKENS}
