"""The port's reader of SentencePiece's `tokenizer.model` (`llm/tokenizer.py`:
`read_sentencepiece`, `sentencepiece_spec`, `load_tokenizer`) against
transformers, which the JAX package's `load_tokenizer` calls: a tiny
byte-fallback BPE model (about 380 pieces, USER_DEFINED and CONTROL pieces
among them) written with transformers' protobuf classes, converted by
`LlamaConverter` with a stand-in `sentencepiece` processor. The port's spec
must equal the converter's, and its ids and decoded text must equal
`AutoTokenizer`'s on the mixed corpus of `test_torch_tokenizer.py`, for
`legacy` true and false (Metaspace `first`) and without a prefix space;
Metaspace `always` is held against `tokenizers` on the same spec. The port
reads the directory with transformers, tokenizers, sentencepiece and
protobuf masked."""

import json
import sys

import pytest
from test_torch_tokenizer import CORPUS, TRAIN, _compare, _random_corpus
from torch_port_helpers import (MASKED_TOKENIZER_PACKAGES, SP_CONTROL, SP_USER_DEFINED,  # noqa: F401
                                stub_sentencepiece, write_sentencepiece_model)

from instructany2pix_tpu.llm import tokenizer as jtok
from instructany2pix_tpu_torch.llm import tokenizer as ttok

EXTRA = ["say <sep> then 日本 and <ctl> here", "<sep><ctl>日本語", " <sep> ", "<unk> a <unk>",
         "x<s>y</s>z", "USER: 日本 ASSISTANT:<sep>"]
CONFIGS = {
    "legacy": {"legacy": True},
    "nonlegacy_first": {"legacy": False},
    "legacy_no_prefix": {"legacy": True, "add_prefix_space": False},
    "default": {},
}


def _sp_dir(tmp_path, config):
    d = tmp_path / "tokenizer"
    d.mkdir()
    write_sentencepiece_model(d / "tokenizer.model", TRAIN + EXTRA)
    (d / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "LlamaTokenizer",
                                                         **config}))
    return str(d)


def _converted(path, config):
    """`LlamaConverter(...).converted()` over the directory's model."""
    from transformers.convert_slow_tokenizer import LlamaConverter
    from transformers.models.llama.tokenization_llama import LlamaTokenizer

    slow = LlamaTokenizer(f"{path}/tokenizer.model", **config)
    return LlamaConverter(slow).converted()


def test_read_sentencepiece_decodes_the_proto(tmp_path, stub_sentencepiece):
    from transformers.utils import sentencepiece_model_pb2_new as pb

    path = _sp_dir(tmp_path, {})
    data = open(f"{path}/tokenizer.model", "rb").read()
    ref = pb.ModelProto.FromString(data)
    got = ttok.read_sentencepiece(data)
    assert [(p.piece, p.score, p.type) for p in ref.pieces] == got["pieces"]
    assert 300 <= len(got["pieces"]) <= 400
    for name in ("model_type", "byte_fallback", "unk_id", "bos_id", "eos_id", "pad_id", "unk_piece",
                 "bos_piece", "eos_piece", "pad_piece"):
        assert got["trainer_spec"][name] == getattr(ref.trainer_spec, name), name
    for name in ("name", "add_dummy_prefix", "remove_extra_whitespaces", "escape_whitespaces"):
        assert got["normalizer_spec"][name] == getattr(ref.normalizer_spec, name), name
    # an unknown field of every wire type is skipped
    extra = bytes([0x78, 0x05, 0x81, 0x01, 0x01, 0, 0, 0, 0, 0, 0, 0, 0x8A, 0x01, 0x02, 0x61, 0x62,
                   0x95, 0x01, 0, 0, 0, 0])
    assert ttok.read_sentencepiece(data + extra) == got
    with pytest.raises(ValueError, match="past the end"):
        ttok.read_sentencepiece(data[:-3])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spec_equals_llama_converter(tmp_path, stub_sentencepiece, name):
    path = _sp_dir(tmp_path, CONFIGS[name])
    ref = json.loads(_converted(path, CONFIGS[name]).to_str())
    model = ttok.read_sentencepiece(open(f"{path}/tokenizer.model", "rb").read())
    spec = ttok.sentencepiece_spec(model, {**ttok.LLAMA_DEFAULTS, **CONFIGS[name]})
    assert spec["model"]["merges"] == ref["model"]["merges"]
    assert len(spec["model"]["merges"]) > 50
    for key in ("vocab", "unk_token", "fuse_unk", "byte_fallback", "type"):
        assert spec["model"][key] == ref["model"][key], key
    for key in ("normalizer", "pre_tokenizer", "decoder"):
        assert spec[key] == ref[key], key
    # the converter's added tokens (USER_DEFINED and CONTROL), plus <unk>,
    # which LlamaTokenizerFast adds as a special token
    conv = {a["content"]: (a["id"], a["special"], a["normalized"]) for a in ref["added_tokens"]}
    mine = {a["content"]: (a["id"], a["special"], a["normalized"]) for a in spec["added_tokens"]}
    assert set(conv) == {"<s>", "</s>", *SP_CONTROL, *SP_USER_DEFINED}
    assert {k: mine[k] for k in conv} == conv and set(mine) - set(conv) == {"<unk>"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ids_and_text_match_autotokenizer(tmp_path, stub_sentencepiece, monkeypatch, name):
    path = _sp_dir(tmp_path, CONFIGS[name])
    hf = jtok.load_tokenizer(path)
    assert type(hf).__name__ == "LlamaTokenizerFast"
    with monkeypatch.context() as m:
        for pkg in MASKED_TOKENIZER_PACKAGES:
            m.setitem(sys.modules, pkg, None)
        port = ttok.load_tokenizer(path)
        assert port("hello world <sep>").input_ids == hf("hello world <sep>").input_ids
    assert isinstance(port, ttok.JsonTokenizer)
    assert ttok.initialize_vision_tokenizer(port) == jtok.initialize_vision_tokenizer(hf)
    assert len(port) == len(hf)
    for attr in ("bos_token_id", "eos_token_id", "unk_token_id", "pad_token_id"):
        assert getattr(port, attr) == getattr(hf, attr), attr
    _compare(port, hf, CORPUS + EXTRA + _random_corpus(1, 60))


def test_metaspace_always_matches_tokenizers(tmp_path, stub_sentencepiece):
    """A `tokenizer.json` with a Metaspace pre-tokenizer and decoder that
    prepend to every piece (`always`), split or not."""
    from tokenizers import Tokenizer

    path = _sp_dir(tmp_path, {"legacy": False})
    spec = json.loads(_converted(path, {"legacy": False}).to_str())
    for split in (False, True):
        spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                                 "split": split}
        spec["decoder"] = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                           "split": split}
        ref = Tokenizer.from_str(json.dumps(spec))
        port = ttok.JsonTokenizer(spec, {})
        for text in CORPUS + EXTRA + _random_corpus(2, 40):
            want = ref.encode(text, add_special_tokens=False).ids
            assert port.encode(text, add_special_tokens=False) == want, (split, text)
            for skip in (False, True):
                assert port.decode(want, skip) == ref.decode(want, skip_special_tokens=skip), text


def test_unconvertible_models_raise(tmp_path, stub_sentencepiece):
    path = _sp_dir(tmp_path, {"tokenizer_class": "T5Tokenizer"})
    with pytest.raises(NotImplementedError, match="T5Tokenizer"):
        ttok.load_tokenizer(path)
    model = ttok.read_sentencepiece(open(f"{path}/tokenizer.model", "rb").read())
    model["trainer_spec"]["model_type"] = 1  # unigram
    with pytest.raises(NotImplementedError, match="model_type 1"):
        ttok.sentencepiece_spec(model, {})
