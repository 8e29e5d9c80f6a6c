"""The port's `tokenizer.json` reader (`llm/tokenizer.py::JsonTokenizer`)
against `AutoTokenizer`, which the JAX package's `load_tokenizer` returns
for the same directory: a small Llama-style tokenizer (SentencePiece BPE
with byte fallback, Vicuna's normalizer and decoder, `<unk>` `<s>` `</s>`,
`LlamaTokenizerFast`) built with `tokenizers` in a temporary directory.
On a mixed corpus (ASCII, runs of spaces, newlines, accents, CJK, emoji,
`<video>` and the 9 generation tokens after `add_tokens`, plus seeded
random strings) the ids and the decoded text, with and without
`skip_special_tokens`, must be identical; also with `transformers` and
`tokenizers` masked from `sys.modules`."""

import json
import sys

import numpy as np
import pytest

from instructany2pix_tpu.llm import generate as jgen
from instructany2pix_tpu.llm import tokenizer as jtok
from instructany2pix_tpu_torch.llm import constants as C
from instructany2pix_tpu_torch.llm import generate as tgen
from instructany2pix_tpu_torch.llm import tokenizer as ttok

TRAIN = [
    "A chat between a curious user and an artificial intelligence assistant. The assistant "
    "gives helpful, detailed, and polite answers to the user's questions.",
    "USER: put the sound of the sea into the picture ASSISTANT: a beach at dusk",
    "the café serves crème brûlée", "hello world  with   spaces", "line one\nline two\n\ttab",
]

CORPUS = [
    "hello world", "", " ", "  lead  spaces", "trailing   ", "line\n\nx", "\n", "\ttab\t",
    "café crème brûlée ñandú", "日本語のテキスト", "emoji 😀🎨 and ✨", "mixed 日本 😀 ñ text",
    "a <video> b<video>c", "<video><video>", "</s> x <s>", "<unk>",
    "<im_gen><video><base>add a cat to the photo. USER: hi!!",
    "A chat between a curious user and an artificial intelligence assistant. USER: put "
    "<video> in <video> ASSISTANT: [a dog by the sea] additions:dog:<video>.</s>",
    "<im_gen_start><audio_gen_start><audio_gen><audio><mask_gen><base_null>",
]


def _random_corpus(seed: int, n: int):
    rs = np.random.RandomState(seed)
    alphabet = list("abcdeghilnorstuw ,.!?'") + [" ", "  ", "\n", "é", "ü", "日", "本", "😀", "✨"]
    alphabet += list(C.SPECIAL_GEN_TOKENS) + ["<s>", "</s>"]
    return ["".join(alphabet[i] for i in rs.randint(0, len(alphabet), rs.randint(1, 40)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    from tokenizers import Tokenizer, decoders, models, normalizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    specials = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    tok.train_from_iterator(TRAIN * 10, trainers.BpeTrainer(vocab_size=450, special_tokens=specials,
                                                           show_progress=False))
    spec = json.loads(tok.to_str())
    # the byte pieces are vocabulary, not added tokens, as in Llama's file
    spec["added_tokens"] = [a for a in spec["added_tokens"] if a["content"] in ("<unk>", "<s>", "</s>")]
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}],
        "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                 {"SpecialToken": {"id": "<s>", "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}},
    }
    d = tmp_path_factory.mktemp("vicuna_tokenizer")
    (d / "tokenizer.json").write_text(json.dumps(spec))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "LlamaTokenizerFast", "bos_token": "<s>", "eos_token": "</s>",
        "unk_token": "<unk>", "add_bos_token": True, "add_eos_token": False,
        "clean_up_tokenization_spaces": False, "legacy": True}))
    return str(d)


def _compare(port, hf, texts):
    for text in texts:
        want = hf(text).input_ids
        got = port(text).input_ids
        assert got == want, f"{text!r}: ids {got} != {want}"
        assert port(text, add_special_tokens=False).input_ids == hf(text, add_special_tokens=False).input_ids
        for skip in (False, True):
            a, b = port.decode(want, skip_special_tokens=skip), hf.decode(want, skip_special_tokens=skip)
            assert a == b, f"{text!r} skip_special_tokens={skip}: {a!r} != {b!r}"


@pytest.mark.parametrize("masked", [False, True])
def test_ids_and_text_match_autotokenizer(llama_dir, masked, monkeypatch):
    hf = jtok.load_tokenizer(llama_dir)
    assert type(hf).__name__ == "LlamaTokenizerFast"
    if masked:
        monkeypatch.setitem(sys.modules, "transformers", None)
        monkeypatch.setitem(sys.modules, "tokenizers", None)
    port = ttok.load_tokenizer(llama_dir)
    assert isinstance(port, ttok.JsonTokenizer)
    assert len(port) == len(hf)
    assert ttok.initialize_vision_tokenizer(port) == jtok.initialize_vision_tokenizer(hf)
    assert len(port) == len(hf) == 450 + 9
    for name in ("bos_token_id", "eos_token_id", "unk_token_id", "pad_token_id"):
        assert getattr(port, name) == getattr(hf, name), name
    _compare(port, hf, CORPUS + _random_corpus(0, 60))
    ids = [hf(t).input_ids for t in CORPUS[:4]]
    assert port.batch_decode(ids, skip_special_tokens=True) == hf.batch_decode(ids, skip_special_tokens=True)


def test_byte_pieces_decode_as_tokenizers_does(llama_dir):
    """A run of byte pieces that is not valid UTF-8 gives one U+FFFD per
    byte; a valid run fuses into its character; unknown ids are dropped."""
    hf, port = jtok.load_tokenizer(llama_dir), ttok.load_tokenizer(llama_dir)
    e6, x97, xa5 = (hf.convert_tokens_to_ids(f"<0x{b}>") for b in ("E6", "97", "A5"))
    a = hf.convert_tokens_to_ids("▁a")
    for ids in ([e6, x97, xa5], [e6, x97], [x97, a, e6], [a, e6, x97, xa5, a], [1, e6, 2]):
        for skip in (False, True):
            assert port.decode(ids, skip_special_tokens=skip) == hf.decode(ids, skip_special_tokens=skip), ids
    assert port.convert_ids_to_tokens([e6, a]) == hf.convert_ids_to_tokens([e6, a])


def test_added_token_ids_follow_the_vocabulary(llama_dir):
    hf, port = jtok.load_tokenizer(llama_dir), ttok.load_tokenizer(llama_dir)
    for toks in (["<x1>", "<x2>"], ["<x2>", "hello"], ["<s>"]):
        assert port.add_tokens(toks, special_tokens=True) == hf.add_tokens(toks, special_tokens=True)
        assert [port.convert_tokens_to_ids(t) for t in toks] == [hf.convert_tokens_to_ids(t) for t in toks]
    assert port.convert_tokens_to_ids("<never-added>") == hf.convert_tokens_to_ids("<never-added>")
    _compare(port, hf, ["say <x1> then <x2><x1> and hello there"])


def test_keyword_stop_sequences_match_jax(llama_dir):
    hf, port = jtok.load_tokenizer(llama_dir), ttok.load_tokenizer(llama_dir)
    kws = ["</s>", "ASSISTANT:", "###"]
    assert tgen.keyword_stop_sequences(port, kws) == jgen.keyword_stop_sequences(hf, kws)


def test_a_directory_without_tokenizer_json_raises(tmp_path):
    """Without tokenizer.json the directory's tokenizer.model is read
    (tests/test_torch_sentencepiece.py): a malformed one raises, and a
    directory with neither file raises naming both."""
    (tmp_path / "tokenizer_config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="neither tokenizer.json nor tokenizer.model"):
        ttok.load_tokenizer(str(tmp_path))
    (tmp_path / "tokenizer.model").write_bytes(b"\x00")
    with pytest.raises(ValueError, match="tokenizer.model"):
        ttok.load_tokenizer(str(tmp_path))


def test_unread_components_raise(llama_dir):
    """A component the reader does not implement is named, never skipped."""
    with open(f"{llama_dir}/tokenizer.json") as f:
        spec = json.load(f)
    for key, value in (("normalizer", {"type": "NFKC"}),
                       ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": False}),
                       ("decoder", {"type": "WordPiece", "prefix": "##"})):
        bad = dict(spec, **{key: value})
        with pytest.raises(NotImplementedError, match=value["type"]):
            ttok.JsonTokenizer(bad, {"tokenizer_class": "LlamaTokenizerFast"})
