"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are drawn with numpy from a stated seed and handed to both the
JAX function and its port; comparisons report the seed and the max and
mean differences when they fail, so a real divergence can be told from
noise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


def randn(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def t(x) -> torch.Tensor:
    """numpy (or JAX) array → float32/int CPU tensor."""
    return torch.from_numpy(np.array(x))


def assert_close(port, ref, tol: float, seed: int, rel: bool = False, what: str = ""):
    """max |port - ref| <= tol (or <= tol * max |ref| when `rel`)."""
    a = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port, np.float32)
    b = np.asarray(ref, np.float32)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    d = np.abs(a - b)
    limit = tol * max(float(np.abs(b).max()), 1e-30) if rel else tol
    assert np.isfinite(a).all(), f"{what}: non-finite port output (seed {seed})"
    assert d.max() <= limit, (
        f"{what}: seed {seed} max diff {d.max():.3g} mean diff {d.mean():.3g} "
        f"> {'rel ' if rel else ''}tol {tol} (limit {limit:.3g})"
    )


def random_tree(shapes, seed: int):
    """Numpy weights in the layout of a JAX parameter tree (the
    `jax.eval_shape` of its `init`, dicts and lists), drawn from `seed`:
    gains `g` 1 + 0.1·N, biases `b` 0.1·N, other leaves N / sqrt(fan-in)
    (every axis but the last). Faster than running a JAX `init` eagerly,
    and the biases are not zero."""
    rs = np.random.RandomState(seed)

    def draw(key, leaf):
        shape = tuple(leaf.shape)
        n = rs.randn(*shape).astype(np.float32)
        if key == "g":
            return 1.0 + 0.1 * n
        if key == "b":
            return 0.1 * n
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return n / np.sqrt(max(fan_in, 1))

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        return draw(key, node)

    return walk(shapes)


def grad_close(got: dict, want, tol: float, seed: int):
    """Every leaf of a JAX gradient tree `want` against the port's
    `convert.to_tree(module, grad=True)`, each within tol times its own
    largest element, plus a rounding floor of 2 float32 ulps (2 * 2^-23) of
    the whole tree's largest element. Only a leaf below 2 * 2^-23 / tol of
    that element (2.4 % at tol 1e-5) leans on the floor. In the VQ-GAN only
    the attention key biases do: their gradient is zero in exact arithmetic
    (a key bias shifts every score of a query row alike), and what both
    sides' rounding leaves there stays under 0.6 ulp of the tree's largest
    element. Returns the number of leaves compared."""
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    floor = 2 * 2.0**-23 * max(float(np.abs(np.asarray(w)).max()) for _, w in leaves)
    for path, w in leaves:
        node = got
        for k in path:
            if hasattr(k, "key"):
                node = node[k.key]
            else:  # a list index: to_tree keys ModuleList children by str
                node = node[str(k.idx)] if isinstance(node, dict) else node[k.idx]
        w = np.asarray(w, np.float32)
        limit = tol * float(np.abs(w).max()) + floor
        d = np.abs(np.asarray(node, np.float32) - w).max()
        assert d <= limit, (f"{jax.tree_util.keystr(path)}: seed {seed} max diff {d:.3g} > "
                            f"{limit:.3g} (leaf max {np.abs(w).max():.3g}, floor {floor:.3g})")
    return len(leaves)


@pytest.fixture
def grad_enabled():
    """Autograd on for the test: another test module of the suite turns it
    off process-wide when it is imported (`torch.set_grad_enabled(False)`),
    and pytest-xdist workers import every module."""
    with torch.enable_grad():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread in a module that imports this fixture: under
    pytest-xdist every worker would otherwise start a thread per core, and
    their OpenMP barriers stall the many small ops of the tiny models by up
    to two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ SentencePiece tokenizer.model

# USER_DEFINED and CONTROL pieces of the tiny model (type 4 and 3)
SP_USER_DEFINED = ("<sep>", "日本")
SP_CONTROL = ("<ctl>",)


def write_sentencepiece_model(path, train_texts, vocab_size: int = 380) -> None:
    """A tiny byte-fallback BPE `tokenizer.model` written with the protobuf
    classes transformers ships: <unk> <s> </s>, the 256 byte pieces, the
    USER_DEFINED and CONTROL pieces above, then BPE pieces learnt by
    `tokenizers` on `train_texts` (score -rank, as SentencePiece scores BPE)."""
    import json

    from tokenizers import Tokenizer, models, normalizers, trainers
    from transformers.utils import sentencepiece_model_pb2_new as pb

    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    specials = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    tok.train_from_iterator(list(train_texts) * 10, trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=specials, show_progress=False))
    vocab = json.loads(tok.to_str())["model"]["vocab"]
    skip = set(specials) | set(SP_USER_DEFINED) | set(SP_CONTROL)
    learnt = [p for p, _ in sorted(vocab.items(), key=lambda kv: kv[1]) if p not in skip]

    m = pb.ModelProto()

    def add(piece, score, kind):
        x = m.pieces.add()
        x.piece, x.score, x.type = piece, score, kind

    add("<unk>", 0.0, 2)
    add("<s>", 0.0, 3)
    add("</s>", 0.0, 3)
    for b in range(256):
        add(f"<0x{b:02X}>", 0.0, 6)
    for p in SP_USER_DEFINED:
        add(p, 0.0, 4)
    for p in SP_CONTROL:
        add(p, 0.0, 3)
    for rank, p in enumerate(learnt):
        add(p, -float(rank), 1)
    ts = m.trainer_spec
    ts.model_type, ts.vocab_size, ts.byte_fallback = 2, len(m.pieces), True
    ts.unk_id, ts.bos_id, ts.eos_id, ts.pad_id = 0, 1, 2, -1
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = True
    m.normalizer_spec.remove_extra_whitespaces = False
    with open(path, "wb") as f:
        f.write(m.SerializeToString())


class _StubProcessor:
    """The few `SentencePieceProcessor` calls transformers' Llama tokenizer
    and `LlamaConverter` make, over the parsed proto (`sentencepiece` is
    not installed)."""

    def __init__(self, **kwargs):
        self._m = None

    def LoadFromSerializedProto(self, data):
        from transformers.utils import sentencepiece_model_pb2_new as pb

        self._m = pb.ModelProto.FromString(data)

    def Load(self, path):
        with open(path, "rb") as f:
            self.LoadFromSerializedProto(f.read())

    def id_to_piece(self, i):
        return self._m.pieces[i].piece

    def piece_to_id(self, piece):
        return next((i for i, p in enumerate(self._m.pieces) if p.piece == piece), 0)

    def get_piece_size(self):
        return len(self._m.pieces)

    def encode(self, text, out_type=str, **kwargs):
        return list(text)

    def serialized_model_proto(self):
        return self._m.SerializeToString()

    IdToPiece, PieceToId, GetPieceSize = id_to_piece, piece_to_id, get_piece_size


@pytest.fixture
def stub_sentencepiece(monkeypatch):
    """transformers with a stand-in `sentencepiece`, so `AutoTokenizer` (the
    JAX package's `load_tokenizer`) converts a `tokenizer.model` directory
    through `LlamaConverter` as it would with the real package."""
    import importlib
    import sys
    import types

    import transformers.utils.import_utils as iu
    from transformers.utils import sentencepiece_model_pb2_new as pb

    mod = types.ModuleType("sentencepiece")
    mod.SentencePieceProcessor = _StubProcessor
    mod.sentencepiece_model_pb2 = pb
    monkeypatch.setitem(sys.modules, "sentencepiece", mod)
    monkeypatch.setattr(iu, "_sentencepiece_available", True)
    slow = importlib.import_module("transformers.models.llama.tokenization_llama")
    fast = importlib.import_module("transformers.models.llama.tokenization_llama_fast")
    # the fast class picks its slow class when first imported
    monkeypatch.setattr(fast.LlamaTokenizerFast, "slow_tokenizer_class", slow.LlamaTokenizer)
    return mod


MASKED_TOKENIZER_PACKAGES = ("transformers", "tokenizers", "sentencepiece", "google.protobuf")
