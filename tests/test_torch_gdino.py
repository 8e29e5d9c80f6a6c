"""The port's GroundingDINO stack vs the JAX package: BERT, Swin (also at a
size the window does not divide), deformable attention, the full forward
and the grounder, the two caption tokenizers and the preprocessing. Tiny
configs with converted weights, CPU, float32, inputs from numpy seeds.

`simple_tokenize` hashes words with Python's `hash`, so its ids depend on
PYTHONHASHSEED: they agree with the JAX package's within one process,
which is where these tests run both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.grounding import bert as jbert
from instructany2pix_tpu.grounding import bert_tokenizer as jtok
from instructany2pix_tpu.grounding import gdino as jgd
from instructany2pix_tpu.grounding import swin as jswin
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.grounding import bert as tbert
from instructany2pix_tpu_torch.grounding import bert_tokenizer as ttok
from instructany2pix_tpu_torch.grounding import gdino as tgd
from instructany2pix_tpu_torch.grounding import swin as tswin
from torch_port_helpers import assert_close, randn, t

TOL = 1e-4  # float32 through several layers, relative to the largest value
DEFORM_TOL = 2e-5  # grid_sample against the JAX gather; the same bilinear weights


def _with_random_bias(tree, seed):
    """The JAX init zeroes Swin's bias tables; fill them from a seed."""
    rs = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(rs.randn(*np.shape(v)).astype(np.float32))
                        if k == "rel_bias" else walk(v)) for k, v in node.items()}
        return node

    return walk(tree)


@pytest.fixture(scope="module")
def gd_pair():
    jcfg = jgd.GDinoConfig.tiny()
    params = _with_random_bias(jgd.init(jax.random.key(5), jcfg), 12)
    tcfg = tgd.GDinoConfig.tiny()
    return jcfg, params, tcfg, convert.gdino(convert.to_numpy(params), tcfg)


def test_bert_matches_jax():
    jcfg, tcfg = jbert.BertConfig.tiny(), tbert.BertConfig.tiny()
    params = jbert.init(jax.random.key(1), jcfg)
    tp = convert.bert(convert.to_numpy(params), tcfg)
    ids = np.array([[98, 5, 9, 20, 99, 0, 0], [98, 7, 7, 31, 44, 12, 99]])
    mask = np.array([[1, 1, 1, 1, 1, 0, 0], [1] * 7])
    out_j = jbert.forward(params, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    out = tbert.forward(tp, tcfg, torch.as_tensor(ids), torch.as_tensor(mask))
    assert_close(out, out_j, TOL, 1, rel=True, what="bert")


@pytest.mark.parametrize("hw", [(32, 48), (36, 52)])
def test_swin_matches_jax(hw):
    """(36, 52): a 9 x 13 first stage, which the 2-wide window does not
    divide (pad, then roll), and odd sizes at every merge."""
    jcfg, tcfg = jswin.SwinConfig.tiny(), tswin.SwinConfig.tiny()
    params = _with_random_bias(jswin.init(jax.random.key(2), jcfg), 13)
    tp = convert.swin(convert.to_numpy(params), tcfg)
    x = randn(hw[0], 2, *hw, 3)
    outs_j = jswin.apply(params, jnp.asarray(x), jcfg)
    outs = tswin.apply(tp, t(x), tcfg)
    assert len(outs) == len(outs_j) == 2
    for i, (a, b) in enumerate(zip(outs, outs_j)):
        assert_close(a, b, TOL, hw[0], rel=True, what=f"swin stage {i}")


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_deformable_attention_matches_jax(gd_pair, ref_dim):
    jcfg, params, tcfg, tp = gd_pair
    shapes = [(6, 7), (3, 4), (2, 2)]
    d, nq, seed = jcfg.d_model, 9, 600 + ref_dim
    value = randn(seed, 2, sum(h * w for h, w in shapes), d)
    query = randn(seed + 1, 2, nq, d)
    # reference points partly outside [0, 1]: zero padding at the borders
    ref = np.random.RandomState(seed + 2).uniform(-0.1, 1.1, (2, nq, ref_dim)).astype(np.float32)
    if ref_dim == 4:
        ref[..., 2:] = np.abs(ref[..., 2:])
    jp = params["dec_0"]["img_deform"]
    # offsets large enough that samples leave the grid
    jp = dict(jp, sampling_offsets={"w": jnp.asarray(randn(seed + 3, d, jp["sampling_offsets"]["w"].shape[1])),
                                    "b": jp["sampling_offsets"]["b"]})
    out_j = jgd.deformable_attention(jp, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(value),
                                     shapes, jcfg.heads, jcfg.points)
    with torch.device("meta"):
        tmod = tgd.Deform(d, jcfg.heads, len(shapes), jcfg.points)
    tmod = convert.build(tmod, convert.to_numpy(jp))
    out = tgd.deformable_attention(tmod, t(query), t(ref), t(value), shapes, tcfg.heads, tcfg.points)
    assert_close(out, out_j, DEFORM_TOL, seed, rel=True, what=f"deformable attention, {ref_dim}-d refs")


def test_forward_matches_jax(gd_pair):
    jcfg, params, tcfg, tp = gd_pair
    x = randn(700, 1, 64, 96, 3)
    ids = np.array([[98, 11, 40, 12, 63, 99]])
    mask = np.array([[1, 1, 1, 1, 1, 1]])
    boxes_j, logits_j = jgd.forward(params, jcfg, jnp.asarray(x), jnp.asarray(ids), jnp.asarray(mask))
    boxes, logits = tgd.forward(tp, tcfg, t(x), ids, mask)
    assert boxes.shape == (1, jcfg.num_queries, 4) and logits.shape == (1, jcfg.num_queries, 6)
    assert_close(boxes, boxes_j, TOL, 700, what="boxes")
    assert_close(logits, logits_j, TOL, 700, rel=True, what="logits")


def _gap_threshold(values):
    """A threshold in the widest gap between the middle values, so that a
    last-digit difference cannot move a value across it."""
    v = np.sort(np.asarray(values).ravel())
    lo, hi = len(v) // 4, 3 * len(v) // 4
    i = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    return float((v[i] + v[i + 1]) / 2)


def test_grounder_matches_jax(gd_pair):
    jcfg, params, tcfg, tp = gd_pair
    img = np.random.RandomState(800).randint(0, 255, (40, 52, 3)).astype(np.uint8)
    caption = "a dog . a red cat"
    ids, _ = jgd.simple_tokenize(caption, jcfg.bert.vocab_size)
    x = jnp.asarray(jgd.preprocess(img))
    _, logits = jgd.forward(params, jcfg, x, jnp.asarray(ids), jnp.asarray(np.ones_like(ids)))
    probs = np.asarray(jax.nn.sigmoid(logits))[0]
    box_th, text_th = _gap_threshold(probs.max(-1)), _gap_threshold(probs)
    b_j, l_j, ph_j = jgd.make_grounder(params, jcfg)(img, caption, box_th, text_th)
    b, lg, ph = tgd.make_grounder(tp, tcfg)(img, caption, box_th, text_th)
    assert 0 < len(ph_j) < jcfg.num_queries and any(ph_j)
    assert ph == ph_j
    assert_close(t(b), b_j, TOL, 800, what="kept boxes")
    assert_close(t(lg), l_j, TOL, 800, what="kept scores")


def test_preprocess_and_tokenizers_match_jax(tmp_path):
    for shape, size in (((40, 52, 3), 800), ((97, 61, 3), 64)):
        img = np.random.RandomState(shape[0]).randint(0, 255, shape).astype(np.uint8)
        assert_close(tgd.preprocess(img, size), jgd.preprocess(img, size), 1e-4, shape[0],
                     what=f"preprocess {shape}")
    for cap in ("a dog . a red cat", "Ticking Clock. antique shop"):
        ids_t, tok_t = tgd.simple_tokenize(cap, 30522)
        ids_j, tok_j = jgd.simple_tokenize(cap, 30522)
        assert np.array_equal(ids_t, ids_j) and tok_t == tok_j
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join("[PAD] [UNK] [CLS] [SEP] . , a dog cat red ##s un ##able walk ##ing "
                               "中".split()) + "\n", encoding="utf-8")
    tt, jt = ttok.BertWordpieceTokenizer(str(vocab)), jtok.BertWordpieceTokenizer(str(vocab))
    for cap in ("a dog. a cat.", "unable dogs walking", "Café 中 red-cats!"):
        assert tt(cap).input_ids == jt(cap).input_ids
        assert tt.convert_ids_to_tokens(tt(cap).input_ids) == jt.convert_ids_to_tokens(jt(cap).input_ids)


def test_config_and_random_init_match_jax():
    import dataclasses

    for name in ("swint", "tiny"):
        assert dataclasses.asdict(getattr(tgd.GDinoConfig, name)()) == \
            dataclasses.asdict(getattr(jgd.GDinoConfig, name)())
    cfg = tgd.GDinoConfig.tiny()
    from instructany2pix_tpu_torch.models import layers as L

    with torch.device("meta"):
        m = tgd.GDino(cfg)
    m = tgd.init_(L.materialize(m, torch.device("cpu"), torch.float32), cfg,
                  torch.Generator().manual_seed(0))
    assert m.enc_0.fusion.gamma_v.detach()[0].item() == pytest.approx(1e-4)
    convert.load_tree(m, convert.to_numpy(jgd.init(jax.random.key(0), jgd.GDinoConfig.tiny())))
