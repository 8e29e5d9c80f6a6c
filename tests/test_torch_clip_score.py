"""The CLIP-score harness of the port against the JAX package: `clip_score`,
`clip_text_embed` and `clip_image_embed` on one set of tiny towers (seeded
numpy draws in the JAX tree's layout), the crc32 word tokenizer, the tiny
scorer, the `RegressionKit` file written by one package and read by the
other, and `load_scoring_clip` on an absent tree, a tree without a
tokenizer, and a written tiny one (HF text and image-encoder directories,
a CLIP BPE vocabulary). CPU, float32: embeddings within TOL relative;
scores within TOL · 100."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import assert_close, one_torch_thread, random_tree, t  # noqa: F401

from instructany2pix_tpu.models import clip as jclip
from instructany2pix_tpu.utils import clip_score as jcs
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.models import clip as tclip
from instructany2pix_tpu_torch.utils import clip_score as tcs

TOL = 2e-5  # float32 through two towers, sums in another order
PROMPTS = ["a photo of a cat", "a red clock in an antique shop"]


def _images():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 255, (40, 52, 3), np.uint8), rs.rand(30, 30, 3).astype(np.float32)]


@pytest.fixture(scope="module")
def towers():
    """JAX and port scorers over the same tiny weights and the crc32
    tokenizer (the JAX tiny scorer's configs)."""
    tcfg = dataclasses.replace(jclip.CLIPTextConfig.tiny(), projection_dim=16)
    vcfg = jclip.CLIPVisionConfig.tiny()
    ttree = random_tree(jax.eval_shape(lambda: jclip.text_init(jax.random.key(0), tcfg)), 0)
    vtree = random_tree(jax.eval_shape(lambda: jclip.vision_init(jax.random.key(0), vcfg)), 1)
    ptcfg = tclip.CLIPTextConfig(**dataclasses.asdict(tcfg))
    pvcfg = tclip.CLIPVisionConfig(**dataclasses.asdict(vcfg))
    jax_side = dict(text_params=jax.tree.map(jnp.asarray, ttree), text_cfg=tcfg,
                    tokenizer=jcs._HashWordTokenizer(tcfg.vocab_size, tcfg.eos_token_id),
                    vision_params=jax.tree.map(jnp.asarray, vtree), vision_cfg=vcfg)
    port = dict(text_params=convert.clip_text(ttree, ptcfg), text_cfg=ptcfg,
                tokenizer=tcs._HashWordTokenizer(ptcfg.vocab_size, ptcfg.eos_token_id),
                vision_params=convert.clip_vision(vtree, pvcfg), vision_cfg=pvcfg)
    return jax_side, port


def _score(mod, s, images, prompts):
    return mod.clip_score(s["text_params"], s["text_cfg"], s["tokenizer"], s["vision_params"],
                          s["vision_cfg"], images, prompts)


def test_clip_score_and_embeddings_match_jax(towers):
    j, p = towers
    images = _images()
    want = _score(jcs, j, images, PROMPTS)
    got = _score(tcs, p, images, PROMPTS)
    assert got.shape == np.asarray(want).shape == (2,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL * 100)
    assert ((got >= 0) & (got <= 100)).all()
    with torch.inference_mode():
        te = tcs.clip_text_embed(p["text_params"], p["text_cfg"], p["tokenizer"], PROMPTS)
        ie = tcs.clip_image_embed(p["vision_params"], p["vision_cfg"], images)
    assert_close(te, jcs.clip_text_embed(j["text_params"], j["text_cfg"], j["tokenizer"],
                                         PROMPTS), TOL, 0, rel=True, what="text embeds")
    assert_close(ie, jcs.clip_image_embed(j["vision_params"], j["vision_cfg"], images), TOL, 0,
                 rel=True, what="image embeds")
    assert torch.allclose(torch.linalg.vector_norm(ie, dim=-1), torch.ones(2), atol=1e-5)


def test_tokenizer_and_tiny_scorer():
    a, b = tcs._HashWordTokenizer(128, 127), jcs._HashWordTokenizer(128, 127)
    for text in PROMPTS + ["", "MiXeD   Case words"]:
        assert a.encode(text) == b.encode(text)
    s1 = tcs.make_tiny_scoring_clip(0, device="cpu")
    s2 = tcs.make_tiny_scoring_clip(0, device="cpu")
    # the JAX scorer's configs (its weights are JAX draws, not the port's)
    jt = dataclasses.replace(jclip.CLIPTextConfig.tiny(), projection_dim=16)
    assert dataclasses.asdict(s1["text_cfg"]) == dataclasses.asdict(jt)
    assert dataclasses.asdict(s1["vision_cfg"]) == dataclasses.asdict(jclip.CLIPVisionConfig.tiny())
    assert s1["tiny_pin"] is True
    images = _images()
    x, y = _score(tcs, s1, images, PROMPTS), _score(tcs, s2, images, PROMPTS)
    np.testing.assert_array_equal(x, y)  # seeded: the same pin every time
    assert np.isfinite(x).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tcs.make_tiny_scoring_clip(0)


def test_regression_kit_file_is_read_across_packages(tmp_path):
    scores = {"cat": 31.25, "clock": 27.5, "b": 10.0}
    pj, pt = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jcs.RegressionKit(pj).record(scores)
    tcs.RegressionKit(pt).record(scores)
    assert open(pj).read() == open(pt).read()
    assert json.load(open(pt)) == scores
    for writer, reader in ((jcs, tcs), (tcs, jcs)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.kit.json")
        writer.RegressionKit(path).record(scores)
        kit = reader.RegressionKit(path, tolerance=1.0)
        assert kit.records == scores
        now = {"cat": 30.5, "clock": 26.0, "b": 9.5, "new": 1.0}
        assert kit.check(now) == ["clock"]
        kit.record({"new": 1.0})
        assert writer.RegressionKit(path).records == {**scores, "new": 1.0}


def _write_tiny_tree(root, with_tokenizer=True):
    """clip-vit-h/ (an HF CLIPTextModelWithProjection state dict, +
    tokenizer/) and sdxl/image_encoder/ (CLIPVisionModelWithProjection),
    tiny, random, written under the HF keys by the CLIP key maps."""
    from ckpt_fixtures import _write_clip_tokenizer

    from instructany2pix_tpu_torch.models import layers as L

    vocab = None
    if with_tokenizer:
        vocab = _write_clip_tokenizer(os.path.join(root, "clip-vit-h", "tokenizer"))
    n = len(vocab) if vocab else 600
    tcfg = dataclasses.replace(jclip.CLIPTextConfig.tiny(), vocab_size=n, eos_token_id=n - 1,
                               max_positions=77, projection_dim=16)
    vcfg = dataclasses.replace(jclip.CLIPVisionConfig.tiny(), hidden_act="quick_gelu")
    gen = torch.Generator().manual_seed(0)
    for sub, make, km in (
            ("clip-vit-h", lambda: tclip.CLIPText(tclip.CLIPTextConfig(**dataclasses.asdict(tcfg))),
             tclip.text_keymap()),
            (os.path.join("sdxl", "image_encoder"),
             lambda: tclip.CLIPVision(tclip.CLIPVisionConfig(**dataclasses.asdict(vcfg))),
             tclip.vision_keymap())):
        with torch.device("meta"):
            m = make()
        m = L.init_(L.materialize(m, torch.device("cpu"), torch.float32), gen)
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        torch.save({k: v.detach().contiguous() for k, v in km.to_ref(
            dict(m.named_parameters())).items()}, os.path.join(root, sub, "pytorch_model.bin"))
    return tcfg, vcfg


def test_load_scoring_clip(tmp_path, monkeypatch):
    assert tcs.load_scoring_clip(str(tmp_path / "absent")) is None
    assert jcs.load_scoring_clip(str(tmp_path / "absent")) is None
    bare = tmp_path / "no_tokenizer"
    _write_tiny_tree(str(bare), with_tokenizer=False)
    assert tcs.load_scoring_clip(str(bare), device="cpu") is None
    assert jcs.load_scoring_clip(str(bare)) is None
    root = tmp_path / "tree"
    jt, jv = _write_tiny_tree(str(root))
    pt = tclip.CLIPTextConfig(**dataclasses.asdict(jt))
    pv = tclip.CLIPVisionConfig(**dataclasses.asdict(jv))
    # the function reads ViT-H/14 towers: stand the tiny configs in for them
    monkeypatch.setattr(tclip.CLIPTextConfig, "vit_h", staticmethod(lambda: pt))
    monkeypatch.setattr(tclip.CLIPVisionConfig, "vit_h", staticmethod(lambda: pv))
    got = tcs.load_scoring_clip(str(root), device="cpu")
    want = jcs.load_scoring_clip(str(root))  # its params; its configs are ViT-H's
    assert got is not None and want is not None
    assert got["text_cfg"] is pt and got["vision_cfg"] is pv
    prompts = ["best quality photo of a cat", "a dog in a shop"]
    for p in prompts:
        assert got["tokenizer"].encode(p) == list(want["tokenizer"].encode(p))
    # the towers the port loads are the JAX converters' weights, bit for bit
    for name, conv, cfg in (("text_params", convert.clip_text, pt),
                            ("vision_params", convert.clip_vision, pv)):
        ref = conv(convert.to_numpy(want[name]), cfg)
        for (n, a), (_, b) in zip(got[name].named_parameters(), ref.named_parameters()):
            assert torch.equal(a, b), f"{name}.{n}"
    assert np.isfinite(_score(tcs, got, _images(), prompts)).all()
    if not torch.cuda.is_available():  # no silent CPU run
        with pytest.raises(RuntimeError):
            tcs.load_scoring_clip(str(root))
