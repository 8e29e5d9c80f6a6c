"""The IP-Adapter Plus Resampler of the port against the JAX package at
tiny sizes, float32: `apply` (plain, with `pos_emb`, with mean-pooled
latents), `plus_xl`'s shapes, and `get_image_embeds_plus` through the tiny
CLIP image tower (penultimate hidden states; the uncond side a zero image)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.diffusion import ip_adapter as jipa
from instructany2pix_tpu.diffusion import resampler as jres
from instructany2pix_tpu.models import clip as jclip
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.core import checkpoint as ckpt_lib
from instructany2pix_tpu_torch.diffusion import resampler as res
from instructany2pix_tpu_torch.models import clip as tclip
from instructany2pix_tpu_torch.models import layers as L
from torch_port_helpers import assert_close, one_torch_thread, randn, t  # noqa: F401

TOL = 2e-5  # float32 both sides


def _tree(jcfg, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rs.randn(*np.shape(x))).astype(np.float32),
                        jres.init(jax.random.key(seed), jcfg))


def _pcfg(jcfg):
    return res.ResamplerConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("variant", ["plain", "pos_emb", "mean_pooled"])
def test_apply_matches_jax(variant):
    seed = 311
    jcfg = jres.ResamplerConfig.tiny()
    if variant == "pos_emb":
        jcfg = dataclasses.replace(jcfg, apply_pos_emb=True)
    elif variant == "mean_pooled":
        jcfg = dataclasses.replace(jcfg, num_latents_mean_pooled=3)
    tree = _tree(jcfg, seed)
    model = convert.resampler(tree, _pcfg(jcfg))
    x = randn(seed, 2, 10, jcfg.embedding_dim)
    ref = jres.apply(tree, jnp.asarray(x), jcfg)
    out = res.apply(model, t(x), _pcfg(jcfg))
    n = jcfg.num_queries + jcfg.num_latents_mean_pooled
    assert out.shape == (2, n, jcfg.output_dim)
    assert_close(out, ref, TOL, seed, what=variant)


def test_plus_xl_shapes():
    cfg = res.ResamplerConfig.plus_xl()
    assert (cfg.dim, cfg.depth, cfg.heads, cfg.num_queries, cfg.embedding_dim, cfg.output_dim) == (
        1280, 4, 20, 16, 1280, 2048)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jres.ResamplerConfig.plus_xl())
    with torch.device("meta"):
        m = res.Resampler(cfg)
    n = sum(p.numel() for p in m.parameters())
    jn = sum(np.prod(np.shape(x)) for x in jax.tree.leaves(
        jax.eval_shape(lambda: jres.init(jax.random.key(0), jres.ResamplerConfig.plus_xl()))))
    assert n == jn
    out = res.apply(res.init(res.ResamplerConfig.tiny(), torch.Generator().manual_seed(0)),
                    torch.zeros(2, 5, 16), res.ResamplerConfig.tiny())
    assert out.shape == (2, 4, 24) and torch.isfinite(out).all()


def test_get_image_embeds_plus_through_clip_tower():
    from transformers import CLIPVisionConfig as HFVCfg
    from transformers import CLIPVisionModelWithProjection

    seed = 313
    torch.manual_seed(seed)
    hf = CLIPVisionModelWithProjection(HFVCfg(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        image_size=28, patch_size=14, projection_dim=16, hidden_act="gelu")).eval()
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    jtower = jclip.convert_vision_from_hf({k: v.numpy() for k, v in sd.items()})
    jvcfg = jclip.CLIPVisionConfig.tiny()
    vcfg = tclip.CLIPVisionConfig(**dataclasses.asdict(jvcfg))
    with torch.device("meta"):
        m = tclip.CLIPVision(vcfg)
    tower = L.materialize(m, torch.device("cpu"), torch.float32)
    ckpt_lib.load_module(tower, tclip.vision_keymap().to_port(sd), "clip vision")

    jcfg = dataclasses.replace(jres.ResamplerConfig.tiny(), embedding_dim=jvcfg.hidden_size)
    tree = _tree(jcfg, seed)
    model = convert.resampler(tree, _pcfg(jcfg))
    img = (np.random.RandomState(seed).rand(40, 36, 3) * 255).astype(np.uint8)
    px = jipa.preprocess_clip_image(img, jvcfg.image_size)
    hid = jclip.vision_apply(jtower, px, jvcfg)["hidden_states"][-2]
    hid_u = jclip.vision_apply(jtower, jnp.zeros_like(px), jvcfg)["hidden_states"][-2]
    ref = jres.get_image_embeds_plus(tree, jcfg, hid, hid_u)
    out = res.get_image_embeds_plus(model, _pcfg(jcfg), image=img, image_encoder=(tower, vcfg))
    for o, r, name in zip(out, ref, ("cond", "uncond")):
        assert_close(o, r, TOL, seed, what=name)
    # the states themselves go in as well
    again = res.get_image_embeds_plus(model, _pcfg(jcfg), t(np.asarray(hid)), t(np.asarray(hid_u)))
    assert_close(again[0], ref[0], TOL, seed, what="from states")
    with pytest.raises(ValueError, match="image_encoder"):
        res.get_image_embeds_plus(model, _pcfg(jcfg), image=img)
