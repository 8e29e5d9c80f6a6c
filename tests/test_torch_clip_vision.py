"""The CLIP vision tower and the image-encoder inputs of the port against
the JAX package: one random HF-layout `CLIPVisionModelWithProjection` state
dict (tiny, exact gelu as ViT-H/14), fed raw to the port through its
`vision_keymap` and through `convert_vision_from_hf` to JAX; every output of
`vision_apply` and every `select_feature` of the LLM's vision tower, the
key map read both ways, `encode_clip_image`, `get_image_embeds(image=...)`,
the MLP projector and `llm/mm_utils.py`. CPU, float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import assert_close, one_torch_thread, randn, t  # noqa: F401 (autouse)

from instructany2pix_tpu.diffusion import ip_adapter as jipa
from instructany2pix_tpu.llm import mm_utils as jmm
from instructany2pix_tpu.llm import tokenizer as jtok
from instructany2pix_tpu.llm import vision_tower as jvt
from instructany2pix_tpu.models import clip as jclip
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.core import checkpoint as ckpt_lib
from instructany2pix_tpu_torch.diffusion import ip_adapter as tipa
from instructany2pix_tpu_torch.llm import mm_utils as tmm
from instructany2pix_tpu_torch.llm import tokenizer as ttok
from instructany2pix_tpu_torch.llm import vision_tower as tvt
from instructany2pix_tpu_torch.models import clip as tclip
from instructany2pix_tpu_torch.models import imagebind as tib

TOL = 2e-5  # float32 on both sides, sums in another order


def _tcfg(jcfg):
    return tclip.CLIPVisionConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def tower():
    """(HF state dict, JAX params, port module) of one tiny tower."""
    from transformers import CLIPVisionConfig as HFVCfg
    from transformers import CLIPVisionModelWithProjection

    torch.manual_seed(0)
    hf = CLIPVisionModelWithProjection(HFVCfg(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        image_size=28, patch_size=14, projection_dim=16, hidden_act="gelu")).eval()
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    jparams = jclip.convert_vision_from_hf({k: v.numpy() for k, v in sd.items()})
    cfg = _tcfg(jclip.CLIPVisionConfig.tiny())
    with torch.device("meta"):
        m = tclip.CLIPVision(cfg)
    from instructany2pix_tpu_torch.models import layers as L

    port = L.materialize(m, torch.device("cpu"), torch.float32)
    ckpt_lib.load_module(port, tclip.vision_keymap().to_port(sd), "clip vision")
    return sd, jparams, port.eval().requires_grad_(False), hf


def test_vision_keymap_reads_both_ways(tower):
    sd, jparams, port, _ = tower
    back = tclip.vision_keymap().to_ref(dict(port.named_parameters()))
    assert sorted(back) == sorted(k for k in sd if not k.endswith("position_ids"))
    assert all(torch.equal(back[k], sd[k]) for k in back)
    # the JAX converter's tree loads into the same module, bit for bit
    conv = convert.build(tclip.CLIPVision(port.cfg), convert.to_numpy(jparams))
    for (n, a), (_, b) in zip(port.named_parameters(), conv.named_parameters()):
        assert torch.equal(a, b), n


def test_vision_apply_matches_jax_and_hf(tower):
    sd, jparams, port, hf = tower
    jcfg = jclip.CLIPVisionConfig.tiny()
    px = randn(1, 2, 28, 28, 3)
    want = jclip.vision_apply(jparams, jnp.asarray(px), jcfg)
    got = tclip.vision_apply(port, t(px), port.cfg)
    assert len(got["hidden_states"]) == len(want["hidden_states"]) == jcfg.num_layers + 1
    for i, (a, b) in enumerate(zip(got["hidden_states"], want["hidden_states"])):
        assert_close(a, b, TOL, 1, rel=True, what=f"hidden_states[{i}]")
    for key in ("last_hidden_state", "pooled", "image_embeds"):
        assert_close(got[key], want[key], TOL, 1, rel=True, what=key)
    with torch.no_grad():
        ref = hf(pixel_values=t(px.transpose(0, 3, 1, 2))).image_embeds
    assert_close(got["image_embeds"], ref.numpy(), TOL, 1, rel=True, what="vs HF")
    plain = tclip.vision_apply(port, t(px), port.cfg, impl="xla")
    assert_close(plain["image_embeds"], got["image_embeds"].numpy(), 1e-6, 1, rel=True,
                 what="plain attention")


@pytest.mark.parametrize("feature,layer", [("patch", -2), ("cls_patch", -1), ("projection", -2)])
def test_vision_tower_features_match_jax(tower, feature, layer):
    _, jparams, port, _ = tower
    jcfg = jvt.VisionTowerConfig(select_feature=feature, select_layer=layer,
                                 clip=jclip.CLIPVisionConfig.tiny())
    tcfg = tvt.VisionTowerConfig(select_feature=feature, select_layer=layer, clip=port.cfg)
    px = randn(2, 3, 28, 28, 3)
    want = jvt.apply(jparams, jnp.asarray(px), jcfg)
    got = tvt.apply(port, t(px), tcfg)
    assert_close(got, want, TOL, 2, rel=True, what=feature)
    zeros_j, zeros_t = jvt.apply(jparams, None, jcfg, batch=3), tvt.apply(port, None, tcfg, batch=3)
    assert tuple(zeros_t.shape) == zeros_j.shape and not zeros_t.any()


def test_build_vision_tower_by_name():
    gen = torch.Generator().manual_seed(0)
    m, cfg = tvt.build_vision_tower("LanguageBind/Video", gen)
    assert isinstance(m, tib.ViT) and cfg == tib.ViTConfig.imagebind_vision()
    m, cfg = tvt.build_vision_tower("openai/clip-vit-large-patch14", gen,
                                    clip=tclip.CLIPVisionConfig.tiny(), select_feature="cls_patch")
    assert isinstance(m, tclip.CLIPVision) and cfg.select_feature == "cls_patch"
    assert tvt.apply(m, torch.zeros(1, 28, 28, 3), cfg).shape == (1, 5, 32)


def test_encode_clip_image_and_get_image_embeds_match_jax(tower):
    _, jparams, port, _ = tower
    jcfg = jclip.CLIPVisionConfig.tiny()
    rs = np.random.RandomState(3)
    imgs = [rs.randint(0, 256, (40, 30, 3)).astype(np.uint8),
            rs.randint(0, 2, (30, 50, 3)).astype(np.uint8),  # near-black uint8: still / 255
            rs.rand(33, 33, 3).astype(np.float32)]
    for img in imgs:
        assert_close(tipa.preprocess_clip_image(img, 28),
                     jipa.preprocess_clip_image(img, 28), 1e-5, 3, what="preprocess")
    assert_close(tipa.encode_clip_image(port, port.cfg, imgs[:2]),
                 jipa.encode_clip_image(jparams, jcfg, imgs[:2]), TOL, 3, rel=True, what="encode")
    pcfg = jipa.ImageProjConfig.tiny(cross_attention_dim=32, clip_embeddings_dim=16)
    jproj = jipa.init(jax.random.key(2), pcfg)
    jproj["raw_embed"] = jnp.asarray(randn(4, 2, 32))
    tproj = convert.image_proj(convert.to_numpy(jproj), tipa.ImageProjConfig(**dataclasses.asdict(pcfg)))
    for kw in (dict(image=imgs[0]), dict(image=imgs[0], image_local=imgs[1], scale_l=0.6),
               dict(image_local=imgs[2], mode="local")):
        want = jipa.get_image_embeds(jproj, pcfg, image_encoder=(jparams, jcfg), **kw)
        got = tipa.get_image_embeds(tproj, tproj.cfg, image_encoder=(port, port.cfg), **kw)
        for a, b in zip(got, want):
            assert_close(a, b, TOL, 4, rel=True, what=f"get_image_embeds {sorted(kw)}")
    with pytest.raises(ValueError, match="image_encoder"):
        tipa.get_image_embeds(tproj, tproj.cfg, image=imgs[0])


def test_mlp_proj_matches_jax():
    jparams = jipa.mlp_proj_init(jax.random.key(6), 16, 24)
    with torch.device("meta"):
        m = tipa.MLPProj(16, 24)
    port = convert.build(m, convert.to_numpy(jparams))
    x = randn(7, 2, 3, 16)
    assert_close(tipa.mlp_proj_apply(port, t(x)), jipa.mlp_proj_apply(jparams, jnp.asarray(x)),
                 TOL, 7, rel=True, what="mlp_proj")


def test_mm_utils_match_jax():
    jt, tt = jtok.ByteTokenizer(), ttok.ByteTokenizer()
    for prompt in ("describe <image> and <image>please", "<image>", "no image", "a<image>"):
        assert np.array_equal(tmm.tokenizer_image_token(prompt, tt),
                              jmm.tokenizer_image_token(prompt, jt)), prompt
    kw = ["</s>", "ASSISTANT:"]
    jstop, tstop = jmm.KeywordsStoppingCriteria(kw, jt, 2), tmm.KeywordsStoppingCriteria(kw, tt, 2)
    for ids in ([5, 6, 7], [5, 6] + jt.encode("ok ASSISTANT:", False), [1, 2, 9, 2], [9, 9]):
        assert tstop(ids) == jstop(ids), ids
    assert tstop.keyword_ids == jstop.keyword_ids
    rs = np.random.RandomState(8)
    imgs = [rs.randint(0, 256, s).astype(np.uint8) for s in ((20, 36, 3), (36, 20, 3), (16, 16, 3))]
    for img in imgs:
        assert np.array_equal(tmm.expand2square(img), jmm.expand2square(img))
    assert np.array_equal(tmm.process_images(imgs, 24), jmm.process_images(imgs, 24))
