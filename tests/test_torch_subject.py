"""Subject consistency in the port vs the JAX package: mask morphology at
the pipeline's sizes, the grounding helpers and fallbacks, both inpaint
branches (the 9-channel inpaint UNet and the base UNet's latent blend),
the IP-Adapter local tokens, and the tiny edit with `subject_strength`
through a tiny SAM segmentor and the whole-image grounder, once with each
inpaint UNet. Same converted weights and the JAX draws injected; CPU,
float32. `from_model_range` truncates to uint8, so images agree within 1."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu import pipeline as jpl
from instructany2pix_tpu.core.prng import KeyChain
from instructany2pix_tpu.diffusion import img2img as ji2i
from instructany2pix_tpu.diffusion import ip_adapter as jipa
from instructany2pix_tpu.grounding import lib as jlib
from instructany2pix_tpu.grounding import morphology as jmorph
from instructany2pix_tpu.grounding import sam as jsam
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch import pipeline as tpl
from instructany2pix_tpu_torch.core.dtypes import FP32
from instructany2pix_tpu_torch.diffusion import img2img as ti2i
from instructany2pix_tpu_torch.diffusion import ip_adapter as tipa
from instructany2pix_tpu_torch.grounding import lib as tlib
from instructany2pix_tpu_torch.grounding import morphology as tmorph
from instructany2pix_tpu_torch.grounding import sam as tsam
from torch_port_helpers import assert_close, one_torch_thread, randn, t  # noqa: F401 (autouse)

MORPH_TOL = 1e-5  # float32 blur sums in another order; pools are exact
LATENT_TOL = 2e-4  # float32 through several UNet steps, relative to the largest value
IP_TOL = 1e-5
UINT8_TOL = 1


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_mask_matches_jax(seed):
    """Erode 10 / dilate 40 (even sizes: one more pad before than after)
    and a 21-wide zero-padded blur, on a random binary mask."""
    rs = np.random.RandomState(seed)
    mask = (rs.rand(120, 96) > 0.7).astype(np.float32)
    mask[30:90, 20:70] = 1.0
    out_j = jmorph.refine_mask(jnp.asarray(mask), 40, 10, 21)
    assert_close(tmorph.refine_mask(t(mask), 40, 10, 21), out_j, MORPH_TOL, seed, what="refine_mask")
    for size in (10, 40, 7):
        assert_close(tmorph.erode(t(mask), size), jmorph.erode(jnp.asarray(mask), size), 0, seed,
                     what=f"erode {size}")
        assert_close(tmorph.dilate(t(mask), size), jmorph.dilate(jnp.asarray(mask), size), 0, seed,
                     what=f"dilate {size}")
    assert np.array_equal(tmorph.gaussian_kernel1d(21), np.asarray(jmorph.gaussian_kernel1d(21)))


def test_grounding_helpers_and_fallbacks_match_jax():
    boxes = np.asarray([[0.5, 0.4, 0.5, 0.6], [0.2, 0.3, 0.1, 0.2]], np.float32)
    assert np.allclose(tlib.boxes_cxcywh_to_xyxy(boxes, 48, 64), jlib.boxes_cxcywh_to_xyxy(boxes, 48, 64))
    for phrases, target in ((["a dog", "cat"], "cat"), (["red cat", "dog"], "cat"), (["x"], "dog")):
        assert tlib.match_phrase_to_box(phrases, target) == jlib.match_phrase_to_box(phrases, target)
    img = np.zeros((48, 64, 3), np.uint8)
    gb_t = tlib.cosine_fallback_grounder(None)(img, "dog . red cat")
    gb_j = jlib.cosine_fallback_grounder(None)(img, "dog . red cat")
    for a, b in zip(gb_t, gb_j):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    box = [3.4, 5.6, 40.2, 30.9]
    assert np.array_equal(tlib.box_fill_segmentor(img, box), jlib.box_fill_segmentor(img, box))
    m_t = tlib.get_mask("red cat", boxes, ["dog", "red cat"], tlib.box_fill_segmentor, img)
    m_j = jlib.get_mask("red cat", boxes, ["dog", "red cat"], jlib.box_fill_segmentor, img)
    assert_close(t(m_t), m_j, MORPH_TOL, 0, what="get_mask")
    assert tlib.get_mask("bird", boxes, ["dog"], tlib.box_fill_segmentor, img) is None

    calls = {"port": [], "jax": []}

    def inpaint(name):
        def fn(image, mask, embed, prompt):
            calls[name].append((np.asarray(mask), np.asarray(embed), prompt))
            return image + 1
        return fn

    subjects = [{"name": "dog", "embed": np.ones(4)}, {"name": "cat", "embed": np.zeros(4)}]
    out_t, ann_t = tlib.subject_consistency(subjects, "cap", img, tlib.box_fill_segmentor,
                                            tlib.cosine_fallback_grounder(None), inpaint("port"))
    out_j, ann_j = jlib.subject_consistency(subjects, "cap", img, jlib.box_fill_segmentor,
                                            jlib.cosine_fallback_grounder(None), inpaint("jax"))
    assert np.array_equal(out_t, out_j) and ann_t["phrases"] == ann_j["phrases"]
    assert len(calls["port"]) == len(calls["jax"]) == 2
    for (mt, et, pt), (mj, ej, pj) in zip(calls["port"], calls["jax"]):
        assert_close(t(mt), mj, MORPH_TOL, 0, what="subject mask")
        assert np.array_equal(et, ej) and pt == pj


def test_build_segmentator(tmp_path):
    """Without checkpoints: the fallbacks. With `sam_vit_h_4b8939.pth` and
    `gdino.pth` (random tiny models written under the official keys): the
    loaded SAM and GroundingDINO, which need `vocab.txt` beside them."""
    from instructany2pix_tpu_torch.grounding import gdino as tgdino
    from instructany2pix_tpu_torch.models import layers as L

    seg, grd = tlib.build_segmentator(str(tmp_path))
    assert seg is tlib.box_fill_segmentor
    assert grd(np.zeros((8, 8, 3), np.uint8), "dog . cat")[2] == ["dog", "cat"]
    scfg, gcfg = tsam.SAMConfig.tiny(), tgdino.GDinoConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        sam, dino = tsam.SAM(scfg), tgdino.GDino(gcfg)
    sam = tsam.init_(L.materialize(sam, torch.device("cpu"), torch.float32), gen)
    dino = tgdino.init_(L.materialize(dino, torch.device("cpu"), torch.float32), gcfg, gen)
    for name, m, km in (("sam_vit_h_4b8939.pth", sam, tsam.keymap(scfg)),
                        ("gdino.pth", dino, tgdino.keymap(gcfg))):
        torch.save(km.to_ref(dict(m.named_parameters())), str(tmp_path / name))
    with pytest.raises(FileNotFoundError, match="vocab.txt"):
        tlib.build_segmentator(str(tmp_path), scfg, gcfg, device="cpu")
    (tmp_path / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "cat", "dog"]))
    seg, grd = tlib.build_segmentator(str(tmp_path), scfg, gcfg, device="cpu")
    assert seg.__qualname__.startswith("make_segmentor")
    assert grd.__qualname__.startswith("make_grounder")
    img = np.random.RandomState(0).randint(0, 255, (40, 32, 3), np.uint8)
    mask = seg(img, np.asarray([2.0, 3.0, 20.0, 30.0]))
    assert mask.shape == (40, 32)
    assert np.array_equal(mask, tsam.make_segmentor(sam, scfg)(img, np.asarray([2.0, 3.0, 20.0, 30.0])))


@pytest.fixture(scope="module")
def jax_pipe():
    return jpl.InstructAny2PixPipeline(tiny=True, seed=0)


def test_ip_local_tokens_match_jax(jax_pipe):
    """The inpaint's IP tokens: a 1-D subject embedding as (1, D), local mode."""
    jp = jax_pipe
    cfg = jp.cfg.image_proj
    tproj = convert.image_proj(convert.to_numpy(jp.params["image_proj"]), cfg)
    embed = randn(900, cfg.clip_embeddings_dim)
    c_j, u_j = jipa.get_image_embeds(jp.params["image_proj"], cfg,
                                     clip_image_embeds_local=jnp.asarray(embed).reshape(1, -1),
                                     mode="local")
    c, u = tipa.get_image_embeds(tproj, cfg, clip_image_embeds_local=t(embed).reshape(1, -1),
                                 mode="local")
    assert_close(c, c_j, IP_TOL, 900, what="local cond tokens")
    assert_close(u, u_j, IP_TOL, 900, what="local uncond tokens")


@pytest.mark.parametrize("which", ["inpaint9", "base4"])
def test_inpaint_matches_jax(jax_pipe, which):
    jp = jax_pipe
    c = jp.cfg
    name = "inpaint_unet" if which == "inpaint9" else "unet"
    ucfg = c.inpaint_unet if which == "inpaint9" else c.unet
    tunet = convert.unet(convert.to_numpy(jp.params[name]), ucfg)
    hl = c.image_size // 2 ** (len(c.vae.block_out_channels) - 1)
    seed = 1000 + ucfg.in_channels
    lat, mlat = randn(seed, 1, hl, hl, 4), randn(seed + 1, 1, hl, hl, 4)
    mask = np.zeros((1, c.image_size, c.image_size, 1), np.float32)
    mask[:, 10:50, 7:41] = 1.0
    mask[:, 12:20, 30:33] = 0.3
    ctx, ctx_n = randn(seed + 2, 1, 77, c.unet.cross_attention_dim), randn(seed + 3, 1, 77, c.unet.cross_attention_dim)
    pooled_dim = c.unet.projection_class_embeddings_input_dim - 6 * c.unet.addition_time_embed_dim
    pooled, pooled_n = randn(seed + 4, 1, pooled_dim), randn(seed + 5, 1, pooled_dim)
    ip, ip_u = randn(seed + 6, 1, 4, c.unet.cross_attention_dim), randn(seed + 7, 1, 4, c.unet.cross_attention_dim)
    tid = np.asarray([[64, 64, 0, 0, 64, 64]], np.float32)
    key = jax.random.key(seed)
    kw = dict(num_inference_steps=10, strength=0.3, guidance_scale=7.5, ip_scale=0.8)
    j_out = ji2i.inpaint(jp.params[name], ucfg, jp.schedule, *(jnp.asarray(x) for x in (lat, mask, mlat)),
                         key, *(jnp.asarray(x) for x in (ctx, ctx_n, pooled, pooled_n, tid)),
                         ip_tokens=jnp.asarray(ip), ip_tokens_uncond=jnp.asarray(ip_u), **kw)
    noise = np.asarray(jax.random.normal(key, lat.shape))
    tp = tpl.InstructAny2PixPipeline(tpl.PipelineConfig.tiny(), params=convert.pipeline_params(jp.params),
                                     device="cpu", policy=FP32)
    out = ti2i.inpaint(tunet, ucfg, tp.schedule, *(t(x) for x in (lat, mask, mlat, ctx, ctx_n, pooled,
                                                                   pooled_n, tid)),
                       ip_tokens=t(ip), ip_tokens_uncond=t(ip_u), noise=t(noise), **kw)
    assert_close(out, j_out, LATENT_TOL, seed, rel=True, what=f"inpaint {which}")
    # the keep region of the base path is the source noised along the grid:
    # a zero mask returns the source latents exactly at the last step
    if which == "base4":
        zero = ti2i.inpaint(tunet, ucfg, tp.schedule, t(lat), t(mask * 0), t(mlat),
                            *(t(x) for x in (ctx, ctx_n, pooled, pooled_n, tid)),
                            ip_tokens=t(ip), ip_tokens_uncond=t(ip_u), noise=t(noise), **kw)
        assert torch.equal(zero, t(lat))


def _randomized_sam_tree(cfg, seed):
    leaves, treedef = jax.tree.flatten(jsam.init(jax.random.key(seed), cfg))
    rs = np.random.RandomState(seed)
    return jax.tree.unflatten(
        treedef, [jnp.asarray(rs.randn(*np.shape(x)).astype(np.float32) * 0.3) for x in leaves])


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("media")
    img = str(d / "img.png")
    Image.fromarray(np.random.RandomState(0).randint(0, 255, (96, 80, 3), np.uint8)).save(img)
    return [{"type": "image", "fname": img}]


def _seed_cache(pipe, media, to_array):
    rs = np.random.RandomState(7)
    d = pipe.cfg.llm.image_codec_dim
    pipe.cache = (to_array(rs.randn(1, d).astype(np.float32)), to_array(rs.randn(d).astype(np.float32)),
                  "a test caption", media[0]["fname"],
                  dict(all_objs=["cat"], extra_embeds=rs.randn(1, d).astype(np.float32),
                       extra_idx=np.array([0])))


@pytest.mark.parametrize("which,refinement", [("inpaint9", 0.5), ("base4", 0.0)])
def test_edit_with_subject_matches_jax(jax_pipe, media, which, refinement):
    jp0 = jax_pipe
    jcfg, params = jp0.cfg, jp0.params
    tcfg = tpl.PipelineConfig.tiny()
    if which == "base4":  # the checkpoint layout: the base UNet inpaints
        jcfg = dataclasses.replace(jcfg, inpaint_unet=jcfg.unet)
        params = {**params, "inpaint_unet": params["unet"]}
        tcfg = dataclasses.replace(tcfg, inpaint_unet=tcfg.unet)
    jp = jpl.InstructAny2PixPipeline(tiny=True, seed=0, config=jcfg, params=params)
    tp = tpl.InstructAny2PixPipeline(tcfg, params=convert.pipeline_params(params), device="cpu",
                                     policy=FP32)
    assert ("inpaint_unet" in tp.models) == (which == "inpaint9")
    sam_cfg = jsam.SAMConfig.tiny()
    sam_tree = _randomized_sam_tree(sam_cfg, 31)  # a seed whose mask is neither empty nor full
    jp.segmentor = jsam.make_segmentor(sam_tree, sam_cfg, dtype=None)
    seg = tsam.make_segmentor(convert.sam(convert.to_numpy(sam_tree), tsam.SAMConfig.tiny()),
                              tsam.SAMConfig.tiny(), dtype=None)
    masks = []
    tp.segmentor = lambda image, box: masks.append(seg(image, box)) or masks[-1]
    jp.grounder = jlib.cosine_fallback_grounder(None)
    tp.grounder = tlib.cosine_fallback_grounder(None)

    seed, steps = 4, 2
    _seed_cache(jp, media, jnp.asarray)
    j_non, j_ref, j_msg = jp("add <video>", media, num_inference_steps=steps, refinement=refinement,
                             seed=seed, use_cache=True, subject_strength=0.7)
    # the JAX draws in KeyChain order: LLM, VAE posterior, polar, [refiner
    # VAE posterior, refiner noise], then the subject's VAE posteriors of the
    # image and of the masked image and the inpaint start noise
    kc = KeyChain(seed)
    kc()
    hl = tp._latent_size()
    shape = (1, hl, hl, 4)
    names = ["vae_noise", "polar_noise"] + (["refiner_vae_noise", "refiner_noise"] if refinement else [])
    draws = {n: np.asarray(jax.random.normal(kc(), shape)) for n in names}
    subject = {k: np.asarray(jax.random.normal(kc(), shape)) for k in ("vae", "masked_vae", "inpaint")}
    _seed_cache(tp, media, np.asarray)
    tp.stage_times = {}
    t_non, t_ref, t_msg = tp("add <video>", media, num_inference_steps=steps, refinement=refinement,
                             seed=seed, use_cache=True, subject_strength=0.7,
                             subject_noise=[subject], **draws)
    assert t_msg == j_msg == "SUCCESS!"
    assert {"grounding", "segmentation", "inpaint"} <= set(tp.stage_times)
    assert len(masks) == 1 and 0 < masks[0].mean() < 1, "the SAM mask is empty or full"
    for name, a, b in (("non_refined", t_non, j_non), ("subject-inpainted", t_ref, j_ref)):
        assert a.shape == b.shape == (64, 64, 3) and a.dtype == np.uint8
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= UINT8_TOL, (
            f"{which} {name}: max {d.max()} levels, mean {d.mean():.4g}, {int((d > 0).sum())} differ")
    # the inpaint changed the image
    base = t_non if refinement == 0 else None
    if base is not None:
        assert np.abs(t_ref.astype(np.int32) - base.astype(np.int32)).max() > UINT8_TOL


def test_subject_noise_is_checked(media):
    tp = tpl.InstructAny2PixPipeline(tpl.PipelineConfig.tiny(), device="cpu", policy=FP32)
    _seed_cache(tp, media, np.asarray)
    with pytest.raises(ValueError, match="injected noise shape"):
        tp("add <video>", media, num_inference_steps=1, refinement=0.0, seed=0, use_cache=True,
           subject_strength=0.5, subject_noise=[{"vae": np.zeros((1, 3, 3, 4))}])
