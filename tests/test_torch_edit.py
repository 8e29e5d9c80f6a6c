"""The port's edit (`InstructAny2PixPipeline.__call__` and `forward_llm`)
vs the JAX pipeline at the tiny config: same converted weights, the LLM
half seeded through `pipe.cache` as the JAX tests do, and the JAX draws of
every sampling site handed to the port. `from_model_range` truncates to
uint8, so a last-digit difference may flip one level: images agree within
1. CPU, float32."""

import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu import pipeline as jpl
from instructany2pix_tpu.core.prng import KeyChain
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch import pipeline as tpl
from instructany2pix_tpu_torch.core.dtypes import FP32
from torch_port_helpers import assert_close

UINT8_TOL = 1


@pytest.fixture(scope="module")
def pipes():
    jp = jpl.InstructAny2PixPipeline(tiny=True, seed=0)
    tp = tpl.InstructAny2PixPipeline(tpl.PipelineConfig.tiny(), params=convert.pipeline_params(jp.params),
                                     device="cpu", policy=FP32)
    return jp, tp


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("media")
    rs = np.random.RandomState(0)
    img = str(d / "img1.png")
    Image.fromarray(rs.randint(0, 255, (96, 80, 3), np.uint8)).save(img)
    wav = str(d / "a.wav")
    with wave.open(wav, "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes((np.sin(np.arange(22050 * 3) * 0.05) * 9000).astype(np.int16).tobytes())
    return [{"type": "image", "fname": img}, {"type": "audio", "fname": wav}]


def _seed_cache(pipe, media, to_array):
    rs = np.random.RandomState(7)
    d = pipe.cfg.llm.image_codec_dim
    pipe.cache = (
        to_array(rs.randn(1, d).astype(np.float32)),
        to_array(rs.randn(d).astype(np.float32)),
        "a test caption",
        media[0]["fname"],
        dict(all_objs=["cat"], extra_embeds=rs.randn(1, d).astype(np.float32),
             extra_idx=np.array([0])),
    )


@pytest.mark.parametrize("seed,refinement,steps", [(0, 0.5, 2), (3, 0.3, 3)])
def test_edit_matches_jax(pipes, media, seed, refinement, steps):
    jp, tp = pipes
    _seed_cache(jp, media, jnp.asarray)
    j_non, j_ref, j_msg = jp("add <video> to <video>", media, num_inference_steps=steps,
                             refinement=refinement, seed=seed, use_cache=True)
    # the JAX draws, in its KeyChain order: LLM, VAE posterior, polar,
    # refiner VAE posterior, refiner img2img
    kc = KeyChain(seed)
    kc()
    hl = tp._latent_size()
    shape = (1, hl, hl, 4)
    draws = {name: np.asarray(jax.random.normal(kc(), shape))
             for name in ("vae_noise", "polar_noise", "refiner_vae_noise", "refiner_noise")}
    _seed_cache(tp, media, np.asarray)
    t_non, t_ref, t_msg = tp("add <video> to <video>", media, num_inference_steps=steps,
                             refinement=refinement, seed=seed, use_cache=True, **draws)
    assert t_msg == j_msg == "SUCCESS!"
    for name, a, b in (("non_refined", t_non, j_non), ("refined", t_ref, j_ref)):
        assert a.shape == b.shape == (64, 64, 3) and a.dtype == np.uint8
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= UINT8_TOL, (
            f"{name} seed {seed}: max {d.max()} levels, mean {d.mean():.4g}, {int((d > 0).sum())} differ")


def test_media_encode_and_llm_inputs_match_jax(pipes, media):
    """ImageBind on an image file and a WAV file (resampled to 16 kHz), the
    renorm, the prompt and the `<video>` splice."""
    jp, tp = pipes
    items = media + [{"type": "image", "fname": "x", "embed": np.ones(16, np.float32)}]
    aux_j, aux_t = jp.embed_mm_data(items), tp.embed_mm_data(items)
    assert_close(aux_t, aux_j, 2e-5, 0, what="aux_info")
    inst = "put <video> in <video> and <video>"
    ids_j, emb_j = jp._prepare_llm_inputs(inst, aux_j)
    ids_t, emb_t = tp._prepare_llm_inputs(inst, aux_t)
    assert np.array_equal(ids_t, np.asarray(ids_j))
    assert int((ids_t == tp.cfg.llm.video_token_id).sum()) == len(items)
    assert_close(emb_t, emb_j, 2e-5, 0, what="spliced embeds")


def test_forward_llm_contract_and_determinism(pipes, media):
    _, tp = pipes
    tp.cache = None
    outs, tokens = [], []
    for _ in range(2):
        tp.cache = None
        outs.append(tp.forward_llm("add <video> to <video>", media,
                                   generator=torch.Generator().manual_seed(5)))
        tokens.append(tp.last_generate.tokens)
    for out in outs:
        assert isinstance(out, tuple) and len(out) == 5 and isinstance(out[2], str)
        if out[0] is not None:
            assert out[0].shape[-1] == tp.cfg.llm.image_codec_dim
    assert outs[0][2] == outs[1][2]
    assert torch.equal(tokens[0], tokens[1])
    tp.cache = None


def test_llm_only_returns_caption(pipes, media):
    _, tp = pipes
    tp.cache = None
    a, b, caption = tp("describe <video>", media, llm_only=True, seed=1)
    assert a is None and b is None and isinstance(caption, str)
    tp.cache = None


@pytest.mark.parametrize("kw", [{"diffusion_mode": "ipa_lcm"}, {"debug": True}])
def test_unported_options_raise(pipes, media, kw):
    _, tp = pipes
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tp("edit", media, use_cache=True, **kw)


def test_speculative_decode_is_refused():
    import dataclasses

    cfg = dataclasses.replace(tpl.PipelineConfig.tiny(), llm_speculative_layers=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpl.InstructAny2PixPipeline(cfg, device="cpu", policy=FP32)


def test_tokenizers_are_looked_up_where_the_jax_pipeline_looks(pipes, tmp_path, monkeypatch):
    """<ckpt>/<llm_folder>/tokenizer for the LLM, <ckpt>/clip-vit-h/tokenizer
    for the prior's CLIP, as in the JAX pipeline. The port is given `params`:
    with a checkpoint directory on disk it refuses to draw random weights."""
    ckpt = str(tmp_path)
    os.makedirs(os.path.join(ckpt, "my-llm", "tokenizer"))
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jpl), ("port", tpl)):
        real_tok, real_clip = mod.load_tokenizer, mod.load_clip_tokenizer
        monkeypatch.setattr(mod, "load_tokenizer",
                            lambda p, _r=real_tok, _s=seen[name]: (_s.append(p), _r(None))[1])
        monkeypatch.setattr(mod, "load_clip_tokenizer",
                            lambda p, _r=real_clip, _s=seen[name]: (_s.append(p), _r(p))[1])
    jpl.InstructAny2PixPipeline(ckpt=ckpt, llm_folder="my-llm", tiny=True, seed=0)
    tpl.InstructAny2PixPipeline(tpl.PipelineConfig.tiny(), params=convert.pipeline_params(
        pipes[0].params), device="cpu", policy=FP32, ckpt=ckpt, llm_folder="my-llm")
    tok_dir = os.path.join(ckpt, "my-llm", "tokenizer")
    assert seen["port"][0] == seen["jax"][0] == tok_dir
    assert os.path.join(ckpt, "clip-vit-h", "tokenizer") in seen["port"]
    assert [p for p in seen["port"] if "clip-vit-h" in p] == [p for p in seen["jax"] if "clip-vit-h" in p]


def _same_fields(port_cfg, jax_cfg, path):
    """Every field of a port config dataclass equals the JAX config's."""
    import dataclasses

    for f in dataclasses.fields(port_cfg):
        a, b = getattr(port_cfg, f.name), getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b, f"{path}.{f.name}")
        else:
            assert a == b, (f"{path}.{f.name}", a, b)


@pytest.mark.parametrize("which", ["full", "tiny"])
def test_edit_config_matches_jax(which):
    jcfg = jpl.PipelineConfig() if which == "full" else jpl.PipelineConfig.tiny()
    tcfg = tpl.PipelineConfig() if which == "full" else tpl.PipelineConfig.tiny()
    if which == "full":  # both leave the LLM to the pipeline: Vicuna-7B
        assert jcfg.llm is None and tcfg.llm is None
        jcfg = jpl.dataclasses.replace(jcfg, llm=jpl.mm_lib.Any2PixLMConfig())
        tcfg = tpl.dataclasses.replace(tcfg, llm=tpl.mm_lib.Any2PixLMConfig())
    for name in ("llm", "prior", "prior_text", "imagebind_vision", "imagebind_audio", "refiner",
                 "inpaint_unet", "embed_norm", "llm_speculative_layers", "image_size", "sam",
                 "gdino"):
        a, b = getattr(tcfg, name), getattr(jcfg, name)
        if jpl.dataclasses.is_dataclass(a):
            _same_fields(a, b, name)
        else:
            assert a == b, name


def test_media_helpers_match_jax():
    items = ["x.png", "y.wav", "z.flac", {"type": "image", "fname": "w.jpg"}]
    assert tpl.preprocess_mm_data(items) == jpl.preprocess_mm_data(items)
    for s in ("a photo [a dog and a cat] additions:dog:<video>.cat:<video>.</s>",
              "no subjects here", "additions:</s>", "x additions:cat:<video>"):
        assert tpl.InstructAny2PixPipeline.get_all_objs(s) == jpl.InstructAny2PixPipeline.get_all_objs(s)
    wav = np.sin(np.arange(3000) * 0.1).astype(np.float32)
    assert np.array_equal(tpl._resample_linear(wav, 22050, 16000), jpl._resample_linear(wav, 22050, 16000))
