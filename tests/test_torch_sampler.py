"""Port sampler vs the JAX package: the CFG denoise loop with IP tokens,
DDIM inversion, prompt encoding and the latent helpers. Tiny configs,
float32, weights shared through `convert.py`, start latents from numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from instructany2pix_tpu.diffusion import sampler as j_sampler
from instructany2pix_tpu.diffusion.schedulers import Schedule as JSchedule
from instructany2pix_tpu.models import clip as j_clip
from instructany2pix_tpu.models import unet as j_unet
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.diffusion import sampler
from instructany2pix_tpu_torch.diffusion.schedulers import Schedule
from instructany2pix_tpu_torch.models import clip, unet
from torch_port_helpers import assert_close, randn, t

LOOP_REL_TOL = 1e-4  # relative to the output's max; float32, 3 UNet steps
PROMPT_TOL = 1e-5
LATENT_TOL = 1e-5


def _unet(seed):
    jcfg = j_unet.UNetConfig.tiny(with_ip=True)
    tree = convert.to_numpy(j_unet.init(jax.random.key(seed), jcfg))
    pcfg = unet.UNetConfig(**dataclasses.asdict(jcfg))
    return jcfg, tree, pcfg, convert.unet(tree, pcfg)


def test_denoise_cfg_ip_matches_jax():
    seed = 71
    jcfg, tree, pcfg, model = _unet(seed)
    c = jcfg.cross_attention_dim
    lat = randn(seed, 1, 16, 16, 4)
    ctx, ctx_u = randn(seed + 1, 1, 7, c), randn(seed + 2, 1, 7, c)
    pooled, pooled_u = randn(seed + 3, 1, jcfg.pooled_dim), randn(seed + 4, 1, jcfg.pooled_dim)
    ip = randn(seed + 5, 1, 4, c)
    tid = j_sampler.default_time_ids(128, 128, 1)
    kw = dict(num_inference_steps=3, guidance_scale=5.0, ip_scale=0.8, ip_window=(0.0, 0.67))
    ref = j_sampler.denoise(
        tree, jcfg, JSchedule.create(), jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(ctx_u),
        jnp.asarray(pooled), jnp.asarray(pooled_u), tid, ip_tokens=jnp.asarray(ip), **kw)
    out = sampler.denoise(
        model, pcfg, Schedule.create(), t(lat), t(ctx), t(ctx_u), t(pooled), t(pooled_u),
        sampler.default_time_ids(128, 128, 1), ip_tokens=t(ip), **kw)
    assert_close(out, ref, LOOP_REL_TOL, seed, rel=True, what="denoise")


def test_ddim_invert_matches_jax():
    seed = 72
    jcfg, tree, pcfg, model = _unet(seed)
    lat = randn(seed, 1, 16, 16, 4)
    ctx = randn(seed + 1, 1, 7, jcfg.cross_attention_dim)
    pooled = randn(seed + 2, 1, jcfg.pooled_dim)
    tid = j_sampler.default_time_ids(128, 128, 1)
    ref = j_sampler.ddim_invert(tree, jcfg, JSchedule.create(), jnp.asarray(lat),
                                jnp.asarray(ctx), jnp.asarray(pooled), tid, num_inference_steps=2)
    out = sampler.ddim_invert(model, pcfg, Schedule.create(), t(lat), t(ctx), t(pooled),
                              sampler.default_time_ids(128, 128, 1), num_inference_steps=2)
    assert_close(out, ref, LOOP_REL_TOL, seed, rel=True, what="ddim_invert")


def test_encode_prompt_sdxl_matches_jax():
    seed = 73
    c1 = j_clip.CLIPTextConfig.tiny()
    c2 = dataclasses.replace(j_clip.CLIPTextConfig.tiny(), projection_dim=24)
    t1 = convert.to_numpy(j_clip.text_init(jax.random.key(seed), c1))
    t2 = convert.to_numpy(j_clip.text_init(jax.random.key(seed + 1), c2))
    ids = np.random.RandomState(seed).randint(0, 128, size=(1, 16)).astype(np.int32)
    ref = j_sampler.encode_prompt_sdxl(t1, c1, t2, c2, jnp.asarray(ids), jnp.asarray(ids))
    p1 = clip.CLIPTextConfig(**dataclasses.asdict(c1))
    p2 = clip.CLIPTextConfig(**dataclasses.asdict(c2))
    out = sampler.encode_prompt_sdxl(convert.clip_text(t1, p1), p1, convert.clip_text(t2, p2),
                                     p2, t(ids), t(ids))
    for o, r, name in zip(out, ref, ("prompt_embeds", "pooled")):
        assert_close(o, r, PROMPT_TOL, seed, what=name)


def test_latent_helpers_match_jax():
    seed = 74
    x, y = randn(seed, 1, 8, 8, 4), randn(seed + 1, 1, 8, 8, 4)
    ref = j_sampler.polar_interpolate(jnp.asarray(x), jnp.asarray(y), 0.7)
    assert_close(sampler.polar_interpolate(t(x), t(y), 0.7), ref, LATENT_TOL, seed, what="polar")
    a, b, c = randn(seed, 2, 16), randn(seed + 1, 2, 16), randn(seed + 2, 2, 16)
    ref = j_sampler.mix_latents(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    assert_close(sampler.mix_latents(t(a), t(b), t(c)), ref, LATENT_TOL, seed, what="mix")
    np.testing.assert_array_equal(sampler.default_time_ids(96, 64, 2).numpy(),
                                  np.asarray(j_sampler.default_time_ids(96, 64, 2)))
