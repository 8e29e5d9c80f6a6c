"""The port's ImageBind towers, audio front end, GPT-2, prior and img2img
vs the JAX package at tiny sizes, with the same weights (converted from
the JAX trees) and the same inputs. CPU, float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.diffusion import img2img as ji2i
from instructany2pix_tpu.diffusion.schedulers import Schedule as JSchedule
from instructany2pix_tpu.models import gpt2 as jgpt2
from instructany2pix_tpu.models import imagebind as jib
from instructany2pix_tpu.models import unet as junet
from instructany2pix_tpu.pipeline import PipelineConfig as JPipelineConfig
from instructany2pix_tpu.prior import model as jprior
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.diffusion import img2img as ti2i
from instructany2pix_tpu_torch.diffusion.schedulers import Schedule
from instructany2pix_tpu_torch.models import gpt2 as tgpt2
from instructany2pix_tpu_torch.models import imagebind as tib
from instructany2pix_tpu_torch.pipeline import PipelineConfig
from instructany2pix_tpu_torch.prior import model as tprior
from torch_port_helpers import assert_close, randn, t

TOL = 2e-5  # float32 on both sides, sums in another order


def _port_cfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("modality", ["vision", "audio"])
def test_imagebind_apply_matches_jax(modality):
    """Vision at the tiny config; audio with overlapping patches, the
    checkpoint's bias_k/bias_v extra key/value position and its stem
    LayerNorm."""
    if modality == "vision":
        jcfg, npatch, x = jib.ViTConfig.tiny(), None, randn(1, 2, 28, 28, 3)
    else:
        jcfg = dataclasses.replace(jib.ViTConfig.tiny(in_channels=1), patch=16, stride=10,
                                   image_size=0, out_scale=20.0)
        npatch = tib.audio_patches(_port_cfg(tib.ViTConfig, jcfg))
        x = randn(2, 3, 128, 204, 1)
    params = jib.init(jax.random.key(5), jcfg, num_patches=npatch)
    if modality == "audio":  # as `convert_from_imagebind` reads the official audio trunk
        for i in range(jcfg.layers):
            params[f"block_{i}"]["bias_k"] = jnp.asarray(randn(10 + i, 1, jcfg.width))
            params[f"block_{i}"]["bias_v"] = jnp.asarray(randn(20 + i, 1, jcfg.width))
        params["patch_norm"] = {"g": jnp.asarray(1.0 + randn(30, jcfg.width, scale=0.1)),
                                "b": jnp.asarray(randn(31, jcfg.width, scale=0.1))}
    ref = jib.apply(params, jnp.asarray(x), jcfg)
    tcfg = _port_cfg(tib.ViTConfig, jcfg)
    port = convert.imagebind(convert.to_numpy(params), tcfg)
    assert hasattr(port.block_0, "bias_k") == hasattr(port, "patch_norm") == (modality == "audio")
    assert_close(tib.apply(port, t(x), tcfg), ref, TOL, 1, what=modality)


def test_preprocess_audio_and_vision_identical():
    wav = np.sin(np.arange(40000) * 0.031).astype(np.float32) + randn(2, 40000, scale=0.1)
    assert np.array_equal(tib.preprocess_audio(wav), jib.preprocess_audio(wav))
    img = np.random.RandomState(3).randint(0, 255, (50, 70, 3), np.uint8)
    assert np.array_equal(tib.preprocess_vision(img, 28), jib.preprocess_vision(img, 28))


def test_gpt2_forward_matches_jax():
    jcfg = jgpt2.GPT2Config.tiny()
    params = jgpt2.init(jax.random.key(2), jcfg)
    x = randn(3, 2, 9, jcfg.hidden_size)
    mask = np.ones((2, 9), np.float32)
    mask[1, :3] = 0
    ref = jgpt2.forward(params, jcfg, jnp.asarray(x), attention_mask=jnp.asarray(mask))
    tcfg = _port_cfg(tgpt2.GPT2Config, jcfg)
    port = convert.build(tgpt2.GPT2(tcfg).to("meta"), convert.to_numpy(params))
    out = tgpt2.forward(port, tcfg, t(x), attention_mask=t(mask))
    assert_close(out, ref, TOL, 3, what="gpt2")


def test_prior_generate_no_diffusion_matches_jax():
    jcfg = JPipelineConfig.tiny().prior
    tcfg = PipelineConfig.tiny().prior
    params = jprior.init(jax.random.key(4), jcfg)
    src, th = randn(5, 1, jcfg.imagebind_dim), randn(6, 1, jcfg.text_len, jcfg.text_dim)
    tm = np.zeros((1, jcfg.text_len), np.float32)
    tm[0, :4] = 1
    kw = dict(guidance_scale=10.0, score=6.5, no_diffusion=True)
    ref = jprior.generate_diffusion(params, jcfg, jprior.MODALITY.VIDEO, jprior.MODALITY.IMAGE,
                                    jnp.asarray(src), jnp.asarray(th), jnp.asarray(tm), **kw)
    port = convert.prior(convert.to_numpy(params), tcfg)
    out = tprior.generate_diffusion(port, tcfg, tprior.MODALITY.VIDEO, tprior.MODALITY.IMAGE,
                                    t(src), t(th), t(tm), **kw)
    assert_close(out, ref, TOL, 5, rel=True, what="prior")
    # the DDPM path runs too (held against JAX in test_torch_prior_ddpm.py)
    ddpm = tprior.generate_diffusion(port, tcfg, 3, 0, t(src), t(th), t(tm), num_inference_steps=2,
                                     generator=torch.Generator().manual_seed(0))
    assert ddpm.shape == out.shape and bool(torch.isfinite(ddpm).all())


@pytest.mark.parametrize("strength", [0.5, 0.0])
def test_img2img_matches_jax_with_its_noise(strength):
    """The refiner pass on a tiny UNet, fed the JAX draw of its noise."""
    jcfg = JPipelineConfig.tiny().refiner
    tcfg = PipelineConfig.tiny().refiner
    params = junet.init(jax.random.key(6), jcfg)
    lat = randn(7, 1, 8, 8, 4)
    ctx, ctx_u = randn(8, 1, 16, jcfg.cross_attention_dim), randn(9, 1, 16, jcfg.cross_attention_dim)
    pooled, pooled_u = randn(10, 1, 24), randn(11, 1, 24)
    tid = np.asarray([[64, 64, 0, 0, 6.0]], np.float32)
    tid_u = np.asarray([[64, 64, 0, 0, 2.5]], np.float32)
    key = jax.random.key(12)
    ref = ji2i.img2img(params, jcfg, JSchedule.create(), jnp.asarray(lat), key, jnp.asarray(ctx),
                       jnp.asarray(ctx_u), jnp.asarray(pooled), jnp.asarray(pooled_u),
                       jnp.asarray(tid), num_inference_steps=10, strength=strength,
                       guidance_scale=5.0, time_ids_uncond=jnp.asarray(tid_u))
    noise = np.asarray(jax.random.normal(key, lat.shape))
    port = convert.unet(convert.to_numpy(params), tcfg)
    out = ti2i.img2img(port, tcfg, Schedule.create(), t(lat), t(ctx), t(ctx_u), t(pooled),
                       t(pooled_u), t(tid), num_inference_steps=10, strength=strength,
                       guidance_scale=5.0, time_ids_uncond=t(tid_u), noise=t(noise))
    assert_close(out, ref, 1e-4, 12, rel=True, what=f"img2img strength {strength}")
    ts, n = ti2i.img2img_timesteps(Schedule.create(), 50, 0.5)
    jts, jn = ji2i.img2img_timesteps(JSchedule.create(), 50, 0.5)
    assert n == jn == 25 and ts.tolist() == np.asarray(jts).tolist()
