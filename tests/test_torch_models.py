"""Port models vs the JAX package at tiny sizes, float32, weights shared
through `convert.py`: CLIP text tower, schedulers, UNet (IP tokens,
precomputed cross K/V, fused parameter trees), VAE and the IP-Adapter
projection."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.diffusion import ip_adapter as j_ipa
from instructany2pix_tpu.diffusion import schedulers as j_sched
from instructany2pix_tpu.models import clip as j_clip
from instructany2pix_tpu.models import unet as j_unet
from instructany2pix_tpu.models import vae as j_vae
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.diffusion import ip_adapter as ipa
from instructany2pix_tpu_torch.diffusion import schedulers as sched
from instructany2pix_tpu_torch.models import clip, unet, vae
from torch_port_helpers import assert_close, randn, t

CLIP_TOL = 1e-5
UNET_REL_TOL = 1e-4
VAE_TOL = 1e-4
IPA_TOL = 1e-6
DDIM_TOL = 1e-6


def perturbed(tree, seed):
    """Numpy copy of a JAX init tree with every leaf moved off its init
    value (zero biases, unit gains), so a mis-mapped leaf shows."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x, np.float32) + 0.1 * rs.randn(*np.shape(x))).astype(np.float32),
        tree,
    )


def test_clip_text_matches_jax():
    seed = 21
    cfg = dataclasses.replace(j_clip.CLIPTextConfig.tiny(), projection_dim=24)
    tree = perturbed(j_clip.text_init(jax.random.key(seed), cfg), seed)
    ids = np.random.RandomState(seed).randint(0, 300, size=(2, 16)).astype(np.int32)
    ids[0, 9] = cfg.eos_token_id  # row 0 pools at its EOS, row 1 at the end
    ref = j_clip.text_apply(tree, jnp.asarray(ids), cfg)
    pcfg = clip.CLIPTextConfig(**dataclasses.asdict(cfg))
    out = clip.text_apply(convert.clip_text(tree, pcfg), t(ids), pcfg)
    assert len(out["hidden_states"]) == len(ref["hidden_states"])
    assert_close(out["hidden_states"][-2], ref["hidden_states"][-2], CLIP_TOL, seed, what="h[-2]")
    assert_close(out["pooled"], ref["pooled"], CLIP_TOL, seed, what="pooled")
    assert_close(out["text_embeds"], ref["text_embeds"], CLIP_TOL, seed, what="text_embeds")


@pytest.mark.parametrize("spacing", ["leading", "trailing", "linspace"])
def test_scheduler_timesteps_exact_and_ddim_step(spacing):
    seed = 31
    jcfg = j_sched.SchedulerConfig(timestep_spacing=spacing)
    js = j_sched.Schedule.create(jcfg)
    ps = sched.Schedule.create(sched.SchedulerConfig(timestep_spacing=spacing))
    for n in (1, 3, 25, 50):
        np.testing.assert_array_equal(ps.timesteps(n).numpy(), np.asarray(js.timesteps(n)))
    np.testing.assert_array_equal(ps.ddpm_timesteps(7).numpy(), np.asarray(js.ddpm_timesteps(7)))
    x, e = randn(seed, 2, 4, 4, 3), randn(seed + 1, 2, 4, 4, 3)
    tt, tp = np.array([981, 21], np.int32), np.array([961, -1], np.int32)
    ref = js.ddim_step(jnp.asarray(e), jnp.asarray(tt), jnp.asarray(tp), jnp.asarray(x))
    assert_close(ps.ddim_step(t(e), t(tt), t(tp), t(x)), ref, DDIM_TOL, seed, what="ddim_step")
    ref = js.ddim_inverse_step(jnp.asarray(e), jnp.asarray(tp), jnp.asarray(tt), jnp.asarray(x))
    out = ps.ddim_inverse_step(t(e), t(tp), t(tt), t(x))
    assert_close(out, ref, DDIM_TOL, seed, rel=True, what="ddim_inverse_step")
    key = jax.random.key(seed)
    noise = np.asarray(jax.random.normal(key, x.shape))
    ref = js.ddpm_step(jnp.asarray(e), jnp.asarray(tt), jnp.asarray(x), key)
    out = ps.ddpm_step(t(e), t(tt), t(x), t(noise))
    assert_close(out, ref, DDIM_TOL, seed, rel=True, what="ddpm_step")


def _unet_case(seed, fused):
    jcfg = j_unet.UNetConfig.tiny(with_ip=True)
    tree = perturbed(j_unet.init(jax.random.key(seed), jcfg), seed)
    pcfg = unet.UNetConfig(**dataclasses.asdict(jcfg))
    src = j_unet.split_geglu(j_unet.fuse_qkv(tree)) if fused else tree
    model = convert.unet(convert.to_numpy(src), pcfg)
    b = 2
    x = randn(seed, b, 16, 16, 4)
    ctx = randn(seed + 1, b, 7, jcfg.cross_attention_dim)
    ip = randn(seed + 2, b, 4, jcfg.cross_attention_dim)
    pooled = randn(seed + 3, b, jcfg.pooled_dim)
    tids = np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (b, 1))
    ts = np.array([981, 500], np.int32)
    return jcfg, tree, pcfg, model, x, ctx, ip, pooled, tids, ts


@pytest.mark.parametrize("fused", [False, True])
def test_unet_ip_and_cross_kv_match_jax(fused):
    seed = 41 + int(fused)
    jcfg, tree, pcfg, model, x, ctx, ip, pooled, tids, ts = _unet_case(seed, fused)
    j_args = dict(pooled_text=jnp.asarray(pooled), time_ids=jnp.asarray(tids),
                  ip_tokens=jnp.asarray(ip), ip_scale=0.7)
    ref = j_unet.apply(tree, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jcfg, **j_args)
    p_args = dict(pooled_text=t(pooled), time_ids=t(tids), ip_tokens=t(ip), ip_scale=0.7)
    out = unet.apply(model, t(x), t(ts), t(ctx), pcfg, **p_args)
    assert_close(out, ref, UNET_REL_TOL, seed, rel=True, what="unet ip tokens")

    kv = unet.precompute_cross_kv(model, pcfg, t(ctx), t(ip))
    out_kv = unet.apply(model, t(x), t(ts), t(ctx), pcfg, pooled_text=t(pooled),
                        time_ids=t(tids), ip_scale=0.7, cross_kv=kv)
    jkv = j_unet.precompute_cross_kv(tree, jcfg, jnp.asarray(ctx), jnp.asarray(ip))
    ref_kv = j_unet.apply(tree, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jcfg,
                          pooled_text=jnp.asarray(pooled), time_ids=jnp.asarray(tids),
                          ip_scale=0.7, cross_kv=jkv)
    assert_close(out_kv, ref_kv, UNET_REL_TOL, seed, rel=True, what="unet cross_kv")
    assert_close(out_kv, out, UNET_REL_TOL, seed, rel=True, what="cross_kv vs live")


def test_convert_is_strict():
    jcfg = j_unet.UNetConfig.tiny(with_ip=True)
    tree = convert.to_numpy(j_unet.init(jax.random.key(0), jcfg))
    pcfg = unet.UNetConfig(**dataclasses.asdict(jcfg))
    bad = dict(tree, extra={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        convert.unet(bad, pcfg)
    missing = {k: v for k, v in tree.items() if k != "conv_out"}
    with pytest.raises(KeyError):
        convert.unet(missing, pcfg)


def test_vae_encode_decode_match_jax():
    seed = 51
    jcfg = j_vae.VAEConfig.tiny()
    tree = perturbed(j_vae.init(jax.random.key(seed), jcfg), seed)
    pcfg = vae.VAEConfig(**dataclasses.asdict(jcfg))
    model = convert.vae(tree, pcfg)
    img = np.tanh(randn(seed, 2, 16, 16, 3))
    key = jax.random.key(seed + 1)
    ref = j_vae.encode(tree, jnp.asarray(img), key, jcfg)
    noise = np.asarray(jax.random.normal(key, ref.shape, jnp.float32))
    out = vae.encode(model, t(img), t(noise), pcfg)
    assert_close(out, ref, VAE_TOL, seed, what="vae encode (sampled)")
    assert_close(vae.encode(model, t(img), cfg=pcfg),
                 j_vae.encode(tree, jnp.asarray(img), None, jcfg), VAE_TOL, seed, what="mean")
    z = randn(seed + 2, 2, 8, 8, 4)
    ref = j_vae.decode(tree, jnp.asarray(z), jcfg)
    assert_close(vae.decode(model, t(z), pcfg), ref, VAE_TOL, seed, what="vae decode")


@pytest.mark.parametrize("mode,local", [("global", False), ("both", True), ("local", True)])
def test_get_image_embeds_matches_jax(mode, local):
    seed = 61
    jcfg = j_ipa.ImageProjConfig.tiny()
    tree = perturbed(j_ipa.init(jax.random.key(seed), jcfg), seed)
    model = convert.image_proj(tree, ipa.ImageProjConfig(**dataclasses.asdict(jcfg)))
    g = randn(seed, 2, jcfg.clip_embeddings_dim)
    lo = randn(seed + 1, 2, jcfg.clip_embeddings_dim) if local else None
    ref = j_ipa.get_image_embeds(tree, jcfg, jnp.asarray(g),
                                 None if lo is None else jnp.asarray(lo), mode=mode, scale_l=0.6)
    out = ipa.get_image_embeds(model, ipa.ImageProjConfig(**dataclasses.asdict(jcfg)), t(g),
                               None if lo is None else t(lo), mode=mode, scale_l=0.6)
    for o, r, name in zip(out, ref, ("cond", "uncond")):
        assert_close(o, r, IPA_TOL, seed, what=name)
    assert torch.is_tensor(out[0])
