"""`__call__(debug=True)` of the port against the JAX pipeline at the tiny
config: the UNet's `capture_ip_attn` tap (both IP branches: projected IP
tokens and precomputed `cross_kv`), `aggregate_attn_maps` on the same taps
(a square and a non-square image), and the debug dict: the same keys,
images within 1 uint8 level, attention maps and the normalized prior output
within 1e-4, and the same images as `debug=False`. CPU, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_edit import _seed_cache, media, pipes  # noqa: F401 (fixtures)
from torch_port_helpers import assert_close, one_torch_thread, randn, t  # noqa: F401 (autouse)

from instructany2pix_tpu.core.prng import KeyChain
from instructany2pix_tpu.diffusion import ip_adapter as jipa
from instructany2pix_tpu.models import unet as junet
from instructany2pix_tpu_torch.diffusion import ip_adapter as tipa
from instructany2pix_tpu_torch.models import unet as tunet

UINT8_TOL = 1
MAP_TOL = 1e-4


def _unet_inputs(jp, seed):
    c = jp.cfg
    hl = c.image_size // 8
    lat = randn(seed, 1, hl, hl, 4)
    ctx = randn(seed + 1, 1, 77, c.unet.cross_attention_dim)
    pooled = randn(seed + 2, 1, c.text2.projection_dim)
    ip = randn(seed + 3, 1, 4, c.unet.cross_attention_dim)
    tid = np.asarray([[64, 64, 0, 0, 64, 64]], np.float32)
    return lat, ctx, pooled, ip, tid


@pytest.mark.parametrize("branch", ["ip_tokens", "cross_kv"])
def test_capture_ip_attn_taps_match_jax(pipes, branch):
    jp, tp = pipes
    c = jp.cfg
    lat, ctx, pooled, ip, tid = _unet_inputs(jp, 3)
    jkw = dict(pooled_text=jnp.asarray(pooled), time_ids=jnp.asarray(tid), ip_scale=0.7,
               capture_ip_attn=True)
    tkw = dict(pooled_text=t(pooled), time_ids=t(tid), ip_scale=0.7, capture_ip_attn=True)
    if branch == "ip_tokens":
        jkw["ip_tokens"], tkw["ip_tokens"] = jnp.asarray(ip), t(ip)
    else:
        jkw["cross_kv"] = junet.precompute_cross_kv(jp.params["unet"], c.unet, jnp.asarray(ctx),
                                                    jnp.asarray(ip))
        tkw["cross_kv"] = tunet.precompute_cross_kv(tp.models["unet"], tp.cfg.unet, t(ctx), t(ip))
    j_eps, j_taps = junet.apply(jp.params["unet"], jnp.asarray(lat), jnp.asarray([5]),
                                jnp.asarray(ctx), c.unet, **jkw)
    t_eps, t_taps = tunet.apply(tp.models["unet"], t(lat), torch.tensor([5]), t(ctx), tp.cfg.unet,
                                **tkw)
    assert sorted(t_taps) == sorted(j_taps) and len(t_taps) > 0
    assert all(k.split(".")[-1].startswith("block_") for k in t_taps)
    for k in j_taps:
        assert t_taps[k].dtype == torch.float32
        assert_close(t_taps[k], j_taps[k], MAP_TOL, 3, what=k)
    assert_close(t_eps, j_eps, 2e-4, 3, rel=True, what="eps")
    # without the tap: the same ε as with it
    plain = tunet.apply(tp.models["unet"], t(lat), torch.tensor([5]), t(ctx), tp.cfg.unet,
                        **{k: v for k, v in tkw.items() if k != "capture_ip_attn"})
    assert_close(plain, t_eps.numpy(), 1e-5, 3, rel=True, what="eps without the tap")


@pytest.mark.parametrize("hw", [(64, 64), (48, 80), (40, 24)])
def test_aggregate_attn_maps_matches_jax(hw):
    """The JAX resize only upsamples on the pipeline's path (64² and 48×80
    here); the third case shrinks one side."""
    rs = np.random.RandomState(4)
    taps = {}
    for i, s in enumerate((64, 16, 64, 12)):  # 12 is not a square: skipped
        logits = rs.randn(2, 3, s, 4).astype(np.float32)
        taps[f"layer_{i}"] = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for bi in (0, 1):
        want = jipa.aggregate_attn_maps({k: jnp.asarray(v) for k, v in taps.items()}, hw, bi)
        got = tipa.aggregate_attn_maps({k: t(v) for k, v in taps.items()}, hw, bi)
        assert got.shape == (4,) + hw
        assert_close(got, want, MAP_TOL, 4, what=f"attn maps {hw} row {bi}")
    assert tipa.aggregate_attn_maps({"x": t(taps["layer_3"])}, hw) is None


def test_debug_dict_matches_jax(pipes, media):
    jp, tp = pipes
    seed, steps = 2, 2
    _seed_cache(jp, media, jnp.asarray)
    j_non, j_ref, j_msg = jp("add <video> to <video>", media, num_inference_steps=steps,
                             refinement=0.5, seed=seed, use_cache=True, debug=True)
    kc = KeyChain(seed)
    kc()
    hl = tp._latent_size()
    draws = {name: np.asarray(jax.random.normal(kc(), (1, hl, hl, 4)))
             for name in ("vae_noise", "polar_noise", "refiner_vae_noise", "refiner_noise")}
    _seed_cache(tp, media, np.asarray)
    tp.stage_times = {}
    t_non, t_ref, t_msg = tp("add <video> to <video>", media, num_inference_steps=steps,
                             refinement=0.5, seed=seed, use_cache=True, debug=True, **draws)
    assert "debug_tap" in tp.stage_times
    tp.stage_times = None
    assert isinstance(t_msg, dict) and sorted(t_msg) == sorted(j_msg)
    for a, b in ((t_non, j_non), (t_ref, j_ref)):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= UINT8_TOL, f"{d.max()} levels"
    assert t_msg["attn_maps"].shape == (4, 64, 64)
    assert_close(t_msg["attn_maps"], j_msg["attn_maps"], MAP_TOL, seed, what="attn_maps")
    assert torch.allclose(t_msg["attn_maps"].sum(0), torch.ones(64, 64), atol=1e-5)
    assert_close(t_msg["y"], j_msg["y"], MAP_TOL, seed, what="y")
    assert t_msg["output_caption"] == j_msg["output_caption"]
    assert t_msg["annotations"] is None and j_msg["annotations"] is None
    assert t_msg["subjec_data"] == j_msg["subjec_data"] == []
    for key, tol in (("latent_inv", 1e-3), ("latent_la", 1e-4), ("base_embed", 1e-6)):
        assert_close(t_msg[key], j_msg[key], tol, seed, rel=True, what=key)
    assert np.array_equal(np.asarray(t_msg["img_base"]), np.asarray(j_msg["img_base"]))

    # the same seed and draws without debug: the same images
    _seed_cache(tp, media, np.asarray)
    p_non, p_ref, p_msg = tp("add <video> to <video>", media, num_inference_steps=steps,
                             refinement=0.5, seed=seed, use_cache=True, **draws)
    assert p_msg == "SUCCESS!"
    assert np.array_equal(p_non, t_non) and np.array_equal(p_ref, t_ref)
    tp.cache = jp.cache = None
