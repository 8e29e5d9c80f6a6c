"""Plug-and-play editing in the port against the JAX package at tiny
sizes, float32: the UNet with `pnp_share_qk` (every up-block
self-attention row attends with row 0's Q/K), the identical-rows property,
and `pnp_denoise` end to end."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.diffusion import pnp as j_pnp
from instructany2pix_tpu.diffusion.schedulers import Schedule as JSchedule
from instructany2pix_tpu.models import unet as j_unet
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.diffusion import pnp
from instructany2pix_tpu_torch.diffusion.schedulers import Schedule
from instructany2pix_tpu_torch.models import unet
from torch_port_helpers import assert_close, one_torch_thread, randn, t  # noqa: F401

UNET_REL_TOL = 1e-4
PNP_REL_TOL = 1e-4


def _case(seed, b=3):
    jcfg = j_unet.UNetConfig.tiny()
    rs = np.random.RandomState(seed)
    tree = jax.tree.map(lambda x: (np.asarray(x) + 0.1 * rs.randn(*np.shape(x))).astype(np.float32),
                        j_unet.init(jax.random.key(seed), jcfg))
    pcfg = unet.UNetConfig(**dataclasses.asdict(jcfg))
    model = convert.unet(tree, pcfg)
    x = randn(seed, b, 16, 16, 4)
    ctx = randn(seed + 1, b, 7, jcfg.cross_attention_dim)
    pooled = randn(seed + 2, b, jcfg.pooled_dim)
    tids = np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (b, 1))
    return jcfg, tree, pcfg, model, x, ctx, pooled, tids


@pytest.mark.parametrize("share", [False, True])
def test_unet_pnp_share_qk_matches_jax(share):
    seed = 301
    jcfg, tree, pcfg, model, x, ctx, pooled, tids = _case(seed)
    ts = np.array([700, 700, 700], np.int32)
    ref = j_unet.apply(tree, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx), jcfg,
                       pooled_text=jnp.asarray(pooled), time_ids=jnp.asarray(tids),
                       pnp_share_qk=share)
    out = unet.apply(model, t(x), t(ts), t(ctx), pcfg, pooled_text=t(pooled), time_ids=t(tids),
                     pnp_share_qk=share)
    assert_close(out, ref, UNET_REL_TOL, seed, rel=True, what=f"pnp_share_qk={share}")
    if share:
        # row 0 attends with its own Q/K either way; the other rows change
        plain = unet.apply(model, t(x), t(ts), t(ctx), pcfg, pooled_text=t(pooled),
                           time_ids=t(tids))
        assert torch.equal(out[0], plain[0])
        assert (out[1:] - plain[1:]).abs().max() > 1e-3


def test_identical_rows_share_nothing_new():
    """With three identical rows, sharing row 0's Q/K changes nothing."""
    seed = 303
    _, _, pcfg, model, x, ctx, pooled, tids = _case(seed)
    rep = lambda a: np.repeat(a[:1], 3, axis=0)  # noqa: E731
    args = (model, t(rep(x)), torch.full((3,), 500), t(rep(ctx)), pcfg)
    kw = dict(pooled_text=t(rep(pooled)), time_ids=t(tids))
    on = unet.apply(*args, pnp_share_qk=True, **kw)
    off = unet.apply(*args, pnp_share_qk=False, **kw)
    assert torch.equal(on, off)


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_pnp_denoise_matches_jax(ratio):
    seed = 305
    jcfg, tree, pcfg, model, _, _, _, _ = _case(seed, b=1)
    lat = randn(seed, 1, 16, 16, 4)
    ctx = [randn(seed + i, 1, 7, jcfg.cross_attention_dim) for i in (1, 2, 3)]
    pooled = [randn(seed + i, 1, jcfg.pooled_dim) for i in (4, 5, 6)]
    tids = np.array([[64, 64, 0, 0, 64, 64]], np.float32)
    steps, g = 4, 5.0
    ref = j_pnp.pnp_denoise(tree, jcfg, JSchedule.create(), jnp.asarray(lat),
                            *[jnp.asarray(c) for c in ctx], *[jnp.asarray(p) for p in pooled],
                            jnp.asarray(tids), num_inference_steps=steps, guidance_scale=g,
                            injection_ratio=ratio)
    out = pnp.pnp_denoise(model, pcfg, Schedule.create(), t(lat), *[t(c) for c in ctx],
                          *[t(p) for p in pooled], t(tids), num_inference_steps=steps,
                          guidance_scale=g, injection_ratio=ratio)
    assert out.shape == (1, 16, 16, 4)
    assert_close(out, ref, PNP_REL_TOL, seed, rel=True, what=f"pnp_denoise ratio {ratio}")
