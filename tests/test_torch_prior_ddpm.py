"""The prior's DDPM sampling path (`generate_diffusion(no_diffusion=False)`)
and its plain autoregressive `generate` and `generate_partial` against the
JAX package, with the same converted weights. The JAX draws are reproduced
by hand and injected: the first `KeyChain(key)()` gives the start latents,
each step's next `kc()` the normal of its `ddpm_step`. CPU, float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import assert_close, one_torch_thread, randn, t  # noqa: F401 (autouse)

from instructany2pix_tpu.core.prng import KeyChain
from instructany2pix_tpu.prior import model as jprior
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.prior import model as tprior

REL_TOL = 1e-5


def _cfgs(kind):
    jcfg = jprior.PriorConfig.tiny()
    if kind == "proj":  # an output projection, two generated tokens
        jcfg = dataclasses.replace(jcfg, output_dim=24, sequence_gen_length=2)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tprior.PriorConfig)}
    fields["gpt2"] = tprior.gpt2.GPT2Config(**dataclasses.asdict(jcfg.gpt2))
    return jcfg, tprior.PriorConfig(**fields)


def _inputs(jcfg, b, seed):
    src = randn(seed, b, jcfg.imagebind_dim)
    th = randn(seed + 1, b, jcfg.text_len, jcfg.text_dim)
    tm = np.zeros((b, jcfg.text_len), np.float32)
    tm[:, :4] = 1
    return src, th, tm


@pytest.mark.parametrize("kind,b,steps", [("plain", 1, 25), ("proj", 2, 4)])
def test_ddpm_path_matches_jax_with_its_draws(kind, b, steps):
    jcfg, tcfg = _cfgs(kind)
    params = jprior.init(jax.random.key(3), jcfg)
    port = convert.prior(convert.to_numpy(params), tcfg)
    src, th, tm = _inputs(jcfg, b, 11)
    key = jax.random.key(9)
    kw = dict(num_inference_steps=steps, guidance_scale=5.0, score=6.8, no_diffusion=False)
    ref = jprior.generate_diffusion(params, jcfg, jprior.MODALITY.VIDEO, jprior.MODALITY.IMAGE,
                                    jnp.asarray(src), jnp.asarray(th), jnp.asarray(tm), key=key, **kw)
    shape = (b, jcfg.sequence_gen_length, jcfg.embed_dim)
    kc = KeyChain(key)
    latents = np.asarray(jax.random.normal(kc(), shape))
    noise = [np.asarray(jax.random.normal(kc(), shape)) for _ in range(steps)]
    out = tprior.generate_diffusion(port, tcfg, tprior.MODALITY.VIDEO, tprior.MODALITY.IMAGE,
                                    t(src), t(th), t(tm), latents=t(latents),
                                    noise=[t(n) for n in noise], **kw)
    assert out.shape == (b, jcfg.sequence_gen_length, jcfg.output_dim)
    assert_close(out, ref, REL_TOL, 9, rel=True, what=f"ddpm {kind}")
    with pytest.raises(ValueError, match="noise draws"):
        tprior.generate_diffusion(port, tcfg, 3, 0, t(src), t(th), t(tm), latents=t(latents),
                                  noise=[t(n) for n in noise[:-1]], **kw)


def test_ddpm_path_draws_from_its_generator():
    jcfg, tcfg = _cfgs("plain")
    port = convert.prior(convert.to_numpy(jprior.init(jax.random.key(3), jcfg)), tcfg)
    src, th, tm = _inputs(jcfg, 1, 2)

    def run(seed):
        return tprior.generate_diffusion(port, tcfg, 3, 0, t(src), t(th), t(tm),
                                         num_inference_steps=3,
                                         generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


@pytest.mark.parametrize("kind", ["plain", "proj"])
def test_generate_and_generate_partial_match_jax(kind):
    jcfg, tcfg = _cfgs(kind)
    params = jprior.init(jax.random.key(5), jcfg)
    port = convert.prior(convert.to_numpy(params), tcfg)
    rs = np.random.RandomState(0)
    cond = {
        "src_type": np.full((2, 1), jprior.MODALITY.AUDIO, np.int32),
        "imagebind": rs.randn(2, 1, jcfg.imagebind_dim).astype(np.float32),
        "crossattn_clip": (rs.randn(2, jcfg.text_len, jcfg.text_dim).astype(np.float32),
                           np.ones((2, jcfg.text_len), np.float32)),
        "score": rs.randn(2, 1, jcfg.score_dim).astype(np.float32),
    }
    jcond = {k: tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v)
             for k, v in cond.items()}
    tcond = {k: tuple(t(x) for x in v) if isinstance(v, tuple) else t(v) for k, v in cond.items()}
    assert_close(tprior.generate(port, tcfg, tcond), jprior.generate(params, jcfg, jcond), 2e-5, 0,
                 rel=True, what="generate")
    target = rs.randn(2, 8, jcfg.embed_dim).astype(np.float32)
    want = jprior.generate_partial(params, jcfg, jcond, jnp.asarray(target))
    got = tprior.generate_partial(port, tcfg, tcond, t(target))
    assert got.shape == want.shape
    assert_close(got, want, 2e-5, 0, rel=True, what="generate_partial")
