"""The reference agrees with the port's plain path at tiny sizes, module
by module and over whole edits, on the same weights."""

from __future__ import annotations

import pytest
import torch
from tinybench import TINY, run_tiny

from portbench import configs, port, weights
from portbench.kinds import edit as edit_kind
from portbench.reference import clip, prior, unet, vae

SEED = 2**31 + 11


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    torch.set_num_threads(4)
    cfgs = configs.reference_cfgs(TINY)
    published = weights.draw_all(weights.MODULE_ORDER, cfgs, SEED, "cpu", cfgs["dtype"])
    pipe = port.build_pipeline(TINY, published, "cpu", str(tmp_path_factory.mktemp("none")))
    return pipe, edit_kind.reference_models(cfgs, SEED, "cpu"), cfgs


def _close(a, b):
    torch.testing.assert_close(a.float(), b.float(), rtol=1e-4, atol=1e-4)


def test_unet(both):
    from instructany2pix_tpu_torch.models import unet as port_unet

    pipe, ref, cfgs = both
    g = torch.Generator().manual_seed(0)
    x, ctx = torch.randn(2, 8, 8, 4, generator=g), torch.randn(2, 5, 64, generator=g)
    kw = dict(pooled_text=torch.randn(2, 24, generator=g), time_ids=torch.randn(2, 6, generator=g),
              ip_tokens=torch.randn(2, 4, 64, generator=g))
    t = torch.tensor([500, 20])
    _close(port_unet.apply(pipe.models["unet"], x, t, ctx, pipe.cfg.unet, **kw),
           unet.apply(ref.unet, x, t, ctx, cfgs["unet"], **kw))


def test_vae(both):
    from instructany2pix_tpu_torch.models import vae as port_vae

    pipe, ref, cfgs = both
    x = torch.rand(1, 64, 64, 3) * 2 - 1
    _close(port_vae.encode(pipe.models["vae"], x, None, pipe.cfg.vae),
           vae.encode(ref.vae, x, None, cfgs["vae"]))
    z = torch.randn(1, 32, 32, 4)
    _close(port_vae.decode(pipe.models["vae"], z, pipe.cfg.vae), vae.decode(ref.vae, z, cfgs["vae"]))


def test_text_towers_and_prior(both):
    from instructany2pix_tpu_torch.models import clip as port_clip
    from instructany2pix_tpu_torch.prior import model as port_prior

    pipe, ref, cfgs = both
    ids = torch.randint(0, 259, (2, 16))
    for name in ("text1", "text2", "prior_text"):
        a = port_clip.text_apply(pipe.models[name], ids, getattr(pipe.cfg, name))
        b = clip.text_apply(getattr(ref, name), ids, cfgs[name])
        _close(a["hidden_states"][-2], b["hidden_states"][-2])
        _close(a["pooled"], b["pooled"])
    src, th, tm = torch.randn(2, 16), torch.randn(2, 7, 32), torch.ones(2, 7)
    _close(port_prior.generate_diffusion(pipe.models["prior"], pipe.cfg.prior, 3, 0, src, th, tm,
                                         guidance_scale=10.0, no_diffusion=True),
           prior.generate_diffusion(ref.prior, cfgs["prior"], 3, 0, src, th, tm,
                                    guidance_scale=10.0))


def test_whole_edits_agree(tiny_root):
    """The program's single edits against the reference, step by step:
    float32 on both sides, so only rounding separates them (an 8-bit level
    at most where a value sits on a rounding edge)."""
    result = run_tiny(tiny_root, "tiny-single", seed=SEED)
    assert result["correct"]
    assert set(result["checks"]) == {"encode", "steps", "decode"}
    assert all(c["value"] < 0.05 for c in result["checks"].values()), result["checks"]
