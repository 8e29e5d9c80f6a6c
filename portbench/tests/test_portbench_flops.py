"""The benchmark's FLOP counters agree with `torch.utils.flop_counter`
on the reference's plain forward at tiny sizes."""

from __future__ import annotations

import pytest
import torch
from tinybench import TINY
from torch.utils.flop_counter import FlopCounterMode

from portbench import configs, flops
from portbench.reference import clip, prior, unet, vae


def _module(make):
    torch.manual_seed(0)
    with torch.device("meta"):
        m = make()
    m = m.to_empty(device="cpu").float()
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.05)
    return m.eval()


def _counted(fn) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("which", ["unet", "unet_ip", "refiner"])
def test_unet(which):
    c = configs.reference_cfgs(TINY)
    cfg = c["refiner" if which == "refiner" else "unet"]
    m, b, side, s = _module(lambda: unet.UNet(cfg)), 2, 8, 5
    n_ip = 4 if which == "unet_ip" else 0
    ip = torch.randn(b, n_ip, cfg.cross_attention_dim) if n_ip else None

    def run():
        unet.apply(m, torch.randn(b, side, side, 4), torch.tensor([10, 10]),
                   torch.randn(b, s, cfg.cross_attention_dim), cfg,
                   pooled_text=torch.randn(b, cfg.pooled_dim),
                   time_ids=torch.randn(b, cfg.num_time_ids), ip_tokens=ip)

    assert _counted(run) == flops.unet_forward(cfg, b, side, s, n_ip)


def test_vae():
    cfg = configs.reference_cfgs(TINY)["vae"]
    m = _module(lambda: vae.VAE(cfg))
    x = torch.randn(2, 16, 16, 3)
    assert _counted(lambda: vae.encode(m, x, None, cfg)) == flops.vae_encode(cfg, 2, 16)
    z = torch.randn(2, 8, 8, 4)
    assert _counted(lambda: vae.decode(m, z, cfg)) == flops.vae_decode(cfg, 2, 8)


@pytest.mark.parametrize("tower", ["text1", "text2"])
def test_clip_text(tower):
    cfg = configs.reference_cfgs(TINY)[tower]
    m = _module(lambda: clip.CLIPText(cfg))
    ids = torch.randint(0, 200, (3, cfg.max_positions))
    assert _counted(lambda: clip.text_apply(m, ids, cfg)) == flops.clip_text(cfg, 3)


def test_prior():
    c = configs.reference_cfgs(TINY)
    cfg = c["prior"]
    m = _module(lambda: prior.Prior(cfg, output_proj=True))
    b = 2

    def run():
        prior.generate_diffusion(m, cfg, prior.MODALITY.VIDEO, prior.MODALITY.IMAGE,
                                 torch.randn(b, cfg.imagebind_dim),
                                 torch.randn(b, cfg.text_len, cfg.text_dim),
                                 torch.ones(b, cfg.text_len), guidance_scale=10.0)

    assert _counted(run) == flops.prior_refine(cfg, b, True)
