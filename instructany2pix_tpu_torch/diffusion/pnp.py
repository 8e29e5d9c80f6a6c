"""Plug-and-play structural editing, counterpart of the JAX package's
`diffusion/pnp.py` (a working version of the reference's stubbed
`SDXLPNPPipeline`, reference ddim/pnp_pipeline.py:281-530).

DDIM-invert the source image, then denoise a 3-row UNet batch [source
replay, edit-uncond, edit-cond] in one loop, where for the first
`injection_ratio` of the steps every row's up-block self-attention uses the
source row's Q/K (`unet.apply(pnp_share_qk=True)`): the edit keeps the
source's spatial structure while its values follow the edit prompt. The
JAX `lax.cond` on the step index is a Python branch here.
"""

from __future__ import annotations

import torch

from ..models import unet as unet_lib
from .sampler import loop_denoise
from .schedulers import Schedule


def pnp_denoise(
    unet_params: unet_lib.UNet,
    unet_cfg: unet_lib.UNetConfig,
    schedule: Schedule,
    inverted_latents: torch.Tensor,  # (1, h, w, 4) from ddim_invert
    ctx: torch.Tensor,  # (1, S, D) edit prompt embeds
    ctx_uncond: torch.Tensor,
    ctx_src: torch.Tensor,  # (1, S, D) source/null prompt embeds
    pooled: torch.Tensor,
    pooled_uncond: torch.Tensor,
    pooled_src: torch.Tensor,
    time_ids: torch.Tensor,  # (1, n)
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    injection_ratio: float = 0.8,
) -> torch.Tensor:
    """→ (1, h, w, 4) edited latents. The source row replays its own
    denoising from the inverted latents (prompt `ctx_src`), giving the
    shared self-attention Q/K for the first int(injection_ratio · steps)
    steps."""
    ts = schedule.timesteps(num_inference_steps)
    n_inject = int(injection_ratio * num_inference_steps)
    dev = unet_params.conv_in.weight.device
    ctx3 = torch.cat([ctx_src, ctx_uncond, ctx], dim=0).to(dev)
    pooled3 = torch.cat([pooled_src, pooled_uncond, pooled], dim=0).to(dev)
    tid3 = time_ids.to(dev).repeat(3, 1)
    cross_kv = unet_lib.precompute_cross_kv(unet_params, unet_cfg, ctx3, None)

    def eps_fn(lat, t, i):
        # lat carries [source, edit]; the UNet batch is [source, edit-uncond, edit-cond]
        lat3 = torch.cat([lat[0:1], lat[1:2], lat[1:2]], dim=0)
        eps3 = unet_lib.apply(
            unet_params, lat3, torch.full((3,), t), ctx3, unet_cfg, pooled_text=pooled3,
            time_ids=tid3, cross_kv=cross_kv, pnp_share_qk=i < n_inject,
        )
        eps_u, eps_c = eps3[1:2], eps3[2:3]
        return torch.cat([eps3[0:1], eps_u + guidance_scale * (eps_c - eps_u)], dim=0)

    lat0 = torch.cat([inverted_latents, inverted_latents], dim=0)
    return loop_denoise(eps_fn, schedule, lat0, ts)[1:2]
