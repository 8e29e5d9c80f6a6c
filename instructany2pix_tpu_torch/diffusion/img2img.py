"""Img2img, the SDXL refiner pass: counterpart of the JAX package's
`diffusion/img2img.py::img2img`, without IP tokens (the refiner has none).
The source latents are noised to the first kept timestep and denoised over
the last `strength · N` steps of the N-step grid. The noise comes in as a
tensor (the JAX function draws it from a key); without one it is drawn
from `generator`."""

from __future__ import annotations

from typing import Optional

import torch

from ..models import unet as unet_lib
from .sampler import loop_denoise, make_cfg_eps_fn
from .schedulers import Schedule


def img2img_timesteps(schedule: Schedule, num_inference_steps: int, strength: float):
    """diffusers img2img: keep the last `strength · N` timesteps."""
    ts = schedule.timesteps(num_inference_steps)
    init_t = min(int(num_inference_steps * strength), num_inference_steps)
    t_start = max(num_inference_steps - init_t, 0)
    return ts[t_start:], int(num_inference_steps - t_start)


def img2img(
    unet_params: unet_lib.UNet,
    unet_cfg: unet_lib.UNetConfig,
    schedule: Schedule,
    src_latents: torch.Tensor,
    ctx: torch.Tensor,
    ctx_uncond: torch.Tensor,
    pooled: torch.Tensor,
    pooled_uncond: torch.Tensor,
    time_ids: torch.Tensor,
    num_inference_steps: int = 25,
    strength: float = 0.5,
    guidance_scale: float = 7.5,
    time_ids_uncond: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    ts, n = img2img_timesteps(schedule, num_inference_steps, strength)
    if n == 0:
        return src_latents
    if noise is None:
        noise = torch.randn(src_latents.shape, generator=generator, device=src_latents.device)
    noise = noise.to(device=src_latents.device, dtype=torch.float32)
    t0 = torch.full((src_latents.shape[0],), int(ts[0]))
    lat = schedule.add_noise(src_latents.float(), noise, t0).to(src_latents.dtype)
    eps_fn = make_cfg_eps_fn(
        unet_params, unet_cfg, ctx, ctx_uncond, pooled, pooled_uncond, time_ids,
        guidance_scale, time_ids_uncond=time_ids_uncond,
    )
    return loop_denoise(eps_fn, schedule, lat, ts)
