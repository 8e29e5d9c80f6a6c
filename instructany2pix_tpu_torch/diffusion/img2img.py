"""Img2img and inpainting samplers: counterpart of the JAX package's
`diffusion/img2img.py`.

  * `img2img`: the SDXL refiner pass, without IP tokens (the refiner has
    none). The source latents are noised to the first kept timestep and
    denoised over the last `strength · N` steps of the N-step grid.
  * `inpaint`: the same truncated loop with a mask, IP tokens and one of
    two UNets. A 9-channel inpaint UNet takes the downsampled mask and the
    masked image's latents as extra input channels every step. The base
    4-channel UNet (what real checkpoints give, since the reference shares
    the base UNet for inpainting) instead resets the keep region after each
    step to the source latents noised to the next timestep, with the same
    noise.
The noise comes in as a tensor (the JAX functions draw it from a key);
without one it is drawn from `generator`."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models import unet as unet_lib
from ..utils import profiling
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


def inpaint(
    unet_params: unet_lib.UNet,
    unet_cfg: unet_lib.UNetConfig,
    schedule: Schedule,
    src_latents: torch.Tensor,  # (B, h, w, 4) clean scaled latents
    mask: torch.Tensor,  # (B, H, W, 1) in [0, 1], 1 = repaint
    masked_latents: torch.Tensor,  # (B, h, w, 4) latents of the masked image
    ctx: torch.Tensor,
    ctx_uncond: torch.Tensor,
    pooled: torch.Tensor,
    pooled_uncond: torch.Tensor,
    time_ids: torch.Tensor,
    num_inference_steps: int = 50,
    strength: float = 0.7,
    guidance_scale: float = 7.5,
    ip_tokens: Optional[torch.Tensor] = None,
    ip_tokens_uncond: Optional[torch.Tensor] = None,
    ip_scale: float = 1.0,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    b, h, w, _ = src_latents.shape
    # nearest with half-pixel centres (pixel 8i + 4 at a factor of 8), as
    # jax.image.resize(..., "nearest"); plain "nearest" would take 8i
    mask_lat = F.interpolate(mask.float().permute(0, 3, 1, 2), size=(h, w),
                             mode="nearest-exact").permute(0, 2, 3, 1)
    ts, n = img2img_timesteps(schedule, num_inference_steps, strength)
    if n == 0:
        return src_latents
    if noise is None:
        noise = torch.randn(src_latents.shape, generator=generator, device=src_latents.device)
    noise = noise.to(device=src_latents.device, dtype=torch.float32)
    src32 = src_latents.float()
    lat = schedule.add_noise(src32, noise, torch.full((b,), int(ts[0]))).to(src_latents.dtype)
    if unet_cfg.in_channels == 9:
        extra = torch.cat([mask_lat.to(lat.dtype), masked_latents.to(lat.dtype)], dim=-1)
        eps_fn = make_cfg_eps_fn(
            unet_params, unet_cfg, ctx, ctx_uncond, pooled, pooled_uncond, time_ids,
            guidance_scale, ip_tokens, ip_tokens_uncond, ip_scale, extra_channels=extra,
        )
        return loop_denoise(eps_fn, schedule, lat, ts)
    eps_fn = make_cfg_eps_fn(
        unet_params, unet_cfg, ctx, ctx_uncond, pooled, pooled_uncond, time_ids,
        guidance_scale, ip_tokens, ip_tokens_uncond, ip_scale,
    )
    ts = [int(t) for t in ts]
    for i, (t, t_prev) in enumerate(zip(ts, ts[1:] + [-1])):
        with profiling.span("unet_step", rows=b, loop="inpaint", step=i):
            eps = eps_fn(lat, t, i)
            nxt = schedule.ddim_step(eps.float(), torch.full((b,), t), torch.full((b,), t_prev),
                                     lat.float())
            keep = (schedule.add_noise(src32, noise, torch.full((b,), t_prev)) if t_prev >= 0
                    else src32)
            lat = ((1.0 - mask_lat) * keep + mask_lat * nxt).to(src_latents.dtype)
    return lat
