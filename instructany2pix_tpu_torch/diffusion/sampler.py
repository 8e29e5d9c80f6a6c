"""SDXL sampling: CFG denoise loop, DDIM inversion loop, prompt encoding,
latent mixing — counterpart of the JAX package's `diffusion/sampler.py`.

The JAX scans are Python loops here. `eps_fn(lat, t, i)` keeps the JAX
contract so samplers compose with any conditioning wrapper. Latents stay
in their own dtype (float32 from the pipeline); each DDIM step runs in
float32 and is cast back, whatever dtype the UNet runs in.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..models import clip as clip_lib
from ..models import unet as unet_lib
from .schedulers import Schedule


def encode_prompt_sdxl(
    text1_params: clip_lib.CLIPText,
    text1_cfg: clip_lib.CLIPTextConfig,
    text2_params: clip_lib.CLIPText,
    text2_cfg: clip_lib.CLIPTextConfig,
    ids1: torch.Tensor,  # (B, 77) tokenizer-1 ids
    ids2: torch.Tensor,  # (B, 77) tokenizer-2 ids
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (prompt_embeds (B, 77, 768+1280), pooled (B, 1280)): penultimate
    hidden states of both encoders; pooled from encoder 2's projection."""
    return sdxl_prompt_embeds(clip_lib.text_apply(text1_params, ids1, text1_cfg),
                              clip_lib.text_apply(text2_params, ids2, text2_cfg))


def sdxl_prompt_embeds(o1: dict, o2: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """`encode_prompt_sdxl` from the two encoders' `text_apply` outputs."""
    h1 = o1["hidden_states"][-2]
    h = torch.cat([h1, o2["hidden_states"][-2].to(h1.device)], dim=-1)
    pooled = o2.get("text_embeds", o2["pooled"])
    return h, pooled


def default_time_ids(h: int, w: int, batch: int, device="cpu") -> torch.Tensor:
    """SDXL added-cond time ids: (orig_h, orig_w, crop_t, crop_l, tgt_h, tgt_w)."""
    return torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32, device=device).repeat(batch, 1)


# ------------------------------------------------------------- loop cores


def loop_denoise(eps_fn: Callable, schedule: Schedule, latents: torch.Tensor, ts) -> torch.Tensor:
    """x_T → x_0 DDIM loop over descending `ts`."""
    ts = [int(t) for t in ts]
    ts_prev = ts[1:] + [-1]
    b = latents.shape[0]
    lat = latents
    for i, (t, t_prev) in enumerate(zip(ts, ts_prev)):
        eps = eps_fn(lat, t, i)
        lat = schedule.ddim_step(
            eps.float(), torch.full((b,), t), torch.full((b,), t_prev), lat.float()
        ).to(latents.dtype)
    return lat


def loop_invert(eps_fn: Callable, schedule: Schedule, latents: torch.Tensor, ts) -> torch.Tensor:
    """x_0 → x_T exact reverse-DDIM loop over ASCENDING `ts` (ε evaluated
    at the target timestep)."""
    ts = [int(t) for t in ts]
    ts_prev = [-1] + ts[:-1]
    b = latents.shape[0]
    lat = latents
    for i, (t, t_prev) in enumerate(zip(ts, ts_prev)):
        eps = eps_fn(lat, t, i)
        lat = schedule.ddim_inverse_step(
            eps.float(), torch.full((b,), t_prev), torch.full((b,), t), lat.float()
        ).to(latents.dtype)
    return lat


def loop_denoise_lcm(eps_fn: Callable, schedule: Schedule, latents: torch.Tensor, ts,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LCM consistency sampling over descending `ts` (the JAX package's
    `scan_denoise_lcm`): each step re-noises to the next timestep with a
    standard normal draw, from `generator` or from `noise` (steps, B, h, w, C)."""
    from .schedulers import lcm_step

    ts = [int(t) for t in ts]
    ts_prev = ts[1:] + [-1]
    if noise is not None and tuple(noise.shape) != (len(ts),) + tuple(latents.shape):
        raise ValueError(f"LCM noise shape {tuple(noise.shape)} != {(len(ts),) + tuple(latents.shape)}")
    b = latents.shape[0]
    lat = latents
    for i, (t, t_prev) in enumerate(zip(ts, ts_prev)):
        eps = eps_fn(lat, t, i)
        z = (noise[i] if noise is not None
             else torch.randn(latents.shape, generator=generator, device=latents.device))
        lat = lcm_step(
            schedule, eps.float(), torch.full((b,), t), torch.full((b,), t_prev), lat.float(),
            noise=z.to(device=latents.device, dtype=torch.float32),
        ).to(latents.dtype)
    return lat


# --------------------------------------------------------- CFG UNet eps_fn


def make_cfg_eps_fn(
    unet_params: unet_lib.UNet,
    unet_cfg: unet_lib.UNetConfig,
    ctx: torch.Tensor,
    ctx_uncond: Optional[torch.Tensor],
    pooled: torch.Tensor,
    pooled_uncond: Optional[torch.Tensor],
    time_ids: torch.Tensor,
    guidance_scale: float = 1.0,
    ip_tokens: Optional[torch.Tensor] = None,
    ip_tokens_uncond: Optional[torch.Tensor] = None,
    ip_scale: float = 1.0,
    ip_step_window: Optional[Tuple[int, int]] = None,
    extra_channels: Optional[torch.Tensor] = None,  # inpaint mask+masked latents
    time_ids_uncond: Optional[torch.Tensor] = None,
) -> Callable:
    """eps_fn wrapping the UNet with classifier-free guidance (uncond
    first, diffusers order), optional IP tokens with a step window and an
    optional per-step channel concat. Cross-attention K/V are projected
    once here for the whole loop."""
    do_cfg = guidance_scale > 1.0
    mult = 2 if do_cfg else 1

    def dup(c, u):
        return torch.cat([u, c], dim=0) if do_cfg else c

    ctx2 = dup(ctx, ctx_uncond)
    pooled2 = dup(pooled, pooled_uncond)
    if do_cfg and time_ids_uncond is not None:
        tid2 = torch.cat([time_ids_uncond, time_ids], dim=0)
    else:
        tid2 = time_ids.repeat(mult, 1)
    ip2 = None
    if ip_tokens is not None:
        ipu = ip_tokens_uncond if ip_tokens_uncond is not None else torch.zeros_like(ip_tokens)
        ip2 = dup(ip_tokens, ipu)
    extra2 = extra_channels.repeat(mult, 1, 1, 1) if extra_channels is not None else None
    cross_kv = unet_lib.precompute_cross_kv(unet_params, unet_cfg, ctx2, ip2)

    def eps_fn(lat, t, i):
        lat_in = lat.repeat(mult, 1, 1, 1)
        if extra2 is not None:
            lat_in = torch.cat([lat_in, extra2.to(lat_in.dtype)], dim=-1)
        scale_i = ip_scale
        if ip_step_window is not None:
            lo, hi = ip_step_window
            scale_i = ip_scale if lo <= i < hi else 0.0
        eps = unet_lib.apply(
            unet_params, lat_in, torch.full((lat_in.shape[0],), t), ctx2, unet_cfg,
            pooled_text=pooled2, time_ids=tid2, ip_tokens=ip2, ip_scale=scale_i,
            cross_kv=cross_kv,
        )
        if do_cfg:
            eps_u, eps_c = eps.chunk(2, dim=0)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
        return eps

    return eps_fn


# ------------------------------------------------------------- public API


def denoise(
    unet_params: unet_lib.UNet,
    unet_cfg: unet_lib.UNetConfig,
    schedule: Schedule,
    latents: torch.Tensor,
    ctx: torch.Tensor,
    ctx_uncond: torch.Tensor,
    pooled: torch.Tensor,
    pooled_uncond: torch.Tensor,
    time_ids: torch.Tensor,
    num_inference_steps: int = 25,
    guidance_scale: float = 10.0,
    ip_tokens: Optional[torch.Tensor] = None,
    ip_tokens_uncond: Optional[torch.Tensor] = None,
    ip_scale: float = 1.0,
    ip_window: Tuple[float, float] = (0.0, 1.0),
) -> torch.Tensor:
    """CFG denoise loop; `ip_window` is control_guidance_start/end."""
    ts = schedule.timesteps(num_inference_steps)
    eps_fn = make_cfg_eps_fn(
        unet_params, unet_cfg, ctx, ctx_uncond, pooled, pooled_uncond, time_ids,
        guidance_scale, ip_tokens, ip_tokens_uncond, ip_scale,
        ip_step_window=(
            int(ip_window[0] * num_inference_steps),
            int(ip_window[1] * num_inference_steps),
        ),
    )
    return loop_denoise(eps_fn, schedule, latents, ts)


def ddim_invert(
    unet_params: unet_lib.UNet,
    unet_cfg: unet_lib.UNetConfig,
    schedule: Schedule,
    latents: torch.Tensor,
    ctx: torch.Tensor,
    pooled: torch.Tensor,
    time_ids: torch.Tensor,
    num_inference_steps: int = 25,
) -> torch.Tensor:
    """Push clean latents to noise (no CFG)."""
    ts = schedule.timesteps(num_inference_steps).flip(0)
    eps_fn = make_cfg_eps_fn(
        unet_params, unet_cfg, ctx, None, pooled, None, time_ids, guidance_scale=1.0
    )
    return loop_invert(eps_fn, schedule, latents, ts)


def polar_interpolate(x: torch.Tensor, y: torch.Tensor, alpha: float) -> torch.Tensor:
    """Norm-preserving interpolation: direction of a*x+(1-a)*y, magnitude
    a*|x|+(1-a)*|y|."""
    xf, yf = x.float(), y.float()
    ll = alpha * xf + (1 - alpha) * yf
    nx, ny, nl = xf.norm(), yf.norm(), ll.norm()
    return (ll / (nl + 1e-9) * (alpha * nx + (1 - alpha) * ny)).to(x.dtype)


def mix_latents(
    base_embed: torch.Tensor,
    image_embeds: torch.Tensor,
    prior_embed: torch.Tensor,
    h: Tuple[float, float, float] = (0.0, 0.4, 1.0),
    norm: float = 20.0,
) -> torch.Tensor:
    """`h0*base + h1*llm + h2*20*prior`, renormalized to `norm`."""
    la = h[0] * base_embed.float() + h[1] * image_embeds.float() + h[2] * 20.0 * prior_embed.float()
    return la / (la.norm(dim=-1, keepdim=True) + 1e-9) * norm
