"""SDXL sampling: the CFG denoise loop, the DDIM inversion loop and their
single steps, prompt embeddings, latent mixing.

`eps_fn(lat, t, i)` gives a step's noise prediction. Latents stay
in their own dtype (float32 from the pipeline); each DDIM step runs in
float32 and is cast back, whatever dtype the UNet runs in.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from . import unet as unet_lib
from .schedulers import Schedule


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


def loop_denoise(eps_fn: Callable, schedule: Schedule, latents: torch.Tensor, ts,
                 log: Optional[List] = None) -> torch.Tensor:
    """x_T → x_0 DDIM loop over descending `ts`; with `log`, each step is
    appended as (t, t_prev, state in, state out)."""
    ts = [int(t) for t in ts]
    ts_prev = ts[1:] + [-1]
    lat = latents
    for i, (t, t_prev) in enumerate(zip(ts, ts_prev)):
        out = ddim_step(eps_fn, schedule, lat, t, t_prev, i)
        if log is not None:
            log.append((t, t_prev, lat, out))
        lat = out
    return lat


def loop_invert(eps_fn: Callable, schedule: Schedule, latents: torch.Tensor, ts,
                log: Optional[List] = None) -> torch.Tensor:
    """x_0 → x_T exact reverse-DDIM loop over ASCENDING `ts` (ε evaluated
    at the target timestep); `log` as `loop_denoise`'s."""
    ts = [int(t) for t in ts]
    ts_prev = [-1] + ts[:-1]
    lat = latents
    for i, (t, t_prev) in enumerate(zip(ts, ts_prev)):
        out = ddim_invert_step(eps_fn, schedule, lat, t_prev, t, i)
        if log is not None:
            log.append((t_prev, t, lat, out))
        lat = out
    return lat


def ddim_step(eps_fn: Callable, schedule: Schedule, lat: torch.Tensor, t: int, t_prev: int,
              i: int) -> torch.Tensor:
    """Step `i` of a DDIM loop, x_t → x_{t_prev}, in float32."""
    b = lat.shape[0]
    eps = eps_fn(lat, t, i)
    return schedule.ddim_step(eps.float(), torch.full((b,), t), torch.full((b,), t_prev),
                              lat.float()).to(lat.dtype)


def ddim_invert_step(eps_fn: Callable, schedule: Schedule, lat: torch.Tensor, t_prev: int,
                     t: int, i: int) -> torch.Tensor:
    """Step `i` of the inversion, x_{t_prev} → x_t, in float32."""
    b = lat.shape[0]
    eps = eps_fn(lat, t, i)
    return schedule.ddim_inverse_step(eps.float(), torch.full((b,), t_prev), torch.full((b,), t),
                                      lat.float()).to(lat.dtype)


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


# ------------------------------------------------------------ latent mixing


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


def img2img_timesteps(schedule: Schedule, num_inference_steps: int, strength: float):
    """The SDXL refiner's img2img slice of its grid (diffusers): the last
    `strength · N` timesteps, and how many there are."""
    ts = schedule.timesteps(num_inference_steps)
    init_t = min(int(num_inference_steps * strength), num_inference_steps)
    t_start = max(num_inference_steps - init_t, 0)
    return ts[t_start:], int(num_inference_steps - t_start)
