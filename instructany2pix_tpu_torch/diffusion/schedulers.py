"""Diffusion schedulers as plain functions over static float32 tables,
counterpart of the JAX package's `diffusion/schedulers.py` (diffusers
conventions: scaled_linear betas, DDIM eta=0 with leading spacing, exact
reverse DDIM, ancestral DDPM, LCM).

Where the JAX functions draw noise from a key, these take the noise
tensor itself (`noise=`), so a test can feed both sides one numpy draw.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: Literal["epsilon", "sample", "v_prediction"] = "epsilon"
    timestep_spacing: Literal["leading", "trailing", "linspace"] = "leading"
    steps_offset: int = 1
    set_alpha_to_one: bool = False


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, n) ** 2
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, n)
    if cfg.beta_schedule == "squaredcos_cap_v2":
        t = np.arange(n + 1) / n

        def f(u):
            return np.cos((u + 0.008) / 1.008 * np.pi / 2) ** 2

        return np.clip(1 - f(t[1:]) / f(t[:-1]), 0, 0.999)
    raise ValueError(cfg.beta_schedule)


def _bcast(a: torch.Tensor, ndim: int) -> torch.Tensor:
    return a.reshape((-1,) + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static float32 tables on one device."""

    cfg: SchedulerConfig
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    final_alpha_cumprod: torch.Tensor

    @staticmethod
    def create(cfg: SchedulerConfig = SchedulerConfig(), device="cpu") -> "Schedule":
        betas = make_betas(cfg)
        ac = np.cumprod(1.0 - betas)
        final = np.array(1.0 if cfg.set_alpha_to_one else ac[0])

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return Schedule(cfg, t(betas), t(ac), t(final))

    # ------------------------------------------------------------ helpers

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        """Descending inference timesteps (diffusers semantics), int32."""
        n = self.cfg.num_train_timesteps
        if self.cfg.timestep_spacing == "leading":
            step = n // num_inference_steps
            ts = (np.arange(num_inference_steps) * step).round()[::-1]
            ts = ts + self.cfg.steps_offset
        elif self.cfg.timestep_spacing == "trailing":
            ts = np.round(np.arange(n, 0, -n / num_inference_steps)) - 1
        else:  # linspace
            ts = np.linspace(0, n - 1, num_inference_steps)[::-1].round()
        return torch.as_tensor(np.ascontiguousarray(ts).astype(np.int32))

    def alpha_bar(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, device=self.alphas_cumprod.device).long()
        return torch.where(
            t >= 0, self.alphas_cumprod[t.clamp(min=0)], self.final_alpha_cumprod
        )

    def add_noise(self, x0, noise, t):
        a = _bcast(self.alpha_bar(t), x0.dim())
        return torch.sqrt(a) * x0 + torch.sqrt(1 - a) * noise

    def to_epsilon(self, model_out, sample, t):
        a = _bcast(self.alpha_bar(t), sample.dim())
        if self.cfg.prediction_type == "epsilon":
            return model_out
        if self.cfg.prediction_type == "sample":
            return (sample - torch.sqrt(a) * model_out) / torch.sqrt(1 - a)
        return torch.sqrt(a) * model_out + torch.sqrt(1 - a) * sample

    def to_x0(self, model_out, sample, t):
        a = _bcast(self.alpha_bar(t), sample.dim())
        if self.cfg.prediction_type == "epsilon":
            return (sample - torch.sqrt(1 - a) * model_out) / torch.sqrt(a)
        if self.cfg.prediction_type == "sample":
            return model_out
        return torch.sqrt(a) * sample - torch.sqrt(1 - a) * model_out

    # --------------------------------------------------------------- DDIM

    def ddim_step(self, model_out, t, t_prev, sample, eta: float = 0.0, noise=None):
        """One DDIM update x_t → x_{t_prev} (deterministic at eta=0)."""
        a_t = _bcast(self.alpha_bar(t), sample.dim())
        a_prev = _bcast(self.alpha_bar(t_prev), sample.dim())
        x0 = self.to_x0(model_out, sample, t)
        eps = self.to_epsilon(model_out, sample, t)
        if eta > 0.0 and noise is not None:
            sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
            dir_xt = torch.sqrt(1 - a_prev - sigma**2) * eps
            return torch.sqrt(a_prev) * x0 + dir_xt + sigma * noise
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps

    def ddim_inverse_step(self, model_out, t, t_next, sample):
        """Exact reverse DDIM (x_t → x_{t_next}, t_next > t)."""
        a_next = _bcast(self.alpha_bar(t_next), sample.dim())
        eps = self.to_epsilon(model_out, sample, t)
        x0 = self.to_x0(model_out, sample, t)
        return torch.sqrt(a_next) * x0 + torch.sqrt(1 - a_next) * eps

    # --------------------------------------------------------------- DDPM

    def ddpm_timesteps(self, num_inference_steps: int) -> torch.Tensor:
        """diffusers DDPMScheduler.set_timesteps: no +1 offset."""
        ratio = self.cfg.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio)[::-1]
        return torch.as_tensor(ts.copy().astype(np.int32))

    def ddpm_step(self, model_out, t, sample, noise, variance_type="fixed_small", t_prev=None):
        """Ancestral DDPM update with the given standard-normal `noise`."""
        t = torch.as_tensor(t, device=sample.device)
        a_bar_t = self.alpha_bar(t)
        a_bar_prev = self.alpha_bar(t - 1 if t_prev is None else t_prev)
        beta_t = 1 - a_bar_t / a_bar_prev
        alpha_t = 1 - beta_t
        n = sample.dim()
        a_bar_t, a_bar_prev = _bcast(a_bar_t, n), _bcast(a_bar_prev, n)
        beta_t, alpha_t = _bcast(beta_t, n), _bcast(alpha_t, n)

        x0 = self.to_x0(model_out, sample, t)
        coef_x0 = torch.sqrt(a_bar_prev) * beta_t / (1 - a_bar_t)
        coef_xt = torch.sqrt(alpha_t) * (1 - a_bar_prev) / (1 - a_bar_t)
        mean = coef_x0 * x0 + coef_xt * sample

        var = (1 - a_bar_prev) / (1 - a_bar_t) * beta_t
        if variance_type == "fixed_small":
            var = var.clamp(min=1e-20)
        t_b = _bcast(t, n) if t.dim() else t
        nonzero = (t_b > 0).to(sample.dtype)
        return mean + nonzero * torch.sqrt(var) * noise


def cfg_combine(uncond, cond, guidance_scale):
    """Classifier-free guidance mix."""
    return uncond + guidance_scale * (cond - uncond)


def lcm_timesteps(schedule: Schedule, num_inference_steps: int = 4) -> torch.Tensor:
    """LCM inference timesteps over the 50-step origin DDIM grid."""
    n = schedule.cfg.num_train_timesteps
    lcm_origin_steps = 50
    c = n // lcm_origin_steps
    ddim_ts = (np.arange(1, lcm_origin_steps + 1) * c) - 1
    skip = lcm_origin_steps // num_inference_steps
    ts = ddim_ts[::-1][::skip][:num_inference_steps]
    return torch.as_tensor(ts.copy().astype(np.int32))


def lcm_boundary_scalings(schedule: Schedule, t, sigma_data: float = 0.5):
    """Consistency-model boundary conditions c_skip(t), c_out(t)."""
    scaled = torch.as_tensor(t, dtype=torch.float32) * (10.0 / schedule.cfg.num_train_timesteps) * 100.0
    c_skip = sigma_data**2 / (scaled**2 + sigma_data**2)
    c_out = scaled / torch.sqrt(scaled**2 + sigma_data**2)
    return c_skip, c_out


def lcm_step(schedule: Schedule, model_out, t, t_prev, sample, noise: Optional[torch.Tensor] = None):
    """One LCM update; `noise` (standard normal) re-noises to t_prev, none
    means zeros, as the JAX function without a key."""
    x0 = schedule.to_x0(model_out, sample, t)
    c_skip, c_out = lcm_boundary_scalings(schedule, t)
    n = sample.dim()
    c_skip, c_out = c_skip.to(sample.device), c_out.to(sample.device)
    denoised = _bcast(c_skip, n) * sample + _bcast(c_out, n) * x0
    a_prev = _bcast(schedule.alpha_bar(t_prev), n)
    noise = noise if noise is not None else torch.zeros_like(sample)
    is_last = _bcast(torch.as_tensor(t_prev, device=sample.device) < 0, n)
    stepped = torch.sqrt(a_prev) * denoised + torch.sqrt(1 - a_prev) * noise
    return torch.where(is_last, denoised, stepped)
