"""The DDIM schedule as plain functions over static float32 tables, with
diffusers' conventions as the SDXL scheduler config sets them:
scaled_linear betas, leading spacing with offset 1, epsilon prediction,
the first alpha as the final one; and the exact reverse DDIM step of the
inversion.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    steps_offset: int = 1


def _bcast(a: torch.Tensor, ndim: int) -> torch.Tensor:
    return a.reshape((-1,) + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static float32 tables on one device."""

    cfg: SchedulerConfig
    alphas_cumprod: torch.Tensor
    final_alpha_cumprod: torch.Tensor

    @staticmethod
    def create(cfg: SchedulerConfig = SchedulerConfig(), device="cpu") -> "Schedule":
        n = cfg.num_train_timesteps
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, n) ** 2
        ac = np.cumprod(1.0 - betas)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return Schedule(cfg, t(ac), t(ac[0]))

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        """Descending inference timesteps, int32."""
        step = self.cfg.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step)[::-1] + self.cfg.steps_offset
        return torch.as_tensor(np.ascontiguousarray(ts).astype(np.int32))

    def alpha_bar(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, device=self.alphas_cumprod.device).long()
        return torch.where(
            t >= 0, self.alphas_cumprod[t.clamp(min=0)], self.final_alpha_cumprod
        )

    def add_noise(self, x0, noise, t):
        a = _bcast(self.alpha_bar(t), x0.dim())
        return torch.sqrt(a) * x0 + torch.sqrt(1 - a) * noise

    def to_x0(self, eps, sample, t):
        a = _bcast(self.alpha_bar(t), sample.dim())
        return (sample - torch.sqrt(1 - a) * eps) / torch.sqrt(a)

    def ddim_step(self, eps, t, t_prev, sample):
        """One deterministic DDIM update x_t → x_{t_prev}."""
        a_prev = _bcast(self.alpha_bar(t_prev), sample.dim())
        x0 = self.to_x0(eps, sample, t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps

    def ddim_inverse_step(self, eps, t, t_next, sample):
        """Exact reverse DDIM (x_t → x_{t_next}, t_next > t)."""
        a_next = _bcast(self.alpha_bar(t_next), sample.dim())
        x0 = self.to_x0(eps, sample, t)
        return torch.sqrt(a_next) * x0 + torch.sqrt(1 - a_next) * eps
