"""The training step for the multimodal LLM, counterpart of the JAX
package's `train/train_step.py`.

The optimizer is optax's chain, written out so its maths match the JAX
step rather than torch's defaults:
  * `clip_by_global_norm(max_norm)`: the gradients are scaled by
    max_norm / g_norm only when g_norm >= max_norm, with no epsilon
    (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm);
  * `warmup_cosine_decay_schedule(0, lr, max(int(total * warmup_ratio), 1),
    total, 0)`, evaluated at the update count before the step, so the first
    update runs at lr 0;
  * AdamW with eps 1e-8 and eps_root 0, bias correction at count + 1, the
    moments kept and updated in the parameter dtype as optax keeps them,
    and weight decay on every parameter.
`grad_norm` is taken before clipping. The global norm is summed in
float32 (optax sums in the gradients' dtype). Parameters and moments are
updated in place; the state dict holds the module itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..llm import multimodal as mm


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    warmup_ratio: float = 0.03
    total_steps: int = 10000
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total, 0) at `count`:
    linear from 0 over the warmup steps, then cosine to 0 at total_steps."""
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 1)
    if count < warmup:
        return cfg.learning_rate * count / warmup
    decay_steps = cfg.total_steps - warmup
    t = min(count - warmup, decay_steps)
    return cfg.learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a 0-d tensor of `like`'s dtype: rounded to that
    dtype first, as optax casts its scalars."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


class Optimizer:
    """clip_by_global_norm, then AdamW on a learning-rate schedule, over
    the trainable parameters of a module (see the module docstring)."""

    def __init__(self, cfg: TrainConfig):
        if cfg.total_steps <= max(int(cfg.total_steps * cfg.warmup_ratio), 1):
            # optax's cosine_decay_schedule refuses a non-positive decay span too
            raise ValueError(f"total_steps={cfg.total_steps} leaves no steps after the warmup")
        self.cfg = cfg

    def init(self, params: torch.nn.Module) -> Dict[str, Any]:
        ps = [p for p in params.parameters() if p.requires_grad]
        return {"count": 0, "mu": [torch.zeros_like(p) for p in ps],
                "nu": [torch.zeros_like(p) for p in ps]}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict[str, Any]) -> torch.Tensor:
        """Apply one step in place; returns the global norm of `grads`
        before clipping (a float32 0-d tensor)."""
        cfg = self.cfg
        g_norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
        clip = g_norm >= cfg.max_grad_norm
        count = state["count"] + 1
        lr = learning_rate(cfg, state["count"])
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            g = torch.where(clip, g / g_norm.to(g.dtype) * cfg.max_grad_norm, g)
            mu.copy_((1 - cfg.b1) * g + cfg.b1 * mu)
            nu.copy_((1 - cfg.b2) * (g * g) + cfg.b2 * nu)
            mu_hat = mu / _scalar(1 - cfg.b1**count, mu)
            nu_hat = nu / _scalar(1 - cfg.b2**count, nu)
            u = mu_hat / (torch.sqrt(nu_hat) + 1e-8)
            u = u + cfg.weight_decay * p
            p.add_(_scalar(-lr, u) * u)
        state["count"] = count
        return g_norm


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


def make_train_step(
    model_cfg: mm.Any2PixLMConfig, train_cfg: TrainConfig = TrainConfig(),
) -> Tuple[Callable, Callable]:
    """Returns (init_state, train_step). `init_state(params)` wraps a
    trainable `Any2PixLM`; `train_step(state, batch)` runs the loss, its
    gradient and the optimizer update in place, and returns the state with
    `step` advanced and the metrics (loss, grad_norm and the individual
    losses, detached 0-d tensors)."""
    tx = make_optimizer(train_cfg)

    def init_state(params: mm.Any2PixLM) -> Dict[str, Any]:
        return {"params": params, "opt_state": tx.init(params), "step": 0}

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        trainable = [p for p in params.parameters() if p.requires_grad]
        with torch.enable_grad():
            loss, individual = mm.train_forward(params, model_cfg, batch)
            grads = torch.autograd.grad(loss, trainable, allow_unused=True)
        # a parameter the batch does not reach has a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(trainable, grads)]
        g_norm = tx.update(trainable, grads, state["opt_state"])
        metrics = {"loss": loss.detach(), "grad_norm": g_norm,
                   **{k: v.detach() for k, v in individual.items()}}
        state["step"] += 1
        return state, metrics

    return init_state, train_step


def make_preview_step(model_cfg: mm.Any2PixLMConfig) -> Callable:
    """The generation-preview forward the launcher runs every N steps:
    `(params, batch) -> {"pred", "src", "has_gen"}` (no gradient)."""

    def preview_step(params, batch):
        return mm.preview_generations(params, model_cfg, batch)

    return preview_step
