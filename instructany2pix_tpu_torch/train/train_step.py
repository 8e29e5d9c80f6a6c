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

With a mesh (`core/mesh.py`, one process per rank) the module is sharded
by FSDP2 over every rank (`parallel/sharding.py::shard_params_fsdp`, per
decoder layer and at the root), the batch over "data" (the model-axis
ranks of one data group hold the same rows), and:
  * every loss is normalised by its global count (`mm.train_forward`'s
    `total`, an all-reduce over "data"), so the step's loss is the whole
    batch's however the valid tokens fall across ranks;
  * each rank back-propagates n_data times its share: FSDP's averaging
    reduce-scatter over n_data · n_model ranks then leaves the sum over
    data groups, once; the parameters FSDP leaves whole get the same
    all-reduce by hand;
  * the clip's global norm sums the squares of every shard once;
  * the optimizer updates each rank's shards, its moments shaped alike.
`full_state` gathers a checkpoint that is the one-process trainer's file,
and `restore_state` loads such a file at any mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.mesh import DATA_AXIS, Mesh
from ..llm import multimodal as mm
from ..parallel import collectives as C
from ..parallel import sharding as sh


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
        """Moments shaped as each trainable parameter's local tensor (its
        shard under FSDP)."""
        ps = [sh.local(p) for p in params.parameters() if p.requires_grad]
        return {"count": 0, "mu": [torch.zeros_like(p) for p in ps],
                "nu": [torch.zeros_like(p) for p in ps]}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict[str, Any], g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one step in place; returns the global norm of `grads`
        before clipping (a float32 0-d tensor). `g_norm`, when given, is
        that norm taken over every shard."""
        cfg = self.cfg
        if g_norm is None:
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
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable, Callable]:
    """Returns (init_state, train_step). `init_state(params)` wraps a
    trainable `Any2PixLM` (sharded by FSDP in place on a mesh);
    `train_step(state, batch)` runs the loss, its gradient and the
    optimizer update in place, and returns the state with `step` advanced
    and the metrics (loss, grad_norm and the individual losses, detached
    0-d tensors, the whole batch's on every rank). On a mesh `batch` is
    the global batch, whose rows must divide by the data axis; each rank
    takes its data group's rows."""
    tx = make_optimizer(train_cfg)

    def init_state(params: mm.Any2PixLM) -> Dict[str, Any]:
        if mesh is not None:
            from ..models.llama import LlamaLayer

            for layer in params.llama.children():
                if isinstance(layer, LlamaLayer):
                    sh.shard_params_fsdp(layer, mesh)
            sh.shard_params_fsdp(params, mesh)
        return {"params": params, "opt_state": tx.init(params), "step": 0}

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        if mesh is not None:
            return _sharded_step(state, batch)
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

    def _sharded_step(state, batch):
        params = state["params"]
        rows = next(iter(batch.values())).shape[0]
        if rows % mesh.n_data:
            raise ValueError(f"a batch of {rows} rows does not divide the data axis "
                             f"({mesh.n_data})")
        from ..core.mesh import shard_batch

        local_batch = shard_batch(batch, mesh)
        data = mesh.group(DATA_AXIS)

        def total(x):
            return C.all_reduce(x, data)

        trainable = [p for p in params.parameters() if p.requires_grad]
        for p in trainable:
            p.grad = None
        with torch.enable_grad():
            # through the module's call: FSDP gathers the root's shards around it
            loss, individual = params(model_cfg, local_batch, total)
            (loss * mesh.n_data).backward()
        world = C.world() if mesh.size() > 1 else None
        replicated = {id(p) for p in getattr(params, "fsdp_replicated", [])}
        grads, sq_shards, sq_whole = [], [], []
        for p in trainable:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if id(p) in replicated:
                if world is not None:
                    g = C.all_reduce(g, world) / mesh.size()
                sq_whole.append(g.float().square().sum())
            else:
                g = sh.local(g)
                sq_shards.append(g.float().square().sum())
            grads.append(g)
        zero = torch.zeros((), dtype=torch.float32, device=mesh.device)
        sq = torch.stack(sq_shards).sum() if sq_shards else zero
        if world is not None:
            sq = C.all_reduce(sq, world)
        g_norm = (sq + (torch.stack(sq_whole).sum() if sq_whole else zero)).sqrt()
        tx.update([sh.local(p) for p in trainable], grads, state["opt_state"], g_norm)
        for p in trainable:
            p.grad = None
        metrics = {"loss": total(loss.detach()), "grad_norm": g_norm,
                   **{k: total(v.detach()) for k, v in individual.items()}}
        state["step"] += 1
        return state, metrics

    return init_state, train_step


@torch.no_grad()
def full_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A training state with every FSDP shard gathered whole (a collective:
    every rank calls it): {"params": state dict, "opt_state", "step"}, the
    blob the one-process trainer's checkpoint holds."""
    from torch.distributed.tensor import DTensor

    params = state["params"]
    sd = {k: sh.full(v).detach().cpu() for k, v in params.state_dict().items()}
    trainable = [p for p in params.parameters() if p.requires_grad]

    def whole(moments):
        out = []
        for p, m in zip(trainable, moments):
            if isinstance(p, DTensor):
                m = DTensor.from_local(m, p.device_mesh, p.placements, shape=p.shape,
                                       stride=p.stride()).full_tensor()
            out.append(m.detach().cpu())
        return out

    opt = state["opt_state"]
    return {"params": sd, "opt_state": {"count": opt["count"], "mu": whole(opt["mu"]),
                                        "nu": whole(opt["nu"])},
            "step": int(state["step"])}


@torch.no_grad()
def restore_state(path: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """Load a checkpoint file (whole tensors, from any mesh or none) into
    a state made by `init_state`, each tensor cut to this rank's shard.
    Returns `state`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    params = state["params"]
    named = dict(params.named_parameters())
    named.update(dict(params.named_buffers()))
    missing = set(named) - set(blob["params"])
    if missing:
        raise KeyError(f"{path}: no tensors for {sorted(missing)[:4]}")
    for name, t in named.items():
        sh.local(t).copy_(sh.shard_like(blob["params"][name], t))
    trainable = [p for p in params.parameters() if p.requires_grad]
    opt = state["opt_state"]
    for key in ("mu", "nu"):
        if len(blob["opt_state"][key]) != len(trainable):
            raise ValueError(f"{path}: {len(blob['opt_state'][key])} moments for "
                             f"{len(trainable)} parameters")
        for p, mine, whole in zip(trainable, opt[key], blob["opt_state"][key]):
            mine.copy_(sh.shard_like(whole, p))
    opt["count"] = int(blob["opt_state"]["count"])
    state["step"] = int(blob["step"])
    return state


def make_preview_step(model_cfg: mm.Any2PixLMConfig) -> Callable:
    """The generation-preview forward the launcher runs every N steps:
    `(params, batch) -> {"pred", "src", "has_gen"}` (no gradient)."""

    def preview_step(params, batch):
        return mm.preview_generations(params, model_cfg, batch)

    return preview_step
