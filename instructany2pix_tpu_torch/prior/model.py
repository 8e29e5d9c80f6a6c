"""The InstructAny2Pix diffusion prior: GPT-2 over multimodal token
sequences, refining the LLM's predicted embedding in ImageBind space;
counterpart of the JAX package's `prior/model.py`, inference half.

The pipeline runs `generate_diffusion(..., no_diffusion=True)`: one
single-step x0-space CFG, x0_u + g·(x0_c − x0_u), over the assembled
prompt [src_type, SOS|imagebind|EOS, SOS|text|EOS, SOS|score|EOS] (the
reference's key-list quirk keeps the noise level and target type out of
it; see the JAX module). `no_diffusion=False` runs the DDPM sampling loop:
the noisy latents join the prompt, GPT-2 predicts the sample, which is
turned into ε for CFG and an ancestral DDPM step. `generate` and
`generate_partial` are the plain autoregressive generations.

Training: `train_forward` is the teacher-forced L1 loss, `make_optimizer`
the reference's AdamW + StepLR with its linear warmup as the JAX optax
chain computes it, `mask_target_sequence` the random target masking and
`param_count` the parameter count. Every random draw (the timestep, the
noise, the masking's ratio and keep draws) can be passed in; otherwise it
comes from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.checkpoint import KeyMap, Rule
from ..diffusion.schedulers import Schedule, SchedulerConfig
from ..models import gpt2
from ..models import layers as L


class MODALITY:
    IMAGE = 0
    AUDIO = 1
    TEXT = 2
    VIDEO = 3


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    embed_dim: int = 1024
    output_dim: int = 1024
    sequence_gen_length: int = 1
    imagebind_dim: int = 1024
    text_dim: int = 1024  # CLIP-ViT-H hidden size
    score_dim: int = 512
    text_len: int = 77
    gpt2: gpt2.GPT2Config = gpt2.GPT2Config.medium()
    # (key, input_dim) in sequence order; dim 0 → no projection
    sequence_input_key: Tuple[Tuple[str, int], ...] = (
        ("src_type", 0),
        ("imagebind", 1024),
        ("crossattn_clip", 1024),
        ("score", 512),
        ("noisy_inputs", 0),
    )

    @staticmethod
    def default() -> "PriorConfig":
        return PriorConfig()

    @staticmethod
    def tiny() -> "PriorConfig":
        return PriorConfig(
            embed_dim=32,
            output_dim=32,
            imagebind_dim=16,
            text_dim=24,
            score_dim=8,
            text_len=7,
            gpt2=gpt2.GPT2Config.tiny(),
            sequence_input_key=(
                ("src_type", 0),
                ("imagebind", 16),
                ("crossattn_clip", 24),
                ("score", 8),
                ("noisy_inputs", 0),
            ),
        )


class Prior(nn.Module):
    """`output_proj` exists when `output_dim` differs from `embed_dim`, or
    as `output_proj` says (a checkpoint that carries one)."""

    def __init__(self, cfg: PriorConfig = PriorConfig(), output_proj: Optional[bool] = None):
        super().__init__()
        d = cfg.embed_dim
        self.sos = nn.Embedding(32, d)
        self.eos = nn.Embedding(32, d)
        self.modality_embedding = nn.Embedding(10, d)
        self.gpt2 = gpt2.GPT2(cfg.gpt2)
        for name, dim in cfg.sequence_input_key:
            if dim > 0:
                self.add_module(f"proj_{name}", nn.Linear(dim, d))
        if cfg.output_dim != cfg.embed_dim if output_proj is None else output_proj:
            self.output_proj = nn.Linear(d, cfg.output_dim)


def _with_sos_eos(params: Prior, kid: int, seq: torch.Tensor, mask: torch.Tensor):
    b, _, d = seq.shape
    sos = params.sos.weight[kid].to(seq.dtype).expand(b, 1, d)
    eos = params.eos.weight[kid].to(seq.dtype).expand(b, 1, d)
    one = torch.ones((b, 1), dtype=mask.dtype, device=mask.device)
    return torch.cat([sos, seq, eos], dim=1), torch.cat([one, mask, one], dim=1)


def assemble_sequence(params: Prior, cfg: PriorConfig, cond: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(input_embeds, attn_mask) in `sequence_input_key` order; keys absent
    from `cond` are skipped. cond: src_type (B,) or (B, 1) ids; imagebind
    (B, 1, D); crossattn_clip a (hidden (B, T, text_dim), mask (B, T))
    pair; score (B, 1, score_dim); noisy_inputs (B, L, embed_dim)."""
    embeds, masks = [], []
    dev = params.sos.weight.device
    for kid, (name, dim) in enumerate(cfg.sequence_input_key):
        if name not in cond:
            continue
        val = cond[name]
        if name in ("src_type", "tgt_type"):
            ids = val.reshape(val.shape[0], -1).to(dev)
            embeds.append(L.embedding(params.modality_embedding, ids))
            masks.append(torch.ones(ids.shape, dtype=torch.float32, device=dev))
            continue
        if isinstance(val, (tuple, list)):
            seq, m = val
        else:
            seq = val
            m = torch.ones(seq.shape[:2], dtype=torch.float32, device=dev)
        seq, m = seq.to(dev), m.to(dev)
        if dim > 0:
            seq = L.linear(getattr(params, f"proj_{name}"), seq)
        seq, m = _with_sos_eos(params, kid, seq, m)
        embeds.append(seq)
        masks.append(m)
    dt = params.sos.weight.dtype
    emb = torch.cat([e.to(dt) for e in embeds], dim=1)
    mask = torch.cat(masks, dim=1)
    max_len = cfg.gpt2.max_positions - cfg.sequence_gen_length
    return emb[:, :max_len], mask[:, :max_len]


def _ar_decode(params: Prior, cfg: PriorConfig, emb, mask, steps: int) -> torch.Tensor:
    """GPT-2 decode of `steps` continuous tokens: a full re-forward per
    token, appending the last hidden state."""
    outs = []
    for _ in range(steps):
        h = gpt2.forward(params.gpt2, cfg.gpt2, emb, attention_mask=mask)
        nxt = h[:, -1:]
        outs.append(nxt)
        emb = torch.cat([emb, nxt], dim=1)
        mask = torch.cat([mask, torch.ones((mask.shape[0], 1), dtype=mask.dtype, device=mask.device)],
                         dim=1)
    return torch.cat(outs, dim=1)


def _project_out(params: Prior, x: torch.Tensor) -> torch.Tensor:
    return L.linear(params.output_proj, x) if hasattr(params, "output_proj") else x


def score_embedding(score: float, dim: int = 512, device="cpu") -> torch.Tensor:
    """Aesthetic-score conditioning as a sinusoidal embedding (1, 1, dim)."""
    t = torch.tensor([score], dtype=torch.float32, device=device)
    return L.timestep_embedding(t, dim, flip_sin_to_cos=True, downscale_freq_shift=0.0).reshape(1, 1, dim)


@torch.inference_mode()
def generate_diffusion(
    params: Prior,
    cfg: PriorConfig,
    src_type: int,
    tgt_type: int,
    src: torch.Tensor,  # (B, imagebind_dim)
    text_hidden: torch.Tensor,  # (B, T, text_dim): CLIP hidden of the "" prompt
    text_mask: torch.Tensor,  # (B, T)
    num_inference_steps: int = 25,
    guidance_scale: float = 5.0,
    score: float = 6.8,
    negative_score: float = 2.0,
    no_diffusion: bool = False,
    schedule: Optional[Schedule] = None,
    generator: Optional[torch.Generator] = None,
    latents: Optional[torch.Tensor] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Refined embedding (B, sequence_gen_length, output_dim).

    The DDPM path starts from `latents` (B, sequence_gen_length, embed_dim)
    and takes `noise[i]` (the same shape) as step i's normal draw; without
    them both are drawn from `generator`, the start latent first, as the
    JAX function draws from its key chain."""
    dev = params.sos.weight.device
    src = src.to(dev)
    b = src.shape[0]
    score_emb = score_embedding(score, cfg.score_dim, dev).repeat(b, 1, 1)
    neg_score_emb = score_embedding(negative_score, cfg.score_dim, dev).repeat(b, 1, 1)

    # CFG layout: cond half first, uncond half second
    def dup(c, u):
        return torch.cat([c, u], dim=0)

    imagebind = src.reshape(b, 1, -1)
    st = torch.full((b, 1), src_type, dtype=torch.long, device=dev)
    cond = {
        "src_type": dup(st, st),
        "imagebind": dup(imagebind, torch.zeros_like(imagebind)),
        "crossattn_clip": (dup(text_hidden, text_hidden), dup(text_mask, text_mask)),
        "score": dup(score_emb, neg_score_emb),
    }
    if no_diffusion:
        # one step at t = 0: the noisy seed cancels, leaving x0-space CFG
        emb, mask = assemble_sequence(params, cfg, cond)
        out = _ar_decode(params, cfg, emb, mask, cfg.sequence_gen_length)
        x0_c, x0_u = out.chunk(2, dim=0)
        return _project_out(params, x0_u + guidance_scale * (x0_c - x0_u))

    sched = schedule or Schedule.create(SchedulerConfig(), dev)
    shape = (b, cfg.sequence_gen_length, cfg.embed_dim)
    if noise is not None and len(noise) != num_inference_steps:
        raise ValueError(f"{len(noise)} noise draws for {num_inference_steps} steps")

    def draw(given):
        if given is None:
            return torch.randn(shape, generator=generator, device=dev)
        t = torch.as_tensor(given, dtype=torch.float32, device=dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"injected prior noise {tuple(t.shape)} != {shape}")
        return t

    lat = draw(latents)
    ts = sched.ddpm_timesteps(num_inference_steps).tolist()
    ratio = sched.cfg.num_train_timesteps // num_inference_steps
    for i, t in enumerate(ts):
        cond["noisy_inputs"] = torch.cat([lat, lat], dim=0)
        emb, mask = assemble_sequence(params, cfg, cond)
        out = _ar_decode(params, cfg, emb, mask, cfg.sequence_gen_length).float()
        # GPT-2 predicts the sample; ε by the reference's fixed formula,
        # whatever the scheduler's prediction type
        a = sched.alpha_bar(torch.full((2 * b,), t, device=dev)).reshape(-1, 1, 1)
        eps = (cond["noisy_inputs"] - torch.sqrt(a) * out) / torch.sqrt(1.0 - a)
        eps_c, eps_u = eps.chunk(2, dim=0)
        lat = sched.ddpm_step(
            eps_u + guidance_scale * (eps_c - eps_u), torch.full((b,), t, device=dev), lat,
            draw(noise[i] if noise is not None else None),
            t_prev=torch.full((b,), t - ratio, device=dev),
        )
    if hasattr(params, "output_proj"):
        lat = lat.to(params.output_proj.weight.dtype)
    return _project_out(params, lat)


@torch.inference_mode()
def generate(params: Prior, cfg: PriorConfig, cond: Dict) -> torch.Tensor:
    """Plain autoregressive generation, no diffusion: the conditioning
    prompt, then `sequence_gen_length` continuous tokens."""
    emb, mask = assemble_sequence(params, cfg, cond)
    return _project_out(params, _ar_decode(params, cfg, emb, mask, cfg.sequence_gen_length))


@torch.inference_mode()
def generate_partial(params: Prior, cfg: PriorConfig, cond: Dict, target: torch.Tensor) -> torch.Tensor:
    """In-context partial generation: the first quarter of `target` (B, T,
    embed_dim) after the prompt, the rest decoded."""
    emb, mask = assemble_sequence(params, cfg, cond)
    t = target.shape[1]
    prefix = target[:, : t // 4].to(device=emb.device, dtype=emb.dtype)
    emb = torch.cat([emb, prefix], dim=1)
    mask = torch.cat([mask, torch.ones((mask.shape[0], prefix.shape[1]), dtype=mask.dtype,
                                       device=mask.device)], dim=1)
    out = _ar_decode(params, cfg, emb, mask, max(3 * t // 4, 1))
    return _project_out(params, torch.cat([prefix, out], dim=1))


# --------------------------------------------------------------- training


def train_forward(
    params: Prior,
    cfg: PriorConfig,
    cond: Dict,
    target: torch.Tensor,  # (B, L, embed_dim)
    t: Optional[torch.Tensor] = None,  # (B,) int timesteps
    noise: Optional[torch.Tensor] = None,  # target's shape
    generator: Optional[torch.Generator] = None,
    schedule: Optional[Schedule] = None,
) -> torch.Tensor:
    """Teacher-forced L1 training loss (reference prior/model.py:660-692):
    the target noised at timestep `t` as 10·add_noise(target/10, noise)
    joins the prompt as `noisy_inputs`, the clean target follows it, and
    the GPT-2 states one position before each target token are held to it.
    `t` (uniform over the training steps) and `noise` (standard normal)
    are drawn from `generator` when not given. A float32 0-d loss."""
    dev = params.sos.weight.device
    target = target.to(dev)
    sched = schedule or Schedule.create(SchedulerConfig(), dev)
    b = target.shape[0]
    if t is None:
        t = torch.randint(0, sched.cfg.num_train_timesteps, (b,), generator=generator,
                          device=generator.device if generator is not None else "cpu")
    if noise is None:
        noise = torch.randn(target.shape, generator=generator, dtype=target.dtype,
                            device=generator.device if generator is not None else "cpu")
    t, noise = t.to(dev), noise.to(device=dev, dtype=target.dtype)
    noisy = 10.0 * sched.add_noise(target / 10.0, noise, t)
    cond = dict(cond)
    cond["noisy_inputs"] = noisy.to(target.dtype)
    emb, mask = assemble_sequence(params, cfg, cond)
    tlen = target.shape[1]
    emb = torch.cat([emb, target.to(emb.dtype)], dim=1)
    mask = torch.cat([mask, torch.ones((b, tlen), dtype=mask.dtype, device=dev)], dim=1)
    h = gpt2.forward(params.gpt2, cfg.gpt2, emb, attention_mask=mask)
    shifted = h[:, -1 - tlen:-1]
    return (shifted.float() - target.float()).abs().mean()


class PriorOptimizer:
    """The JAX `make_optimizer` chain, in its order: optax's
    `scale_by_adam` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0; moments in the
    parameter dtype, bias correction at count + 1), then
    `add_decayed_weights` (u + wd·p), then `scale_by_learning_rate` of the
    warmup·StepLR schedule at the count before the step. No clipping: this is
    not the LLM trainer's clipped AdamW. Updates trainable parameters in
    place."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax's scale_by_adam defaults

    def __init__(self, learning_rate: float, weight_decay: float = 0.0, warmup_steps: int = 1000,
                 step_size_epochs: int = 5, gamma: float = 0.8, steps_per_epoch: int = 1000):
        self.lr, self.wd = learning_rate, weight_decay
        self.warmup, self.step_size, self.gamma = warmup_steps, step_size_epochs, gamma
        self.steps_per_epoch = steps_per_epoch

    def schedule(self, step: int) -> float:
        """lr · min(step / warmup, 1) · γ^(epoch // step_size), epoch =
        step // steps_per_epoch (Lightning steps the StepLR per epoch)."""
        warm = min(step / max(self.warmup, 1), 1.0)
        epoch = step // self.steps_per_epoch
        return self.lr * warm * self.gamma ** (epoch // self.step_size)

    def init(self, params: nn.Module) -> Dict:
        ps = [p for p in params.parameters() if p.requires_grad]
        return {"count": 0, "mu": [torch.zeros_like(p) for p in ps],
                "nu": [torch.zeros_like(p) for p in ps]}

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state: Dict) -> None:
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            mu_hat = mu / torch.tensor(1 - self.b1**count, dtype=mu.dtype, device=mu.device)
            nu_hat = nu / torch.tensor(1 - self.b2**count, dtype=nu.dtype, device=nu.device)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            u = u + self.wd * p
            p.add_(torch.tensor(-lr, dtype=u.dtype, device=u.device) * u)
        state["count"] = count


def make_optimizer(learning_rate: float, weight_decay: float = 0.0, warmup_steps: int = 1000,
                   step_size_epochs: int = 5, gamma: float = 0.8,
                   steps_per_epoch: int = 1000) -> PriorOptimizer:
    """The prior's training optimizer (reference prior/model.py:262-270
    `configure_optimizers`: AdamW + StepLR(step_size=5, γ=0.8), with the
    1000-step linear warmup of its `warmup_step` hook :383-401)."""
    return PriorOptimizer(learning_rate, weight_decay, warmup_steps, step_size_epochs, gamma,
                          steps_per_epoch)


def train_step(params: Prior, cfg: PriorConfig, tx: PriorOptimizer, state: Dict, cond: Dict,
               target: torch.Tensor, **draws) -> torch.Tensor:
    """One step: `train_forward` (its draws passed through), the gradient
    of every trainable parameter and `tx`'s update in place. Returns the
    detached loss."""
    trainable = [p for p in params.parameters() if p.requires_grad]
    with torch.enable_grad():
        loss = train_forward(params, cfg, cond, target, **draws)
        grads = torch.autograd.grad(loss, trainable, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(trainable, grads)]
    tx.update(trainable, grads, state)
    return loss.detach()


def mask_target_sequence(
    target: torch.Tensor,  # (B, L, D)
    attn_mask: torch.Tensor,  # (B, L)
    mask_ratio: float,
    random_ratio: bool = False,
    generator: Optional[torch.Generator] = None,
    ratio_u: Optional[torch.Tensor] = None,  # () uniform draw in [0, 1)
    keep_u: Optional[torch.Tensor] = None,  # (B, L) uniform draws in [0, 1)
):
    """Reference prior/model.py:403-420: zero target embeddings (and their
    attention slots) at `mask_ratio`, or with `random_ratio` at a ratio
    drawn uniformly in [0, mask_ratio) per call. A slot is kept where its
    uniform draw exceeds the ratio. The draws come from `generator` unless
    given. Returns (masked_target, masked_attn_mask, keep), keep None when
    nothing is masked (ratio <= 1e-4)."""
    if mask_ratio <= 1e-4:
        return target, attn_mask, None
    b, l, _ = target.shape
    dev = generator.device if generator is not None else "cpu"
    if random_ratio:
        if ratio_u is None:
            ratio_u = torch.rand((), generator=generator, device=dev)
        ratio = ratio_u.to(target.device).float() * mask_ratio
    else:
        ratio = torch.tensor(mask_ratio, dtype=torch.float32, device=target.device)
    if keep_u is None:
        keep_u = torch.rand((b, l), generator=generator, device=dev)
    keep = keep_u.to(target.device).float() > ratio
    masked = torch.where(keep[..., None], target, torch.zeros_like(target))
    return masked, attn_mask * keep.to(attn_mask.dtype), keep


def param_count(params: nn.Module) -> int:
    """Every parameter's element count (reference prior/model.py:747-794)."""
    return int(sum(p.numel() for p in params.parameters()))


# ------------------------------------------------------------ checkpoints

# the reference's input projections by index (`input_sequence_embed_linear.<i>`)
SEQUENCE_KEY_ORDER = ("src_type", "imagebind", "crossattn_clip", "score", "noisy_inputs")


def keymap() -> KeyMap:
    """`prior/model.bin` ↔ `Prior`: GPT-2 under `model.`, the start, end and
    modality tables, one input projection per sequence key in
    `SEQUENCE_KEY_ORDER`, and the output projection."""
    rules = [Rule("start_of_sequence_tokens.weight", "sos.weight"),
             Rule("end_of_sequence_tokens.weight", "eos.weight"),
             Rule("modality_embedding.weight", "modality_embedding.weight"),
             Rule("output_proj.weight", "output_proj.weight"),
             Rule("output_proj.bias", "output_proj.bias")]
    for i, name in enumerate(SEQUENCE_KEY_ORDER):
        for leaf in ("weight", "bias"):
            rules.append(Rule(f"input_sequence_embed_linear.{i}.{leaf}", f"proj_{name}.{leaf}"))
    return gpt2.hf_keymap().prefixed(ref="model.", port="gpt2.") + KeyMap(rules)
