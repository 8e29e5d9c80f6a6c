"""Shared building blocks over PyTorch modules, in the JAX package's
layouts.

Weights live in `nn.Linear`/`nn.Conv2d`/`nn.LayerNorm`/`nn.GroupNorm`/
`nn.Embedding` modules (PyTorch's (out, in) and OIHW storage); the
functions here take such a module and an activation and keep the JAX
package's conventions at their boundary: activations are NHWC for convs,
norms compute in float32, `embedding` clamps out-of-range ids, `gelu` is
exact. Convolutions run as channels_last NCHW views of the NHWC tensor, so
no layout copy is made when the weights are channels_last.

`init_` draws every parameter of a module tree from a `torch.Generator`
with the JAX package's initializers.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import quant as Q
from ..ops.groupnorm import group_norm as _group_norm
from ..parallel import sharding as tp

# ---------------------------------------------------------------- linear


def _use_qmv(p: Q.QLinear, x: torch.Tensor) -> bool:
    """The JAX package's `_use_pallas_qmv` rule: decode shapes (M <= 16
    rows) with a lane-aligned output (N % 128 == 0) take K2; prefill and
    odd widths, such as the 32009-wide vocab head, take the plain product."""
    m = math.prod(x.shape[:-1]) if x.dim() > 1 else 1
    return m <= Q.QMV_MAX_M and p.out_features % Q.QMV_TILE_N == 0


def has_lora(p: nn.Module) -> bool:
    """True when a linear carries low-rank adapters (`add_lora`)."""
    return getattr(p, "lora_a", None) is not None


def _lora_delta(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """((x @ A) @ B) · lora_scale in x's dtype: the adapter branch."""
    a, b = p.lora_a.to(x.dtype), p.lora_b.to(x.dtype)
    return F.linear(F.linear(x, a), b) * p.lora_scale.to(x.dtype)


def linear(
    p: Union[nn.Linear, Q.QLinear],
    x: torch.Tensor,
    norm: Optional[Tuple[torch.Tensor, float]] = None,
    swiglu: bool = False,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`x @ w + b` for float (`nn.Linear`) or weight-only quantized
    (`QLinear`) weights. `norm=(g, eps)` (an RMSNorm before the product),
    `swiglu` (x is the gate|up pair, the product takes silu(gate)·up) and
    `residual` (added to the output) fuse into K2 when the quantized
    decode path is taken; every other path composes the same ops, in the
    same order.

    A linear carrying adapters (`add_lora`) adds ((x @ A) @ B) · lora_scale,
    on float and quantized weights alike (on a float weight after the bias,
    which the JAX package adds last: the same sum in another order). The adapters
    must see the transformed activation, so with a quantized base and any
    of `norm`/`swiglu`/`residual` the prologue is composed here and K2 is
    called without it (the JAX package's `"lora_a" not in p` rule).

    A linear tagged by `parallel.sharding.apply_tp_rules` holds this
    rank's shard and runs with the collective its kind needs (`_tp_linear`)."""
    kind = getattr(p, "tp", None)
    if kind is not None:
        return _tp_linear(p, x, kind, norm, swiglu, residual)
    return _linear(p, x, norm, swiglu, residual)


def _tp_linear(p, x, kind, norm, swiglu, residual):
    """A tensor-parallel linear on this rank's shard: a column layer's
    local outputs (plus its bias slice, all-gathered for "col_gather"); a
    row layer's partial product all-reduced over "model", then the bias
    and the residual added once (added inside every rank's product they
    would count n_model times); "row_gather" gathers its sharded input and
    runs whole."""
    b = p.q.get("b") if isinstance(p, Q.QLinear) else p.bias
    if kind in ("col", "col_gather"):
        if residual is not None:
            raise ValueError("a column-parallel linear takes no residual")
        y = _linear(p, x, norm, swiglu, bias=False)
        if b is not None:
            lo, hi = p.tp_cols
            y = y + b[lo:hi].to(y.dtype)
        return tp.model_all_gather(y, -1) if kind == "col_gather" else y
    if kind == "row":
        if norm is not None:
            raise ValueError("a row-parallel linear sees a slice of its input: no RMSNorm prologue")
        y = tp.model_all_reduce(_linear(p, x, None, swiglu, bias=False))
        if b is not None:
            y = y + b.to(y.dtype)
        return y + residual.to(y.dtype) if residual is not None else y
    if kind == "row_gather":
        if swiglu:  # gather the gate and up halves apart: they pair elementwise
            k = x.shape[-1] // 2
            x = torch.cat([tp.model_all_gather(x[..., :k]), tp.model_all_gather(x[..., k:])], -1)
        else:
            x = tp.model_all_gather(x)
        return _linear(p, x, norm, swiglu, residual)
    raise ValueError(f"linear: tensor-parallel kind {kind!r}")


def _linear(p, x, norm=None, swiglu=False, residual=None, bias: bool = True) -> torch.Tensor:
    """`linear` on the tensors the module holds; `bias=False` leaves its
    bias out."""
    fused = norm is not None or swiglu or residual is not None
    lora = has_lora(p)
    if isinstance(p, Q.QLinear):
        q = p.q
        if fused and (lora or not _use_qmv(p, x)):
            y = _linear(p, _fused_prologue(x, norm, swiglu), bias=bias)
            return y + residual if residual is not None else y
        if _use_qmv(p, x):
            y = Q.qmatmul(
                x, q, norm_g=norm[0] if norm is not None else None,
                norm_eps=norm[1] if norm is not None else 1e-6,
                swiglu=swiglu, residual=residual,
            )
        elif "w_q" in q:
            y = (x @ q["w_q"].to(x.dtype)) * q["scale"].to(x.dtype)
        else:
            y = Q.int4_matmul(x, q)
        if lora:
            y = y + _lora_delta(p, x)
        return y + q["b"].to(y.dtype) if "b" in q and bias else y
    if fused:
        y = _linear(p, _fused_prologue(x, norm, swiglu), bias=bias)
        return y + residual if residual is not None else y
    b = p.bias if bias else None
    if lora:
        # the bias stays in the product, so zero adapters leave the output bit-identical
        x = x.to(p.weight.dtype)
        return F.linear(x, p.weight, b) + _lora_delta(p, x)
    return F.linear(x.to(p.weight.dtype), p.weight, b)


@torch.no_grad()
def add_lora(p: nn.Module, rank: int = 8, alpha: float = 16.0,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """Attach low-rank adapters to a linear, in place, in PEFT's layout:
    `lora_a` (rank, in) drawn N(0, 1)/sqrt(in) from `generator`, `lora_b`
    (out, rank) zero, so the forward is unchanged until they are trained or
    loaded, and a `lora_scale` buffer alpha/rank. All three sit beside the
    base weight, whose name stays as it was (`to_q.weight`). On a
    `QLinear` the adapters are float (the dtype of its bias, else float32).
    Returns `p`."""
    if has_lora(p):
        raise ValueError("this linear already carries adapters")
    if isinstance(p, Q.QLinear):
        ref = p.b if hasattr(p, "b") else p.packed.new_empty((), dtype=torch.float32)
    else:
        ref = p.weight
    n_in, n_out = p.in_features, p.out_features
    a = torch.empty(rank, n_in, dtype=ref.dtype, device=ref.device)
    a.normal_(generator=generator).mul_(n_in**-0.5)
    p.lora_a = nn.Parameter(a)
    p.lora_b = nn.Parameter(torch.zeros(n_out, rank, dtype=ref.dtype, device=ref.device))
    p.register_buffer("lora_scale", torch.tensor(alpha / rank, dtype=ref.dtype, device=ref.device))
    return p


def remove_lora(p: nn.Module) -> nn.Module:
    """Detach a linear's adapters (after a merge). Returns `p`."""
    for name in ("lora_a", "lora_b", "lora_scale"):
        if hasattr(p, name):
            delattr(p, name)
    return p


def _fused_prologue(x, norm, swiglu):
    """Composed form of the linear-fusion prologue, in K2's op order."""
    if norm is not None:
        x = rms_norm(norm[0], x, norm[1])
    if swiglu:
        k = x.shape[-1] // 2
        x = silu(x[..., :k]) * x[..., k:]
    return x


# ----------------------------------------------------------------- norms


class RMSNorm(nn.Module):
    """Holds an RMSNorm gain under the JAX tree's name `g`."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.empty(dim))


def layer_norm(p: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    y = F.layer_norm(x.float(), x.shape[-1:], p.weight.float(), p.bias.float(), eps)
    return y.to(x.dtype)


def rms_norm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * g.float()).to(x.dtype)


def group_norm(p: nn.GroupNorm, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
    """GroupNorm over the channel-last axis with the module's own group
    count and eps (1e-5 in UNet resnets, 1e-6 in transformers and the VAE)."""
    return _group_norm(x, p.weight, p.bias, p.num_groups, p.eps, silu)


# ------------------------------------------------------------------ conv

Padding = Union[str, Sequence[Tuple[int, int]]]


def conv2d(p: nn.Conv2d, x: torch.Tensor, stride: int = 1, padding: Padding = "SAME") -> torch.Tensor:
    """NHWC conv. "SAME" is symmetric k//2 padding (stride-1 odd kernels,
    the only SAME convs here); "VALID" pads nothing; explicit padding is
    [(top, bottom), (left, right)] and must be symmetric."""
    kh, kw = p.weight.shape[-2:]
    if padding == "SAME":
        if stride != 1 or kh % 2 == 0 or kw % 2 == 0:
            raise ValueError("SAME padding is only symmetric for stride-1 odd kernels")
        pad = (kh // 2, kw // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        (t, b), (l, r) = padding
        if t != b or l != r:
            raise ValueError(f"asymmetric padding {padding}: pad the input first")
        pad = (t, l)
    if getattr(p, "tp", None) == "conv":
        # this rank's output channels, gathered whole; the bias after the gather
        y = F.conv2d(x.to(p.weight.dtype).permute(0, 3, 1, 2), p.weight, None, stride, pad)
        y = tp.model_all_gather(y.permute(0, 2, 3, 1), -1)
        return y + p.bias.to(y.dtype) if p.bias is not None else y
    y = F.conv2d(x.to(p.weight.dtype).permute(0, 3, 1, 2), p.weight, p.bias, stride, pad)
    return y.permute(0, 2, 3, 1)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return y.reshape(b, h * 2, w * 2, c)


# ----------------------------------------------------------- embeddings


def embedding(p: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """Out-of-range ids clamp (the JAX `mode="clip"`) instead of raising.
    A table sharded on its hidden dim ("embed") is gathered after the lookup."""
    y = F.embedding(ids.long().clamp(0, p.num_embeddings - 1), p.weight)
    return tp.model_all_gather(y, -1) if getattr(p, "tp", None) == "embed" else y


def timestep_embedding(
    t: torch.Tensor,
    dim: int,
    max_period: float = 10000.0,
    flip_sin_to_cos: bool = False,
    downscale_freq_shift: float = 1.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """Sinusoidal embedding, diffusers get_timestep_embedding semantics."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - downscale_freq_shift)
    )
    args = t.float()[..., None] * freqs * scale
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[..., half:], emb[..., :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


# -------------------------------------------------------------- helpers


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


# ------------------------------------------------------------ init / build


@torch.no_grad()
def init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter with the JAX package's initializers: linear
    N(0,1)/sqrt(in), conv N(0,1)/sqrt(in*k*k), embeddings N(0,1)*0.02,
    zero biases, unit norm gains (RMSNorm's too). Free parameters (such as IP-Adapter's
    `raw_embed`) start at zero, as in the JAX init."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(generator=generator).mul_(fan_in**-0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(generator=generator).mul_(0.02)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.g.fill_(1.0)
        else:
            for prm in m.parameters(recurse=False):
                prm.zero_()
    return module


def materialize(module: nn.Module, device: torch.device, dtype: torch.dtype) -> nn.Module:
    """Allocate a module built on the meta device, in `dtype`, on `device`,
    with conv weights channels_last. Values are uninitialized: follow with
    `init_` or a weight load."""
    module = module.to(dtype=dtype).to_empty(device=device)
    return module.to(memory_format=torch.channels_last)
