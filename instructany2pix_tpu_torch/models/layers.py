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
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.groupnorm import group_norm as _group_norm

# ---------------------------------------------------------------- linear


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`x @ w + b` (float weights; the quantized forms come with the LLM)."""
    return F.linear(x.to(p.weight.dtype), p.weight, p.bias)


# ----------------------------------------------------------------- norms


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
    y = F.conv2d(x.to(p.weight.dtype).permute(0, 3, 1, 2), p.weight, p.bias, stride, pad)
    return y.permute(0, 2, 3, 1)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return y.reshape(b, h * 2, w * 2, c)


# ----------------------------------------------------------- embeddings


def embedding(p: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """Out-of-range ids clamp (the JAX `mode="clip"`) instead of raising."""
    return F.embedding(ids.long().clamp(0, p.num_embeddings - 1), p.weight)


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
    zero biases, unit norm gains. Free parameters (such as IP-Adapter's
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
