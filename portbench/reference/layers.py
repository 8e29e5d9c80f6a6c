"""Plain building blocks of the reference, in float32 by default.

The same conventions as the measured program at its module boundary
(NHWC activations for convolutions, float32 norm statistics, exact GELU,
clamped embedding ids), but every product is a plain `torch` operation.
`precision("fp8")` makes every linear, convolution and attention product
take its operands through float8 (e4m3, one scale per tensor) and
accumulate in float32: the lower-precision control that the comparison
must reject.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

_PRECISION = contextvars.ContextVar("reference_precision", default="fp32")
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


@contextlib.contextmanager
def precision(name: str):
    """"fp32" (the reference) or "fp8" (the control) for the products
    computed inside the block."""
    if name not in ("fp32", "fp8"):
        raise ValueError(f"precision {name!r}")
    token = _PRECISION.set(name)
    try:
        yield
    finally:
        _PRECISION.reset(token)


def operand(t: torch.Tensor) -> torch.Tensor:
    """A product's operand in the current precision, as float32."""
    t = t.float()
    if _PRECISION.get() == "fp32":
        return t
    amax = t.abs().amax().clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    b = p.bias.float() if p.bias is not None else None
    return F.linear(operand(x), operand(p.weight), b)


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.empty(dim))


def layer_norm(p: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], p.weight.float(), p.bias.float(), eps)


def group_norm(p: nn.GroupNorm, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
    """GroupNorm over the channel-last axis: two-pass float32 statistics."""
    c, g = x.shape[-1], p.num_groups
    xf = x.float().reshape(x.shape[0], -1, g, c // g)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=(1, 3), keepdim=True)
    y = (xc * torch.rsqrt(var + p.eps)).reshape(x.shape) * p.weight.float() + p.bias.float()
    return F.silu(y) if silu else y


Padding = Union[str, Sequence[Tuple[int, int]]]


def conv2d(p: nn.Conv2d, x: torch.Tensor, stride: int = 1, padding: Padding = "SAME") -> torch.Tensor:
    kh, kw = p.weight.shape[-2:]
    if padding == "SAME":
        pad = (kh // 2, kw // 2)
    elif padding == "VALID":
        pad = (0, 0)
    else:
        (t, _), (l, _) = padding
        pad = (t, l)
    b = p.bias.float() if p.bias is not None else None
    y = F.conv2d(operand(x).permute(0, 3, 1, 2), operand(p.weight), b, stride, pad)
    return y.permute(0, 2, 3, 1)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, h * 2, w * 2, c)


def embedding(p: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids.long().clamp(0, p.num_embeddings - 1), p.weight).float()


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = False, downscale_freq_shift: float = 1.0,
                       scale: float = 1.0) -> torch.Tensor:
    """Sinusoidal embedding, diffusers' get_timestep_embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
                      / (half - downscale_freq_shift))
    args = t.float()[..., None] * freqs * scale
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[..., half:], emb[..., :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
