"""Flash attention forward (K1): the CUDA kernel and its plain version.

`flash_attention` is the counterpart of the JAX package's public
`flash_attention` (forward only). On a CUDA tensor it launches the
hand-written Hopper kernel in `csrc/flash_fwd.cu`; on a CPU tensor it runs
`_reference_attention`, the plain PyTorch version of the same function.
There is no fallback from one to the other: a CUDA call the kernel does
not take raises.

Layout: (B, H, S, D) like the JAX function. Any strides are accepted as
long as the last dimension is contiguous, so callers holding (B, S, H, D)
tensors pass `x.transpose(1, 2)` without a copy; the output has q's
strides.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _reference_attention(q, k, v, causal, scale, return_lse=False):
    """Plain version: float32 logits, softmax, p cast to v's dtype for P.V
    (the JAX `_reference_attention`). Also returns the per-row logsumexp
    when asked, as the kernel writes it."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype), v).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v must be on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
            "the kernel takes float32 or bfloat16"
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, D)")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} > {MAX_HEAD_DIM}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H = {b * h} exceeds the grid limit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous last dim")


def _lib():
    from . import _build

    lib = _build.load("flash_fwd")
    fn = lib.ia2p_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 12 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def flash_fwd_cuda(q, k, v, causal: bool, scale: float, return_lse: bool = False):
    """Launch K1 on PyTorch's current stream. Outputs come from
    `torch.empty`; the kernel allocates nothing. Raises on input the kernel
    does not take and on a refused launch."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if sq == 0:
        return (o, lse) if return_lse else o
    fn = _lib()
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr() if lse is not None else None,
            b, h, sq, sk, d, *strides, float(scale), int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {rc}")
    flash_fwd_cuda.launches += 1
    return (o, lse) if return_lse else o


flash_fwd_cuda.launches = 0  # K1 launches in this process


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused attention over (B, H, S, D). With `return_lse` also returns
    the float32 (B, H, Sq) logsumexp."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, causal, scale, return_lse)
    return flash_fwd_cuda(q, k, v, causal, scale, return_lse)
