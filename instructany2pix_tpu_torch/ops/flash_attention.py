"""Flash attention: the forward (K1) with its backward (K4) as one autograd
Function, and the SAM rel-pos variant (K3); the CUDA kernels and their plain
versions.

`flash_attention` is the counterpart of the JAX package's public
`flash_attention` and its `custom_vjp`. On a CUDA tensor the forward
launches K1 (`csrc/flash_fwd.cu`) and, when an input needs a gradient, the
backward computes delta = rowsum(dO * O) in float32, as the JAX wrapper does
outside Pallas, and launches K4 (`flash_bwd_cuda`, `csrc/flash_bwd.cu`): one
fused TMA/wgmma kernel for dq, dk and dv at bf16 head_dim 64, 80 and 128
(dq added into a zeroed float32 accumulator that is rounded once after the
kernel), K4a (dq) then K4b (dk, dv) otherwise. K4a and K4b also stay
callable on their own (`flash_bwd_dq_cuda`, `flash_bwd_dkv_cuda`). On a CPU
tensor both directions run the plain versions: `_reference_attention`
forward, `flash_bwd_reference` (the blocked backward of `_flash_bwd`)
backward. `_bwd_recompute` is the counterpart of the JAX recompute backward,
kept for comparison. An optional int32 `kv_len` (B,) masks row b's keys at
or past kv_len[b]: with `causal` it is the training collator's right-padding
mask, the function the JAX package computes on its masked XLA path.

`flash_attention_relpos2d` is the counterpart of the JAX function of that
name, forward only: K1's wgmma kernel with a bias policy
(`ia2p_flash_relpos2d` in `csrc/flash_fwd.cu`) on a CUDA tensor,
`_reference_relpos2d` on a CPU tensor. Like the JAX function it has no
gradient, so on the card it refuses an input that requires one while grad
mode is on rather than return a tensor that ends the graph.

There is no fallback from a kernel to its plain version: a CUDA call the
kernel does not take raises. Layout: (B, H, S, D) like the JAX functions.
Any strides are accepted as long as the last dimension is contiguous, so
callers holding (B, S, H, D) tensors pass `x.transpose(1, 2)` without a
copy, and a zero stride (a row broadcast with `expand`) is read in place,
TMA maps included; outputs are dense, in their input's stride order.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256
BWD_BLOCK_Q = 1024  # query rows per block of the plain backward
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _wide(x):
    """x in float32, or in float64 when it is float64 (the plain versions'
    accumulation type; float64 keeps `gradcheck` meaningful)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _visible(sq, sk, causal, kv_len, device):
    """Bool mask of the keys each query may see, broadcastable to
    (B, H, Sq, Sk): the end-aligned causal rule and the kv_len tail."""
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask = mask.tril(sk - sq)
    if kv_len is not None:
        col = torch.arange(sk, device=device)
        mask = mask & (col < kv_len.to(device).reshape(-1, 1, 1, 1))
    return mask


def _reference_attention(q, k, v, causal, scale, return_lse=False, kv_len=None):
    """Plain version: float32 logits, softmax, p cast to v's dtype for P.V
    (the JAX `_reference_attention`; with kv_len, its masked path). Also
    returns the per-row logsumexp when asked, as the kernel writes it."""
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * scale
    if causal or kv_len is not None:
        s = s.masked_fill(~_visible(s.shape[-2], s.shape[-1], causal, kv_len, s.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype), v).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def _bwd_recompute(q, k, v, o, g, causal, scale, kv_len=None):
    """The JAX `_bwd_recompute`: the whole backward in float32 from the
    saved (q, k, v, o), softmax recomputed, (B, H, Sq, Sk) logits
    materialized."""
    qf, kf, vf, gf = (_wide(x) for x in (q, k, v, g))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal or kv_len is not None:
        s = s.masked_fill(~_visible(s.shape[-2], s.shape[-1], causal, kv_len, s.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * _wide(o)).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(g, o):
    """delta = rowsum(dO * O) in float32, (B, H, Sq): what K4 reads beside
    the logsumexp."""
    return (_wide(g) * _wide(o)).sum(-1)


def flash_bwd_reference(q, k, v, o, lse, g, causal, scale, kv_len=None, delta=None,
                        block_q=BWD_BLOCK_Q):
    """Plain version of K4a and K4b, blocked over query rows like
    `_flash_bwd`: p = exp(s - lse) where visible (else 0), dp = g.v^T,
    ds = p (dp - delta) scale, and dq = ds.k, dk = ds^T.q, dv = p^T.g with
    ds and p rounded to the operand dtype before the products, float32
    accumulation, outputs in the input dtype. Only a (B, H, block_q, Sk)
    slab of logits exists at a time."""
    dt = q.dtype
    sq, sk = q.shape[2], k.shape[2]
    if delta is None:
        delta = flash_delta(g, o)
    kf, vf = _wide(k), _wide(v)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dq = torch.empty_like(q)
    vis = _visible(sq, sk, causal, kv_len, q.device)
    for r0 in range(0, sq, block_q):
        r1 = min(sq, r0 + block_q)
        qb, gb = _wide(q[:, :, r0:r1]), _wide(g[:, :, r0:r1])
        s = torch.matmul(qb, kf.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[:, :, r0:r1, None]).masked_fill_(~vis[..., r0:r1, :], 0.0)
        del s
        dp = torch.matmul(gb, vf.transpose(-1, -2))
        ds = p * (dp - delta[:, :, r0:r1, None]) * scale
        del dp
        ds = _wide(ds.to(dt))
        dq[:, :, r0:r1] = torch.matmul(ds, kf).to(dt)
        dk += torch.matmul(ds.transpose(-1, -2), qb)
        dv += torch.matmul(_wide(p.to(dt)).transpose(-1, -2), gb)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


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


def _check_kv_len(kv_len, q):
    if kv_len is None:
        return None
    if (kv_len.device != q.device or kv_len.dtype != torch.int32
            or tuple(kv_len.shape) != (q.shape[0],) or not kv_len.is_contiguous()):
        raise ValueError(f"flash_attention: kv_len must be a contiguous int32 ({q.shape[0]},) "
                         f"tensor on {q.device}, got {kv_len.dtype} {tuple(kv_len.shape)} on "
                         f"{kv_len.device}")
    return kv_len.data_ptr()


K1_PATHS = ("fma", "wgmma")  # ia2p_flash_fwd_last_path's codes (K1 and K3)


def _lib():
    """K1's entry point and the query of the path its last call took."""
    from . import _build

    lib = _build.load("flash_fwd")
    fn, path = lib.ia2p_flash_fwd, lib.ia2p_flash_fwd_last_path
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 12 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        path.argtypes = []
        path.restype = ctypes.c_int
    return fn, path


def flash_fwd_cuda(q, k, v, causal: bool, scale: float, return_lse: bool = False, kv_len=None):
    """Launch K1 on PyTorch's current stream. Outputs come from
    `torch.empty`; the kernel allocates nothing. Raises on input the kernel
    does not take and on a refused launch. The output carries no gradient:
    `flash_attention` is the differentiable entry point. Each launch is
    counted in `launches` and, by the path the kernel took (K1_PATHS: wgmma
    for bf16 at head_dim 64, 80 and 128, fma otherwise), in
    `launches_by_path`."""
    _check(q, k, v)
    kv_ptr = _check_kv_len(kv_len, q)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if sq == 0 or b * h == 0:
        return (o, lse) if return_lse else o
    fn, last_path = _lib()
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr() if lse is not None else None, kv_ptr,
            b, h, sq, sk, d, *strides, float(scale), int(bool(causal)), stream,
        )
    path = K1_PATHS[last_path()]
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch ({path} path) failed with CUDA "
                           f"error {rc}")
    flash_fwd_cuda.launches += 1
    flash_fwd_cuda.launches_by_path[path] += 1
    if any(t.stride(i) == 0 and t.shape[i] > 1 for t in (q, k, v) for i in range(3)):
        flash_fwd_cuda.launches_broadcast += 1
    return (o, lse) if return_lse else o


flash_fwd_cuda.launches = 0  # K1 launches in this process
flash_fwd_cuda.launches_by_path = dict.fromkeys(K1_PATHS, 0)  # the same, by path taken
# the same, those with an operand broadcast along B, H or S (a zero stride, such
# as plug-and-play's shared row-0 Q/K): the kernel reads such views in place
flash_fwd_cuda.launches_broadcast = 0


def _check_bwd(q, k, v, g, lse, delta):
    _check(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device or g.stride(-1) != 1:
        raise ValueError(f"flash_attention backward: dO {g.dtype} {tuple(g.shape)} for q "
                         f"{q.dtype} {tuple(q.shape)} (a unit last stride is needed)")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != tuple(q.shape[:3])
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"flash_attention backward: {name} must be contiguous float32 "
                             f"{tuple(q.shape[:3])} on {q.device}")


def _on_stream(device, fn, *args):
    """fn(*args, stream) with `device` current and PyTorch's current stream
    on it: where the ctypes entry points launch."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _bwd_lib(name):
    from . import _build

    fn = getattr(_build.load("flash_bwd"), name)
    if fn.argtypes is None:
        n_out = 1 if name == "ia2p_flash_bwd_dq" else 2
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * (7 + n_out) + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _launch_bwd(name, outs, q, k, v, g, lse, delta, causal, scale, kv_len) -> bool:
    """Fill `outs` with K4a or K4b; returns whether a kernel was launched
    (with no query or key rows the gradients are zeros and nothing is)."""
    _check_bwd(q, k, v, g, lse, delta)
    kv_ptr = _check_kv_len(kv_len, q)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if b * h == 0 or sq == 0 or sk == 0:
        for t in outs:
            t.zero_()
        return False
    fn = _bwd_lib(name)
    strides = (ctypes.c_int64 * (3 * (4 + len(outs))))(
        *[s for t in (q, k, v, g, *outs) for s in t.stride()[:3]])
    rc = _on_stream(q.device, fn, _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(), kv_ptr,
                    *[t.data_ptr() for t in outs], b, h, sq, sk, d,
                    ctypes.cast(strides, ctypes.c_void_p), float(scale), int(bool(causal)))
    if rc != 0:
        raise RuntimeError(f"flash_attention backward: {name} launch failed with CUDA error {rc}")
    return True


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal: bool, scale: float, kv_len=None):
    """Launch K4a on PyTorch's current stream: dq from the saved lse and
    delta (float32, (B, H, Sq), contiguous). dq comes from
    `torch.empty_like(q)`. float32 fma on the CUDA cores at every dtype and
    head dim (the tensor-core backward is `flash_bwd_cuda`'s fused kernel).
    Raises on input the kernel does not take and on a refused launch."""
    dq = torch.empty_like(q)
    if _launch_bwd("ia2p_flash_bwd_dq", (dq,), q, k, v, g, lse, delta, causal, scale, kv_len):
        flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0  # K4a launches in this process


def flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal: bool, scale: float, kv_len=None):
    """Launch K4b on PyTorch's current stream: (dk, dv), from
    `torch.empty_like(k)` and `torch.empty_like(v)`. As K4a otherwise."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _launch_bwd("ia2p_flash_bwd_dkv", (dk, dv), q, k, v, g, lse, delta, causal, scale, kv_len):
        flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0  # K4b launches in this process


# ia2p_flash_bwd_last_path's codes; no kernel of the library reports 1, "mma"
K4_PATHS = ("fma", "mma", "wgmma")
WGMMA_BWD_HEAD_DIMS = (64, 80, 128)  # bf16 head dims of the fused kernel


def _fused_bwd_lib():
    """K4's whole-backward entry point and the query of the path its last
    call took."""
    from . import _build

    lib = _build.load("flash_bwd")
    fn, path = lib.ia2p_flash_bwd, lib.ia2p_flash_bwd_last_path
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        path.argtypes = []
        path.restype = ctypes.c_int
    return fn, path


def flash_bwd_cuda(q, k, v, g, lse, delta, causal: bool, scale: float, kv_len=None):
    """Launch K4 on PyTorch's current stream: (dq, dk, dv) from the saved lse
    and delta (float32, (B, H, Sq), contiguous), each from `torch.empty_like`
    of its input. bf16 at head_dim 64, 80 and 128 takes the fused wgmma
    kernel, which adds dq into a float32 accumulator from
    `torch.zeros_like(q)` that is rounded into dq once after the kernel;
    other calls take K4a then K4b on the scalar fma loop. Raises on input the
    kernels do not take and on a refused launch, with no fallback. Each call
    that launches is counted once in `launches` and, by the path the kernel
    reported (K4_PATHS), in `launches_by_path`; with no query or key rows the
    gradients are zeros and nothing launches."""
    _check_bwd(q, k, v, g, lse, delta)
    kv_ptr = _check_kv_len(kv_len, q)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b * h == 0 or sq == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    acc = (torch.zeros_like(q, dtype=torch.float32)
           if q.dtype == torch.bfloat16 and d in WGMMA_BWD_HEAD_DIMS else None)
    fn, last_path = _fused_bwd_lib()
    outs = (dq, dk, dv, dq if acc is None else acc)  # acc's strides unused without acc
    strides = (ctypes.c_int64 * 24)(*[s for t in (q, k, v, g, *outs) for s in t.stride()[:3]])
    rc = _on_stream(q.device, fn, _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(), kv_ptr,
                    None if acc is None else acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), b, h, sq, sk, d, ctypes.cast(strides, ctypes.c_void_p),
                    float(scale), int(bool(causal)))
    path = K4_PATHS[last_path()]
    if rc != 0:
        raise RuntimeError(f"flash_attention backward: kernel launch ({path} path) failed with "
                           f"CUDA error {rc}")
    if path == "wgmma":
        dq.copy_(acc)
    flash_bwd_cuda.launches += 1
    flash_bwd_cuda.launches_by_path[path] += 1
    return dq, dk, dv


flash_bwd_cuda.launches = 0  # K4 backward calls that launched, in this process
flash_bwd_cuda.launches_by_path = dict.fromkeys(K4_PATHS, 0)  # the same, by path taken


class _FlashAttention(torch.autograd.Function):
    """K1 forward and K4 backward (`flash_bwd_cuda`; their plain versions on
    the CPU), the counterpart of the JAX `custom_vjp`. (q, k, v, o, lse) are
    saved only when an input needs a gradient; lse has none."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, scale):
        if q.device.type == "cpu":
            o, lse = _reference_attention(q, k, v, causal, scale, True, kv_len)
        else:
            o, lse = flash_fwd_cuda(q, k, v, causal, scale, True, kv_len)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.scale = causal, scale
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, o, lse, kv_len)
        return o, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, o, lse, kv_len = ctx.saved_tensors
        g = g.to(q.dtype)
        if q.device.type == "cpu":
            dq, dk, dv = flash_bwd_reference(q, k, v, o, lse, g, ctx.causal, ctx.scale, kv_len)
        else:
            if g.stride(-1) != 1:
                g = g.contiguous()
            delta = flash_delta(g, o)
            dq, dk, dv = flash_bwd_cuda(q, k, v, g, lse, delta, ctx.causal, ctx.scale, kv_len)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    return_lse: bool = False,
    kv_len: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused attention over (B, H, S, D), differentiable in q, k and v.
    With `return_lse` also returns the float32 (B, H, Sq) logsumexp;
    `kv_len` (int32 (B,), every value >= 1) masks row b's keys at or past
    kv_len[b]."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = _FlashAttention.apply(q, k, v, kv_len, causal, scale)
        return (o, lse) if return_lse else o
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, causal, scale, return_lse, kv_len)
    return flash_fwd_cuda(q, k, v, causal, scale, return_lse, kv_len)


# --------------------------------------------------------------------------
# K3: attention with SAM's decomposed 2-D relative-position bias over a g x g
# token grid (`ia2p_flash_relpos2d` in `csrc/flash_fwd.cu`), forward only.
# The logit for query t and key u*g + v is q.k*scale + bh[t, u] + bw[t, v].

RELPOS_HEAD_DIMS = (64, 80)
RELPOS_MAX_GRID = 120  # the bias rows of 128 queries fit in shared memory beside q and k/v


def _reference_relpos2d(q, k, v, bh, bw, scale):
    """Plain version: float32 logits, the bias as a broadcast add over an
    (N, g, g) view of the keys, softmax, p cast to v's dtype for P.V."""
    b, h, n, _ = q.shape
    g = bh.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.view(b, h, n, g, g) + bh.float()[..., :, None] + bw.float()[..., None, :]
    p = torch.softmax(s.view(b, h, n, n), dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def _check_relpos2d(q, k, v, bh, bw):
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v, bh, bw)):
        raise ValueError("flash_attention_relpos2d: all inputs must be on one CUDA device")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_relpos2d: q/k/v are {q.dtype}/{k.dtype}/{v.dtype}; "
                         "the kernel takes bfloat16")
    if bh.dtype != torch.float32 or bw.dtype != torch.float32:
        raise ValueError("flash_attention_relpos2d: bh and bw must be float32")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention_relpos2d: shapes {q.shape} {k.shape} {v.shape}")
    b, h, n, d = q.shape
    g = bh.shape[-1] if bh.dim() == 4 else 0
    if g * g != n or g > RELPOS_MAX_GRID:
        raise ValueError(f"flash_attention_relpos2d: N = {n} is not g^2 for g <= "
                         f"{RELPOS_MAX_GRID} (bias width {g})")
    if tuple(bh.shape) != (b, h, n, g) or bw.shape != bh.shape:
        raise ValueError(f"flash_attention_relpos2d: bias shapes {bh.shape} {bw.shape}")
    if not (bh.is_contiguous() and bw.is_contiguous()):
        raise ValueError("flash_attention_relpos2d: bh and bw must be contiguous")
    if d not in RELPOS_HEAD_DIMS:
        raise ValueError(f"flash_attention_relpos2d: head_dim {d} not in {RELPOS_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"flash_attention_relpos2d: B*H = {b * h} exceeds the grid limit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_relpos2d: {name} needs a unit last stride and "
                             "16-byte aligned rows")


def _relpos2d_lib():
    """K3's entry point and the query of the path its last call took (K1's:
    the library keeps one per thread for both entry points)."""
    from . import _build

    _, path = _lib()
    fn = _build.load("flash_fwd").ia2p_flash_relpos2d
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn, path


def flash_relpos2d_cuda(q, k, v, bh, bw, scale: float):
    """Launch K3 on PyTorch's current stream; the output comes from
    `torch.empty_like(q)`. Raises on input the kernel does not take, on an
    input that requires a gradient while grad mode is on (K3 has no
    backward), and on a refused launch. Each launch is counted in
    `launches` and, by the path the library reports (K1_PATHS: wgmma, the
    only one K3 has), in `launches_by_path`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bh, bw)):
        raise RuntimeError("flash_attention_relpos2d: the CUDA kernel has no backward; call it "
                           "under torch.no_grad() or on inputs that need no gradient")
    _check_relpos2d(q, k, v, bh, bw)
    b, h, n, d = q.shape
    o = torch.empty_like(q)
    if b * h == 0:
        return o
    fn, last_path = _relpos2d_lib()
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]]
    rc = _on_stream(q.device, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), bh.data_ptr(),
                    bw.data_ptr(), o.data_ptr(), b, h, n, bh.shape[-1], d, *strides, float(scale))
    path = K1_PATHS[last_path()]
    if rc != 0:
        raise RuntimeError(f"flash_attention_relpos2d: kernel launch ({path} path) failed with "
                           f"CUDA error {rc}")
    flash_relpos2d_cuda.launches += 1
    flash_relpos2d_cuda.launches_by_path[path] += 1
    return o


flash_relpos2d_cuda.launches = 0  # K3 launches in this process
flash_relpos2d_cuda.launches_by_path = dict.fromkeys(K1_PATHS, 0)  # the same, by path taken


def flash_attention_relpos2d(q, k, v, bh, bw, scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, N, D), N = g^2, with float32 (B, H, N, g)
    biases bh and bw. q, k, v may be strided views with a unit last dim,
    such as (B, N, H, D) tensors passed as `x.transpose(1, 2)`."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _reference_relpos2d(q, k, v, bh, bw, scale)
    return flash_relpos2d_cuda(q, k, v, bh, bw, scale)
