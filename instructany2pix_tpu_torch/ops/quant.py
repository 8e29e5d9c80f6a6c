"""Weight-only quantization and the decode matvec (K2): the CUDA kernel and
its plain version.

Counterpart of the JAX package's `ops/quant.py`. Quantized weights keep
the JAX layout, input-major:

  {"w_q": (K, N) int8, "scale": (N,) f32}                int8, per channel
  {"w_q4": (K/2, N) int8, "scale": (N,) f32}             int4, per channel
  {"w_q4": (K/2, N) int8, "gscale": (K/g, N) f32}        int4, group g

int4 packs two signed nibbles per byte, even/odd interleaved: byte row i
holds original row 2i in its low nibble and row 2i+1 in its high nibble
(`_pack_nibbles`). The quantizers produce the same bytes and scales as the
JAX ones.

`qmatmul` is the counterpart of `pallas_qmatmul`: the small-M (decode)
product x @ dequant(W) with an optional RMSNorm prologue, SwiGLU prologue
and residual epilogue. On a CUDA tensor it launches the hand-written
Hopper kernel in `csrc/qmv.cu` once per call (bf16 activations with int4
weights on the tensor cores, the "mma" path; float32 activations and int8
weights on the CUDA cores, "fma"); on a CPU tensor it runs
`_qmv_reference`, the plain PyTorch version of the same function. There is
no fallback from one to the other: a CUDA call the kernel does not take
raises.
`int4_matmul` is the plain large-M (prefill) product, as the JAX package
leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

QMV_MAX_M = 16  # rows the decode kernel takes (the router's M <= 16)
QMV_TILE_N = 128  # output columns per block; N must be a multiple
QMV_GROUP = 128  # int4 groups that are a multiple of it run on the tensor cores
QMV_MAX_CLUSTER = 8  # blocks per thread block cluster (the portable limit)
QMV_STAGE_ROWS = 64  # packed byte rows per stage of the kernel's ring
QMV_PATHS = ("fma", "mma")  # ia2p_qmv_last_path's codes
_FMT_CODES = {"int8": 0, "int4": 1, "int4g": 2}
_ACT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (cluster, ring) of the fastest plan on an NVIDIA H100 80GB HBM3 (700 W) at
# the shapes the port runs: the 7B decode projections, int4 group 128, bf16,
# M = 1 and 16 (`benchmarks_torch/k2_ab.py --plans`, a CUDA graph over weight
# copies larger than L2). Key: (M, K, N, fmt, dtype, SwiGLU, RMSNorm).
_PLANS = {
    (1, 4096, 12288, "int4g", "bfloat16", False, True): (2, 8),
    (16, 4096, 12288, "int4g", "bfloat16", False, True): (4, 4),
    (1, 4096, 4096, "int4g", "bfloat16", False, False): (8, 4),
    (16, 4096, 4096, "int4g", "bfloat16", False, False): (4, 8),
    (1, 4096, 22016, "int4g", "bfloat16", False, True): (2, 4),
    (16, 4096, 22016, "int4g", "bfloat16", False, True): (4, 4),
    (1, 11008, 4096, "int4g", "bfloat16", True, False): (8, 4),
    (16, 11008, 4096, "int4g", "bfloat16", True, False): (8, 8),
    (1, 4096, 4096, "int8", "bfloat16", False, False): (8, 4),
    (16, 4096, 4096, "int8", "bfloat16", False, False): (4, 4),
}
# other shapes: the fewest chunks that give the card this many blocks, and
# a ring of 4 stages (within 5 % of the best ring at every measured shape)
_FILL_BLOCKS = 176
_RING = 4  # a multiple of the consumer warps (csrc/qmv.cu)


# ------------------------------------------------------------ quantizers


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(in, out) float weights → int8 + per-out-channel scale."""
    w = w.float().contiguous()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w_q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return {"w_q": w_q, "scale": scale}


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """(in, out) int8 values in [-7, 7] → (in/2, out) packed bytes, row 2i
    in the low nibble and row 2i+1 in the high nibble of byte row i."""
    q32 = q.to(torch.int32)
    packed = (q32[0::2] & 0x0F) | ((q32[1::2] & 0x0F) << 4)
    return packed.to(torch.uint8).view(torch.int8)


def quantize_weight_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(in, out) → packed int4 + per-channel scale; `in` must be even."""
    w = w.float().contiguous()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[None, :]), -7, 7).to(torch.int8)
    return {"w_q4": _pack_nibbles(q), "scale": scale}


def quantize_weight_int4_grouped(w: torch.Tensor, group: int = 128) -> Dict[str, torch.Tensor]:
    """(in, out) → packed int4 + per-(group, out) scales; `in` must be a
    multiple of 2·group, so each byte stays inside one scale group."""
    k, n = w.shape
    if k % (2 * group):
        raise ValueError(f"in={k} is not a multiple of 2*group={2 * group}")
    wg = w.float().contiguous().reshape(k // group, group, n)
    amax = wg.abs().amax(dim=1)  # (G, N)
    gscale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wg / gscale[:, None, :]), -7, 7).reshape(k, n).to(torch.int8)
    return {"w_q4": _pack_nibbles(q), "gscale": gscale}


def _group_of(q: Dict[str, torch.Tensor]) -> int:
    return 2 * q["w_q4"].shape[0] // q["gscale"].shape[0]


def _nibble_planes(packed: torch.Tensor, dtype) -> tuple:
    """(K/2, N) packed → sign-extended (lo, hi): lo[i] is original row 2i,
    hi[i] row 2i+1."""
    p32 = packed.to(torch.int32)
    lo = p32 & 0x0F
    hi = (p32 >> 4) & 0x0F
    lo = lo - ((lo & 0x08) << 1)
    hi = hi - ((hi & 0x08) << 1)
    return lo.to(dtype), hi.to(dtype)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(in/2, out) packed → (in, out) int32 values in [-7, 7], rows back in
    original order. Inverse of `_pack_nibbles`."""
    lo, hi = _nibble_planes(packed, torch.int32)
    half, n = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * half, n)


def int4_matmul(x: torch.Tensor, q: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain (prefill / large-M) product: x @ W = x[:, 0::2] @ lo + x[:, 1::2] @ hi,
    so no row interleave of W is materialized."""
    lo, hi = _nibble_planes(q["w_q4"], x.dtype)
    if "gscale" in q:
        s = q["gscale"].to(x.dtype).repeat_interleave(_group_of(q) // 2, dim=0)
        return x[..., 0::2] @ (lo * s) + x[..., 1::2] @ (hi * s)
    y = x[..., 0::2] @ lo + x[..., 1::2] @ hi
    return y * q["scale"].to(x.dtype)


# --------------------------------------------------- quantized linear module


class QLinear(nn.Module):
    """A weight-only quantized linear: the tensors of one of the three
    formats above as buffers, plus an optional float bias `b`. Scales stay
    float32 whatever the activations' dtype; do not cast the module with
    `.to(dtype)`."""

    KEYS = ("w_q", "w_q4", "scale", "gscale", "b")

    def __init__(self, q: Dict[str, torch.Tensor]):
        super().__init__()
        extra = set(q) - set(self.KEYS)
        if extra or (("w_q" in q) == ("w_q4" in q)):
            raise ValueError(f"not a quantized linear: keys {sorted(q)}")
        for k in self.KEYS:
            if k in q:
                self.register_buffer(k, q[k].contiguous())

    @property
    def q(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.KEYS if hasattr(self, k)}

    @property
    def packed(self) -> torch.Tensor:
        return self.w_q4 if hasattr(self, "w_q4") else self.w_q

    @property
    def out_features(self) -> int:
        return self.packed.shape[1]

    @property
    def in_features(self) -> int:
        return self.packed.shape[0] * (2 if hasattr(self, "w_q4") else 1)

    def extra_repr(self) -> str:
        fmt = "int8" if hasattr(self, "w_q") else ("int4g" if hasattr(self, "gscale") else "int4")
        return f"{fmt}, in={self.in_features}, out={self.out_features}"


_DEFAULT_PATTERN = re.compile(r"(layer_\d+\.(q|k|v|o|gate|up|down)|lm_head)$")


def _quantize_bits(w: torch.Tensor, bits: int, int4_grouped: bool) -> Dict[str, torch.Tensor]:
    # int4 only where the decode kernel can take it (even K, N % 128 == 0);
    # other shapes, such as the 32009-wide vocab head, stay int8
    if bits == 4 and w.shape[1] % 128 == 0:
        if int4_grouped and w.shape[0] % 256 == 0:
            return quantize_weight_int4_grouped(w)
        if w.shape[0] % 2 == 0:
            return quantize_weight_int4(w)
    return quantize_weight(w)


@torch.no_grad()
def quantize_tree(
    module: nn.Module,
    should_quantize: Optional[Callable[[str], bool]] = None,
    bits: int = 8,
    int4_grouped: bool = True,
    int8_paths: Optional[Callable[[str], bool]] = None,
) -> nn.Module:
    """Replace every matched `nn.Linear` of `module` (by dotted name) with
    its `QLinear`, in place, one at a time: each float weight is freed as
    soon as its quantized copy exists. Linears still on the meta device
    are left for a later call, so a model can be quantized as it is built,
    layer by layer. Low-rank adapters (`layers.add_lora`) move to the
    `QLinear` unchanged, in float. `int8_paths` names linears kept at int8
    whatever `bits` says. Returns `module`."""
    match = should_quantize or (lambda p: bool(_DEFAULT_PATTERN.search(p)))
    names = [n for n, m in module.named_modules() if isinstance(m, nn.Linear)]
    for name in names:
        parent_name, _, leaf = name.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        lin = getattr(parent, leaf)
        if lin.weight.is_meta or not match(name):
            continue
        b = 8 if int8_paths is not None and int8_paths(name) else bits
        q = _quantize_bits(lin.weight.T, b, int4_grouped)  # (in, out), the JAX layout
        if lin.bias is not None:
            q["b"] = lin.bias.detach()
        ql = QLinear(q)
        if getattr(lin, "lora_a", None) is not None:
            # adapters survive quantization of the base weight, as in the JAX tree
            ql.lora_a, ql.lora_b = lin.lora_a, lin.lora_b
            ql.register_buffer("lora_scale", lin.lora_scale)
        setattr(parent, leaf, ql)
        del lin
    return module


_TP_ROWS = re.compile(r"layer_\d+\.(o|down)$")


def quantize_llama(module: nn.Module, bits: int = 8, int4_grouped: bool = True,
                   tp_rows_int8: bool = False) -> nn.Module:
    """Quantize every decoder linear (q/k/v/o/gate/up/down and lm_head) of
    a port Llama in place; embeddings and norms stay as they are.
    `tp_rows_int8` keeps the row-parallel layers (o, down) at int8, so a
    tensor-parallel decode can shard their contraction dim: the packed
    int4 rows are never row-split (`parallel/sharding.py`)."""
    return quantize_tree(module, bits=bits, int4_grouped=int4_grouped,
                         int8_paths=(lambda p: bool(_TP_ROWS.search(p))) if tp_rows_int8 else None)


# -------------------------------------------- the decode matvec (K2), plain


def _fmt(q: Dict[str, torch.Tensor]) -> str:
    if "w_q4" in q:
        return "int4g" if "gscale" in q else "int4"
    return "int8"


def _prologue(x: torch.Tensor, norm_g, norm_eps: float, swiglu: bool) -> torch.Tensor:
    """RMSNorm then SwiGLU on (M, K') rows, rounded to x's dtype after each,
    as the kernel's prologue does."""
    act = x.dtype
    if norm_g is not None:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        x = (xf * torch.rsqrt(var + norm_eps) * norm_g.float()).to(act)
    if swiglu:
        k = x.shape[-1] // 2
        x = F.silu(x[:, :k].float()).to(act) * x[:, k:]
    return x


def _qmv_reference(x2, q, norm_g=None, norm_eps=1e-6, swiglu=False, residual=None):
    """Plain version of K2 on (M, K') rows: the prologue in the activation
    dtype, int4 activations in float32, float32 products and sums, one
    partial dot per scale group scaled and accumulated in group order,
    the cast to x's dtype, then the residual added in that dtype."""
    out_dtype = x2.dtype
    fmt = _fmt(q)
    fused = norm_g is not None or swiglu
    x = x2
    if fmt != "int8" and not fused:
        x = x.float()  # plain int4 calls cast before the kernel
    x = _prologue(x, norm_g, norm_eps, swiglu)
    if fmt != "int8":
        x = x.float()
    xf = x.float()  # bf16 products are exact in float32
    if fmt == "int4g":
        w = unpack_int4(q["w_q4"]).float()
        g_count = q["gscale"].shape[0]
        group = w.shape[0] // g_count
        m, n = xf.shape[0], w.shape[1]
        parts = torch.bmm(
            xf.reshape(m, g_count, group).transpose(0, 1), w.reshape(g_count, group, n)
        )  # (G, M, N)
        s = q["gscale"].float()
        acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
        for g in range(g_count):
            acc = acc + parts[g] * s[g][None]
    else:
        w = unpack_int4(q["w_q4"]) if fmt == "int4" else q["w_q"]
        acc = (xf @ w.float()) * q["scale"].float()[None]
    y = acc.to(out_dtype)
    if residual is not None:
        y = y + residual.to(out_dtype)
    return y


# --------------------------------------------- the decode matvec (K2), CUDA


class QmvPlan(NamedTuple):
    """How K2 cuts one call: `tile` output columns per block, K in chunks
    of `chunk` rows (`chunk_stages` stages, `stages` in all), one chunk per
    block of a thread block cluster of `cluster` blocks, streamed through a
    ring of `ring` stages, on `path` ("mma" or "fma")."""

    tile: int
    chunk: int
    chunk_stages: int
    cluster: int
    stages: int
    path: str
    ring: int


def qmv_path(fmt: str, dtype: torch.dtype, group: int = QMV_GROUP) -> str:
    """The kernel path of a call: the tensor cores for bf16 activations
    with int4 weights (grouped: a group that is a multiple of 128), the
    CUDA cores otherwise."""
    ok = fmt == "int4" or (fmt == "int4g" and group % QMV_GROUP == 0)
    return "mma" if dtype == torch.bfloat16 and ok else "fma"


@functools.lru_cache(maxsize=None)
def qmv_plan(m: int, k: int, n: int, fmt: str, dtype: torch.dtype = torch.bfloat16,
             swiglu: bool = False, norm: bool = False, group: int = QMV_GROUP) -> QmvPlan:
    """The plan of one K2 call, cached per shape, fusion and group. A stage
    is 64 packed byte rows: 128 k of int4 or 64 k of int8. K is cut into
    `cluster` chunks of whole stages, one per block of a cluster; N/128
    tiles alone (32 at N = 4096) cannot keep 132 SMs streaming. The
    (cluster, ring) measured fastest where `_PLANS` has the shape; else the
    smallest cluster whose blocks number `_FILL_BLOCKS`, and a ring of
    `_RING` stages. The kernel stages x' in windows when a
    chunk's does not fit its shared memory, so every K has a plan."""
    path = qmv_path(fmt, dtype, group)
    kstage = QMV_STAGE_ROWS * (1 if fmt == "int8" else 2)
    stages = -(-k // kstage)
    key = (m, k, n, fmt, str(dtype).rpartition(".")[2], bool(swiglu), bool(norm))
    if key in _PLANS and (fmt != "int4g" or group == QMV_GROUP):
        cluster, ring = _PLANS[key]
    else:
        tiles = n // QMV_TILE_N
        cluster = next((c for c in (1, 2, 4) if tiles * c >= _FILL_BLOCKS), QMV_MAX_CLUSTER)
        ring = _RING
    chunk_stages = -(-stages // min(cluster, stages))
    cluster = -(-stages // chunk_stages)  # every block of the cluster has a stage
    return QmvPlan(QMV_TILE_N, chunk_stages * kstage, chunk_stages, cluster, stages, path,
                   min(ring, chunk_stages))


def _lib():
    from . import _build

    lib = _build.load("qmv")
    fn, path, occ = lib.ia2p_qmv, lib.ia2p_qmv_last_path, lib.ia2p_qmv_max_active_clusters
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        path.argtypes, path.restype = [], ctypes.c_int
        occ.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
        occ.restype = ctypes.c_int
    return fn, path, occ


def _check(x2, q, norm_g, residual, swiglu):
    dev = x2.device
    if not x2.is_cuda:
        raise ValueError("qmatmul: x must be a CUDA tensor")
    if x2.dtype not in _ACT_CODES:
        raise ValueError(f"qmatmul: activations {x2.dtype}; the kernel takes float32 or bfloat16")
    w = q["w_q4"] if "w_q4" in q else q["w_q"]
    tensors = [("w", w, torch.int8)]
    tensors.append(("gscale", q["gscale"], torch.float32) if "gscale" in q
                   else ("scale", q["scale"], torch.float32))
    if norm_g is not None:  # float32 or bf16 (read as float32, exactly)
        tensors.append(("norm_g", norm_g,
                        torch.bfloat16 if norm_g.dtype == torch.bfloat16 else torch.float32))
    if residual is not None:
        tensors.append(("residual", residual, x2.dtype))
    tensors.append(("x", x2, x2.dtype))
    for name, t, dt in tensors:
        if t.device != dev:
            raise ValueError(f"qmatmul: {name} is on {t.device}, x on {dev}")
        if t.dtype != dt:
            raise ValueError(f"qmatmul: {name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"qmatmul: {name} must be contiguous and 16-byte aligned")
    m, xk = x2.shape
    n = w.shape[1]
    k = w.shape[0] * (2 if "w_q4" in q else 1)
    if m < 1 or m > QMV_MAX_M:
        raise ValueError(f"qmatmul: M={m} rows; the kernel takes 1..{QMV_MAX_M}")
    if n % QMV_TILE_N:
        raise ValueError(f"qmatmul: N={n} is not a multiple of {QMV_TILE_N}")
    if xk != (2 * k if swiglu else k):
        raise ValueError(f"qmatmul: x width {xk} for K={k} (swiglu={swiglu})")
    if "gscale" in q:
        g = _group_of(q)
        if g % 2 or k % g or q["gscale"].shape != (k // g, n):
            raise ValueError(f"qmatmul: gscale {tuple(q['gscale'].shape)} for K={k}, N={n}; "
                             "the kernel takes even groups that divide K")
    elif q["scale"].shape != (n,):
        raise ValueError(f"qmatmul: scale {tuple(q['scale'].shape)} for N={n}")
    if norm_g is not None and norm_g.shape != (xk,):
        raise ValueError(f"qmatmul: norm_g {tuple(norm_g.shape)} for width {xk}")
    if residual is not None and residual.shape != (m, n):
        raise ValueError(f"qmatmul: residual {tuple(residual.shape)} for ({m}, {n})")
    return m, k, n, xk


def qmv_cuda(x2, q, norm_g=None, norm_eps=1e-6, swiglu=False, residual=None):
    """Launch K2 once on PyTorch's current stream for (M, K') rows. The
    output comes from `torch.empty` and is all it allocates. Raises on
    input the kernel does not take and on a refused launch (cluster
    scheduling included). Counts the launch in `launches` and, by the path
    the kernel reports (QMV_PATHS), in `launches_by_path`; one with no
    prologue or epilogue also in `launches_unfused`. K2 has no
    backward (nor has the JAX kernel), so an input that requires a gradient
    while grad mode is on is refused rather than given an output that
    silently ends the autograd graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2, norm_g, residual)):
        raise RuntimeError("qmatmul: the CUDA kernel has no backward; call it under "
                           "torch.no_grad() or on inputs that need no gradient")
    m, k, n, xk = _check(x2, q, norm_g, residual, swiglu)
    fmt = _fmt(q)
    group = _group_of(q) if fmt == "int4g" else QMV_GROUP
    plan = qmv_plan(m, k, n, fmt, x2.dtype, bool(swiglu), norm_g is not None, group)
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    w = q["w_q4"] if "w_q4" in q else q["w_q"]
    scale = q["gscale"] if fmt == "int4g" else q["scale"]

    def ptr(t):
        return t.data_ptr() if t is not None else None

    fn, last_path, _ = _lib()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        rc = fn(
            _FMT_CODES[fmt], _ACT_CODES[x2.dtype], x2.data_ptr(), w.data_ptr(), scale.data_ptr(),
            ptr(norm_g), ptr(residual), out.data_ptr(), m, k, n, xk, group, plan.chunk_stages,
            plan.cluster, plan.ring, int(bool(swiglu)), int(norm_g is not None),
            int(norm_g is not None and norm_g.dtype == torch.bfloat16), float(norm_eps), stream,
        )
    if rc != 0:
        raise RuntimeError(f"qmatmul: kernel launch failed with CUDA error {rc}")
    path = QMV_PATHS[last_path()]
    qmv_cuda.launches += 1
    qmv_cuda.launches_by_path[path] += 1
    if norm_g is None and not swiglu and residual is None:
        qmv_cuda.launches_unfused += 1
    return out


qmv_cuda.launches = 0  # K2 launches in this process
qmv_cuda.launches_by_path = dict.fromkeys(QMV_PATHS, 0)  # the same, by path taken
# the same, those without a prologue or an epilogue (a linear carrying adapters
# composes its RMSNorm/SwiGLU/residual around such a call)
qmv_cuda.launches_unfused = 0


def reset_qmv_counts():
    """Set K2's launch counters to 0."""
    qmv_cuda.launches = 0
    qmv_cuda.launches_by_path = dict.fromkeys(QMV_PATHS, 0)
    qmv_cuda.launches_unfused = 0


def qmv_max_active_clusters(q, m, dtype, swiglu=False, norm=False):
    """How many of K2's clusters for this call can be resident on the card
    at once (`cudaOccupancyMaxActiveClusters` at the plan's shared memory
    and cluster size); 0 means the launch cannot be scheduled."""
    fmt = _fmt(q)
    w = q["w_q4"] if "w_q4" in q else q["w_q"]
    k = w.shape[0] * (2 if "w_q4" in q else 1)
    n = w.shape[1]
    group = _group_of(q) if fmt == "int4g" else QMV_GROUP
    plan = qmv_plan(m, k, n, fmt, dtype, bool(swiglu), bool(norm), group)
    scale = q["gscale"] if fmt == "int4g" else q["scale"]
    _, _, occ = _lib()
    with torch.cuda.device(w.device):
        r = occ(_FMT_CODES[fmt], _ACT_CODES[dtype], w.data_ptr(), scale.data_ptr(), m, k, n,
                group, plan.chunk_stages, plan.cluster, plan.ring, int(bool(swiglu)),
                int(bool(norm)))
    if r < 0:
        raise RuntimeError(f"qmatmul: occupancy query failed with CUDA error {-r}")
    return r


def qmatmul(
    x: torch.Tensor,
    q: Dict[str, torch.Tensor],
    norm_g: Optional[torch.Tensor] = None,
    norm_eps: float = 1e-6,
    swiglu: bool = False,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Small-M quantized product x @ dequant(W), x (..., K) or (..., 2K)
    with `swiglu`. `norm_g` folds an RMSNorm over x into the prologue,
    `swiglu` takes x as the (gate | up) pair and uses silu(gate)·up, and
    `residual` (..., N) is added to the output. Output in x's dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    n = q["w_q4"].shape[1] if "w_q4" in q else q["w_q"].shape[1]
    r2 = residual.reshape(-1, n) if residual is not None else None
    if x.device.type == "cpu":
        y = _qmv_reference(x2, q, norm_g, norm_eps, swiglu, r2)
    else:
        if norm_g is not None and norm_g.dtype not in (torch.float32, torch.bfloat16):
            norm_g = norm_g.float()
        g = norm_g.contiguous() if norm_g is not None else None
        r2 = r2.to(x2.dtype).contiguous() if r2 is not None else None
        y = qmv_cuda(x2.contiguous(), q, g, norm_eps, swiglu, r2)
    return y.reshape(*lead, n)
