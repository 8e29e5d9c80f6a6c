"""Sharding rules over `torch.distributed`, counterpart of the JAX
package's `parallel/sharding.py`.

Strategy on the ("data", "model") mesh of `core/mesh.py`:
  * Training (ZeRO-3 class): `fsdp_spec` picks each parameter's shard axis
    with the JAX rule, and `shard_params_fsdp` hands those axes to FSDP2
    (`fully_shard(shard_placement_fn=...)`), which all-gathers parameters
    for the forward and reduce-scatters gradients over every rank.
  * Serving (tensor parallelism, hand-written Megatron): the LLaMA and
    UNet rules shard attention heads and MLP hidden dims over "model".
    `apply_tp_rules` slices each rank's shard in place and tags the
    module with its kind; `models/layers.py` runs a tagged module's local
    product and the one collective its kind needs. DTensor's parallel
    styles are not used: they do not know `QLinear`'s packed int4 buffers.

Kinds (the value of a rule):
  "col"        column-parallel: the output dim is sharded, the input is
               replicated (an RMSNorm prologue sees every element); the
               output stays sharded.
  "col_gather" as "col", then the output is all-gathered (the vocab head).
  "row"        row-parallel: the input dim is sharded; the partial
               products are all-reduced, then the bias and the residual
               are added once.
  "conv"       a convolution's output channels, all-gathered after the
               local convolution (GroupNorm and the residual add need
               every channel); the bias is added after the gather.
  "embed"      an embedding's hidden dim, all-gathered after the lookup.
A rule whose axis does not divide (or, for attention, whose heads do not)
replicates its module, the JAX fallback. A row layer that cannot be split
while its input is sharded ("row_gather": int4's packed rows, which
`quantize_llama(tp_rows_int8=True)` avoids) gathers its input and runs
whole. Biases stay replicated, as the JAX rules leave them; a column
layer adds its slice.

The model code's collectives run under `tp_activation_constraints(mesh)`,
a `contextvars.ContextVar`: a server's worker thread sees its own mesh.
A tagged module run outside it raises. The JAX context pins GSPMD's
activation layouts; here the layouts are explicit in the model code (the
residual stream replicated over "model", batch over "data"), so there is
no `constrain` to port.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from ..ops import quant as Q
from . import collectives as C

Rules = Sequence[Tuple[str, str]]
Spec = Tuple

# ---------------------------------------------------------------- FSDP


def fsdp_spec(shape, mesh: Mesh, min_size: int = 1024) -> Spec:
    """The JAX rule: shard the largest axis that divides across (data,
    model); failing that, across model alone; below `min_size` elements,
    replicate. Returns a spec tuple, () for replicated."""
    shape = tuple(shape)
    if not shape or math.prod(shape) < min_size:
        return ()
    n_total = mesh.size()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for axis in order:
        if shape[axis] % n_total == 0:
            spec = [None] * len(shape)
            spec[axis] = (DATA_AXIS, MODEL_AXIS)
            return tuple(spec)
    n_model = mesh.n_model
    for axis in order:
        if shape[axis] % n_model == 0:
            spec = [None] * len(shape)
            spec[axis] = MODEL_AXIS
            return tuple(spec)
    return ()


def fsdp_shard_dim(spec: Spec) -> Optional[int]:
    """The axis a spec shards over every rank, else None."""
    for i, ax in enumerate(spec):
        if ax == (DATA_AXIS, MODEL_AXIS):
            return i
    return None


def shard_params_fsdp(module: nn.Module, mesh: Mesh, min_size: int = 1024) -> nn.Module:
    """FSDP2 over every rank of the mesh, each parameter sharded on the
    axis `fsdp_spec` picks. Parameters it leaves to the model axis alone or
    replicates stay whole on every rank (FSDP ignores them; the training
    step all-reduces their gradients): with FSDP over all ranks a
    model-only shard would hold the same bytes as a replica within each
    data group. Returns the module; it records the replicated parameters
    in `module.fsdp_replicated` and the mesh in `module.fsdp_mesh`."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    dims, replicated = {}, []
    for p in module.parameters():
        dim = fsdp_shard_dim(fsdp_spec(p.shape, mesh, min_size))
        if dim is None:
            replicated.append(p)
        else:
            dims[id(p)] = dim
    if mesh.device_mesh is not None:
        world = getattr(mesh, "_fsdp_mesh", None)
        if world is None:  # one 1-D mesh over every rank, made once per Mesh
            from torch.distributed.device_mesh import init_device_mesh

            world = mesh._fsdp_mesh = init_device_mesh(
                mesh.device_mesh.device_type, (mesh.size(),), mesh_dim_names=("fsdp",))
        fully_shard(module, mesh=world, shard_placement_fn=lambda p: Shard(dims[id(p)]),
                    ignored_params=set(replicated), reshard_after_forward=True)
    module.fsdp_replicated = replicated
    module.fsdp_mesh = mesh
    return module


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (FSDP's parameters and gradients); any other
    tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective: every rank calls it); any
    other tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def shard_like(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a whole tensor, cut as `like` (an FSDP DTensor)
    is cut: `Shard(d)` splits as `torch.chunk` does. A plain `like` takes
    the whole tensor."""
    if not hasattr(like, "placements"):
        return whole
    dim = like.placements[0].dim
    n = like.device_mesh.size()
    r = like.device_mesh.get_local_rank()
    parts = torch.chunk(whole, n, dim=dim)
    if r < len(parts):
        return parts[r]
    return whole.narrow(dim, 0, 0)


# ------------------------------------------------------------------ TP

# (regex over the port's module path, kind) — first match wins. The paths
# are the JAX tree's (the port's modules carry its names), so each rule is
# the JAX rule for the module's weight. TP shards only the UNFUSED names:
# a column shard of a fused qkv/gate_up weight crosses the q/k/v and
# gate/up boundaries (`assert_unfused_for_tp`).
LLAMA_TP_RULES: Rules = [
    (r"embed_tokens$", "embed"),
    (r"lm_head$", "col_gather"),
    (r"layer_\d+\.(q|k|v)$", "col"),
    (r"layer_\d+\.o$", "row"),
    (r"layer_\d+\.(gate|up)$", "col"),
    (r"layer_\d+\.down$", "row"),
]

UNET_TP_RULES: Rules = [
    # attention projections: heads on the output dim
    (r".*\.attn\d?\.to_(q|k|v|k_ip|v_ip)$", "col"),
    (r".*\.attn\d?\.to_out$", "row"),
    # ff_in_a/ff_in_g are the split_geglu halves (models/unet.py): each is
    # column-parallel on its own, so the geglu pairing stays local
    (r".*\.(ff_in|ff_in_a|ff_in_g|fc1)$", "col"),
    (r".*\.(ff_out|fc2)$", "row"),
    # convs: output channels (the JAX rules' `\.` before the name leaves
    # the top-level conv_in and conv_out replicated; so does this)
    (r".*conv\d?$", "conv"),
    (r".*\.(down|up|shortcut|conv_in|conv_out)$", "conv"),
]


def match_rules(path: str, rules: Rules) -> Optional[str]:
    """First rule whose regex is found in `path` wins (the JAX `match_rules`)."""
    for pattern, value in rules:
        if re.search(pattern, path):
            return value
    return None


def assert_unfused_for_tp(module: nn.Module) -> None:
    """Raise if a LLaMA carries fused qkv/gate_up projections: the TP rules
    shard the unfused names only."""
    fused = [n for n, _ in module.named_modules() if n.endswith((".qkv", ".gate_up"))]
    if fused:
        raise ValueError(
            "tensor-parallel sharding requires unfused projections; found fused modules "
            f"(e.g. {fused[0]!r}). Load the LLM without llama.fuse_projections for TP decode.")


def _dims(m: nn.Module, kind: str) -> Dict[str, int]:
    """The dim each tensor of a module is cut along, in the port's layout;
    tensors not listed stay whole."""
    if isinstance(m, Q.QLinear):  # input-major (K, N), the JAX layout
        if kind in ("col", "col_gather"):
            return {"w_q": 1, "w_q4": 1, "scale": 0, "gscale": 1}
        return {"w_q": 0}  # row: int8 rows; scales stay whole
    if isinstance(m, nn.Linear):  # (out, in)
        return {"weight": 0} if kind in ("col", "col_gather") else {"weight": 1}
    if isinstance(m, nn.Conv2d):  # OIHW
        return {"weight": 0}
    if isinstance(m, nn.Embedding):  # (V, D)
        return {"weight": 1}
    raise TypeError(f"no tensor-parallel layout for {type(m).__name__}")


def _split_size(m: nn.Module, kind: str) -> int:
    if kind in ("col", "col_gather"):
        return m.out_features
    if kind == "row":
        return m.in_features
    if kind == "conv":
        return m.weight.shape[0]
    return m.weight.shape[1]  # embed


def _plan(module: nn.Module, mesh: Mesh, rules: Rules,
          unit: Optional[Callable[[str, nn.Module, str], int]] = None) -> Dict[str, Tuple[str, nn.Module]]:
    """{module path: (kind after fallback, module)} of every matched module."""
    n = mesh.n_model
    out = {}
    for path, m in module.named_modules():
        if not path or not isinstance(m, (nn.Linear, Q.QLinear, nn.Conv2d, nn.Embedding)):
            continue
        kind = match_rules(path, rules)
        if kind is None:
            continue
        u = unit(path, m, kind) if unit is not None else 1
        if _split_size(m, kind) % (n * u):
            kind = None  # its column partner falls back alike: the input stays whole
        elif kind == "row" and isinstance(m, Q.QLinear) and hasattr(m, "w_q4"):
            kind = "row_gather"  # packed int4 rows are never row-split; the input is sharded
        if kind is not None:
            out[path] = (kind, m)
    return out


def tp_specs(module: nn.Module, mesh: Mesh, rules: Rules,
             unit: Optional[Callable[[str, nn.Module, str], int]] = None) -> Dict[str, Spec]:
    """{parameter or buffer name: spec} in the port's layout (() when
    replicated) that `apply_tp_rules` would give each tensor."""
    plan = _plan(module, mesh, rules, unit)
    specs = {}
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        path, _, leaf = name.rpartition(".")
        spec: Spec = ()
        if path in plan and plan[path][0] != "row_gather":
            kind, m = plan[path]
            dim = _dims(m, kind).get(leaf)
            if dim is not None:
                s = [None] * t.dim()
                s[dim] = MODEL_AXIS
                spec = tuple(s)
        specs[name] = spec
    return specs


def _slice_(m: nn.Module, name: str, dim: int, r: int, n: int) -> None:
    t = getattr(m, name)
    size = t.shape[dim] // n
    part = t.narrow(dim, r * size, size).clone().contiguous()
    if isinstance(t, nn.Parameter):
        setattr(m, name, nn.Parameter(part, requires_grad=t.requires_grad))
    else:
        m.register_buffer(name, part)


@torch.no_grad()
def apply_tp_rules(module: nn.Module, mesh: Mesh, rules: Rules,
                   unit: Optional[Callable[[str, nn.Module, str], int]] = None) -> nn.Module:
    """Slice this rank's model-axis shard of every matched module in place
    and tag the module (`m.tp`, its kind; `m.tp_cols`, the (start, stop)
    of a column layer's outputs, which its bias adds). `unit(path,
    module, kind)` is the granule a split must keep whole (a head). Axes
    that do not divide fall back to replication. Modules carrying low-rank
    adapters are refused. Returns the module."""
    n = mesh.n_model
    if n == 1:
        return module
    r = mesh.axis_index(MODEL_AXIS)
    for path, (kind, m) in _plan(module, mesh, rules, unit).items():
        if getattr(m, "lora_a", None) is not None:
            raise ValueError(f"{path} carries low-rank adapters; merge them before TP sharding")
        if getattr(m, "tp", None) is not None:
            raise ValueError(f"{path} is already sharded")
        if kind != "row_gather":
            for name, dim in _dims(m, kind).items():
                if hasattr(m, name):
                    _slice_(m, name, dim, r, n)
        if isinstance(m, nn.Linear):
            m.in_features, m.out_features = m.weight.shape[1], m.weight.shape[0]
        elif isinstance(m, nn.Conv2d):
            m.out_channels = m.weight.shape[0]
        elif isinstance(m, nn.Embedding):
            m.embedding_dim = m.weight.shape[1]
        if kind in ("col", "col_gather"):
            size = m.out_features
            m.tp_cols = (r * size, (r + 1) * size)
        m.tp = kind
    return module


# ---------------------------------------- the model code's TP context

_ACT_MESH: contextvars.ContextVar = contextvars.ContextVar("ia2p_tp_mesh", default=None)


@contextlib.contextmanager
def tp_activation_constraints(mesh: Mesh):
    """Run tensor-parallel modules under `mesh`: the model code's
    collectives use its model group. Thread-local through the ContextVar."""
    token = _ACT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACT_MESH.reset(token)


def active_tp_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing `tp_activation_constraints`, else None."""
    return _ACT_MESH.get()


def tp_mesh() -> Mesh:
    mesh = _ACT_MESH.get()
    if mesh is None:
        raise RuntimeError("a tensor-parallel module ran outside tp_activation_constraints(mesh)")
    return mesh


def model_group():
    return tp_mesh().group(MODEL_AXIS)


def model_all_reduce(x: torch.Tensor) -> torch.Tensor:
    return C.all_reduce(x, model_group())


def model_all_gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return C.all_gather(x, dim % x.dim(), model_group())


def model_broadcast(x: torch.Tensor) -> torch.Tensor:
    """Model-rank 0's x on every rank of the model group (outside a TP
    context, x itself)."""
    mesh = _ACT_MESH.get()
    if mesh is None or mesh.n_model == 1:
        return x
    return C.broadcast(x, 0, mesh.group(MODEL_AXIS))


def collective_bytes() -> Dict[str, Dict[str, int]]:
    """{op: {"count", "bytes"}} of the port's collectives so far
    (`collectives.counts`): the counterpart of the JAX function, which
    parses a compiled program's HLO."""
    return C.counts()


def batch_spec(ndim: int) -> Spec:
    return (DATA_AXIS,) + (None,) * (ndim - 1)


def batch_shardings(batch, mesh: Mesh):
    from ..core.mesh import Sharding

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return Sharding(mesh, batch_spec(getattr(x, "ndim", 0) or 1))

    return walk(batch)
