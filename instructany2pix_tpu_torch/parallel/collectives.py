"""The port's collectives: one wrapper per op, each counting its calls and
bytes, so a run can report its communication as the JAX package's
`collective_bytes` reports a compiled program's (there is no HLO to parse
here: the port calls every collective itself).

`counts()` is `{op: {"count": n, "bytes": b}}` under the HLO op names
("all-reduce", "all-gather", "collective-permute", "broadcast"); bytes are
the result's, as `collective_bytes` counts them. FSDP's own all-gathers
and reduce-scatters (`parallel/sharding.py::shard_params_fsdp`) run inside
`fully_shard` and are not counted here.

On a gloo group the wrappers move CUDA tensors through pinned host memory
explicitly: gloo takes only some collectives on CUDA tensors, and several
ranks sharing one card cannot use NCCL. That is the backend's transport;
the compute stays on the card (an all-reduce gathers the partial tensors
and sums them there). A one-rank group (or None) is the identity and
counts nothing.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

import torch

_LOCK = threading.Lock()
_COUNTS: Dict[str, Dict[str, int]] = {}


def counts() -> Dict[str, Dict[str, int]]:
    """A copy of the counters: {op: {"count", "bytes"}}."""
    with _LOCK:
        return {k: dict(v) for k, v in _COUNTS.items()}


def reset_counts() -> None:
    with _LOCK:
        _COUNTS.clear()


def _count(op: str, nbytes: int) -> None:
    with _LOCK:
        agg = _COUNTS.setdefault(op, {"count": 0, "bytes": 0})
        agg["count"] += 1
        agg["bytes"] += int(nbytes)


def _dist():
    import torch.distributed as dist

    return dist


def world():
    """The default group (every rank), None without a process group."""
    dist = _dist()
    return dist.group.WORLD if dist.is_initialized() else None


def group_size(group) -> int:
    if group is None:
        return 1
    return _dist().get_world_size(group)


def _host(group) -> bool:
    """True when this group's backend wants host tensors (gloo)."""
    return _dist().get_backend(group) == "gloo"


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """x as the group's backend takes it: a CUDA tensor for gloo is copied
    into pinned host memory (PyTorch's caching host allocator keeps the
    buffers)."""
    if _host(group) and x.is_cuda:
        t = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        t.copy_(x)
        return t
    return x.contiguous()


def _gathered(t: torch.Tensor, group) -> List[torch.Tensor]:
    pin = t.device.type == "cpu" and torch.cuda.is_available() and t.is_pinned()
    parts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for _ in range(group_size(group))]
    _dist().all_gather(parts, t, group=group)
    return parts


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; returns a new tensor on x's device. On gloo the
    partial tensors are gathered and summed on x's device in float32, in
    group-rank order, then rounded once to x's dtype: every rank gets the
    same bits, and no host thread sums bf16."""
    if group_size(group) == 1:
        return x
    if _host(group):
        parts = [p.to(x.device, non_blocking=True) for p in _gathered(_staged(x, group), group)]
        out = parts[0].float()
        for p in parts[1:]:
            out = out + p.float()
        out = out.to(x.dtype)
    else:
        out = x.clone()
        _dist().all_reduce(out, group=group)
    _count("all-reduce", out.numel() * out.element_size())
    return out


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's x along `dim`, in group-rank order."""
    n = group_size(group)
    if n == 1:
        return x
    parts = _gathered(_staged(x, group), group)
    out = torch.cat([p.to(x.device, non_blocking=True) for p in parts], dim=dim)
    _count("all-gather", out.numel() * out.element_size())
    return out


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group-rank `src`'s x on every rank of the group."""
    if group_size(group) == 1:
        return x
    dist = _dist()
    t = _staged(x, group)
    if t is x:
        t = x.clone()
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    _count("broadcast", t.numel() * t.element_size())
    return t.to(x.device)


def broadcast_objects(objs: List[Any], src: int = 0, group=None) -> List[Any]:
    """`broadcast_object_list` (pickled Python objects) from group-rank `src`;
    `group` None is the default group."""
    dist = _dist()
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return objs
    objs = list(objs)
    src_global = dist.get_global_rank(group, src) if group is not None else src
    dist.broadcast_object_list(objs, src=src_global, group=group)
    _count("broadcast", 0)
    return objs


def ring_shift(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each tensor to the next rank of the group and receive the
    previous rank's (group-rank i → i + 1 mod n), in one
    `batch_isend_irecv`: a `ppermute` with the JAX ring's permutation."""
    n = group_size(group)
    if n == 1:
        return tensors
    dist = _dist()
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    sends = [_staged(t, group) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for r in recvs:
        _count("collective-permute", r.numel() * r.element_size())
    return [r.to(t.device) for r, t in zip(recvs, tensors)]
