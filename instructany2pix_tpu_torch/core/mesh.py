"""The ("data", "model") device mesh over `torch.distributed`, counterpart
of the JAX package's `core/mesh.py`.

The JAX package is single-controller: one process drives every device and
GSPMD inserts the collectives. The port is multi-controller: one process
per rank (launched by `torchrun` or `torch.multiprocessing`), each holding
its own shards and calling every collective itself (`parallel/`).

Axis conventions, as in the JAX package:
  "data"  — batch / data-parallel axis (FSDP shards parameters over every
            rank, `parallel/sharding.py`).
  "model" — tensor-parallel axis (attention heads, MLP hidden, UNet
            channels).

Rank r sits at (r // n_model, r % n_model): the ranks of one model group
are consecutive. `Mesh.groups` holds one process group per axis for this
rank (None on a one-rank mesh, which needs no process group at all).
A mesh is NCCL's on the card and gloo's on the CPU; gloo may also carry
several ranks that share one card, since NCCL does not take two ranks on
one device (`parallel/collectives.py` moves CUDA tensors through host
memory for it).

`use_mesh`/`current_mesh` keep the active mesh in a `contextvars.ContextVar`,
so a server's worker thread sees the mesh it entered, not another
thread's.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of an (n_data, n_model) mesh. `device` is where its
    tensors live; `groups` maps each axis to the process group of the
    ranks that share this rank's other coordinate; `device_mesh` is the
    `DeviceMesh` the groups came from (None on a one-rank mesh)."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: Optional[str] = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    device_mesh: Any = None

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]

    def size(self) -> int:
        return self.n_data * self.n_model

    def coords(self) -> Tuple[int, int]:
        return divmod(self.rank, self.n_model)

    def axis_index(self, axis: str) -> int:
        d, m = self.coords()
        return d if axis == DATA_AXIS else m

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.n_data}, model={self.n_model}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def abstract_mesh(n_data: int, n_model: int = 1, rank: int = 0) -> Mesh:
    """A mesh's shape and one rank's coordinates, with no process group:
    enough for the placement rules (`fsdp_spec`, `tp_specs`), which need
    only the axis sizes."""
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, rank, torch.device("cpu"))


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     timeout_s: float = 600.0) -> None:
    """`torch.distributed.init_process_group` when it has not run: from
    `torchrun`'s environment (`env://`) unless `init_method`, `rank` and
    `world_size` are given (`tcp://localhost:<port>` or `file://<path>`).
    The backend defaults to NCCL when a GPU is visible, else gloo."""
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {}
    if init_method is not None:
        kw = dict(init_method=init_method, rank=int(rank), world_size=int(world_size))
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """An (n_data, n_model) mesh over the default process group, whose
    world size must be n_data · n_model (n_data defaults to world / n_model).
    Without a process group, the one-rank mesh. `device` is where this
    rank's tensors live: the card unless the caller asks for the CPU (on a
    machine with several cards, the one of the local rank)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        if world % n_model:
            raise ValueError(f"world size {world} is not a multiple of n_model={n_model}")
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks; "
                         f"the process group has {world}")
    if device is None and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if world > 1 else 0))
        device = f"cuda:{local % torch.cuda.device_count()}"
    dev = resolve_device(device)
    if world == 1 and not dist.is_initialized():
        return Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, 0, dev)
    from torch.distributed.device_mesh import init_device_mesh

    backend = dist.get_backend()
    # the DeviceMesh's type follows the backend: gloo's groups carry host
    # tensors even when this rank computes on the card
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", (n_data, n_model),
                          mesh_dim_names=AXES)
    groups = {a: dm.get_group(a) for a in AXES}
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, dist.get_rank(), dev, backend,
                groups, dm)


def single_device_mesh(device=None) -> Mesh:
    """The (1, 1) mesh on one device; needs no process group."""
    return Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, 0, resolve_device(device))


_CURRENT_MESH: contextvars.ContextVar = contextvars.ContextVar("ia2p_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    token = _CURRENT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT_MESH.reset(token)


def current_mesh() -> Optional[Mesh]:
    return _CURRENT_MESH.get()


class Sharding(NamedTuple):
    """A placement description: one entry per tensor dim, each an axis
    name, a tuple of axis names or None (replicated along that dim)."""

    mesh: Mesh
    spec: Tuple[Any, ...]


def sharding(mesh: Mesh, *spec) -> Sharding:
    return Sharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharded(mesh: Mesh) -> Sharding:
    """Leading (batch) dim over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def batch_rows(n: int, mesh: Mesh) -> Tuple[int, int, int]:
    """(start, stop, padded) of this rank's rows of an n-row batch padded
    to a multiple of the data axis."""
    per = -(-n // mesh.n_data)
    start = mesh.axis_index(DATA_AXIS) * per
    return start, start + per, per * mesh.n_data


def shard_batch(tree, mesh: Mesh):
    """This rank's rows of every tensor in a tree (dicts, lists, tuples) of
    tensors with a leading batch dim: the batch padded to a multiple of the
    data axis by repeating its last row, then this data rank's contiguous
    block, on the mesh's device."""

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        x = torch.as_tensor(x)
        start, stop, padded = batch_rows(x.shape[0], mesh)
        if padded > x.shape[0]:
            x = torch.cat([x, x[-1:].expand(padded - x.shape[0], *x.shape[1:])])
        return x[start:stop].to(mesh.device)

    return take(tree)
