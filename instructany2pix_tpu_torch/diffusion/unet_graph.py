"""Piecewise CUDA graphs of the UNet forward inside a sampling loop.

At batch 1-2 the host cannot launch a UNet step's thousands of small kernels
as fast as the H100 runs them. A `Loop` (one per `sampler.make_cfg_eps_fn`
loop) replays the forward from CUDA graphs instead: one graph for each
stretch of kernels between two attention calls that reach K1 (self, text
cross and IP attention; none for a stretch that launches nothing, as between
text and IP attention), and K1 itself launched eagerly between the replays
through `flash_attention.flash_fwd_cuda`, looked up at every call, so its
launch counters, the tracer's "k1" counter and any wrapper of that entry
point see every launch. K1 writes straight into the buffer the next graph
reads (`flash_fwd_cuda(..., out=)`); its cross-attention K/V are the loop's
own `cross_kv` tensors, rebound for each loop and never copied into a graph.

When it engages, decided from what the loop can observe (nothing to set):
the UNet's weights on CUDA, grad mode off, no mesh (a tensor-parallel
context or a current mesh of more than one device keeps the eager forward
and its collectives), and IP scales that the UNet's dtype holds exactly
(a graph reads the scale from a device scalar of that dtype, the eager
forward multiplies by the Python float; 1.0 and 0 are exact in bf16).
`make_cfg_eps_fn` never taps IP attention or shares pnp's Q/K: those
callers run `unet.apply` themselves, eagerly. Everything else, the CPU
included, runs the eager forward unchanged.

A key is the UNet, its config, the latent's shape and dtype, the rows,
the timestep's dtype, the conditioning's shapes and dtypes (context length,
IP tokens or none, inpaint channels), the cross K/V's layout and the
device. Its first forward runs eagerly, its second captures the graphs
and replays them, later ones replay: a shape seen once (a partial served
microbatch) costs no capture. The latent, the timestep and the IP scale
are written into device buffers before each replay, the conditioning when
the loop's tensors change; no Python number that changes between steps
or requests is baked into a graph. The graphs of one UNet share one memory
pool, which any forward of that UNet writes over; so a forward holds the
UNet's lock (threads wait for it) from loading the inputs until the replay's
ε has been copied out of the pool, and the caller gets the copy. Every
thread enqueues on the device's default stream, so the copy is ordered
before the next replay.

Graphs are dropped, and their pool freed, when a staged store evicts the
UNet (`release`), and when its weights move otherwise (a dtype change,
adapters attached): the pointers are checked once per loop. A restaged
UNet captures anew. `UNetGraphs` keeps counts like K1's `launches` (`captures`,
`replays`, `eager`, `segments`) and, while the tracer is on, counts
("capture" | "replay" | "eager", rows) under "unet_graph".
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import warnings
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.mesh import current_mesh
from ..ops import flash_attention
from ..parallel.sharding import active_tp_mesh
from ..utils import profiling

_INT_OF_SIZE = {1: "|u1", 2: "<i2", 4: "<i4", 8: "<i8"}


class _Memory:
    """The `__cuda_array_interface__` of a tensor's memory, as integers of
    its element size, without a reference to its storage."""

    def __init__(self, t: torch.Tensor):
        n = t.element_size()
        self.__cuda_array_interface__ = {
            "shape": tuple(t.shape), "typestr": _INT_OF_SIZE[n], "data": (t.data_ptr(), False),
            "strides": tuple(s * n for s in t.stride()), "version": 2}


class CudaGraphs:
    """Segments as `torch.cuda.CUDAGraph`s captured on a side stream of the
    device; K1's operands as tensors over the pool's memory that do not keep
    it allocated, so the capture reuses it as the eager forward would."""

    def __init__(self):
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    @staticmethod
    def usable(t: torch.Tensor) -> bool:
        return t.is_cuda

    @staticmethod
    def pool():
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def graph():
        return torch.cuda.CUDAGraph()

    @contextlib.contextmanager
    def capturing(self, device: torch.device):
        torch.cuda.synchronize(device)
        side = self._streams.get(device)
        if side is None:
            side = self._streams[device] = torch.cuda.Stream(device)
        cur = torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            yield
        cur.wait_stream(side)

    @staticmethod
    def alias(t: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(_Memory(t), device=t.device).view(t.dtype)


BACKEND = CudaGraphs()

_RUNNERS: "weakref.WeakKeyDictionary[torch.nn.Module, UNetGraphs]" = weakref.WeakKeyDictionary()
_RUNNERS_LOCK = threading.Lock()


def graphs_of(unet: torch.nn.Module) -> "UNetGraphs":
    """The UNet's graphs and counts, made on first use; they go with the
    module."""
    with _RUNNERS_LOCK:
        r = _RUNNERS.get(unet)
        if r is None:
            r = _RUNNERS[unet] = UNetGraphs(BACKEND)
        return r


def release(module: torch.nn.Module):
    """Drop the graphs of every UNet in `module` (a staged store evicts it)."""
    with _RUNNERS_LOCK:
        runners = [r for m in module.modules() if (r := _RUNNERS.get(m)) is not None]
    for r in runners:
        r.clear()


def _weights(unet: torch.nn.Module) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in itertools.chain(unet.parameters(), unet.buffers()))


def _exact(value: float, dtype: torch.dtype) -> bool:
    """Whether `dtype` holds `value` as the eager product's float32 operand."""
    return float(torch.tensor(value, dtype=dtype)) == float(torch.tensor(value, dtype=torch.float32))


def _trace(event: str, rows: int):
    if profiling.ON:
        profiling.count("unet_graph", (event, rows))


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


class _KV:
    """A K1 operand that is a view of the loop's cross K/V leaf `i`."""

    __slots__ = ("i", "size", "stride", "offset")

    def __init__(self, i, size, stride, offset):
        self.i, self.size, self.stride, self.offset = i, size, stride, offset


class _Splitter:
    """What `flash_attention` calls while a forward is captured: ends the
    current graph at each K1 call, records the call and begins the next."""

    def __init__(self, backend, pool, leaves: Sequence[torch.Tensor]):
        self.backend, self.pool = backend, pool
        self.kv = {t.untyped_storage().data_ptr(): (i, t.storage_offset())
                   for i, t in enumerate(leaves)}
        self.graphs: list = []
        self.calls: list = []
        self.open = None

    def begin(self):
        self.open = self.backend.graph()
        self.open.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self):
        g, self.open = self.open, None
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            g.capture_end()
        # PyTorch warns when the stretch launched nothing (two K1 calls in a row: text
        # cross and IP attention); such a graph is not kept, and not replayed
        empty = any("graph is empty" in str(w.message).lower() for w in said)
        self.graphs.append(None if empty else g)

    def abort(self):
        if self.open is not None:
            with contextlib.suppress(RuntimeError):
                self.open.capture_end()
            self.open = None

    def _operand(self, t):
        hit = self.kv.get(t.untyped_storage().data_ptr())
        if hit is None:
            return self.backend.alias(t)
        return _KV(hit[0], tuple(t.shape), tuple(t.stride()), t.storage_offset() - hit[1])

    def __call__(self, q, k, v, causal, scale, return_lse, kv_len):
        if return_lse or kv_len is not None:
            raise ValueError("a graphed UNet forward takes K1 without lse or kv_len")
        o = torch.empty_like(q)  # in this graph's pool, as K1's own output would be
        self.end()
        self.calls.append((self._operand(q), self._operand(k), self._operand(v),
                           self.backend.alias(o), bool(causal), float(scale)))
        self.begin()
        return o


class _Captured:
    """One key's graphs, K1 calls, input buffers and output."""

    def __init__(self, graphs, calls, bufs, out):
        self.graphs, self.calls, self.bufs, self.out = graphs, calls, bufs, out
        self.t = self.scale = None
        self.consts: List[Optional[weakref.ref]] = [None] * len(bufs["consts"])

    def load(self, loop: "Loop", lat, t, scale):
        b = self.bufs
        b["lat"].copy_(lat)
        if t != self.t:
            b["t"].fill_(t)
            self.t = t
        if scale != self.scale:
            b["scale"].fill_(scale)
            self.scale = scale
        for j, (buf, x) in enumerate(zip(b["consts"], loop.consts)):
            ref = self.consts[j]
            if x is not None and (ref is None or ref() is not x):
                buf.copy_(x)
                self.consts[j] = weakref.ref(x)

    def replay(self, bound) -> torch.Tensor:
        for g, (q, k, v, o, causal, scale) in zip(self.graphs, bound):
            if g is not None:
                g.replay()
            flash_attention.flash_fwd_cuda(q, k, v, causal, scale, out=o)
        if self.graphs[-1] is not None:
            self.graphs[-1].replay()
        return self.out


class UNetGraphs:
    """The captured keys of one UNet, and its counts: forwards that
    `captures` (then replayed), `replays` and ran `eager`; `segments`
    graphs held (a stretch that launched nothing has none)."""

    def __init__(self, backend):
        self.backend = backend
        self.captures = self.replays = self.eager = self.segments = 0
        self._keys: Dict[tuple, _Captured] = {}
        self._seen: set = set()
        self._pool = None
        self._weights: Optional[Tuple[int, ...]] = None
        self._lock = threading.Lock()

    def clear(self):
        """Drop every graph and forget every key seen."""
        with self._lock:
            self._drop()

    def _drop(self):
        self._keys.clear()
        self._seen.clear()
        self._pool = None
        self.segments = 0

    def check_weights(self, unet: torch.nn.Module):
        """Drop the graphs when the UNet's tensors have moved."""
        w = _weights(unet)
        with self._lock:
            if w != self._weights:
                self._drop()
                self._weights = w

    def _count(self, event: str, rows: int):
        attr = {"capture": "captures", "replay": "replays", "eager": "eager"}[event]
        setattr(self, attr, getattr(self, attr) + 1)
        _trace(event, rows)

    def forward(self, loop: "Loop", lat, t, scale) -> torch.Tensor:
        rows = lat.shape[0] * loop.mult
        key = (loop.key, tuple(lat.shape), lat.dtype, type(t))
        with self._lock:
            cap = self._keys.get(key)
            if cap is None and key not in self._seen:
                self._seen.add(key)
                self._count("eager", rows)
                return loop.eager(lat, t, scale)
            if cap is None:
                cap = self._keys[key] = self._capture(loop, lat, t, scale)
                self.segments += sum(g is not None for g in cap.graphs)
                self._count("capture", rows)
            else:
                self._count("replay", rows)
            held = loop.bound.get(key)
            if held is None or held[0] is not cap:
                held = loop.bound[key] = (cap, loop.bind(cap.calls))
            cap.load(loop, lat, t, scale)
            return cap.replay(held[1]).clone()

    def _capture(self, loop: "Loop", lat, t, scale) -> _Captured:
        dev = loop.device

        def like(x):
            return None if x is None else torch.empty(x.shape, dtype=x.dtype, device=dev)

        with torch.inference_mode(False):  # buffers written later in any mode
            bufs = {"lat": like(lat),
                    "t": torch.empty(lat.shape[0] * loop.mult, dtype=torch.tensor(t).dtype,
                                     device=dev),
                    "scale": torch.empty((), dtype=loop.dtype, device=dev),
                    "consts": [like(x) for x in loop.consts]}
        cap = _Captured([], [], bufs, None)
        cap.load(loop, lat, t, scale)
        if self._pool is None:
            self._pool = self.backend.pool()
        split = _Splitter(self.backend, self._pool, loop.leaves)
        with self.backend.capturing(dev):
            token = flash_attention.K1_SPLIT.set(split)
            try:
                split.begin()
                out = loop.fn(bufs["lat"], bufs["t"], bufs["scale"], *bufs["consts"])
                split.end()
            except BaseException:
                split.abort()
                raise
            finally:
                flash_attention.K1_SPLIT.reset(token)
        cap.graphs, cap.calls, cap.out = split.graphs, split.calls, out
        return cap


class Loop:
    """The UNet forward of one sampling loop: `fn(lat, t, scale, *consts)`
    → ε over the loop's conditioning `consts` and cross K/V `cross_kv`
    (closed over by `fn`), with `mult` UNet rows per latent row and the
    IP scales the loop will pass. `loop(lat, t, scale)` replays the
    UNet's graphs where they engage (the module docstring), else runs
    `fn` eagerly with the timestep as a host tensor, as it always has."""

    def __init__(self, unet: torch.nn.Module, cfg, fn: Callable, cross_kv: dict,
                 consts: Sequence[Optional[torch.Tensor]], mult: int, scales: Sequence[float]):
        self.fn, self.consts, self.mult = fn, tuple(consts), mult
        self.leaves = _leaves(cross_kv)
        self.dtype, self.device = unet.conv_in.weight.dtype, unet.conv_in.weight.device
        self.bound: Dict[tuple, tuple] = {}  # key → (its capture, the K1 calls bound here)
        self.graphs: Optional[UNetGraphs] = None
        mesh = current_mesh()
        if (BACKEND.usable(unet.conv_in.weight) and active_tp_mesh() is None
                and (mesh is None or mesh.size() <= 1)
                and all(_exact(s, self.dtype) for s in scales)):
            self.graphs = graphs_of(unet)
            self.graphs.check_weights(unet)
            self.key = (cfg, self.dtype, self.device,
                        tuple(None if t is None else (tuple(t.shape), t.dtype) for t in self.consts),
                        tuple((tuple(t.shape), t.stride(), t.dtype) for t in self.leaves))

    def eager(self, lat, t, scale) -> torch.Tensor:
        return self.fn(lat, torch.full((lat.shape[0] * self.mult,), t), scale, *self.consts)

    def bind(self, calls) -> list:
        """The K1 calls with this loop's cross K/V in place of the capture's."""
        def view(x):
            if not isinstance(x, _KV):
                return x
            leaf = self.leaves[x.i]
            return leaf.as_strided(x.size, x.stride, leaf.storage_offset() + x.offset)

        return [(view(q), view(k), view(v), o, causal, scale)
                for q, k, v, o, causal, scale in calls]

    def __call__(self, lat, t, scale: float) -> torch.Tensor:
        if self.graphs is None:
            _trace("eager", lat.shape[0] * self.mult)
            return self.eager(lat, t, scale)
        if torch.is_grad_enabled():
            self.graphs._count("eager", lat.shape[0] * self.mult)
            return self.eager(lat, t, scale)
        return self.graphs.forward(self, lat, t, scale)
