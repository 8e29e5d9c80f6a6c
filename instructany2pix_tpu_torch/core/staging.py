"""A memory-budgeted store of the pipeline's modules for a card that cannot
hold them all, counterpart of the JAX package's `core/staging.py`.

`StagedParams` is a Mapping from group name to `nn.Module` that the
pipeline uses as its `models`: a group is built by its factory on first
access and evicted, least recently used first, when the live groups' bytes
would pass `budget_bytes`. Evicting moves the module's parameters and
buffers to the host, in place (the module object stays the same); the
first eviction copies them, and the host copy is kept, so later evictions
only drop the device tensors and restaging copies the host tensors back.
Restaging never reruns the factory (no checkpoint read, no quantization).
A module reference held outside the store across an eviction sees host
tensors, so callers resolve groups through the store where they use them
(the server's `params_provider`).

Eviction waits for the device before it frees anything; restaging
synchronizes before `swap_s` is read, so it is the copy's whole time. A
re-entrant lock serializes the store between the server's worker thread
and the caller.

The budget bounds the live groups between accesses, not the peak. A
restage evicts first, since the host copy's size is known; a first build
runs its factory on top of the live groups and evicts afterwards, as the
JAX store does, so the peak can reach the budget plus the largest group plus the
caller's activations.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch import nn

# (owning module, is a parameter, attribute name, host tensor)
_Entry = Tuple[nn.Module, bool, str, torch.Tensor]


def tree_device_bytes(module: nn.Module) -> int:
    """Bytes of a module's parameters and buffers."""
    return (sum(p.nbytes for p in module.parameters())
            + sum(b.nbytes for b in module.buffers()))


def _slots(module: nn.Module):
    """(owner, is_param, name, tensor) of every parameter and buffer slot of
    a module tree. A shared parameter comes once (setting its `data` moves it
    for every owner); a shared buffer comes once per owner."""
    seen = set()
    for m in module.modules():
        for name, p in m._parameters.items():
            if p is not None and id(p) not in seen:
                seen.add(id(p))
                yield m, True, name, p
        for name, b in m._buffers.items():
            if b is not None:
                yield m, False, name, b


def _moved(slots, to) -> List[_Entry]:
    """Each slot with its tensor passed through `to`, once per tensor."""
    memo: Dict[int, torch.Tensor] = {}
    out = []
    for owner, is_param, name, t in slots:
        if id(t) not in memo:
            memo[id(t)] = to(t)
        out.append((owner, is_param, name, memo[id(t)]))
    return out


def _install(entries: List[_Entry]) -> None:
    with torch.no_grad():
        for owner, is_param, name, t in entries:
            if is_param:
                owner._parameters[name].data = t
            else:
                owner._buffers[name] = t


def _unique_bytes(entries: List[_Entry]) -> int:
    return sum({id(t): t.nbytes for *_, t in entries}.values())


def _device_of(module: nn.Module) -> torch.device:
    for *_, t in _slots(module):
        return t.device
    return torch.device("cpu")


def _device_barrier(device: torch.device) -> None:
    """Wait until all work queued on `device` has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StagedParams(Mapping):
    """Dict-shaped view over lazily built module groups.

    factories: name -> zero-argument callable returning the group's module
        on its device (a checkpoint load, a random build, ...).
    budget_bytes: byte ceiling across live groups once an access has
        returned. A first build runs before anything is evicted for it (a
        group larger than the budget still materializes, and then
        everything else is evicted); a restage evicts before it copies.
    aliases: name -> the group it shares (the inpainting UNet is the base
        UNet, `inpaint_unet` -> `unet`).
    pin: groups never evicted.
    """

    def __init__(
        self,
        factories: Dict[str, Callable[[], nn.Module]],
        budget_bytes: float = 14e9,
        aliases: Optional[Dict[str, str]] = None,
        pin: tuple = (),
    ):
        self._factories = dict(factories)
        self._aliases = dict(aliases or {})
        self._budget = int(budget_bytes)
        self._pin = set(pin)
        self._live: Dict[str, nn.Module] = {}
        # the server's worker thread and the caller share the store: every
        # change to _live/_order and every free happens under this lock
        self._lock = threading.RLock()
        self._home: Dict[str, torch.device] = {}
        self._host: Dict[str, Tuple[nn.Module, List[_Entry]]] = {}
        self._bytes: Dict[str, int] = {}
        self._order: list = []  # LRU order, most recently used last
        self.stats: Dict[str, object] = {
            "load_s": {},  # first build (factory) per group
            "swap_s": 0.0,  # host-to-device restaging, synchronized
            "swaps": 0,
            "swap_bytes": 0,
            "evict_s": 0.0,  # evictions, device-to-host copies included
            "evictions": [],  # group names in eviction order
        }

    # ------------------------------------------------------------ mapping

    def _resolve(self, name: str) -> str:
        seen = set()
        while name in self._aliases:
            if name in seen:
                raise ValueError(f"alias cycle at {name!r}")
            seen.add(name)
            name = self._aliases[name]
        return name

    def __getitem__(self, name: str) -> nn.Module:
        with self._lock:
            name = self._resolve(name)
            if name in self._live:
                self._touch(name)
                return self._live[name]
            return self._materialize(name)

    def __setitem__(self, name: str, module: nn.Module) -> None:
        """Replace a group in place; the module counts as live."""
        with self._lock:
            name = self._resolve(name)
            if name in self._live:
                self._order.remove(name)
            self._live[name] = module
            self._bytes[name] = tree_device_bytes(module)
            self._home[name] = _device_of(module)
            self._host.pop(name, None)  # a stale host copy
            self._order.append(name)
            self._shrink(exclude=name)

    def __iter__(self) -> Iterator[str]:
        return iter(set(self._factories) | set(self._aliases) | set(self._live))

    def __len__(self) -> int:
        return len(set(self._factories) | set(self._aliases) | set(self._live))

    def __contains__(self, name: object) -> bool:
        name = self._resolve(str(name))
        return name in self._factories or name in self._live

    # ------------------------------------------------------------ engine

    def _touch(self, name: str) -> None:
        self._order.remove(name)
        self._order.append(name)

    def _live_bytes(self) -> int:
        return sum(self._bytes[n] for n in self._live)

    def _materialize(self, name: str) -> nn.Module:
        if name not in self._factories:
            raise KeyError(name)
        if name in self._host:
            # evict before restaging when the incoming size is known: staging
            # first and shrinking after would peak at live + incoming
            module, entries = self._host[name]
            incoming = _unique_bytes(entries)
            while self._live_bytes() + incoming > self._budget:
                victim = next((n for n in self._order if n not in self._pin), None)
                if victim is None:
                    break
                self._evict(victim)
            dev = self._home[name]
            t0 = time.perf_counter()
            with torch.inference_mode(False):
                _install(_moved(entries, lambda t: t.to(dev)))
            _device_barrier(dev)
            self.stats["swap_s"] += time.perf_counter() - t0
            self.stats["swaps"] += 1
            self.stats["swap_bytes"] += incoming
        else:
            t0 = time.perf_counter()
            # built outside inference mode, whatever the caller is in: an
            # inference tensor's `data` cannot be swapped for the host copy
            with torch.inference_mode(False):
                module = self._factories[name]()
            self._home[name] = _device_of(module)
            self.stats["load_s"][name] = time.perf_counter() - t0
        self._live[name] = module
        self._bytes[name] = tree_device_bytes(module)
        self._order.append(name)
        self._shrink(exclude=name)
        return module

    def _shrink(self, exclude: str) -> None:
        while self._live_bytes() > self._budget:
            victim = next((n for n in self._order if n != exclude and n not in self._pin), None)
            if victim is None:
                break  # everything left is pinned or the group itself
            self._evict(victim)

    def _evict(self, name: str) -> None:
        t0 = time.perf_counter()
        module = self._live.pop(name)
        self._order.remove(name)
        self._bytes.pop(name)
        # work already queued may read these tensors: let it finish first
        _device_barrier(self._home[name])
        with torch.inference_mode(False):
            if name not in self._host:
                self._host[name] = (module, _moved(list(_slots(module)), lambda t: t.to("cpu")))
            _install(self._host[name][1])
        self.stats["evict_s"] += time.perf_counter() - t0
        self.stats["evictions"].append(name)

    # ------------------------------------------------------------ control

    def prefetch(self, *names: str) -> None:
        for n in names:
            self[n]

    def evict(self, *names: str) -> None:
        with self._lock:
            for n in names:
                n = self._resolve(n)
                if n in self._live:
                    self._evict(n)

    def pin(self, *names: str) -> None:
        """Never evict these groups from now on."""
        with self._lock:
            self._pin.update(self._resolve(n) for n in names)

    def unpin(self, *names: str) -> None:
        with self._lock:
            for n in names:
                self._pin.discard(self._resolve(n))

    def live_groups(self) -> Dict[str, int]:
        with self._lock:
            return {n: self._bytes[n] for n in self._order}
