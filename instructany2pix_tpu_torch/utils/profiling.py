"""The port's one tracer, and its profiling helpers (counterpart of the JAX
package's `utils/profiling.py`):

  * spans and counters kept in memory, off by default. `enable()` starts
    a new record, `disable()` stops recording, `snapshot()` returns what
    was recorded and `clear()` empties it. While off, a call site costs
    one test of the module flag `ON`: nothing is allocated and no clock
    or device is read.
      - `span(name, rows, loop, step, memory)`: a context manager, one
        span on this thread, whose parent is the span open around it on
        the same thread.
      - `begin(name)` / `end(span)`: a span that may end on another thread
        (a request, from `submit` to its answer). It has no parent.
      - A span's `id` is unique in the process (a request's id is its
        span's); `ids` holds the ids it covers (a microbatch's requests),
        and `rows`, `loop` and `step` describe its work. One opened with
        `memory=True` records the caching allocator's deltas over it,
        `device_allocs` (cudaMalloc calls) and `reserved_bytes`, read from
        `torch.cuda.memory_stats()` on the host, with no sync.
      - `count(name, key)`: a counter at the same boundaries (K1's and K3's
        calls, by shape). A key may hold `torch.Size`s and dtypes, which
        `snapshot()` gives as tuples and names.
    Times are `time.perf_counter_ns()`, the clock of `time.perf_counter()`.
    `enable()` also takes an anchor, a (perf_counter_ns, time_ns) pair,
    that places them on a `torch.profiler` Chrome trace's clock:
    ts = (time_ns at the anchor + (t - perf_counter_ns at the anchor)
    - the trace's baseTimeNanoseconds) / 1000 µs (`trace_us`).
    The buffer holds `capacity` spans and counts those it drops.
  * `stage(name)` — a span inside a `torch.profiler` range of the same
    name; it does not sync.
  * `nan_check(x, name)` — raise on non-finite values in a tensor, a
    module's parameters, or a nested dict, list or tuple of tensors.
  * `device_trace(log_dir)` — a `torch.profiler` capture of CPU and CUDA
    activity written as a Chrome trace to `log_dir/trace.json`, with the
    program's spans beside the kernels as complete events of category
    "program_span" on the trace's clock, and the counts made during the
    capture under the trace's "programCounters" key (name → a list of
    {"key", "calls"}: K1's calls by shape beside its kernels).

The pipeline's `_stage` opens a span and, when `pipe.stage_times` is a
dict, also times the stage (CUDA events on the card).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

ON = False  # the one flag every call site tests
CAPACITY = 1 << 16  # spans kept before the buffer drops

_FIELDS = ("id", "parent", "name", "start_ns", "end_ns", "thread", "ids", "rows", "loop", "step",
           "device_allocs", "reserved_bytes")


class Span:
    """One span; `with span(...)` opens it on this thread's stack, under
    the span open there, and `begin` starts one that `end` closes."""

    __slots__ = _FIELDS + ("_mem",)

    def __init__(self, name: str, rows=None, loop=None, step=None, memory: bool = False):
        self.id = next(_ids)
        self.name = name
        self.thread = threading.get_ident()
        self.ids = ()
        self.rows, self.loop, self.step = rows, loop, step
        self.parent = self.device_allocs = self.reserved_bytes = self.end_ns = None
        self._mem = memory

    def _start(self) -> "Span":
        self._mem = _alloc_stats() if self._mem else None
        self.start_ns = time.perf_counter_ns()
        return self

    def _close(self):
        self.end_ns = time.perf_counter_ns()
        if self._mem is not None:
            now = _alloc_stats()
            if now is not None:
                self.device_allocs = now[0] - self._mem[0]
                self.reserved_bytes = now[1] - self._mem[1]
        _record.add(self)

    def __enter__(self) -> "Span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        return self._start()

    def __exit__(self, *exc):
        _open.stack.pop()
        self._close()
        return False

    def as_dict(self) -> Dict:
        return {f: getattr(self, f) for f in _FIELDS if getattr(self, f) not in (None, ())}


def _alloc_stats() -> Optional[Tuple[int, int]]:
    """(cudaMalloc calls, reserved bytes) of the current device's caching
    allocator, or None where CUDA is not in use."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    s = torch.cuda.memory_stats()
    return s.get("num_device_alloc", 0), s.get("reserved_bytes.all.current", 0)


class _Record:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.spans: List[Span] = []
        self.counters: Dict[str, Dict[tuple, int]] = {}
        self.dropped = 0
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self.lock = threading.Lock()

    def add(self, span: Span):
        with self.lock:
            if len(self.spans) < self.capacity:
                self.spans.append(span)
            else:
                self.dropped += 1


_ids = itertools.count(1)
_record = _Record(0)
_open = threading.local()  # this thread's stack of open `span`s
_NO_SPAN = contextlib.nullcontext()


def enable(capacity: int = CAPACITY) -> None:
    """Start a new record (dropping the last one) and turn recording on."""
    global ON, _record
    _record = _Record(capacity)
    ON = True


def disable() -> None:
    """Stop recording; what was recorded stays for `snapshot()`."""
    global ON
    ON = False


def clear() -> None:
    """Empty the record, keeping its anchor and capacity."""
    with _record.lock:
        _record.spans, _record.counters, _record.dropped = [], {}, 0


def _plain(key):
    """A counter key with each `torch.Size` as a tuple and each dtype as
    its name."""
    if isinstance(key, tuple):
        return tuple(_plain(k) for k in key)
    return str(key) if isinstance(key, torch.dtype) else key


def snapshot() -> Dict:
    """What was recorded: closed spans in the order they closed (as dicts,
    unset fields left out), counters by name and (plain) key, the anchor
    and the number of spans dropped."""
    with _record.lock:
        spans = list(_record.spans)
        raw = {n: list(c.items()) for n, c in _record.counters.items()}
        anchor, dropped = _record.anchor, _record.dropped
    counters = {}
    for name, items in raw.items():
        c = counters[name] = {}
        for key, n in items:
            key = _plain(key)
            c[key] = c.get(key, 0) + n
    return {"spans": [s.as_dict() for s in spans], "counters": counters,
            "anchor": anchor, "dropped": dropped}


def trace_us(t_ns: int, anchor: Tuple[int, int], base_ns: int) -> float:
    """A span time on a `torch.profiler` Chrome trace's clock (µs)."""
    return (anchor[1] + (t_ns - anchor[0]) - base_ns) / 1e3


def span(name: str, rows=None, loop=None, step=None, memory: bool = False):
    """`with span(...) as s:` records one span on this thread (s is the
    `Span`, or None while the tracer is off)."""
    if not ON:
        return _NO_SPAN
    return Span(name, rows, loop, step, memory)


def begin(name: str) -> Optional[Span]:
    """A span that `end` closes, on any thread; None while the tracer is off."""
    if not ON:
        return None
    return Span(name)._start()


def end(s: Optional[Span]) -> None:
    if s is not None:
        s._close()


def count(name: str, key: tuple, n: int = 1) -> None:
    """Add `n` to counter `name` at `key` (kept as given; `snapshot` makes
    it plain); call sites test `ON` first."""
    with _record.lock:
        c = _record.counters.setdefault(name, {})
        c[key] = c.get(key, 0) + n


@contextlib.contextmanager
def stage(name: str):
    """A span named `name`, inside a `torch.profiler` range of that name,
    so the stage shows in any profiler capture (no sync)."""
    with torch.profiler.record_function(name), span(name):
        yield


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, torch.nn.Module):
        yield from (p.detach() for p in x.parameters())
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)


def nan_check(tree, name: str = "") -> None:
    for i, leaf in enumerate(_leaves(tree)):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in {name} leaf {i}")


def _program_events(spans: List[Dict], anchor: Tuple[int, int], base_ns: int) -> List[Dict]:
    """Spans as Chrome trace complete events of category "program_span"."""
    pid = os.getpid()
    out = []
    for s in spans:
        args = {k: (list(v) if isinstance(v, tuple) else v) for k, v in s.items()
                if k not in ("name", "start_ns", "end_ns", "thread")}
        ts = trace_us(s["start_ns"], anchor, base_ns)
        out.append({"ph": "X", "cat": "program_span", "name": s["name"], "pid": pid,
                    "tid": s["thread"], "ts": ts,
                    "dur": trace_us(s["end_ns"], anchor, base_ns) - ts, "args": args})
    return out


def _counts_between(before: Dict, after: Dict) -> Dict[str, List[Dict]]:
    """The counts made between two snapshots' counters, as JSON rows."""
    out = {}
    for name, c in after.items():
        was = before.get(name, {})
        rows = [{"key": json.loads(json.dumps(k)), "calls": n - was.get(k, 0)}
                for k, n in c.items() if n > was.get(k, 0)]
        if rows:
            out[name] = rows
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a `torch.profiler` trace (CPU, and CUDA when a device is
    present) and write it to `log_dir/trace.json` (Chrome trace format),
    with the spans that ended inside it and the counts made during it. The tracer is turned on for the
    capture where it was off (a new record) and off again after it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = ON
    if not was_on:
        enable()
    counted = snapshot()["counters"]
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    t0 = time.perf_counter_ns()
    try:
        yield prof
    finally:
        prof.stop()
        snap = snapshot()
        if not was_on:
            disable()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        spans = [s for s in snap["spans"] if s["end_ns"] >= t0]
        trace["traceEvents"] += _program_events(spans, snap["anchor"], trace["baseTimeNanoseconds"])
        trace["programCounters"] = _counts_between(counted, snap["counters"])
        with open(path, "w") as f:
            json.dump(trace, f)
