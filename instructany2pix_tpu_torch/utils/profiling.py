"""Tracing and profiling helpers, counterpart of the JAX package's
`utils/profiling.py`:

  * `stage(name)` — a context manager that records the seconds of a stage
    into every active `collect_stages()` and opens a `torch.profiler`
    record-function range of that name, so stages show in device traces.
    On a CUDA device it synchronizes before reading the clock at the end,
    as the JAX timings block on their results.
  * `StageTimes` — the collected seconds by stage.
  * `nan_check(x, name)` — raise on non-finite values in a tensor, a
    module's parameters, or a nested dict, list or tuple of tensors.
  * `device_trace(log_dir)` — a `torch.profiler` capture of CPU and CUDA
    activity written as a Chrome trace into `log_dir`.

The pipeline keeps its own `_stage`, which writes `stage_times`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


class StageTimes:
    def __init__(self):
        self.times: Dict[str, float] = {}

    def __repr__(self):
        inner = ", ".join(f"{k}={v * 1e3:.1f}ms" for k, v in self.times.items())
        return f"StageTimes({inner})"


_ACTIVE: list = []


@contextlib.contextmanager
def collect_stages():
    st = StageTimes()
    _ACTIVE.append(st)
    try:
        yield st
    finally:
        _ACTIVE.pop()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage(name: str):
    _sync()
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _sync()
    dt = time.perf_counter() - t0
    for st in _ACTIVE:
        st.times[name] = st.times.get(name, 0.0) + dt


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


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a `torch.profiler` trace (CPU, and CUDA when a device is
    present) and write it to `log_dir/trace.json` (Chrome trace format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
