"""The device trace of one profiled unit of work (a served microbatch or a
single edit), reduced to what the per-layer metrics and the result's
breakdown read: device busy seconds, kernel seconds by name and by kind,
and idle gaps by what the host was doing.

`torch.profiler` writes its Chrome trace under the run's temporary
directory; it is read and deleted at once.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
LABELLED_GAPS = 2000  # the longest gaps, each named by the host event under it
HOST_LOOKBACK = 1500  # host events searched back from a gap's middle


def kernel_kind(name: str) -> str:
    """A device kernel's kind by its name: K3 (the relative-position
    bias instance) "k3", K1 "k1", else "other"."""
    n = name.lower()
    if "relpos2d" in n:
        return "k3"
    return "k1" if "flash_fwd" in n else "other"


class Profiled:
    """`with Profiled(tmpdir) as p:` profiles the block; `p.summary()`,
    called once the measured window is over, reads the trace (None where
    the profiler saw no device time)."""

    def __init__(self, tmpdir: str):
        self.tmpdir = tmpdir
        self.window_s = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        # the device's activity and the CUDA runtime calls alone: recording
        # every host operator would slow the host-paced steps it measures
        self._cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA] if self._cuda else [ProfilerActivity.CPU]
        if self._cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def summary(self) -> Optional[Dict]:
        path = os.path.join(self.tmpdir, f"trace-{os.getpid()}.json")
        self._prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return reduce_events(events, self.window_s)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce_events(events: List[dict], window_s: float) -> Optional[Dict]:
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["dur"]), e.get("name", "?")))
        elif cat in HOST_CATS:
            host.append((float(e["ts"]), float(e["dur"]), e.get("name", "?")))
    if not dev:
        return None
    by_name: Dict[str, float] = defaultdict(float)
    by_kind: Dict[str, float] = defaultdict(float)
    for _, dur, name in dev:
        by_name[name] += dur * 1e-6
        by_kind[kernel_kind(name)] += dur * 1e-6
    busy = _union([(ts, ts + dur) for ts, dur, _ in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    # the longest gaps between busy spans, each named by the innermost host
    # event at its middle; the rest summed as short gaps
    host.sort()
    starts = [ts for ts, _, _ in host]
    spans = sorted(((b_start - a_end, a_end, b_start)
                    for (_, a_end), (b_start, _) in zip(busy, busy[1:])), reverse=True)
    gaps: Dict[str, float] = defaultdict(float)
    for rank, (length, a_end, b_start) in enumerate(spans):
        if rank >= LABELLED_GAPS:
            gaps["short gaps, each under %.3f ms" % (spans[LABELLED_GAPS][0] * 1e-3)] += length * 1e-6
            continue
        mid, best = (a_end + b_start) / 2, None
        i = bisect.bisect_right(starts, mid)
        for ts, dur, name in reversed(host[max(0, i - HOST_LOOKBACK):i]):
            if ts + dur >= mid and (best is None or dur < best[0]):
                best = (dur, name)
        gaps["host in " + best[1] if best else "host outside CUDA calls"] += length * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernel_s": dict(by_kind),
        "device_ops": [[n[:120], s] for n, s in top],
        "idle_gaps": [[n[:120], s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }
