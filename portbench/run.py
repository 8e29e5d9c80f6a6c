"""Run one cell of `BENCHMARK.json` once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The configuration's kind
(`portbench/kinds/<kind>.py`, "edit" where its file names none) draws the
weights on the card from the seed and builds the program from them; the
cell's driver warms up the cell's shapes, then measures for `--seconds`. With `--trace 0`
the result carries the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, read by `portbench/metrics/<name>.py` from the traced
run's records. After the window the reference checks a sample of the
answers (`correct.py`). The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import MappingProxyType
from typing import Dict, Optional

_T0 = time.perf_counter()

import torch  # noqa: E402

from . import configs, correct, flops, port, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "instructany2pix_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules():
    """Top-level names in `sys.modules` that the run must not hold, each
    compared whole (the program's name begins with the JAX package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_plugin(path: str, name: str):
    """A kind, driver or metric module from its file."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Run:
    """One run of one cell: what its driver and metrics read and record."""

    def __init__(self, root: str, cell: str, seed: int, seconds: float, trace_on: bool, device,
                 tmpdir: str):
        self.seed = int(seed)
        self.seconds, self.trace, self.device, self.tmpdir = seconds, trace_on, device, tmpdir
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        matches = [w for w in self.bench["workloads"] if w["name"] == cell]
        if not matches:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
        self.cell = matches[0]
        with open(os.path.join(root, "portbench", "workloads", f"{cell}.json")) as f:
            self.wl = json.load(f)
        self.limits = MappingProxyType(dict(self.wl["limits"]))  # before any kind's code runs
        self.cfg_json = configs.load(self.wl["config"], os.path.join(root, "portbench", "configs"))
        kind = self.cfg_json.get("kind", "edit")
        self.kind = load_plugin(os.path.join(root, "portbench", "kinds", f"{kind}.py"),
                                f"portbench_kind_{kind}")
        self.cfgs = self.kind.cfgs(self.cfg_json)
        self.driver = load_plugin(os.path.join(root, "portbench", "drivers", f"{self.wl['driver']}.py"),
                                  f"portbench_driver_{self.wl['driver']}")
        self.pipe = None
        self.setup_s: Optional[float] = None
        self.profiled: Optional[trace.Profiled] = None
        self.profile: Optional[Dict] = None
        self.kernel_calls = []
        self._requests: Dict[int, object] = {}
        self._lock = threading.Lock()
        self.late_draws = 0  # requests first drawn inside the window
        self.traffic = self.kind.traffic(self)

    def request(self, i: int):
        with self._lock:
            if i not in self._requests:
                self._requests[i] = self.traffic.request(i)
                self.late_draws += self.setup_s is not None
            return self._requests[i]

    def prefill(self, n: int):
        """Requests 0..n-1 drawn before the window, four at a time (the
        drawing and the image writes release the GIL)."""
        with ThreadPoolExecutor(4) as pool:
            for i, req in enumerate(pool.map(self.traffic.request, range(n))):
                self._requests.setdefault(i, req)

    def sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def mark_window_start(self):
        self.setup_s = process_age_s()

    @contextlib.contextmanager
    def profiled_unit_context(self):
        """The profiler and the K1/K3 call log around one unit of work."""
        with trace.Profiled(self.tmpdir) as prof, port.KernelCalls() as calls:
            yield
        self.profiled = prof
        self.kernel_calls = calls.calls

    def warm_profiler(self):
        with trace.Profiled(self.tmpdir):
            torch.ones(8, device=self.device).sum()

    def free_program(self):
        for name in ("server", "recorder", "steps"):
            if hasattr(self, name):
                delattr(self, name)
        self.pipe = None
        self._requests = {}

    def records(self, outcome) -> Dict:
        """What the per-layer metrics read."""
        self.profile = self.profiled.summary() if self.profiled is not None else None
        units = outcome["units"]
        unit_flops = [self.kind.unit_flops(self, u) for u in units]
        bounds: Dict[str, float] = {}
        for kernel, q, k, causal, dtype in self.kernel_calls:
            bounds[kernel] = bounds.get(kernel, 0.0) + (
                flops.k1_bound_s(q, k, causal, dtype) if kernel == "k1" else flops.k3_bound_s(q))
        return {"driver": self.wl["driver"], "window_s": outcome["window_s"], "units": units,
                "unit_flops": unit_flops, "unet_stages": outcome["unet_stages"],
                "profile": self.profile, "kernel_bounds_s": bounds,
                "peak_flops": flops.PEAK_BF16}


def run_cell(root: str, cell: str, seed: int, seconds: float, trace_on: bool, device,
             tmpdir: str) -> Dict:
    """One run of `cell` → the result object (without the chip check)."""
    run = Run(root, cell, seed, seconds, trace_on, device, tmpdir)
    run.kind.build(run)
    with port.StepLog() as run.steps:
        run.driver.setup(run)
        outcome = run.driver.window(run)
    run.sync()
    if run.late_draws:
        print(f"portbench: {run.late_draws} requests were drawn inside the window, past the "
              f"{run.wl['prefill']} drawn before it", file=sys.stderr)
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics: Dict[str, Dict] = {}
    if trace_on:
        records = run.records(outcome)
        for m in run.bench["per_layer"]:
            if not applies(m, cell):
                continue
            reader = load_plugin(os.path.join(root, "portbench", "metrics", f"{m['name']}.py"),
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(records)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in run.bench["end_to_end"]:
            if applies(m, cell):
                value = run.setup_s if m["name"] == "setup_s" else outcome["end_to_end"][m["name"]]
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted, failed = outcome["attempted"], outcome["failed"]
    ok, checks = correct.check(run, outcome)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                   "count": int(run.cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace_on and run.profile is not None:
        device_info["busy_s"] = run.profile["busy_s"]
        device_info["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = os.getcwd()
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    chips = int(cells[a.workload]["chips"]) if a.workload in cells else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    importlib.import_module(port.PROGRAM)  # a checkout without the program stops here
    # every build and kernel cache stays inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(root, "build", sub))
    tmpdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        result = run_cell(root, a.workload, a.seed, a.seconds, bool(a.trace), "cuda", tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}, which nothing it runs may import", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
