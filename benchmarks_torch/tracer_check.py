#!/usr/bin/env python3
"""The port's tracer (`utils/profiling.py`) on the card: its spans on the
device trace's clock, its K1 counter against the kernels, and its cost.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

  python3 benchmarks_torch/tracer_check.py --out build/tracer_check.json

1. Clock. Under `profiling.device_trace`, K1 is launched once inside each
   of TRIALS "probe" spans, with SLEEP_S of idle host time on each side.
   Then K1 is launched once, a DDIM loop (`sampler.loop_denoise`, STEPS
   steps) runs whose eps function launches K1 twice, and K1 is launched
   once more, SLEEP_S apart. On the trace's clock, each probe span holds
   exactly one K1 launch (the runtime call whose correlation id is a K1
   kernel's), each "unet_step" span exactly two, and the launches before
   and after the loop fall in no span. The spans are placed by the one
   anchor the tracer takes when enabled, so a misplaced anchor moves every
   span off its launches; the smallest margins between a span's edges and
   its launch bound the anchor's error on each side.
2. Counter. The trace's "programCounters" hold as many K1 calls as the
   trace has K1 kernels, at the shapes called.
3. Cost. The host's time per K1 call at a shape the card keeps up with,
   with the tracer off and on (on, the entry point's only extra work is
   its counter), per count as the entry point makes it, per "unet_step"
   span, and per span that reads the allocator ("request", "batch"), off
   and on, in rounds taken in turn.

The last line of output is the JSON summary; --out also writes it.
Exit status 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

TRIALS = 50
STEPS = 10
SLEEP_S = 0.002
SHAPE = (1, 2, 128, 64)  # K1's work here is a few µs: the host sets the pace
COST_CALLS = 20_000
COST_SPANS = 100_000
COST_ROUNDS = 5


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def k1_launches(events):
    """The trace's K1 launches as (start µs, end µs), in time order, and
    the number of K1 kernels."""
    k1 = {e["args"]["correlation"] for e in events
          if e.get("cat") == "kernel" and "flash_fwd" in e.get("name", "").lower()}
    launches = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat", "").startswith("cuda_") and e.get("ph") == "X"
                      and e.get("args", {}).get("correlation") in k1)
    return launches, len(k1)


def clock_and_counter(fa, profiling, sampler, torch, failures):
    q = torch.randn(SHAPE, device="cuda", dtype=torch.bfloat16)

    def k1():
        fa.flash_attention(q, q, q)

    class Schedule:
        def ddim_step(self, eps, t, t_prev, lat):
            return lat - 0.01 * eps

    def eps_fn(lat, t, i):
        time.sleep(SLEEP_S / 4)
        k1()
        k1()
        return torch.zeros_like(lat)

    for _ in range(3):
        k1()
    torch.cuda.synchronize()
    log_dir = tempfile.mkdtemp(prefix="tracer-check-")
    with torch.inference_mode(), profiling.device_trace(log_dir):
        for i in range(TRIALS):
            time.sleep(SLEEP_S)
            with profiling.span("probe", step=i):
                k1()
            time.sleep(SLEEP_S)
        k1()
        time.sleep(SLEEP_S)
        sampler.loop_denoise(eps_fn, Schedule(), torch.zeros(2, 4, device="cuda"),
                             list(range(STEPS, 0, -1)))
        time.sleep(SLEEP_S)
        k1()
        torch.cuda.synchronize()
    with open(os.path.join(log_dir, "trace.json")) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    launches, kernels = k1_launches(events)
    spans = {name: sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                          if e.get("cat") == "program_span" and e["name"] == name)
             for name in ("probe", "unet_step")}
    out = {"k1_launches": len(launches), "k1_kernels": kernels,
           "spans": {n: len(s) for n, s in spans.items()}}
    want = TRIALS + 2 * STEPS + 2
    if len(launches) != want or kernels != want:
        failures.append(f"clock: {len(launches)} K1 launches and {kernels} kernels, not {want}")
    held = {n: [[l for l in launches if a <= l[0] and l[1] <= b] for a, b in s]
            for n, s in spans.items()}
    for name, per, each in (("probe", held["probe"], 1), ("unet_step", held["unet_step"], 2)):
        counts = [len(h) for h in per]
        out[f"{name}_launch_counts"] = sorted(set(counts))
        if len(per) != (TRIALS if name == "probe" else STEPS) or set(counts) != {each}:
            failures.append(f"clock: {name} spans hold {counts} K1 launches, not {each} each")
    inside = {l for per in held.values() for h in per for l in h}
    out["launches_outside_spans"] = len(launches) - len(inside)
    if len(launches) - len(inside) != 2:
        failures.append(f"clock: {len(launches) - len(inside)} launches outside every span, not 2")
    loop = [l for h in held["unet_step"] for l in h]
    out["loop_launches_in_unet_step_pct"] = 100.0 * len(loop) / (2 * STEPS)
    # how far the anchor could be off before a span loses its launch (µs)
    pairs = [(a, b, h[0]) for (a, b), h in zip(spans["probe"], held["probe"]) if len(h) == 1]
    if pairs:
        out["margin_before_us"] = min(l[0] - a for a, _, l in pairs)
        out["margin_after_us"] = min(b - l[1] for _, b, l in pairs)
        out["probe_span_us_median"] = statistics.median(b - a for a, b, _ in pairs)
    counted = trace.get("programCounters", {}).get("k1", [])
    out["k1_counted"] = sum(r["calls"] for r in counted)
    out["k1_counted_keys"] = [r["key"] for r in counted]
    if out["k1_counted"] != kernels or [r["key"][0] for r in counted] != [list(SHAPE)]:
        failures.append(f"counter: {counted} against {kernels} K1 kernels of shape {SHAPE}")
    return out


def cost(fa, profiling, torch):
    """Host µs per K1 call, per count, per "unet_step" span and per span
    that reads the allocator, off and on, medians of COST_ROUNDS rounds in
    turn."""
    q = torch.randn(SHAPE, device="cuda", dtype=torch.bfloat16)

    def k1_calls():
        for _ in range(COST_CALLS):
            fa.flash_attention(q, q, q)
        torch.cuda.synchronize()

    def counts():  # the K1 entry point's counter alone, as its call site makes it
        for _ in range(COST_SPANS):
            if profiling.ON:
                profiling.count("k1", (q.shape, q.shape, False, q.dtype))

    def steps():
        for i in range(COST_SPANS):
            with profiling.span("unet_step", rows=2, loop="denoise", step=i):
                pass

    def memory_spans():
        for _ in range(COST_SPANS // 100):
            with profiling.span("batch", memory=True):
                pass

    work = {"k1_call": (k1_calls, COST_CALLS), "k1_count": (counts, COST_SPANS),
            "unet_step_span": (steps, COST_SPANS),
            "memory_span": (memory_spans, COST_SPANS // 100)}
    got = {f"{n}_{side}": [] for n in work for side in ("off", "on")}
    with torch.inference_mode():
        k1_calls()
        for r in range(COST_ROUNDS):
            for on in ((False, True) if r % 2 == 0 else (True, False)):
                for name, (fn, n) in work.items():
                    if on:
                        profiling.enable(capacity=2 * COST_SPANS)
                    t0 = time.perf_counter()
                    fn()
                    dt = time.perf_counter() - t0
                    profiling.disable()
                    profiling.clear()
                    got[f"{name}_{'on' if on else 'off'}"].append(dt / n * 1e6)
    out = {k: statistics.median(v) for k, v in got.items()}
    for name in work:
        out[f"{name}_added_us"] = out[f"{name}_on"] - out[f"{name}_off"]
    out["rounds"] = got
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the summary to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("tracer_check: no CUDA device", file=sys.stderr)
        return 2
    from instructany2pix_tpu_torch.diffusion import sampler
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.utils import profiling

    failures: list = []
    result = {"card": card_line(), "torch": torch.__version__}
    result["clock"] = clock_and_counter(fa, profiling, sampler, torch, failures)
    result["cost"] = cost(fa, profiling, torch)
    result["failures"] = failures
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    print(text)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
