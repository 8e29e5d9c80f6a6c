"""One user sending one request at a time through the configuration
kind's `single_call` (for the edit, `InstructAny2PixPipeline.__call__(...,
use_cache=True)`, with `pipe.cache` set to the request's given LLM answer).

The window starts with the first timed request and ends when the request
in flight at `--seconds` returns its image; `request_latency_s` is the sum
of the requests' times, from the call to the image on the host, over
their number. A traced run profiles the window's second request and
records each request's stage seconds. Every run keeps each request's DDIM
steps for the comparison, with the answer `single_call` returns.
"""

from __future__ import annotations

import contextlib
import time
import traceback

from portbench.flops import refiner_steps

WARMUP_INDEX = 1_000_000  # warm-up requests are drawn past the measured ones


def setup(run):
    wl = run.wl
    run.kind.single_call(run, run.request(WARMUP_INDEX), wl["warmup_steps"],
                         wl["warmup_steps"] / 50)
    run.sync()
    run.prefill(wl["prefill"])


def window(run):
    wl = run.wl
    units, answered = [], []
    start = time.perf_counter()
    run.mark_window_start()
    i, failed = 0, 0
    while True:
        req = run.request(i)
        ctx = run.profiled_unit_context() if run.trace and i == 1 else contextlib.nullcontext()
        if run.trace:
            run.pipe.stage_times = {}
        run.steps.unit = []
        t0 = time.perf_counter()
        try:
            with ctx:
                answer = run.kind.single_call(run, req, wl["steps"], wl["refinement"])
            answered.append((req, dict(answer, steps=run.steps.unit, row=0)))
            ok = True
        except Exception:  # noqa: BLE001 — a failed request is counted, and shown
            traceback.print_exc()
            failed, ok = failed + 1, False
        t1 = time.perf_counter()
        run.steps.unit = None
        units.append({"start": t0, "end": t1, "rows": 1, "ok": ok, "profiled": run.trace and i == 1,
                      "stages": dict(run.pipe.stage_times or {})})
        i += 1
        if t1 - start >= run.seconds:
            break
    end = units[-1]["end"]
    busy = sum(u["end"] - u["start"] for u in units)
    return {
        "window_s": end - start,
        "attempted": len(units),
        "failed": failed,
        "answered": answered,
        "end_to_end": {"request_latency_s": busy / len(units)},
        "units": [u for u in units if u["ok"]],
        "unet_stages": {"ddim_inversion": wl["steps"], "denoise": wl["steps"],
                        "refiner": refiner_steps(wl["refinement"])},
    }
