"""The batched server under a closed loop: `clients` users each send a
request, wait for its image and send the next, through
`PipelineServer.submit` (`max_batch`, `max_wait_s`).

The window starts when the first microbatch starts with every client's
first request queued, and ends when the microbatch in flight at
`--seconds` completes; `served_requests_per_s` is every request answered
in it over its length. A traced run profiles the window's second
microbatch and records each microbatch's stage seconds. Every run keeps
each microbatch's DDIM steps for the comparison.
"""

from __future__ import annotations

import threading
import traceback
import time
from concurrent.futures import TimeoutError as FutureTimeout

from portbench import port
from portbench.flops import refiner_steps

UNET_STAGES = ("serve_inversion", "serve_denoise", "serve_refiner")
WARMUP_INDEX = 1_000_000  # warm-up requests are drawn past the measured ones


class Recorder:
    """The benchmark's span around each microbatch (`_run_batch`)."""

    def __init__(self, run):
        self.run = run
        self.units = []
        self.non_refined = {}  # request index → the served non-refined image
        self.in_flight = None
        self.profiled_unit = None
        self._ctx = None

    def start(self, indices):
        run = self.run
        if run.trace:
            run.pipe.stage_times = {}
            if len(self.units) == self.profiled_unit:
                self._ctx = run.profiled_unit_context()
                self._ctx.__enter__()
        run.steps.unit = []
        self.in_flight = time.perf_counter()
        return self.in_flight

    def end(self, t0, indices, ok):
        run = self.run
        profiled = self._ctx is not None
        if profiled:
            ctx, self._ctx = self._ctx, None
            ctx.__exit__(None, None, None)
        stages = dict(run.pipe.stage_times or {})
        steps, run.steps.unit = run.steps.unit, None
        self.units.append({"start": t0, "end": time.perf_counter(), "rows": len(indices),
                           "indices": indices, "ok": ok, "stages": stages, "profiled": profiled,
                           "steps": steps})
        self.in_flight = None


def setup(run):
    wl = run.wl
    if run.trace:  # the profiler starts once on this thread before the worker's
        run.warm_profiler()
    run.recorder = Recorder(run)
    run.server = port.make_server(run.pipe, wl["max_batch"], wl["max_wait_s"], run.recorder)
    warm = [run.request(WARMUP_INDEX + i) for i in range(wl["max_batch"])]
    futs = [run.server.submit(port.served_request(
        r, wl["warmup_steps"], wl["cfg"], wl["warmup_steps"] / 50, wl["scale"])) for r in warm]
    for f in futs:
        f.result()
    run.sync()
    run.recorder.units.clear()
    run.recorder.non_refined.clear()
    run.prefill(wl["prefill"])


def window(run):
    wl, server, rec = run.wl, run.server, run.recorder
    rec.profiled_unit = 1
    results, lock = [], threading.Lock()
    counter = iter(range(10**9))
    over, drained = threading.Event(), threading.Event()

    def client():
        while not over.is_set():
            with lock:
                i = next(counter)
            req = run.request(i)
            t0 = time.perf_counter()
            fut = server.submit(port.served_request(req, wl["steps"], wl["cfg"], wl["refinement"],
                                                    wl["scale"]))
            while True:
                try:
                    res = fut.result(timeout=0.2)
                except FutureTimeout:
                    if drained.is_set() and not fut.done():
                        return  # queued past the window's end: never run
                    continue
                except Exception as e:  # noqa: BLE001 — a failed request is counted, and shown
                    traceback.print_exception(e)
                    res = e
                break
            with lock:
                results.append((req, res, t0, time.perf_counter()))

    threads = [threading.Thread(target=client, daemon=True) for _ in range(wl["clients"])]
    for t in threads:
        t.start()
    while not rec.units and rec.in_flight is None:
        time.sleep(0.001)
    start = rec.in_flight if rec.in_flight is not None else rec.units[0]["start"]
    run.mark_window_start()
    time.sleep(max(0.0, start + run.seconds - time.perf_counter()))
    t_stop = time.perf_counter()
    over.set()
    in_flight = rec.in_flight
    server.scheduler._stop.set()  # no microbatch starts once this one ends
    while server.scheduler._thread.is_alive():
        server.stop()
    drained.set()
    for t in threads:
        t.join(timeout=60)
    ended = [u for u in rec.units if u["start"] >= start]
    end = max(u["end"] for u in ended if u["start"] <= t_stop) if in_flight is not None else t_stop
    units = [u for u in ended if u["end"] <= end]
    # a request belongs to the window when its microbatch ended in it
    where = {i: (u, j) for u in units if u["ok"] for j, i in enumerate(u["indices"])}
    answered = [(req, {"non_refined": rec.non_refined[req.index], "refined": res.image,
                       "steps": where[req.index][0]["steps"], "row": where[req.index][1]})
                for req, res, _, _ in results if req.index in where]
    steps = {"serve_inversion": wl["steps"], "serve_denoise": wl["steps"],
             "serve_refiner": refiner_steps(wl["refinement"])}
    return {
        "window_s": end - start,
        "attempted": sum(u["rows"] for u in units),
        "failed": sum(u["rows"] for u in units if not u["ok"]),
        "answered": answered,
        "end_to_end": {"served_requests_per_s": len(where) / (end - start)},
        "units": [u for u in units if u["ok"]],
        "unet_stages": steps,
    }
