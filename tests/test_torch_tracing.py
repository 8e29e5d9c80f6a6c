"""The port's tracer (`utils/profiling.py`) and its call sites: spans and
counters off by default, nesting and ids, the clock anchor against a CPU
`torch.profiler` trace, the batch scheduler's request and batch spans, the
pipeline's stage timing without a sync, the UNet step spans and K1's and
K3's call counters by shape. CPU only; the CUDA calls are stood in for."""

from __future__ import annotations

import contextlib
import json
import threading
import time
import types

import pytest
import torch

from instructany2pix_tpu_torch import pipeline as tpl
from instructany2pix_tpu_torch import serving
from instructany2pix_tpu_torch.diffusion import sampler
from instructany2pix_tpu_torch.ops import flash_attention as fa
from instructany2pix_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with the tracer off and its record empty."""
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


def by_name(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


class FakeEvent:
    """`torch.cuda.Event` on a fake device clock that advances 5 ms per
    recorded event."""
    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 5.0
        self.t = FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def pipeline_on(device: str):
    """A pipeline object with only what `_stage` and `stage_times` use."""
    pipe = object.__new__(tpl.InstructAny2PixPipeline)
    pipe.device = torch.device(device)
    pipe.stage_times = None
    return pipe


def no_cuda(monkeypatch):
    """Every CUDA read a call site could make raises."""
    def refuse(*a, **kw):
        raise AssertionError("read the device while the tracer is off")

    for name in ("Event", "synchronize", "memory_stats", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(profiling, "_alloc_stats", refuse)
    monkeypatch.setattr(profiling, "Span", refuse)  # the only reader of the clock
    monkeypatch.setattr(profiling, "_Record", refuse)


def test_the_tracer_off_records_nothing_and_reads_no_device(monkeypatch):
    no_cuda(monkeypatch)
    assert not profiling.ON
    with profiling.span("a", rows=2, loop="denoise", step=0, memory=True) as s:
        assert s is None
    with profiling.stage("b"):
        pass
    profiling.end(profiling.begin("request"))
    pipe = pipeline_on("cuda")  # stage timing off as well: no event is made
    with pipe._stage("vae_encode"):
        pass
    assert pipe.stage_times is None
    sched = serving.BatchScheduler(lambda reqs: reqs, max_batch=2, max_wait_s=0.01,
                                    bucket_fn=lambda r: 0).start()
    assert sched.submit("x").result(timeout=10) == "x"
    sched.stop()
    lat = sampler.loop_denoise(lambda x, t, i: torch.zeros_like(x), _StubSchedule(),
                               torch.ones(1, 2), [3, 2, 1])
    assert lat.shape == (1, 2)
    monkeypatch.undo()
    assert profiling.snapshot()["spans"] == [] and profiling.snapshot()["counters"] == {}


class _StubSchedule:
    def ddim_step(self, eps, t, t_prev, lat):
        return lat - 0.1 * eps

    def ddim_inverse_step(self, eps, t_prev, t, lat):
        return lat + 0.1 * eps


def test_nesting_parents_ids_counters_and_the_bounded_buffer():
    profiling.enable(capacity=5)
    with profiling.span("batch", rows=2, memory=True) as outer:
        outer.ids = (7, 8)
        with profiling.span("unet_step", rows=2, loop="invert", step=3) as inner:
            assert inner.parent == outer.id
        req = profiling.begin("request")
        done = threading.Event()
        threading.Thread(target=lambda: (profiling.end(req), done.set())).start()
        assert done.wait(10)
    profiling.count("k1", ((2, 10, 64, 64), (2, 10, 64, 64), False, "torch.bfloat16"))
    profiling.count("k1", ((2, 10, 64, 64), (2, 10, 64, 64), False, "torch.bfloat16"), 2)
    snap = profiling.snapshot()
    (b,), (u,), (r,) = by_name(snap, "batch"), by_name(snap, "unet_step"), by_name(snap, "request")
    assert b["id"] == outer.id and b["ids"] == (7, 8) and b["rows"] == 2 and "parent" not in b
    assert "device_allocs" not in b  # no CUDA in use: the allocator is not read
    assert u["parent"] == b["id"] and (u["loop"], u["step"], u["rows"]) == ("invert", 3, 2)
    assert "parent" not in r and r["id"] not in (b["id"], u["id"])
    for s in (b, u, r):
        assert s["end_ns"] >= s["start_ns"]
    assert b["start_ns"] <= u["start_ns"] <= u["end_ns"] <= b["end_ns"]
    assert snap["counters"] == {"k1": {((2, 10, 64, 64), (2, 10, 64, 64), False,
                                        "torch.bfloat16"): 3}}
    for _ in range(4):
        with profiling.span("x"):
            pass
    snap = profiling.snapshot()
    assert len(snap["spans"]) == 5 and snap["dropped"] == 2
    profiling.disable()
    with profiling.span("after"):
        pass
    assert not by_name(profiling.snapshot(), "after")  # off: kept what it had, adds nothing
    profiling.clear()
    assert profiling.snapshot()["spans"] == [] and profiling.snapshot()["dropped"] == 0


def test_spans_land_inside_the_profiled_op_on_the_trace_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer_op"):
            time.sleep(0.002)
            with profiling.span("inside"):
                torch.ones(256).cumsum(0)
            time.sleep(0.002)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    op = next(e for e in trace["traceEvents"] if e.get("name") == "outer_op")
    snap = profiling.snapshot()
    (s,) = by_name(snap, "inside")
    a = profiling.trace_us(s["start_ns"], snap["anchor"], trace["baseTimeNanoseconds"])
    b = profiling.trace_us(s["end_ns"], snap["anchor"], trace["baseTimeNanoseconds"])
    assert op["ts"] < a < b < op["ts"] + op["dur"]
    # 2 ms of sleep on each side: the span sits well inside, not at an edge
    assert a - op["ts"] > 1000 and op["ts"] + op["dur"] - b > 1000


def test_device_trace_writes_the_programs_spans_beside_the_ops(tmp_path):
    from torch.profiler import record_function

    assert not profiling.ON
    with profiling.device_trace(str(tmp_path / "trace")):
        with record_function("host_op"):
            time.sleep(0.002)
            with profiling.stage("traced"):
                torch.ones(8).cumsum(0)
            time.sleep(0.002)
    assert not profiling.ON  # turned on for the capture only
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (ev,) = [e for e in events if e.get("cat") == "program_span" and e["name"] == "traced"]
    op = next(e for e in events if e.get("name") == "host_op")
    assert ev["ph"] == "X" and op["ts"] < ev["ts"] < ev["ts"] + ev["dur"] < op["ts"] + op["dur"]
    # `stage` also opens a profiler range, seen by a capture of its own
    assert [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "traced"]


def test_device_trace_writes_the_counts_made_during_it(tmp_path):
    """The counters' deltas over the capture go into its trace.json, keys
    made plain: what an operator reads beside the kernels."""
    key = (torch.Size([1, 2, 16, 64]), torch.Size([1, 2, 77, 64]), False, torch.bfloat16)
    profiling.enable()
    profiling.count("k1", key)  # before the capture: left out of it
    profiling.count("k3", key)
    with profiling.device_trace(str(tmp_path / "trace")):
        profiling.count("k1", key)
        profiling.count("k1", key, 2)
    assert profiling.ON  # it was on: the capture leaves it on
    with open(tmp_path / "trace" / "trace.json") as f:
        counted = json.load(f)["programCounters"]
    assert counted == {"k1": [{"key": [[1, 2, 16, 64], [1, 2, 77, 64], False, "torch.bfloat16"],
                               "calls": 3}]}
    plain = ((1, 2, 16, 64), (1, 2, 77, 64), False, "torch.bfloat16")
    assert profiling.snapshot()["counters"] == {"k1": {plain: 4}, "k3": {plain: 1}}


def test_batch_scheduler_request_and_batch_spans():
    """Requests queue behind a running microbatch; each gets a request
    span, each microbatch a batch span with its request ids, and the stage
    spans `run_batch` opens sit under it."""
    def run(reqs):
        with profiling.stage("stage_a"):
            time.sleep(0.05)
        return [r * 10 for r in reqs]

    profiling.enable()
    sched = serving.BatchScheduler(run, max_batch=2, max_wait_s=0.01, bucket_fn=lambda r: 0).start()
    first = sched.submit(1)
    time.sleep(0.02)  # the first microbatch is running: these wait for it
    futs = [first] + [sched.submit(i) for i in (2, 3, 4)]
    assert [f.result(timeout=10) for f in futs] == [10, 20, 30, 40]
    sched.stop()
    snap = profiling.snapshot()
    reqs, batches = by_name(snap, "request"), by_name(snap, "batch")
    runs, stages = by_name(snap, "run_batch"), by_name(snap, "stage_a")
    assert len(reqs) == 4 and len(batches) == 3 and len(runs) == 3 and len(stages) == 3
    assert [b["rows"] for b in batches] == [1, 2, 1]
    assert sorted(i for b in batches for i in b["ids"]) == sorted(r["id"] for r in reqs)
    run_of = {r["parent"]: r for r in runs}
    for b in batches:
        r = run_of[b["id"]]
        assert b["start_ns"] <= r["start_ns"] <= r["end_ns"] <= b["end_ns"]
        (st,) = [s for s in stages if s["parent"] == r["id"]]
        assert r["start_ns"] <= st["start_ns"]
        for rid in b["ids"]:  # every request waits from submit to its batch's run
            (q,) = [x for x in reqs if x["id"] == rid]
            assert q["start_ns"] <= r["start_ns"] and q["end_ns"] >= r["end_ns"]
    # the second microbatch's requests waited about one microbatch
    wait = runs[1]["start_ns"] - min(x["start_ns"] for x in reqs if x["id"] in batches[1]["ids"])
    assert wait > 0.02e9


def test_stage_times_by_cuda_events_without_a_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)

    def refuse(*a, **kw):
        raise AssertionError("_stage synchronized the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    pipe = pipeline_on("cuda")
    pipe.stage_times = {}
    profiling.enable()
    for name in ("prior", "denoise", "prior"):
        with pipe._stage(name):
            pass
    assert pipe._stage_events and not pipe._stage_times  # nothing read before the unit's end
    pipe._settle_stages()  # where the unit's images reached the host
    assert pipe._stage_events == []
    assert pipe._stage_times == {"prior": 0.010, "denoise": 0.005}  # 5 ms a stage, prior twice
    with pipe._stage("denoise"):
        pass
    assert pipe.stage_times == {"prior": 0.010, "denoise": 0.010}  # read early: settled there
    assert pipe._stage_events == []
    assert [s["name"] for s in profiling.snapshot()["spans"]] == ["prior", "denoise", "prior",
                                                                   "denoise"]
    pipe.stage_times = {}  # a new dict starts afresh
    assert pipe.stage_times == {}
    with pytest.raises(RuntimeError), pipe._stage("vae_decode"):
        raise RuntimeError("a failed stage records no time")
    assert pipe.stage_times == {}


def test_stage_times_on_the_cpu_by_the_host_clock():
    pipe = pipeline_on("cpu")
    pipe.stage_times = {}
    with pipe._stage("vae_encode"):
        time.sleep(0.01)
    assert 0.01 <= pipe.stage_times["vae_encode"] < 1.0


def test_unet_step_spans_one_per_step():
    profiling.enable()
    eps = lambda x, t, i: torch.zeros_like(x)  # noqa: E731
    sampler.loop_invert(eps, _StubSchedule(), torch.ones(3, 2), [1, 2])
    sampler.loop_denoise(eps, _StubSchedule(), torch.ones(3, 2), [3, 2, 1])
    steps = by_name(profiling.snapshot(), "unet_step")
    assert [(s["loop"], s["step"], s["rows"]) for s in steps] == [
        ("invert", 0, 3), ("invert", 1, 3), ("denoise", 0, 3), ("denoise", 1, 3),
        ("denoise", 2, 3)]


class _AsCuda(torch.Tensor):
    """A CPU tensor that K1's and K3's input checks take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def _as_cuda(t):
    return torch.Tensor._make_subclass(_AsCuda, t)


@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_kernel_call_counter_by_shape(monkeypatch, kernel):
    """K1's and K3's launch entry points count calls by (q shape, k shape,
    causal, dtype) while the tracer is on, the library stood in for."""
    monkeypatch.setattr(fa, "_lib", lambda: (lambda *a: 0, lambda: 1))
    monkeypatch.setattr(fa, "_relpos2d_lib", lambda: (lambda *a: 0, lambda: 1))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: types.SimpleNamespace(
        cuda_stream=0))
    for fn in (fa.flash_fwd_cuda, fa.flash_relpos2d_cuda):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_path", dict.fromkeys(fa.K1_PATHS, 0))

    def call(b, n, causal=False):
        q, k, v = (_as_cuda(torch.zeros(b, 2, n, 64, dtype=torch.bfloat16)) for _ in range(3))
        if kernel == "k1":
            fa.flash_fwd_cuda(q, k, v, causal, 0.25)
        else:
            g = int(n ** 0.5)
            bh, bw = (_as_cuda(torch.zeros(b, 2, n, g)) for _ in range(2))
            fa.flash_relpos2d_cuda(q, k, v, bh, bw, 0.25)

    call(1, 16)  # off: not counted
    profiling.enable()
    call(1, 16)
    call(1, 16)
    call(2, 64)
    if kernel == "k1":
        call(1, 16, causal=True)
    counts = profiling.snapshot()["counters"][kernel]
    bf16 = "torch.bfloat16"
    want = {((1, 2, 16, 64), (1, 2, 16, 64), False, bf16): 2,
            ((2, 2, 64, 64), (2, 2, 64, 64), False, bf16): 1}
    if kernel == "k1":
        want[((1, 2, 16, 64), (1, 2, 16, 64), True, bf16)] = 1
    assert counts == want
    launched = fa.flash_fwd_cuda if kernel == "k1" else fa.flash_relpos2d_cuda
    assert launched.launches == 1 + sum(want.values())


def test_threads_lose_no_span_or_count():
    """Many threads recording at once, with the interpreter switching
    threads as often as it can: every span and every count is kept, ids
    are unique, and each thread's spans nest under its own."""
    import os
    import sys

    workers, rounds = 4 * (os.cpu_count() or 1), 50
    profiling.enable()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(w):
            for i in range(rounds):
                with profiling.span("outer", rows=w):
                    with profiling.span("inner", rows=w, step=i):
                        profiling.count("k1", (w % 3,))

        threads = [threading.Thread(target=work, args=(w,)) for w in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = profiling.snapshot()
    spans = {s["id"]: s for s in snap["spans"]}
    assert len(spans) == len(snap["spans"]) == 2 * workers * rounds and snap["dropped"] == 0
    assert sum(snap["counters"]["k1"].values()) == workers * rounds
    for s in spans.values():
        if s["name"] == "inner":
            assert spans[s["parent"]]["name"] == "outer" and spans[s["parent"]]["rows"] == s["rows"]
