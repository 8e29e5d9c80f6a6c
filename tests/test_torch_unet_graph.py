"""The piecewise CUDA-graph runner of the UNet forward
(`diffusion/unet_graph.py`) on the CPU, with both CUDA sides stood in for:
a graph backend whose segments record the aten ops run while they are
captured and replay them on the same tensors (so an input read where it
lay at capture, or a number baked in, shows as a wrong result), and K1 as
its plain version writing into the buffer it is given. Each graphed ε is
held bit-identical to the eager forward of a copy of the UNet."""

from __future__ import annotations

import contextlib
import copy
import threading
import types
import warnings

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from instructany2pix_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh, use_mesh
from instructany2pix_tpu_torch.core.staging import StagedParams
from instructany2pix_tpu_torch.diffusion import pnp, sampler, unet_graph
from instructany2pix_tpu_torch.diffusion.schedulers import Schedule
from instructany2pix_tpu_torch.models import unet as unet_lib
from instructany2pix_tpu_torch.ops import attention
from instructany2pix_tpu_torch.ops import flash_attention as fa
from instructany2pix_tpu_torch.parallel import sharding
from instructany2pix_tpu_torch.utils import profiling
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)


def _tensors(x):
    return [t for t in (x if isinstance(x, (list, tuple)) else [x]) if isinstance(t, torch.Tensor)]


class _Recorder(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("a host sync inside a captured segment")
        out = func(*args, **(kwargs or {}))
        self.ops.append((func, args, kwargs or {}, out))
        return out


class FakeGraph:
    """A segment: the ops run between `capture_begin` and `capture_end`,
    replayed in order on the recorded tensors. A view keeps aliasing what
    it aliased; an in-place op runs again; another op's result is written
    over the tensor it gave at capture. Views and allocations launch
    nothing: a segment of those alone is empty."""

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.pool, self.ops = pool, []
        self._mode = _Recorder(self.ops)
        self._mode.__enter__()

    def capture_end(self):
        self._mode.__exit__(None, None, None)
        if all(func.is_view or func.__name__.startswith("empty") for func, *_ in self.ops):
            # nothing launched: PyTorch warns so
            warnings.warn("The CUDA Graph is empty. This usually means that the graph was "
                          "attempted to be captured on wrong device or stream.")

    def replay(self):
        for func, args, kwargs, out in self.ops:
            if func.is_view:
                continue
            new = func(*args, **kwargs)
            if not func._schema.is_mutable:
                for o, n in zip(_tensors(out), _tensors(new)):
                    o.copy_(n)


class FakeGraphs:
    """The graph backend on the CPU."""

    def __init__(self):
        self.graphs, self.pools = [], 0

    @staticmethod
    def usable(t):
        return True

    def pool(self):
        self.pools += 1
        return object()

    def graph(self):
        self.graphs.append(FakeGraph())
        return self.graphs[-1]

    def capturing(self, device):
        return contextlib.nullcontext()

    @staticmethod
    def alias(t):
        return t


def stand_in_k1(q, k, v, causal, scale, return_lse=False, kv_len=None, out=None):
    """K1 as its plain version, writing `out` when given."""
    o = fa._reference_attention(q, k, v, causal, scale)
    return o if out is None else out.copy_(o)


@pytest.fixture
def fake(monkeypatch):
    backend = FakeGraphs()
    monkeypatch.setattr(unet_graph, "BACKEND", backend)
    monkeypatch.setattr(fa, "flash_fwd_cuda", stand_in_k1)
    return backend


CFG = unet_lib.UNetConfig.tiny(with_ip=True)


def _net(seed=0, dtype=torch.float32):
    torch.manual_seed(seed)
    return unet_lib.UNet(CFG).to(dtype).requires_grad_(False)


def _cond(seed, rows=1, ctx_len=5):
    g = torch.Generator().manual_seed(seed)

    def r(*s):
        return torch.randn(*s, generator=g)

    return dict(ctx=r(rows, ctx_len, 32), ctx_uncond=r(rows, ctx_len, 32),
                pooled=r(rows, CFG.pooled_dim), pooled_uncond=r(rows, CFG.pooled_dim),
                time_ids=r(rows, 6).abs() * 100, ip_tokens=r(rows, 4, 32),
                ip_tokens_uncond=r(rows, 4, 32))


def _eps_fn(net, cond, guidance=3.0, ip_scale=0.5, window=(0, 99), ip=True):
    c = dict(cond)
    if not ip:
        c.pop("ip_tokens"), c.pop("ip_tokens_uncond")
    return sampler.make_cfg_eps_fn(net, CFG, guidance_scale=guidance, ip_scale=ip_scale,
                                   ip_step_window=window if ip else None, **c)


def _reference(net, cond, monkeypatch, **kw):
    """The eager eps_fn of a copy of the UNet (the CPU's own backend)."""
    with monkeypatch.context() as m:
        m.setattr(unet_graph, "BACKEND", unet_graph.CudaGraphs())
        return _eps_fn(copy.deepcopy(net), cond, **kw)


def _lat(seed, rows=1):
    return torch.randn(rows, 8, 8, 4, generator=torch.Generator().manual_seed(seed))


def _attention_calls(monkeypatch):
    calls = []
    real = attention.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("case", ["cpu", "grad", "tp_mesh", "mesh", "inexact_scale"])
def test_the_eager_forward_runs_where_graphs_do_not_engage(monkeypatch, case):
    """No graph on the CPU's own backend, with grad mode on, under a
    tensor-parallel context or a mesh of two devices, or with an IP scale
    the UNet's dtype does not hold exactly."""
    backend = FakeGraphs()
    if case != "cpu":
        monkeypatch.setattr(unet_graph, "BACKEND", backend)
    net = _net(dtype=torch.bfloat16 if case == "inexact_scale" else torch.float32)
    cond = {k: v.to(net.conv_in.weight.dtype) for k, v in _cond(1).items()}
    scope = {
        "cpu": contextlib.nullcontext(), "grad": torch.enable_grad(),
        "tp_mesh": sharding.tp_activation_constraints(object()),
        "mesh": use_mesh(Mesh({DATA_AXIS: 2, MODEL_AXIS: 1}, 0, torch.device("cpu"))),
        "inexact_scale": contextlib.nullcontext(),
    }[case]
    with torch.no_grad(), scope:
        fn = _eps_fn(net, cond, ip_scale=0.8 if case == "inexact_scale" else 0.5)
        lat = _lat(2).to(net.conv_in.weight.dtype)
        for i in range(3):
            fn(lat, 500 - i, i)
    assert backend.graphs == []
    runner = unet_graph._RUNNERS.get(net)
    if case == "grad":
        assert (runner.eager, runner.captures, runner.replays) == (3, 0, 0)
    else:
        assert runner is None


def test_ip_taps_and_pnp_run_eagerly(fake):
    """The callers that tap IP attention or share pnp's Q/K call
    `unet.apply` themselves: nothing is captured for them."""
    net = _net()
    c = _cond(3)
    with torch.no_grad():
        ctx2 = torch.cat([c["ctx_uncond"], c["ctx"]])
        eps, taps = unet_lib.apply(
            net, _lat(4, 2), torch.full((2,), 10), ctx2, CFG,
            pooled_text=torch.cat([c["pooled_uncond"], c["pooled"]]),
            time_ids=c["time_ids"].repeat(2, 1), ip_tokens=torch.cat([c["ip_tokens"]] * 2),
            capture_ip_attn=True)
        assert taps
        pnp.pnp_denoise(net, CFG, Schedule.create(), _lat(5), c["ctx"], c["ctx_uncond"],
                        c["ctx_uncond"], c["pooled"], c["pooled_uncond"], c["pooled_uncond"],
                        c["time_ids"], num_inference_steps=3)
    assert fake.graphs == [] and unet_graph._RUNNERS.get(net) is None


def test_capture_on_second_sight_then_replay_and_a_key_per_row_count(fake, monkeypatch):
    net, cond = _net(), _cond(6)
    ref = _reference(net, cond, monkeypatch)
    calls = _attention_calls(monkeypatch)
    with torch.no_grad():
        fn = _eps_fn(net, cond)
        runner = unet_graph.graphs_of(net)
        lat = _lat(7)
        python_calls = []
        for i, t in enumerate([900, 700, 500, 300]):
            n = len(calls)
            got = fn(lat + i, t, i)
            python_calls.append(len(calls) - n)
            assert torch.equal(got, ref(lat + i, t, i)), f"step {i}"
            want = [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2)][i]
            assert (runner.eager, runner.captures, runner.replays) == want, f"step {i}"
        # 4 transformer blocks (down, mid, two up), each self, text and IP attention;
        # a replay runs no Python forward
        assert python_calls == [12, 12, 0, 0]
        # 13 stretches, of which the 4 between text and IP attention launch nothing
        assert len(fake.graphs) == 13 and runner.segments == 9
        assert fake.pools == 1
        # two latent rows: another key, eager first, then captured into the same pool
        lat2 = _lat(8, 2)
        fn2, ref2 = _eps_fn(net, _cond(9, 2)), _reference(net, _cond(9, 2), monkeypatch)
        for i in range(3):
            assert torch.equal(fn2(lat2, 400 - i, i), ref2(lat2, 400 - i, i))
        assert (runner.eager, runner.captures, runner.replays) == (2, 2, 3)
        assert runner.segments == 2 * 9 and fake.pools == 1


def test_cross_kv_and_inputs_are_rebound_for_each_loop(fake, monkeypatch):
    """A second loop with other conditioning replays the first loop's
    graphs with its own cross K/V, context, pooled embeddings, time ids and
    IP tokens; the first loop still gets its own afterwards."""
    net = _net()
    lat = _lat(10)
    with torch.no_grad():
        a, ref_a = _eps_fn(net, _cond(11)), _reference(net, _cond(11), monkeypatch)
        b, ref_b = _eps_fn(net, _cond(12)), _reference(net, _cond(12), monkeypatch)
        for i in range(3):
            assert torch.equal(a(lat, 600, i), ref_a(lat, 600, i))
        for i in range(3):
            assert torch.equal(b(lat, 600, i), ref_b(lat, 600, i))
        assert torch.equal(a(lat, 650, 3), ref_a(lat, 650, 3))
        runner = unet_graph.graphs_of(net)
        assert (runner.eager, runner.captures, runner.replays) == (1, 1, 5)


def test_ip_window_switches_the_scale_without_a_new_capture(fake, monkeypatch):
    net, cond = _net(), _cond(13)
    ref = _reference(net, cond, monkeypatch, window=(1, 3))
    lat = _lat(14)
    with torch.no_grad():
        fn = _eps_fn(net, cond, window=(1, 3))
        outs = [fn(lat, 800 - 100 * i, i) for i in range(5)]  # scales 0, .5, .5, 0, 0
        for i, got in enumerate(outs):
            assert torch.equal(got, ref(lat, 800 - 100 * i, i)), f"step {i}"
        assert not torch.equal(outs[2], fn(lat, 600, 3))  # the scale reached the graphs
    runner = unet_graph.graphs_of(net)
    assert (runner.captures, runner.replays) == (1, 4)


def test_no_ip_and_no_cfg_loops_are_graphed_too(fake, monkeypatch):
    """An inversion-like loop: no guidance, no IP tokens."""
    net, cond = _net(), _cond(15)
    ref = _reference(net, cond, monkeypatch, guidance=1.0, ip=False)
    with torch.no_grad():
        fn = _eps_fn(net, cond, guidance=1.0, ip=False)
        for i in range(3):
            assert torch.equal(fn(_lat(16 + i), 100 * i + 1, i), ref(_lat(16 + i), 100 * i + 1, i))
    runner = unet_graph.graphs_of(net)
    assert (runner.eager, runner.captures, runner.replays) == (1, 1, 1)
    assert runner.segments == 9  # self and text attention in 4 blocks: 8 K1 calls


def test_the_counter_and_the_attributes(fake):
    net, cond = _net(), _cond(20)
    profiling.disable()
    profiling.clear()
    profiling.enable()
    try:
        with torch.no_grad():
            fn = _eps_fn(net, cond)
            for i in range(4):
                fn(_lat(21), 300, i)
        counts = profiling.snapshot()["counters"]["unet_graph"]
    finally:
        profiling.disable()
        profiling.clear()
    assert counts == {("eager", 2): 1, ("capture", 2): 1, ("replay", 2): 2}
    runner = unet_graph.graphs_of(net)
    assert (runner.eager, runner.captures, runner.replays, runner.segments) == (1, 1, 2, 9)
    hit = runner.replays / (runner.eager + runner.captures + runner.replays)
    assert hit == 0.5


def test_k1_is_called_through_the_module_attribute_at_each_replay(fake, monkeypatch):
    """A wrapper installed after the capture sees every K1 call of each
    replay, each with the buffer the next graph reads."""
    net, cond = _net(), _cond(22)
    with torch.no_grad():
        fn = _eps_fn(net, cond)
        fn(_lat(23), 200, 0)
        fn(_lat(23), 200, 1)  # captured here
        seen = []

        def wrapper(q, k, v, causal, scale, *a, **kw):
            seen.append((tuple(q.shape), kw["out"].data_ptr()))
            return stand_in_k1(q, k, v, causal, scale, *a, **kw)

        monkeypatch.setattr(fa, "flash_fwd_cuda", wrapper)
        fn(_lat(23), 200, 2)
        fn(_lat(23), 100, 3)
    runner = unet_graph.graphs_of(net)
    assert len(seen) == 2 * 12
    assert seen[:12] == seen[12:]  # the same buffers at every replay


def test_moved_weights_drop_the_graphs(fake, monkeypatch):
    net, cond = _net(), _cond(24)
    with torch.no_grad():
        fn = _eps_fn(net, cond)
        for i in range(3):
            fn(_lat(25), 300, i)
        runner = unet_graph.graphs_of(net)
        assert runner.segments == 9
        net.conv_in.weight.data = net.conv_in.weight.data * 2  # as a staged store's restage
        ref = _reference(net, cond, monkeypatch)
        fn = _eps_fn(net, cond)
        assert runner.segments == 0
        for i in range(3):
            assert torch.equal(fn(_lat(25), 300, i), ref(_lat(25), 300, i))
    assert (runner.eager, runner.captures, runner.replays) == (2, 2, 2)


@pytest.mark.parametrize("guidance", [3.0, 1.0], ids=["cfg", "no_cfg"])
def test_two_threads_interleave_loops_of_one_unet(fake, monkeypatch, guidance):
    """Two loops of one key on two threads, each forward of one thread run
    between the other's forward and its use of ε (the CFG combine, or the
    caller's step): each loop still gets its own eager ε."""
    net, lat, ip = _net(), _lat(30), guidance > 1.0
    conds = {"a": _cond(31), "b": _cond(32)}
    fns = {n: _eps_fn(net, c, guidance=guidance, ip=ip) for n, c in conds.items()}
    refs = {n: _reference(net, c, monkeypatch, guidance=guidance, ip=ip) for n, c in conds.items()}
    real = unet_graph.UNetGraphs.forward
    go = {"a": threading.Event(), "b": threading.Event()}

    def forward(self, loop, lat, t, scale):
        me = threading.current_thread().name
        if me == "b":
            assert go["b"].wait(30)
            go["b"].clear()
        out = real(self, loop, lat, t, scale)
        if me == "a":
            go["b"].set()  # b's forward runs now, before a reads its ε
            assert go["a"].wait(30)
            go["a"].clear()
        else:
            go["a"].set()
        return out

    monkeypatch.setattr(unet_graph.UNetGraphs, "forward", forward)
    got, errors = {"a": [], "b": []}, []

    def run(name):
        try:
            with torch.no_grad():
                for i in range(4):
                    got[name].append(fns[name](lat + i, 900 - 100 * i, i))
        except BaseException as e:  # noqa: BLE001  (reported below)
            errors.append(e)
            go["a"].set(), go["b"].set()

    threads = [threading.Thread(target=run, args=(n,), name=n) for n in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not errors and all(len(v) == 4 for v in got.values())
    for n in "ab":
        for i, eps in enumerate(got[n]):
            assert torch.equal(eps, refs[n](lat + i, 900 - 100 * i, i)), f"{n} step {i}"
    runner = unet_graph.graphs_of(net)
    assert (runner.eager, runner.captures, runner.replays) == (1, 1, 6)


def test_a_staged_eviction_drops_the_graphs(fake, monkeypatch):
    """Evicting the UNet from a staged store drops its graphs and their
    pool; restaged, it is seen, captured and replayed anew."""
    store = StagedParams({"unet": _net}, budget_bytes=1e12)
    cond = _cond(26)
    with torch.no_grad():
        net = store["unet"]
        fn = _eps_fn(net, cond)
        for i in range(3):
            fn(_lat(27), 300, i)
        runner = unet_graph.graphs_of(net)
        assert runner.segments == 9 and fake.pools == 1
        store.evict("unet")
        assert runner.segments == 0 and runner._keys == {} and runner._pool is None
        net = store["unet"]
        ref = _reference(net, cond, monkeypatch)
        fn = _eps_fn(net, cond)
        for i in range(3):
            assert torch.equal(fn(_lat(27), 300, i), ref(_lat(27), 300, i))
    assert (runner.eager, runner.captures, runner.replays) == (2, 2, 2)
    assert runner.segments == 9 and fake.pools == 2


class _AsCuda(torch.Tensor):
    """A CPU tensor that K1's input checks take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def _as_cuda(t):
    return torch.Tensor._make_subclass(_AsCuda, t)


def test_flash_fwd_cuda_writes_the_given_buffer_and_refuses_a_wrong_one(monkeypatch):
    launched = []
    monkeypatch.setattr(fa, "_lib", lambda: (lambda *a: launched.append(a) or 0, lambda: 1))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: types.SimpleNamespace(
        cuda_stream=0))
    monkeypatch.setattr(fa.flash_fwd_cuda, "launches", 0)
    monkeypatch.setattr(fa.flash_fwd_cuda, "launches_by_path", dict.fromkeys(fa.K1_PATHS, 0))
    # (B, H, S, D) views of (B, S, H, D) tensors, as the UNet passes them
    q, k, v = (_as_cuda(torch.zeros(2, 16, 3, 64, dtype=torch.bfloat16)).transpose(1, 2)
               for _ in range(3))
    out = torch.empty(2, 16, 3, 64, dtype=torch.bfloat16).transpose(1, 2)
    got = fa.flash_fwd_cuda(q, k, v, False, 0.125, out=out)
    assert got is out and launched[-1][4] == out.data_ptr()
    assert launched[-1][21:24] == out.stride()[:3]
    assert fa.flash_fwd_cuda.launches == 1
    bad = {
        "shape": torch.empty(2, 16, 4, 64, dtype=torch.bfloat16).transpose(1, 2),
        "dtype": torch.empty(2, 16, 3, 64, dtype=torch.float32).transpose(1, 2),
        "stride order": torch.empty(2, 3, 16, 64, dtype=torch.bfloat16),
        "not dense": torch.empty(2, 16, 3, 128, dtype=torch.bfloat16)[..., :64].transpose(1, 2),
        "device": torch.empty(2, 16, 3, 64, dtype=torch.bfloat16, device="meta").transpose(1, 2),
    }
    for what, o in bad.items():
        with pytest.raises(ValueError, match="out"):
            fa.flash_fwd_cuda(q, k, v, False, 0.125, out=o)
    assert fa.flash_fwd_cuda.launches == 1, "a refused buffer launched K1"
