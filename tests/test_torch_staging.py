"""`core/staging.py` (`StagedParams`), the staged boot, the pipeline and
server over a store, and `utils/profiling.py`.

A mirror of `tests/test_staging.py` on module groups, and the JAX store and
the port's fed the same access sequences with groups of the same byte
sizes: the same evictions, swaps and swap bytes. The tiny edit through a
store whose budget forces evictions between stages is bit-identical to the
edit without one, and so is a served batch. CPU, float32 (on the CPU the
host is the device, so an eviction moves no bytes; the card's run is in
`chip_smoke.py`)."""

import copy
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch_port_helpers import grad_enabled, one_torch_thread  # noqa: F401 (fixtures)

from instructany2pix_tpu.core import staging as jst
from instructany2pix_tpu_torch import loaders, serving
from instructany2pix_tpu_torch import pipeline as tpl
from instructany2pix_tpu_torch.core import staging as tst
from instructany2pix_tpu_torch.core.dtypes import FP32
from instructany2pix_tpu_torch.utils import profiling


class _Group(nn.Module):
    def __init__(self, n, value=0.0, dtype=torch.float32):
        super().__init__()
        self.w = nn.Parameter(torch.full((n,), float(value), dtype=dtype), requires_grad=False)


def _mk(value, n=64 * 64):
    calls = {"n": 0}

    def factory():
        calls["n"] += 1
        return _Group(n, value)

    return factory, calls


def test_materialize_and_lru_eviction():
    fa, ca = _mk(1.0)
    fb, cb = _mk(2.0)
    fc, cc = _mk(3.0)
    one = 64 * 64 * 4
    store = tst.StagedParams({"a": fa, "b": fb, "c": fc}, budget_bytes=2 * one + 1)
    assert float(store["a"].w[0]) == 1.0
    assert float(store["b"].w[0]) == 2.0
    assert set(store.live_groups()) == {"a", "b"}
    store["a"]  # a is now the most recent: b is the victim when c loads
    store["c"]
    assert set(store.live_groups()) == {"a", "c"}
    assert store.stats["evictions"] == ["b"]
    b = store["b"]  # restaged from the host copy: the factory does not run again
    assert float(b.w[0]) == 2.0 and cb["n"] == 1
    assert store.stats["swaps"] == 1 and store.stats["swap_bytes"] == one
    assert store.stats["swap_s"] >= 0.0 and store.stats["evict_s"] >= 0.0
    assert ca["n"] == 1 and cc["n"] == 1
    assert set(store.stats["load_s"]) == {"a", "b", "c"}


def test_alias_and_pin():
    fa, ca = _mk(1.0)
    fb, _ = _mk(2.0)
    one = 64 * 64 * 4
    store = tst.StagedParams({"a": fa, "b": fb}, budget_bytes=one + 1, aliases={"a2": "a"},
                             pin=("a",))
    assert store["a2"] is store["a"]
    assert ca["n"] == 1
    store["b"]  # would evict a, which is pinned: b stays over the budget
    assert "a" in store.live_groups()
    assert "a2" in store and "a" in store and "zz" not in store
    store.unpin("a2")
    store.evict("b")
    store["b"]  # restaging b evicts a first, now that a is not pinned
    assert store.stats["evictions"] == ["b", "a"]
    store.pin("a")
    store["a"]
    assert store.stats["evictions"] == ["b", "a", "b"]
    with pytest.raises(KeyError):
        store["zz"]
    cyc = tst.StagedParams({}, aliases={"x": "y", "y": "x"})
    with pytest.raises(ValueError):
        cyc["x"]


def test_setitem_replaces_group():
    fa, _ = _mk(1.0)
    store = tst.StagedParams({"a": fa}, budget_bytes=1e9)
    store["a"]
    store["a"] = _Group(8 * 8)
    assert float(store["a"].w.sum()) == 0.0
    assert store.live_groups()["a"] == 8 * 8 * 4


def test_oversized_group_still_materializes():
    fa, _ = _mk(1.0)
    fb, _ = _mk(2.0)
    store = tst.StagedParams({"a": fa, "b": fb}, budget_bytes=16)
    assert float(store["a"].w[0]) == 1.0
    assert float(store["b"].w[0]) == 2.0  # built, then everything else evicted
    assert store.stats["evictions"] == ["a"] and list(store.live_groups()) == ["b"]


def test_first_build_runs_before_eviction_and_a_restage_after(monkeypatch):
    """The budget bounds the live groups once an access returns, not the
    peak: a first build runs its factory with the other groups still live,
    in both packages, and a restage evicts before it copies back."""
    one = 64 * 64 * 4
    seen = {}

    def both(store, name, make):
        def factory():
            seen.setdefault(name, []).append(dict(store.live_groups()))
            return make()

        return factory

    j = jst.StagedParams({}, budget_bytes=one + 1)
    t = tst.StagedParams({}, budget_bytes=one + 1)
    for store, tag, make in ((j, "j", lambda: {"w": jnp.ones((64 * 64,), jnp.float32)}),
                             (t, "t", lambda: _Group(64 * 64, 1.0))):
        store._factories.update({g: both(store, tag + g, make) for g in "ab"})
        store["a"]
        store["b"]
    assert seen["ja"] == seen["ta"] == [{}]
    assert seen["jb"] == seen["tb"] == [{"a": one}]  # a is live while b is built
    assert j.stats["evictions"] == t.stats["evictions"] == ["a"]
    install = tst._install

    def spy(entries):
        seen["restage"] = dict(t.live_groups())
        install(entries)

    monkeypatch.setattr(tst, "_install", spy)
    t["a"]
    assert seen["restage"] == {}  # b was evicted before a came back
    assert t.stats["evictions"] == ["a", "b"] and t.stats["swaps"] == 1


def test_quantized_llm_round_trips_through_the_host():
    """An int4 group-128 Llama's packed buffers through an eviction and a
    restage: the same buffers, contiguous (K2 takes nothing else), and the
    same logits bit for bit."""
    from instructany2pix_tpu_torch.models import llama as tllama
    from instructany2pix_tpu_torch.ops import quant as Q

    cfg = tllama.LlamaConfig(vocab_size=280, hidden_size=256, intermediate_size=512,
                             num_layers=2, num_heads=4, num_kv_heads=4)
    torch.manual_seed(0)

    def build():
        m = tllama.Llama(cfg)
        for p in m.parameters():
            p.data.normal_(0, 0.05)
        return tllama.fuse_projections(Q.quantize_llama(m, bits=4))

    store = tst.StagedParams({"llm": build, "b": _mk(1.0)[0]}, budget_bytes=64 * 64 * 4 + 1)
    ids = torch.arange(7).reshape(1, 7)
    llm = store["llm"]
    packed = {n: b for n, b in llm.named_buffers() if n.endswith("w_q4")}
    assert len(packed) == 2 * 4
    with torch.inference_mode():
        before = tllama.forward(llm, cfg, input_ids=ids)["logits"]
        store["b"]  # evicts the LLM
        assert store["llm"] is llm and store.stats["swaps"] == 1
        after = tllama.forward(llm, cfg, input_ids=ids)["logits"]
    assert store.stats["evictions"] == ["llm", "b"]
    for n, b in llm.named_buffers():
        if n.endswith("w_q4"):
            assert b.dtype == packed[n].dtype and b.is_contiguous(), n
            assert torch.equal(b, packed[n]), n
    assert torch.equal(before, after)


def test_tree_device_bytes():
    m = nn.Module()
    m.a = nn.Parameter(torch.zeros((4, 4), dtype=torch.bfloat16))
    m.register_buffer("b", torch.zeros((2,), dtype=torch.int8))
    m.child = nn.Linear(3, 2)
    m.shared = m.child  # counted once
    assert tst.tree_device_bytes(m) == 4 * 4 * 2 + 2 + (6 + 2) * 4
    t = {"a": jnp.zeros((4, 4), jnp.bfloat16), "b": jnp.zeros((2,), jnp.int8)}
    assert jst.tree_device_bytes(t) == 4 * 4 * 2 + 2


# the bench's group inventory, proxy-scaled: 1 KB stands for 1 GB
SIZES = {"llm": 3.8, "imagebind_vision": 1.3, "imagebind_audio": 0.2, "text1": 0.3,
         "text2": 1.4, "prior_text": 0.3, "prior": 2.0, "vae": 0.2, "image_proj": 0.1,
         "unet": 5.8, "refiner": 4.5}
GB = 256  # floats per proxy GB (x 4 bytes = 1 KB)
# one edit's group accesses, in the pipeline's order
EDIT = ["imagebind_vision", "imagebind_audio", "llm", "text1", "text2", "prior_text", "prior",
        "vae", "unet", "image_proj", "unet", "vae", "text2", "vae", "refiner", "vae"]


def _both(budget_gb, pins=(), aliases=None):
    jf = {k: (lambda v=v: {"w": jnp.ones((int(v * GB),), jnp.float32)}) for k, v in SIZES.items()}
    tf = {k: (lambda v=v: _Group(int(v * GB), 1.0)) for k, v in SIZES.items()}
    budget = int(budget_gb * GB * 4)
    return (jst.StagedParams(jf, budget_bytes=budget, pin=pins, aliases=aliases),
            tst.StagedParams(tf, budget_bytes=budget, pin=pins, aliases=aliases))


def test_planned_mode_swap_accounting():
    """The planned policy: the small groups and the UNet pinned, so across a
    warm edit only the LLM and the refiner rotate, 2 swaps of llm + refiner
    bytes, in both packages."""
    pins = tuple(k for k in SIZES if k not in ("llm", "refiner"))
    j, t = _both(15.0, pins)
    for store in (j, t):
        for name in EDIT:  # cold: every group's first build
            store[name]
    s0 = {"j": dict(j.stats), "t": dict(t.stats)}
    for store in (j, t):
        for name in EDIT:  # warm
            store[name]
    for key, store in (("j", j), ("t", t)):
        assert store.stats["swaps"] - s0[key]["swaps"] == 2, store.stats["evictions"]
        swap_gb = (store.stats["swap_bytes"] - s0[key]["swap_bytes"]) / (GB * 4)
        assert abs(swap_gb - (SIZES["llm"] + SIZES["refiner"])) < 0.01
        assert set(store.stats["evictions"]) <= {"llm", "refiner"}
    assert t.stats["evictions"] == j.stats["evictions"]


@pytest.mark.parametrize("budget_gb,pinned", [(8.0, ()), (12.5, ("unet",)), (20.0, ()),
                                              (6.0, ("vae", "text2")), (4.0, ())])
def test_eviction_sequence_equals_jax(budget_gb, pinned):
    """Three edits, the inpaint alias and an explicit evict and prefetch: the
    port's evictions, swaps, swap bytes and live groups are JAX's."""
    j, t = _both(budget_gb, pinned, aliases={"inpaint_unet": "unet"})
    seq = EDIT + ["inpaint_unet"] + EDIT[::-1] + EDIT
    for store in (j, t):
        for name in seq[:20]:
            store[name]
        store.evict("vae", "inpaint_unet")
        store.prefetch("refiner", "llm")
        for name in seq[20:]:
            store[name]
    for k in ("evictions", "swaps", "swap_bytes"):
        assert t.stats[k] == j.stats[k], k
    assert t.live_groups() == j.live_groups()
    assert sorted(t) == sorted(j) and len(t) == len(j)


def test_evicted_modules_keep_their_identity_and_host_copies():
    fa, _ = _mk(1.0)
    fb, _ = _mk(2.0)
    store = tst.StagedParams({"a": fa, "b": fb}, budget_bytes=64 * 64 * 4 + 1)
    a = store["a"]
    w = a.w
    store["b"]  # evicts a
    assert store["a"] is a and a.w is w  # the same module and Parameter, restaged
    assert a.w.device.type == "cpu" and float(a.w[0]) == 1.0


def test_groups_first_built_in_inference_mode_are_ordinary_tensors(grad_enabled):
    """The pipeline touches the store inside `torch.inference_mode()`; a
    group built there must still take its host copy back (an inference
    tensor's `data` cannot be swapped) and serve outside it."""
    fa, _ = _mk(1.0)
    fb, _ = _mk(2.0)
    store = tst.StagedParams({"a": fa, "b": fb}, budget_bytes=64 * 64 * 4 + 1)
    with torch.inference_mode():
        a = store["a"]
        store["b"]  # evicts a
        assert store["a"] is a  # restaged
        assert float(a.w.sum()) == 64 * 64
    assert not a.w.is_inference() and not store["b"].w.is_inference()
    w = a.w.detach().clone().requires_grad_(True)
    (w * a.w).sum().backward()
    assert torch.equal(w.grad, a.w)


def test_shared_parameters_and_buffers_move_together():
    m = nn.Module()
    m.l1 = nn.Linear(4, 4)
    m.l2 = nn.Module()
    m.l2.tied = m.l1.weight
    buf = torch.arange(3.0)
    m.l1.register_buffer("buf", buf)
    m.l2.register_buffer("buf", buf)
    fb, _ = _mk(2.0)
    store = tst.StagedParams({"m": lambda: m, "b": fb}, budget_bytes=tst.tree_device_bytes(m) + 1)
    store["m"]
    store["b"]
    store["m"]
    assert m.l2.tied is m.l1.weight
    assert m.l1.buf is m.l2.buf


def test_store_is_safe_across_threads():
    """More threads than cores hammer one store with a short switch
    interval: every access returns its group's values, the budget holds,
    and every build or restage is matched by an eviction or a live group
    (a lost update would break the count)."""
    import sys

    factories = {f"g{i}": _mk(float(i))[0] for i in range(6)}
    store = tst.StagedParams(factories, budget_bytes=3 * 64 * 64 * 4)
    errors = []

    def worker(seed):
        rs = np.random.RandomState(seed)
        try:
            for _ in range(100):
                i = int(rs.randint(6))
                assert float(store[f"g{i}"].w[0]) == float(i)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(2 * os.cpu_count())]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:3]
    st = store.stats
    assert sum(store.live_groups().values()) <= 3 * 64 * 64 * 4
    assert len(st["load_s"]) + st["swaps"] == len(st["evictions"]) + len(store.live_groups())


# ------------------------------------------------------ pipeline and server


@pytest.fixture(scope="module")
def resident():
    return tpl.InstructAny2PixPipeline(tpl.PipelineConfig.tiny(), device="cpu", policy=FP32,
                                       seed=0)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("staged_media")
    rs = np.random.RandomState(0)
    img = str(d / "img.png")
    Image.fromarray(rs.randint(0, 255, (80, 96, 3), np.uint8)).save(img)
    return [{"type": "image", "fname": img}]


def _store(resident, budget=2048):
    """The resident pipeline's modules as factories (copies, so an eviction
    never touches the resident pipeline), under a budget that forces
    evictions between stages."""
    return tst.StagedParams({k: (lambda v=v: copy.deepcopy(v)) for k, v in resident.models.items()},
                            budget_bytes=budget)


def _cache(pipe, media):
    rs = np.random.RandomState(7)
    d = pipe.cfg.llm.image_codec_dim
    return (rs.randn(1, d).astype(np.float32), rs.randn(d).astype(np.float32), " a caption",
            media[0]["fname"], dict(all_objs=["cat"], extra_embeds=rs.randn(1, d).astype(
                np.float32), extra_idx=np.array([0])))


def test_staged_edit_is_bit_identical(resident, media):
    store = _store(resident)
    staged = tpl.InstructAny2PixPipeline(resident.cfg, device="cpu", policy=FP32, models=store)
    outs = []
    for pipe in (resident, staged):
        pipe.cache = _cache(pipe, media)
        outs.append(pipe("edit <video>", media, num_inference_steps=2, refinement=0.1, seed=5,
                         use_cache=True, subject_strength=0.1))
        pipe.cache = None
    (a_non, a_ref, a_msg), (b_non, b_ref, b_msg) = outs
    assert a_msg == b_msg == "SUCCESS!"
    np.testing.assert_array_equal(a_non, b_non)
    np.testing.assert_array_equal(a_ref, b_ref)
    assert len(store.stats["evictions"]) > 5
    assert "inpaint_unet" in store.stats["evictions"]
    assert store.stats["swaps"] > 0
    # the LLM half through the store: the same greedy-free sample with one seed
    toks = []
    for pipe in (resident, staged):
        pipe.forward_llm("edit <video>", media, generator=torch.Generator().manual_seed(1))
        toks.append(pipe.last_generate.tokens.tolist())
    assert toks[0] == toks[1]


def test_server_over_a_store(resident, media):
    staged = tpl.InstructAny2PixPipeline(resident.cfg, device="cpu", policy=FP32,
                                         models=_store(resident))
    d = resident.cfg.llm.image_codec_dim

    def stage(reqs):
        out = []
        for r in reqs:
            rk = np.random.RandomState(r.seed)
            out.append((rk.randn(1, d).astype(np.float32), rk.randn(d).astype(np.float32),
                        f" scene {r.seed}", media[0]["fname"],
                        dict(all_objs=[], extra_embeds=[], extra_idx=[])))
        return out

    reqs = [serving.PipelineRequest("edit <video>", media, num_inference_steps=2, refinement=0.1,
                                    seed=s) for s in (3, 4)]
    results = []
    for pipe in (resident, staged):
        server = serving.PipelineServer(pipe, max_batch=2)
        server._llm_stage = stage
        try:
            results.append(server._run_batch(reqs))
            if pipe is staged:
                futs = [server.submit(r) for r in reqs]
                again = [f.result(timeout=300) for f in futs]
        finally:
            server.stop()
    for a, b, c in zip(results[0], results[1], again):
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(b.image, c.image)
    assert len(staged.models.stats["evictions"]) > 0


def test_staged_boot_takes_only_the_groups_on_disk(tmp_path):
    cfg = tpl.PipelineConfig.tiny()
    store = loaders.staged_models_from_root(cfg, str(tmp_path), device="cpu")
    assert len(list(store)) == 1 and "inpaint_unet" not in store  # only the alias
    os.makedirs(tmp_path / "sdxl-base" / "vae")
    store = loaders.staged_models_from_root(cfg, str(tmp_path), device="cpu",
                                            budget_bytes=1e6, pin=("vae",))
    assert "vae" in store and "unet" not in store and store._budget == 1_000_000
    with pytest.raises(FileNotFoundError):  # the factory reads on first access
        store["vae"]
    if not torch.cuda.is_available():  # no silent CPU boot
        with pytest.raises(RuntimeError):
            loaders.staged_models_from_root(cfg, str(tmp_path))


# -------------------------------------------------------------- profiling


def test_stage_collection_and_nan_check(tmp_path):
    with profiling.collect_stages() as outer:
        with profiling.stage("a"):
            with profiling.collect_stages() as inner:
                with profiling.stage("b"):
                    torch.ones(3).sum()
        with profiling.stage("a"):
            pass
    assert set(outer.times) == {"a", "b"} and set(inner.times) == {"b"}
    assert outer.times["a"] >= outer.times["b"] >= 0.0
    assert "ms" in repr(outer)
    with profiling.stage("unrecorded"):
        pass
    assert "unrecorded" not in outer.times
    tree = {"x": torch.ones(2), "y": [torch.zeros(1), torch.arange(3)], "m": nn.Linear(2, 2)}
    profiling.nan_check(tree, "ok")
    with pytest.raises(FloatingPointError, match="bad leaf 1"):
        profiling.nan_check({"a": torch.ones(1), "b": torch.tensor([float("nan")])}, "bad")
    m = nn.Linear(2, 2)
    with torch.no_grad():
        m.bias[0] = float("inf")
    with pytest.raises(FloatingPointError):
        profiling.nan_check(m, "module")
    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.stage("traced"):
            torch.ones(8).cumsum(0)
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert '"traced"' in text
