"""The port's flash-attention gradient against the JAX package: the
autograd Function (K1 forward, K4 backward; their plain versions on the
CPU) against `jax.grad` through the Pallas kernels in interpret mode,
`flash_bwd_reference` against `_flash_bwd(interpret=True)`, the kv_len path
against the JAX masked XLA path, and `gradcheck` in float64. Also: K4's
wrapper counts its calls by the path the kernel reports (a stand-in library
on the CPU), the kernels without a backward (K2, K3) refuse inputs that need
a gradient, and the build hashes the headers K1 and K4 share. CPU, float32."""

import ctypes
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.ops.attention import dot_product_attention as j_dpa
from instructany2pix_tpu.ops.flash_attention import (
    _bwd_recompute as j_bwd_recompute,
    _flash_bwd,
    _flash_fwd,
    flash_attention as j_flash,
)
from instructany2pix_tpu_torch.ops import _build
from instructany2pix_tpu_torch.ops import flash_attention as fa
from instructany2pix_tpu_torch.ops import quant as Q
from instructany2pix_tpu_torch.ops.attention import dot_product_attention
from torch_port_helpers import assert_close, randn, t

# float32 on both sides, as tests/test_ops.py holds the JAX custom VJP
# against XLA's gradient; the kernels sum in another order
GRAD_TOL = 1e-4

CASES = [
    # (causal, sq, sk, d)
    (False, 128, 128, 64),
    (True, 128, 128, 64),
    (False, 100, 77, 32),
    (True, 64, 200, 128),
    (False, 200, 64, 128),
    (True, 130, 130, 32),
    # head_dim 80 (the ViT-H towers; the fused kernel's tail boxes on the card)
    (True, 64, 200, 80),
    (False, 100, 77, 80),
]



@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Another test file turns grad mode off when it is imported, and pytest
    imports every test file in each worker: these tests need it on."""
    with torch.enable_grad():
        yield


def _inputs(seed, b, h, sq, sk, d):
    return (randn(seed, b, h, sq, d), randn(seed + 1, b, h, sk, d), randn(seed + 2, b, h, sk, d),
            randn(seed + 3, b, h, sq, d))


def _port_grads(q, k, v, g, causal, scale, kv_len=None):
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal, scale, kv_len=kv_len)
    return o, torch.autograd.grad(o, (qt, kt, vt), t(g))


@pytest.mark.parametrize("causal,sq,sk,d", CASES)
def test_function_grads_match_jax_pallas_interpret(causal, sq, sk, d):
    seed = 7 * sq + sk + d + int(causal)
    q, k, v, g = _inputs(seed, 2, 2, sq, sk, d)
    scale = d**-0.5

    def loss(q, k, v):  # interpret=True makes the JAX VJP run _flash_bwd
        return jnp.sum(j_flash(q, k, v, causal, scale, 128, 128, True) * g)

    grads_j = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    o, grads = _port_grads(q, k, v, g, causal, scale)
    o_j = j_flash(*(jnp.asarray(x) for x in (q, k, v)), causal, scale, 128, 128, True)
    assert_close(o, o_j, GRAD_TOL, seed, what="o")
    for name, a, b in zip(("dq", "dk", "dv"), grads, grads_j):
        assert_close(a, b, GRAD_TOL, seed, what=name)


@pytest.mark.parametrize("causal,sq,sk,d", CASES)
def test_flash_bwd_reference_matches_pallas_bwd(causal, sq, sk, d):
    """The plain blocked backward against `_flash_bwd` in interpret mode on
    the same o and lse, with 128-row blocks so the JAX kernels walk several
    blocks (the causal start block, padded tails)."""
    seed = 11 * sq + sk + d + int(causal)
    q, k, v, g = _inputs(seed, 1, 3, sq, sk, d)
    scale = d**-0.5
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    o, lse = _flash_fwd(jq, jk, jv, causal, scale, 128, 128, interpret=True, return_lse=True)
    ref = _flash_bwd(jq, jk, jv, o, lse, jg, causal, scale, 128, 128, interpret=True)
    got = fa.flash_bwd_reference(t(q), t(k), t(v), t(o), t(lse), t(g), causal, scale,
                                 block_q=64)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert_close(a, b, GRAD_TOL, seed, what=name)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_recompute_matches_jax(causal):
    seed = 40 + int(causal)
    q, k, v, g = _inputs(seed, 2, 2, 96, 96, 64)
    scale = 0.125
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o = j_flash(jq, jk, jv, causal, scale, 128, 128, True)
    ref = j_bwd_recompute(jq, jk, jv, o, jnp.asarray(g), causal, scale)
    got = fa._bwd_recompute(t(q), t(k), t(v), t(o), t(g), causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert_close(a, b, GRAD_TOL, seed, what=name)


@pytest.mark.parametrize("s,kv,d", [(48, (48, 31, 1), 64), (70, (5, 70, 64), 32),
                                    (40, (40, 23), 80)])
def test_kv_len_grads_match_jax_masked_path(s, kv, d):
    """A right-padding mask under the causal rule: the port's router sends
    kv_len to the differentiable flash path, the JAX router sends the mask
    to XLA math; values and gradients agree, pad rows included."""
    seed = s + d
    b, h = len(kv), 2
    q, k, v, g = (randn(seed + i, b, s, h, d) for i in range(4))
    mask = np.arange(s)[None, :] < np.asarray(kv)[:, None]

    def loss(q, k, v):
        return jnp.sum(j_dpa(q, k, v, mask=jnp.asarray(mask), causal=True) * g)

    jargs = tuple(jnp.asarray(x) for x in (q, k, v))
    grads_j = jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    o_j = j_dpa(*jargs, mask=jnp.asarray(mask), causal=True)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    kv_len = torch.tensor(kv, dtype=torch.int32)
    o = dot_product_attention(qt, kt, vt, causal=True, kv_len=kv_len)
    grads = torch.autograd.grad(o, (qt, kt, vt), t(g))
    assert_close(o, o_j, GRAD_TOL, seed, what="o")
    for name, a, b_ in zip(("dq", "dk", "dv"), grads, grads_j):
        assert_close(a, b_, GRAD_TOL, seed, what=name)
    # the router's plain path for the same call builds the mask from kv_len
    o_plain = dot_product_attention(qt, kt, vt, causal=True, kv_len=kv_len, impl="xla")
    assert_close(o_plain, o_j, GRAD_TOL, seed, what="o (plain path)")


@pytest.fixture
def one_thread():
    """gradcheck makes thousands of tiny float64 calls. Run them on one
    intra-op thread: more threads only spin against the other pytest-xdist
    workers (a gradcheck took 5.5 s alone and over 500 s in a loaded
    6-worker run with 8 threads, 2.2 s alone with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("causal,sq,sk,kv", [
    (True, 24, 24, None), (False, 17, 29, None), (True, 12, 30, None), (True, 21, 21, (21, 9, 1)),
])
def test_function_gradcheck_float64(one_thread, causal, sq, sk, kv):
    gen = torch.Generator().manual_seed(sq * 100 + sk)
    b = len(kv) if kv else 2
    q = torch.randn(b, 2, sq, 8, dtype=torch.float64, generator=gen, requires_grad=True)
    k = torch.randn(b, 2, sk, 8, dtype=torch.float64, generator=gen, requires_grad=True)
    v = torch.randn(b, 2, sk, 8, dtype=torch.float64, generator=gen, requires_grad=True)
    kv_len = torch.tensor(kv, dtype=torch.int32) if kv else None
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.flash_attention(q, k, v, causal, 0.3, kv_len=kv_len), (q, k, v))


def test_cpu_backward_is_plain_and_uncounted():
    q, k, v, g = (t(x) for x in _inputs(3, 1, 2, 40, 40, 32))
    before = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
              fa.flash_bwd_dkv_cuda.launches)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    grads = torch.autograd.grad(fa.flash_attention(qr, kr, vr, True), (qr, kr, vr), g)
    after = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
             fa.flash_bwd_dkv_cuda.launches)
    assert after == before
    o, lse = fa._reference_attention(q, k, v, True, 32**-0.5, return_lse=True)
    ref = fa.flash_bwd_reference(q, k, v, o, lse, g, True, 32**-0.5)
    for a, b in zip(grads, ref):
        assert torch.equal(a, b)


def test_no_grad_needed_takes_the_forward_only():
    q = t(randn(0, 1, 2, 16, 32))
    with torch.no_grad():
        out = fa.flash_attention(q.requires_grad_(), q, q)
    assert not out.requires_grad
    assert torch.equal(out, fa._reference_attention(q, q, q, False, 32**-0.5))


def test_cpu_backward_runs_only_the_plain_version(monkeypatch):
    """On CPU tensors `_FlashAttention.backward` calls `flash_bwd_reference`
    once and no kernel wrapper: each wrapper is replaced by one that fails."""
    def refuse(*_a, **_k):
        raise AssertionError("a kernel wrapper was called on CPU tensors")

    for name in ("flash_fwd_cuda", "flash_bwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda"):
        monkeypatch.setattr(fa, name, refuse)
    calls = []
    real = fa.flash_bwd_reference
    monkeypatch.setattr(fa, "flash_bwd_reference",
                        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    q, k, v, g = (t(x) for x in _inputs(9, 2, 2, 24, 30, 32))
    kv_len = torch.tensor([30, 11], dtype=torch.int32)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    grads = torch.autograd.grad(fa.flash_attention(qr, kr, vr, True, kv_len=kv_len), (qr, kr, vr),
                                g)
    assert len(calls) == 1
    o, lse = fa._reference_attention(q, k, v, True, 32**-0.5, True, kv_len)
    for a, b in zip(grads, real(q, k, v, o, lse, g, True, 32**-0.5, kv_len)):
        assert torch.equal(a, b)


def _fake_fused_library(monkeypatch, code, rc=0):
    """Stand in for the library of `ia2p_flash_bwd` on the CPU: the call
    returns `rc` and records its arguments, the path query returns `code`.
    The device checks are lifted and the stream is None."""
    calls = []

    def fn(*args):
        calls.append(args)
        return rc

    monkeypatch.setattr(fa, "_check_bwd", lambda *_: None)
    monkeypatch.setattr(fa, "_check_kv_len", lambda *_: None)
    monkeypatch.setattr(fa, "_fused_bwd_lib", lambda: (fn, lambda: code))
    monkeypatch.setattr(fa, "_on_stream", lambda device, f, *args: f(*args, None))
    return calls


@pytest.mark.parametrize("dtype,d,code", [
    (torch.bfloat16, 128, 2), (torch.bfloat16, 64, 2), (torch.bfloat16, 80, 2),
    (torch.bfloat16, 72, 0), (torch.float32, 64, 0),
])
def test_fused_bwd_counts_launches_by_path(monkeypatch, dtype, d, code):
    """One count per backward call, under the path the kernel reported; K4a's
    and K4b's own counters stay. A float32 dq accumulator is passed only where
    the fused kernel may take the call (bf16 at head_dim 64, 80 and 128), and on
    the wgmma path dq is that accumulator rounded (zeros here: the stand-in
    adds nothing). A refused launch raises, naming its path, and counts
    nothing."""
    calls = _fake_fused_library(monkeypatch, code)
    q, k, v, g = (torch.ones(2, 3, 20, d, dtype=dtype) for _ in range(4))
    stats = torch.zeros(2, 3, 20)
    path = fa.K4_PATHS[code]
    others = (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches)
    before = (fa.flash_bwd_cuda.launches, dict(fa.flash_bwd_cuda.launches_by_path))
    dq, dk, dv = fa.flash_bwd_cuda(q, k, v, g, stats, stats, True, 0.2)
    assert len(calls) == 1
    assert fa.flash_bwd_cuda.launches == before[0] + 1
    assert fa.flash_bwd_cuda.launches_by_path == {
        p: n + (p == path) for p, n in before[1].items()}
    assert (fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches) == others
    fused = dtype == torch.bfloat16 and d in fa.WGMMA_BWD_HEAD_DIMS
    assert (calls[0][8] is not None) == fused  # the dq accumulator
    assert calls[0][12:17] == (2, 3, 20, 20, d)
    for x, like in ((dq, q), (dk, k), (dv, v)):
        assert x.shape == like.shape and x.dtype == like.dtype
    if code == 2:
        assert not dq.any()
    _fake_fused_library(monkeypatch, code, rc=700)
    with pytest.raises(RuntimeError, match=f"{path} path"):
        fa.flash_bwd_cuda(q, k, v, g, stats, stats, True, 0.2)
    assert fa.flash_bwd_cuda.launches == before[0] + 1


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_fused_bwd_lays_out_outputs_like_inputs(monkeypatch, layout):
    """`flash_bwd_cuda` hands the library dq, dk and dv with q's, k's and v's
    strides (the router's (B, S, H, D) views too), so the library's
    alignment checks, which differ only in the outputs they see, agree on
    every call the wrapper makes; the dq accumulator (bf16 at head_dim 80
    here) has q's strides too."""
    seen = []

    def fn(*args):
        seen.append(list(ctypes.cast(args[17], ctypes.POINTER(ctypes.c_int64))[:24]))
        return 0

    _fake_fused_library(monkeypatch, 2)
    monkeypatch.setattr(fa, "_fused_bwd_lib", lambda: (fn, lambda: 2))
    q, k, v, g = (torch.ones(2, 3, 20, 80, dtype=torch.bfloat16) for _ in range(4))
    if layout == "bshd":
        q, k, v, g = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v, g))
    stats = torch.zeros(2, 3, 20)
    fa.flash_bwd_cuda(q, k, v, g, stats, stats, True, 0.2)
    (st,) = seen
    bhs = [list(x.stride()[:3]) for x in (q, k, v, g)]
    assert [st[i:i + 3] for i in range(0, 24, 3)] == bhs + [bhs[0], bhs[1], bhs[2], bhs[0]]


def test_k4_wrappers_reject_cpu_tensors():
    q, k, v, g = (t(x) for x in _inputs(5, 1, 2, 16, 16, 32))
    lse = torch.zeros(1, 2, 16)
    for fn in (fa.flash_bwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, g, lse, lse, True, 0.2)


@pytest.mark.parametrize("b, sq, sk", [(1, 0, 16), (1, 16, 0), (0, 16, 16)])
def test_empty_calls_launch_and_count_nothing(monkeypatch, b, sq, sk):
    """With no query rows, no key rows or no (batch, head) pair, the K1, K4,
    K4a and K4b wrappers return empty or zero outputs, launch nothing and add
    nothing to their counters. The device checks are lifted so that the
    wrappers take CPU tensors; loading a library fails the test."""
    def no_library(*_):
        raise AssertionError("a kernel library was loaded for an empty call")

    monkeypatch.setattr(fa, "_check", lambda *_: None)
    monkeypatch.setattr(fa, "_check_bwd", lambda *_: None)
    monkeypatch.setattr(fa, "_check_kv_len", lambda *_: None)
    monkeypatch.setattr(fa, "_lib", no_library)
    monkeypatch.setattr(fa, "_bwd_lib", no_library)
    monkeypatch.setattr(fa, "_fused_bwd_lib", no_library)
    q, g = torch.ones(b, 2, sq, 32), torch.ones(b, 2, sq, 32)
    k, v = torch.ones(b, 2, sk, 32), torch.ones(b, 2, sk, 32)
    stats = torch.zeros(b, 2, sq)
    counters = (fa.flash_fwd_cuda, fa.flash_bwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    before = [c.launches for c in counters]
    by_path = dict(fa.flash_bwd_cuda.launches_by_path)
    dq = fa.flash_bwd_dq_cuda(q, k, v, g, stats, stats, True, 0.2)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, g, stats, stats, True, 0.2)
    fused = fa.flash_bwd_cuda(q, k, v, g, stats, stats, True, 0.2)
    if sq == 0 or b == 0:  # K1 launches with no keys: its rows are written
        fa.flash_fwd_cuda(q, k, v, True, 0.2, return_lse=True)
    assert [c.launches for c in counters] == before
    assert fa.flash_bwd_cuda.launches_by_path == by_path
    for x, like in ((dq, q), (dk, k), (dv, v), *zip(fused, (q, k, v))):
        assert x.shape == like.shape and not x.any()


def test_kernels_without_backward_refuse_grad_inputs():
    """K3 and K2 have no backward (nor have their JAX kernels): their CUDA
    wrappers refuse an input that needs a gradient while grad mode is on,
    before anything else; with grad mode off they go on to their usual
    checks (here: a CPU tensor is not taken), and the CPU inference paths
    are unchanged."""
    q = t(randn(1, 1, 2, 16, 64)).requires_grad_()
    bias = t(randn(2, 1, 2, 16, 4))
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_relpos2d_cuda(q, q, q, bias, bias, 0.1)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fa.flash_relpos2d_cuda(q, q, q, bias, bias, 0.1)
    with torch.no_grad():
        out = fa.flash_attention_relpos2d(q, q, q, bias, bias, 0.1)
    assert torch.equal(out, fa._reference_relpos2d(q.detach(), q.detach(), q.detach(), bias,
                                                   bias, 0.1))

    qw = Q.quantize_weight_int4_grouped(t(randn(3, 256, 128)))
    x = t(randn(4, 2, 256)).requires_grad_()  # (M, K) rows
    with pytest.raises(RuntimeError, match="no backward"):
        Q.qmv_cuda(x, qw)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        Q.qmv_cuda(x, qw)
    with torch.no_grad():
        y = Q.qmatmul(x, qw)
    assert torch.equal(y, Q._qmv_reference(x.detach(), qw, None, 1e-6, False, None))


CSRC_FILES = ("flash_fwd.cu", "flash_fwd_sm90.cuh", "flash_bwd.cu", "flash_bwd_sm90.cuh",
              "sm90_common.cuh", "flash_mma.cuh", "qmv.cu")


def test_build_hashes_included_headers(tmp_path, monkeypatch):
    """K1 and K4 share csrc/flash_mma.cuh: editing it must give both new
    libraries, and leave K2's alone."""
    for name in CSRC_FILES:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("flash_bwd")] == [
        "flash_bwd.cu", "flash_bwd_sm90.cuh", "flash_mma.cuh", "sm90_common.cuh"]
    before = {n: _build.artifact(n) for n in ("flash_fwd", "flash_bwd", "qmv")}
    (tmp_path / "flash_mma.cuh").write_text((tmp_path / "flash_mma.cuh").read_text() + "\n// edit\n")
    after = {n: _build.artifact(n) for n in ("flash_fwd", "flash_bwd", "qmv")}
    assert after["flash_fwd"] != before["flash_fwd"]
    assert after["flash_bwd"] != before["flash_bwd"]
    assert after["qmv"] == before["qmv"]
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmd = _build.nvcc_command(tmp_path / "flash_bwd.cu", tmp_path / "x.so")
    assert cmd[cmd.index("-I") + 1] == str(tmp_path)


def test_build_hash_covers_the_hopper_header_and_flags(tmp_path, monkeypatch):
    """K1's wgmma loop lives in csrc/flash_fwd_sm90.cuh, which includes
    flash_mma.cuh itself: editing it rebuilds K1 (and K3, the same library)
    and nothing else, a header reached only through another header is
    hashed too, and a changed nvcc flag rebuilds every library."""
    for name in CSRC_FILES:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("flash_fwd")] == [
        "flash_fwd.cu", "flash_fwd_sm90.cuh", "flash_mma.cuh", "sm90_common.cuh"]
    names = ("flash_fwd", "flash_bwd", "qmv")
    before = {n: _build.artifact(n) for n in names}
    hdr = tmp_path / "flash_fwd_sm90.cuh"
    hdr.write_text(hdr.read_text() + "\n// edit\n")
    after = {n: _build.artifact(n) for n in names}
    assert after["flash_fwd"] != before["flash_fwd"]
    assert after["flash_bwd"] == before["flash_bwd"] and after["qmv"] == before["qmv"]
    # a header included only by a header
    (tmp_path / "nested.cuh").write_text("#pragma once\n")
    hdr.write_text('#include "nested.cuh"\n' + hdr.read_text())
    assert "nested.cuh" in [p.name for p in _build.sources("flash_fwd")]
    nested = _build.artifact("flash_fwd")
    (tmp_path / "nested.cuh").write_text("#pragma once\n// edit\n")
    assert _build.artifact("flash_fwd") != nested
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert all(_build.artifact(n) != after[n] for n in ("flash_bwd", "qmv"))


@pytest.mark.parametrize("header,rebuilt", [
    ("sm90_common.cuh", {"flash_fwd", "flash_bwd", "qmv"}),
    ("flash_bwd_sm90.cuh", {"flash_bwd"}),
    ("flash_fwd_sm90.cuh", {"flash_fwd"}),
])
def test_build_hash_covers_the_shared_hopper_headers(tmp_path, monkeypatch, header, rebuilt):
    """K1's and K4's wgmma kernels and K2 share csrc/sm90_common.cuh (TMA,
    barriers, descriptors, the Wgmma products, tensor maps): editing it
    rebuilds all three libraries, and editing either flash kernel's own
    header rebuilds that library only."""
    for name in CSRC_FILES:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("flash_fwd", "flash_bwd", "qmv")
    before = {n: _build.artifact(n) for n in names}
    (tmp_path / header).write_text((tmp_path / header).read_text() + "\n// edit\n")
    after = {n: _build.artifact(n) for n in names}
    assert {n for n in names if after[n] != before[n]} == rebuilt


def test_build_copies_writes_each_patched_copy(tmp_path, monkeypatch):
    """`_build.build_copies` (planted faults, benchmark variants) writes
    each copy's source and patched headers to a directory of its own, leaves
    csrc/ as it was, builds each copy once and returns its report; a patch
    whose text is not in its file exactly once raises before any build."""
    commands = []

    def fake_nvcc(src, out):
        commands.append((src, out))
        return [sys.executable, "-c", f"print('report of {src.parent.name}')"]

    monkeypatch.setattr(_build, "nvcc_command", fake_nvcc)
    header = (_build.CSRC / "flash_bwd_sm90.cuh").read_text()
    old = "constexpr int kStages = 2;"
    built = _build.build_copies("flash_bwd", {
        "tree": {}, "stages_3": {"flash_bwd_sm90.cuh": [(old, "constexpr int kStages = 3;")]},
    }, tmp_path)
    assert sorted(built) == ["stages_3", "tree"]
    assert (_build.CSRC / "flash_bwd_sm90.cuh").read_text() == header
    for name, (so, report) in built.items():
        assert so == tmp_path / name / "flash_bwd.so"
        assert report.strip() == f"report of {name}"
        assert ((tmp_path / name / "flash_bwd.cu").read_text()
                == (_build.CSRC / "flash_bwd.cu").read_text())
    assert not (tmp_path / "tree" / "flash_bwd_sm90.cuh").exists()
    assert (tmp_path / "stages_3" / "flash_bwd_sm90.cuh").read_text() == header.replace(
        old, "constexpr int kStages = 3;")
    assert len(commands) == 2
    with pytest.raises(RuntimeError, match="exactly once"):
        _build.build_copies("flash_bwd", {"x": {"flash_bwd_sm90.cuh": [("no such text", "")]}},
                            tmp_path)
    assert len(commands) == 2


def test_planted_faults_patch_real_code():
    """Every planted fault of chip_smoke.py (K1's fma and wgmma loops and
    its head_dim 80 tail boxes, K2, K3's bias policy, K4's two-kernel fma
    path and fused kernel, its head_dim 80 tail boxes included) names source
    text that occurs exactly once in the file it patches, so each broken
    copy differs from the real kernel. At least 5 patch the wgmma forward's
    bias policy and head_dim 80 code, which took the place of the mma.sync
    loop and its 6 faults; at least 2 the fused backward's head_dim 80 tail
    boxes."""
    import chip_smoke

    sets = ((chip_smoke.FAULTS, "flash_fwd"), (chip_smoke.QMV_FAULTS, "qmv"),
            (chip_smoke.K3_FAULTS, "flash_fwd"), (chip_smoke.K4_FAULTS, "flash_bwd"))
    wgmma = {"flash_fwd_sm90.cuh": 0, "flash_bwd_sm90.cuh": 0}
    for faults, src in sets:
        for name, (what, old, new, *where) in faults.items():
            target = where[0] if where else f"{src}.cu"
            assert (_build.CSRC / target).read_text().count(old) == 1, name
            assert old != new and what, name
            if target in wgmma:
                wgmma[target] += 1
    assert min(wgmma.values()) >= 5, wgmma
    new_code = [n for n, f in {**chip_smoke.FAULTS, **chip_smoke.K3_FAULTS}.items()
                if f[3:] == ("flash_fwd_sm90.cuh",) and n.startswith(("d80_", "bias_"))]
    assert len(new_code) >= 6, new_code
    assert not [n for n in chip_smoke.FAULTS if n.startswith("mma_")]
    d80_bwd = [n for n, f in chip_smoke.K4_FAULTS.items()
               if f[3:] == ("flash_bwd_sm90.cuh",) and n.startswith("fused_d80_")]
    assert len(d80_bwd) >= 2, d80_bwd


def test_k1_counts_launches_by_path():
    """The wrapper keeps a launch count per path beside the total; a CPU
    call runs the plain version and counts nothing."""
    assert fa.K1_PATHS == ("fma", "wgmma")
    assert set(fa.flash_fwd_cuda.launches_by_path) == set(fa.K1_PATHS)
    q = t(randn(7, 1, 2, 16, 64))
    before = dict(fa.flash_fwd_cuda.launches_by_path)
    fa.flash_attention(q, q, q)
    assert fa.flash_fwd_cuda.launches_by_path == before
