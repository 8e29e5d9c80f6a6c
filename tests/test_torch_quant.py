"""Port quantization vs the JAX package: the quantizers (bytes and scales
identical), the unpack and the prefill product, K2's plain version against
`pallas_qmatmul` (which interprets its Pallas kernel on the CPU), the
linear router against `_use_pallas_qmv`, and the quantized `linear` with
every fusion. CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.models import layers as jL
from instructany2pix_tpu.ops import quant as jq
from instructany2pix_tpu_torch.models import layers as L
from instructany2pix_tpu_torch.ops import quant as Q
from torch_port_helpers import assert_close, randn, t

QUANTIZERS = {
    "int8": (jq.quantize_weight, Q.quantize_weight),
    "int4": (jq.quantize_weight_int4, Q.quantize_weight_int4),
    "int4g": (jq.quantize_weight_int4_grouped, Q.quantize_weight_int4_grouped),
}
# K2's plain version vs the Pallas kernel interpreted on the CPU: float32
# sums of the same products in another order, so 1e-5 of the largest
# output in float32. In bf16 the two may round a sum to neighbouring bf16
# values, before and after the residual: one bf16 ulp (2^-7 relative) of
# the larger of the output and the product before the residual. With a
# prologue, the plain version rounds x' to bf16 as the kernel does, while
# XLA on the CPU may keep it in float32 (it folds the convert into the
# dot): each x'_k then differs by up to 2^-8 relative, a sum whose spread
# is under 2^-8 sigma, sigma = sqrt(sum_k (x'_k W_kn)^2); 2^-6 sigma is 4
# of those.
QMV_TOL_F32 = 1e-5
BF16_ULP = 2.0**-7
BF16_PROLOGUE_STOL = 2.0**-6


def _q_torch(q):
    return {k: torch.from_numpy(np.array(v)) for k, v in q.items()}


@pytest.mark.parametrize("fmt", sorted(QUANTIZERS))
@pytest.mark.parametrize("k,n", [(256, 128), (256, 384), (512, 128), (512, 384)])
def test_quantized_bytes_and_scales_identical(fmt, k, n):
    seed = k + n
    w = randn(seed, k, n)
    jfn, tfn = QUANTIZERS[fmt]
    qj, qt = jfn(jnp.asarray(w)), tfn(t(w))
    assert set(qj) == set(qt)
    for key in qj:
        a, b = np.asarray(qj[key]), qt[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), f"{fmt} {key}: seed {seed}, {int((a != b).sum())} differ"


def test_unpack_and_int4_matmul_match_jax():
    w, x = randn(1, 256, 128), randn(2, 3, 256)
    for quant_j in (jq.quantize_weight_int4, jq.quantize_weight_int4_grouped):
        qj = quant_j(jnp.asarray(w))
        qt = _q_torch(qj)
        assert np.array_equal(Q.unpack_int4(qt["w_q4"]).numpy(), np.asarray(jq.unpack_int4(qj["w_q4"])))
        assert_close(Q.int4_matmul(t(x), qt), jq.int4_matmul(jnp.asarray(x), qj), 1e-5, 1,
                     rel=True, what=quant_j.__name__)


# (format, fusion, M, dtype): each fusion in each format, both M, both dtypes
QMV_CASES = [
    ("int8", "none", 1, "float32"), ("int8", "norm", 16, "bfloat16"),
    ("int8", "swiglu", 1, "bfloat16"), ("int8", "residual", 16, "float32"),
    ("int8", "swiglu+residual", 1, "float32"),
    ("int4", "none", 16, "bfloat16"), ("int4", "norm", 1, "float32"),
    ("int4", "swiglu", 16, "float32"), ("int4", "residual", 1, "bfloat16"),
    ("int4", "swiglu+residual", 16, "bfloat16"),
    ("int4g", "none", 1, "float32"), ("int4g", "norm", 16, "float32"),
    ("int4g", "swiglu", 1, "bfloat16"), ("int4g", "residual", 16, "bfloat16"),
    ("int4g", "swiglu+residual", 1, "bfloat16"),
]


@pytest.mark.parametrize("fmt,fusion,m,dtype", QMV_CASES)
def test_qmv_plain_matches_pallas_interpret(fmt, fusion, m, dtype):
    seed = 100 + QMV_CASES.index((fmt, fusion, m, dtype))
    k, n = 512, 256
    swiglu = "swiglu" in fusion
    xk = 2 * k if swiglu else k
    qj = QUANTIZERS[fmt][0](jnp.asarray(randn(seed, k, n)))
    qt = _q_torch(qj)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = randn(seed + 1, m, xk)
    g = randn(seed + 2, xk, scale=0.1) + 1.0 if fusion == "norm" else None
    r = randn(seed + 3, m, n) if "residual" in fusion else None
    xj = jnp.asarray(x).astype(jdt)
    ref = jq.pallas_qmatmul(
        xj, qj, interpret=True, norm_g=jnp.asarray(g) if g is not None else None,
        swiglu=swiglu, residual=jnp.asarray(r).astype(jdt) if r is not None else None,
    )
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    out = Q.qmatmul(
        xt, qt, norm_g=t(g) if g is not None else None, swiglu=swiglu,
        residual=t(r).to(tdt) if r is not None else None,
    )
    assert out.dtype == tdt and out.shape == (m, n)
    a, b = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    d = np.abs(a - b)
    if dtype == "float32":
        limit = QMV_TOL_F32 * np.abs(b).max()
    else:
        pre = b - (np.asarray(jnp.asarray(r).astype(jdt).astype(jnp.float32)) if r is not None else 0)
        limit = BF16_ULP * np.maximum(np.abs(b), np.abs(pre))
        if g is not None or swiglu:
            h = Q._prologue(xt, t(g) if g is not None else None, 1e-6, swiglu).float()
            wd = (Q.unpack_int4(qt["w_q4"]) if "w_q4" in qt else qt["w_q"]).float()
            s = qt["gscale"].repeat_interleave(k // qt["gscale"].shape[0], 0) if fmt == "int4g" \
                else qt["scale"][None]
            sigma = torch.sqrt((h * h) @ (wd * s) ** 2).numpy()
            limit = limit + BF16_PROLOGUE_STOL * sigma
    assert (d <= limit).all(), (
        f"{fmt} {fusion} M={m} {dtype}: seed {seed} max diff {d.max():.3g} mean {d.mean():.3g}")


def test_qmv_cpu_path_is_plain_and_uncounted():
    q = Q.quantize_weight_int4_grouped(t(randn(0, 256, 128)))
    x = t(randn(1, 1, 256))
    before = Q.qmv_cuda.launches
    y = Q.qmatmul(x, q)
    assert Q.qmv_cuda.launches == before
    assert torch.equal(y, Q._qmv_reference(x, q))


def test_qmv_kernel_wrapper_rejects_what_it_does_not_take():
    q = Q.quantize_weight_int4_grouped(t(randn(0, 256, 128)))
    with pytest.raises(ValueError, match="CUDA"):
        Q.qmv_cuda(t(randn(1, 1, 256)), q)


@pytest.mark.parametrize("m,n", [(1, 256), (16, 256), (17, 256), (1, 200), (16, 384)])
def test_router_matches_use_pallas_qmv(monkeypatch, m, n):
    """M <= 16 and N % 128 == 0 take K2, as the JAX rule on its TPU."""
    w = randn(m + n, 256, n)
    qj = jq.quantize_weight(jnp.asarray(w))
    x = randn(1, m, 256)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = jL._use_pallas_qmv(qj, jnp.asarray(x))
    assert L._use_qmv(Q.QLinear(_q_torch(qj)), t(x)) == want


@pytest.mark.parametrize("fmt", sorted(QUANTIZERS))
def test_quantized_linear_matches_jax_composed(fmt):
    """`linear` with a QLinear and every fusion against the JAX `linear`
    (whose CPU path composes the ops); M = 1 takes K2's plain version,
    M = 20 the prefill product."""
    k, n = 256, 128
    qj = QUANTIZERS[fmt][0](jnp.asarray(randn(3, k, n)))
    lin = Q.QLinear(_q_torch(qj))
    g = randn(4, k, scale=0.1) + 1.0
    for m in (1, 20):
        x, r = randn(5 + m, 1, m, k), randn(6 + m, 1, m, n)
        ref = jL.linear(qj, jnp.asarray(x), norm=(jnp.asarray(g), 1e-6), residual=jnp.asarray(r))
        out = L.linear(lin, t(x), norm=(t(g), 1e-6), residual=t(r))
        assert_close(out, ref, 1e-5, m, rel=True, what=f"{fmt} M={m}")
        gu = randn(7 + m, 1, m, 2 * k)
        ref = jL.linear(qj, jnp.asarray(gu), swiglu=True)
        assert_close(L.linear(lin, t(gu), swiglu=True), ref, 1e-5, m, rel=True,
                     what=f"{fmt} swiglu M={m}")
