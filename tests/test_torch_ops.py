"""Port ops vs the JAX package: flash attention (K1's plain version vs the
Pallas kernel in interpret mode), the attention router, GroupNorm and the
layer primitives. CPU, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.models import layers as jL
from instructany2pix_tpu.ops.attention import dot_product_attention as j_dpa
from instructany2pix_tpu.ops.flash_attention import _flash_fwd, flash_attention as j_flash
from instructany2pix_tpu.ops.groupnorm import group_norm as j_group_norm
from instructany2pix_tpu_torch.models import layers as L
from instructany2pix_tpu_torch.ops import flash_attention as fa
from instructany2pix_tpu_torch.ops.attention import dot_product_attention
from instructany2pix_tpu_torch.ops.groupnorm import group_norm
from torch_port_helpers import assert_close, randn, t

# float32 on both sides; the kernels accumulate in another order
FLASH_TOL = 2e-5
DPA_TOL = 1e-5
GN_TOL = 1e-5


@pytest.mark.parametrize(
    "causal,sq,sk,d",
    [
        (False, 128, 128, 64),
        (True, 128, 128, 64),
        (False, 100, 77, 80),
        (True, 64, 200, 128),
        (False, 200, 64, 128),
        (True, 130, 130, 80),
    ],
)
def test_flash_plain_matches_pallas_interpret(causal, sq, sk, d):
    seed = sq * 1000 + sk + d + int(causal)
    q, k, v = randn(seed, 2, 3, sq, d), randn(seed + 1, 2, 3, sk, d), randn(seed + 2, 2, 3, sk, d)
    scale = d**-0.5
    o_j = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale, interpret=True)
    _, lse_j = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
                          128, 128, interpret=True, return_lse=True)
    o, lse = fa.flash_attention(t(q), t(k), t(v), causal, scale, return_lse=True)
    assert_close(o, o_j, FLASH_TOL, seed, what="o")
    assert_close(lse, lse_j, FLASH_TOL, seed, rel=True, what="lse")


def test_flash_cpu_path_is_plain_and_uncounted():
    q = t(randn(0, 1, 2, 16, 32))
    before = fa.flash_fwd_cuda.launches
    out = fa.flash_attention(q, q, q)
    assert fa.flash_fwd_cuda.launches == before
    assert torch.equal(out, fa._reference_attention(q, q, q, False, 32**-0.5))


def test_flash_kernel_wrapper_rejects_cpu_tensors():
    q = t(randn(0, 1, 2, 16, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, q, q, False, 1.0)


@pytest.mark.parametrize("case", ["plain", "causal", "mask2d", "mask3d", "gqa", "causal_mask"])
def test_dot_product_attention_matches_jax(case):
    seed = {"plain": 1, "causal": 2, "mask2d": 3, "mask3d": 4, "gqa": 5, "causal_mask": 6}[case]
    b, sq, sk, h, d = 2, 24, 24 if "causal" in case else 20, 4, 16
    hk = 2 if case == "gqa" else h
    q, k, v = randn(seed, b, sq, h, d), randn(seed + 1, b, sk, hk, d), randn(seed + 2, b, sk, hk, d)
    rs = np.random.RandomState(seed)
    mask = None
    if case in ("mask2d", "causal_mask"):
        mask = rs.rand(b, sk) > 0.3
        mask[:, 0] = True
    elif case == "mask3d":
        mask = rs.rand(b, sq, sk) > 0.3
        mask[:, :, 0] = True
    causal = "causal" in case
    ref = j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                mask=None if mask is None else jnp.asarray(mask))
    out = dot_product_attention(t(q), t(k), t(v), causal=causal,
                                mask=None if mask is None else t(mask))
    assert_close(out, ref, DPA_TOL, seed, what=case)
    xla = dot_product_attention(t(q), t(k), t(v), causal=causal,
                                mask=None if mask is None else t(mask), impl="xla")
    assert_close(xla, ref, DPA_TOL, seed, what=case + " impl=xla")


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape,groups,eps", [((2, 8, 8, 64), 32, 1e-5), ((2, 40, 16), 4, 1e-6)])
def test_group_norm_matches_jax(silu, shape, groups, eps):
    seed = len(shape) * 10 + int(silu)
    x = randn(seed, *shape, scale=3.0) + 5.0  # large mean: two-pass variance matters
    g, b = randn(seed + 1, shape[-1]), randn(seed + 2, shape[-1])
    ref = j_group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), groups, eps, silu)
    out = group_norm(t(x), t(g), t(b), groups, eps, silu)
    assert_close(out, ref, GN_TOL, seed, what="group_norm")


def test_layer_primitives_match_jax():
    seed = 11
    tsteps = np.array([0.0, 17.0, 999.0], np.float32)
    for flip, shift in ((False, 1.0), (True, 0.0)):
        ref = jL.timestep_embedding(jnp.asarray(tsteps), 33, flip_sin_to_cos=flip,
                                    downscale_freq_shift=shift)
        out = L.timestep_embedding(t(tsteps), 33, flip_sin_to_cos=flip, downscale_freq_shift=shift)
        assert_close(out, ref, 1e-5, seed, what=f"timestep_embedding flip={flip}")

    x = randn(seed, 2, 6, 6, 4)
    assert_close(L.upsample2x_nearest(t(x)), jL.upsample2x_nearest(jnp.asarray(x)), 0, seed,
                 what="upsample")
    for g in (L.gelu, L.quick_gelu, L.silu):
        jg = getattr(jL, g.__name__)
        assert_close(g(t(x)), jg(jnp.asarray(x)), 1e-6, seed, what=g.__name__)

    emb = torch.nn.Embedding(5, 3)
    ids = torch.tensor([[-2, 0, 4, 9]])
    out = L.embedding(emb, ids)
    ref = jL.embedding({"w": jnp.asarray(emb.weight.detach().numpy())}, jnp.asarray(ids.numpy()))
    assert_close(out, ref, 0, seed, what="embedding clamps")

    conv = torch.nn.Conv2d(4, 5, 3)
    w_hwio = jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 1, 0))
    p = {"w": w_hwio, "b": jnp.asarray(conv.bias.detach().numpy())}
    for stride, pad in ((1, "SAME"), (2, [(1, 1), (1, 1)]), (2, "VALID")):
        ref = jL.conv2d(p, jnp.asarray(x), stride=stride, padding=pad)
        out = L.conv2d(conv, t(x), stride=stride, padding=pad)
        assert_close(out, ref, 1e-5, seed, what=f"conv2d {stride} {pad}")
    assert jax.default_backend() == "cpu"
