"""The port's ring attention (`parallel/ring_attention.py`) on gloo ranks
against the JAX package's `ring_attention` on the virtual CPU devices, at
2 ranks (the model axis of a (1, 2) mesh) and 4 (the data axis of a (4, 1)
mesh), causal and not: each rank's block of the output within the JAX
test's 2e-5 (tests/test_ring_attention.py), and the K/V rotations counted
as collective-permutes. CPU, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instructany2pix_tpu.core.mesh import make_mesh
from instructany2pix_tpu.parallel.ring_attention import ring_attention
from torch_port_helpers import randn, spawn_ranks

TOL = 2e-5  # tests/test_ring_attention.py
B, S, H, D = 2, 64, 4, 16


@pytest.mark.parametrize("dims,axis", [((1, 2), "model"), ((4, 1), "data")])
def test_ring_attention_matches_jax(tmp_path, dims, axis):
    n = dims[0] * dims[1]
    jmesh = make_mesh(n_data=dims[0], n_model=dims[1], devices=jax.devices()[:n])
    cases, want = [], []
    for causal in (False, True):
        seed = 7 + 3 * int(causal) + n
        q, k, v = (randn(seed + i, B, S, H, D) for i in range(3))
        cases.append({"q": q, "k": k, "v": v, "axis": axis, "causal": causal})
        want.append(np.asarray(ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              jmesh, axis=axis, causal=causal)))
    outs = spawn_ranks("ring", n, tmp_path, {"mesh": dims, "cases": cases})
    size = outs[0]["outs"][0].shape[1]
    assert size == S // dims[0 if axis == "data" else 1]
    for c, ref in enumerate(want):
        blocks = {}
        for r, o in enumerate(outs):
            idx = divmod(r, dims[1])[0 if axis == "data" else 1]
            blocks.setdefault(idx, o["outs"][c])
            np.testing.assert_array_equal(blocks[idx], o["outs"][c])  # replicas agree
        got = np.concatenate([blocks[i] for i in range(len(blocks))], axis=1)
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL, err_msg=f"case {c}")
    ring_size = len({divmod(r, dims[1])[0 if axis == "data" else 1] for r in range(n)})
    # n - 1 rotations of k and v per case, each one block of float32
    per = B * size * H * D * 4
    assert outs[0]["counts"]["collective-permute"] == {
        "count": 2 * 2 * (ring_size - 1), "bytes": 2 * 2 * (ring_size - 1) * per}
