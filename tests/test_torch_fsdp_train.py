"""The port's FSDP training step (`train/train_step.py` with a mesh) on gloo
ranks against the JAX package's `make_train_step(mesh=...)` on the virtual
CPU devices, at meshes (2, 1) and (1, 2), on the toy batch of
tests/test_torch_train.py, whose two rows hold unequal counts of valid
tokens (at (2, 1) each rank holds one row): three steps' losses, grad
norms and individual losses within 1e-5 relative, and the parameters
after them as test_torch_train holds them. The checkpoint FSDP gathers
equals the one-process trainer's file after the same steps, a one-process
file restored at the mesh gathers back to itself, and the launcher runs
with `--n-model`. CPU, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.core.mesh import make_mesh
from instructany2pix_tpu.llm import multimodal as j_mm
from instructany2pix_tpu.train import train_step as j_ts
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.core import checkpoint as ckpt_lib
from instructany2pix_tpu_torch.train import train_step as ts
from test_torch_train import (LR, PARAM_MAX_OF_LR, PARAM_MEAN_OF_LR, SEED, _batches, _datasets,
                              _models, _toy_files, _torch_batch)
from torch_port_helpers import assert_close, spawn_ranks

LOSS_TOL = 1e-5  # relative, as test_torch_train
STEPS = 3
# the gathered checkpoint against the one-process file after the same steps:
# the gradients sum over ranks in another order, so the parameters are held
# as test_torch_train holds them against JAX, and the first moments (each a
# sum of gradients) within 1e-5 of their largest element
MOMENT_TOL = 1e-5


@pytest.mark.parametrize("dims", [(2, 1), (1, 2)])
def test_fsdp_steps_match_jax_and_checkpoint(tmp_path, dims):
    jds, pds = _datasets(tmp_path)
    jb, pb = _batches(jds, pds, j_mm.Any2PixLMConfig.tiny())
    valid = (pb["labels"][:, 1:] != -100).sum(1)
    assert valid[0] != valid[1], valid  # the ranks of (2, 1) hold unequal counts
    jcfg, pcfg, params, module = _models(jds.token_ids)
    weights = convert.to_numpy(params)  # the JAX step donates its state
    tcfg = dict(learning_rate=LR, total_steps=100)
    n = dims[0] * dims[1]
    jmesh = make_mesh(n_data=dims[0], n_model=dims[1], devices=jax.devices()[:n])
    j_init, j_step = j_ts.make_train_step(jcfg, j_ts.TrainConfig(**tcfg), mesh=jmesh)
    jstate = j_init(params)
    jbatch = {k: jnp.asarray(v) for k, v in jb.items()}
    jm = []
    for _ in range(STEPS):
        jstate, m = j_step(jstate, jbatch)
        jm.append({k: float(v) for k, v in m.items()})

    # the one-process trainer, the same steps, its checkpoint
    init_state, step = ts.make_train_step(pcfg, ts.TrainConfig(**tcfg))
    state = init_state(module)
    for _ in range(STEPS):
        state, _ = step(state, _torch_batch(pb))
    one = str(tmp_path / "one.pt")
    ckpt_lib.save(one, state)

    dp, _ = _toy_files(tmp_path)
    launch_args = ["--data", dp, "--media-map", str(tmp_path / "map.json"), "--media-root",
                   str(tmp_path), "--tiny", "--batch-size", "2", "--max-length", "512",
                   "--log-steps", "1", "--steps", "2", "--preview-steps", "0"]
    outs = spawn_ranks("fsdp_train", n, tmp_path, {
        "mesh": dims, "token_ids": jds.token_ids, "tcfg": tcfg, "steps": STEPS,
        "params": weights, "batch": pb, "restore": one,
        "launch": launch_args if dims == (1, 2) else None})
    for r, o in enumerate(outs):
        assert o["n_sharded"] > 0 and o["n_replicated"] > 0
        for i, (got, want) in enumerate(zip(o["metrics"], jm)):
            assert sorted(got) == sorted(want)
            for k in want:
                assert_close(np.float32(got[k]), want[k], LOSS_TOL, i, rel=True,
                             what=f"rank {r} step {i + 1} {k}")

    # the gathered checkpoint against JAX's parameters and the one-process file
    blob = torch.load(outs[0]["ckpt"], weights_only=True)
    ref = torch.load(one, weights_only=True)
    assert sorted(blob["params"]) == sorted(ref["params"])
    assert blob["step"] == ref["step"] == STEPS and blob["opt_state"]["count"] == STEPS
    lr_sum = sum(ts.learning_rate(ts.TrainConfig(**tcfg), i) for i in range(STEPS))
    for k, v in ref["params"].items():
        assert v.shape == blob["params"][k].shape and v.dtype == blob["params"][k].dtype, k
        rounding = 1e-6 * float(v.abs().max())
        assert_close(blob["params"][k], v.numpy(), PARAM_MAX_OF_LR * lr_sum + rounding, 0,
                     what=f"ckpt {k}")
    for a, b in zip(blob["opt_state"]["mu"], ref["opt_state"]["mu"]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert_close(a, b.numpy(), MOMENT_TOL, 0, rel=True, what="mu")
    module.load_state_dict(blob["params"])
    flat_j = jax.tree_util.tree_flatten_with_path(convert.to_numpy(jstate["params"]))[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(convert.to_tree(module))[0])
    for path, a in flat_j:
        rounding = 1e-6 * float(np.abs(a).max())
        what = f"params {jax.tree_util.keystr(path)}"
        assert_close(flat_p[path], a, PARAM_MAX_OF_LR * lr_sum + rounding, SEED, what=what)
        mean = float(np.abs(flat_p[path] - a).mean())
        assert mean <= PARAM_MEAN_OF_LR * lr_sum + rounding, f"{what}: mean diff {mean:.3g}"

    # the one-process file restored at the mesh gathers back to itself, on every rank
    for o in outs:
        back = o["restored"]
        assert back["step"] == back["count"] == STEPS
        for k, v in ref["params"].items():
            np.testing.assert_array_equal(back["params"][k], v.numpy(), err_msg=k)
        for a, b in zip(back["mu"], ref["opt_state"]["mu"]):
            np.testing.assert_array_equal(a, b.numpy())
    if dims == (1, 2):
        for o in outs:
            hist = o["launch"]["history"]
            assert len(hist) == 2 and all(np.isfinite(list(m.values())).all() for m in hist)
        assert outs[0]["launch"]["saves"][-1]["step"] == 2 and not outs[1]["launch"]["saves"]
