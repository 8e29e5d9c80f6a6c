"""Model surgery in the port against the JAX package: `make_delta` and
`apply_delta` over an LLM state dict whose embedding and `lm_head` grew by
the 9 added special tokens (kept verbatim), and `consolidate` re-saving a
sharded directory as one file the port's loaders read."""

import os

import numpy as np
import pytest
import torch

from instructany2pix_tpu.core import tree as j_tree
from instructany2pix_tpu.utils import surgery as j_surgery
from instructany2pix_tpu_torch.core import checkpoint as ckpt_lib
from instructany2pix_tpu_torch.utils import surgery

ADDED = 9


def _state(seed, vocab, d=8):
    rs = np.random.RandomState(seed)
    return {"model.embed_tokens.weight": rs.randn(vocab, d).astype(np.float32),
            "lm_head.weight": rs.randn(vocab, d).astype(np.float32),
            "model.layers.0.self_attn.q_proj.weight": rs.randn(d, d).astype(np.float32),
            "model.norm.weight": rs.randn(d).astype(np.float32)}


def test_delta_round_trip_matches_jax():
    base = _state(0, 32)
    fine = _state(1, 32 + ADDED)
    fine["model.vae_predictor_image.0.weight"] = np.ones((4, 8), np.float32)  # not in the base
    tb = {k: torch.from_numpy(v) for k, v in base.items()}
    tf = {k: torch.from_numpy(v) for k, v in fine.items()}
    delta = surgery.make_delta(tf, tb)
    jdelta = j_tree.flatten(j_surgery.make_delta(j_tree.unflatten(fine), j_tree.unflatten(base)))
    assert delta.keys() == jdelta.keys()
    for k in delta:
        np.testing.assert_array_equal(delta[k].numpy(), np.asarray(jdelta[k]), err_msg=k)
    emb = delta["model.embed_tokens.weight"]
    assert emb.shape == (32 + ADDED, 8)
    # the added rows verbatim, the shared rows as differences
    assert torch.equal(emb[32:], tf["model.embed_tokens.weight"][32:])
    assert torch.equal(emb[:32], tf["model.embed_tokens.weight"][:32] - tb["model.embed_tokens.weight"])
    back = surgery.apply_delta(delta, tb)
    jback = j_tree.flatten(j_surgery.apply_delta(j_tree.unflatten(
        {k: np.asarray(v) for k, v in jdelta.items()}), j_tree.unflatten(base)))
    for k in fine:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]), err_msg=k)
        np.testing.assert_allclose(back[k].numpy(), fine[k], atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="beyond the row count"):
        surgery.make_delta({"x": torch.zeros(3, 4)}, {"x": torch.zeros(3, 5)})


def test_consolidate_reads_back_as_one_shard(tmp_path):
    sd = {k: torch.from_numpy(v) for k, v in _state(2, 41).items()}
    src, dst = tmp_path / "sharded", tmp_path / "one"
    src.mkdir()
    keys = sorted(sd)
    for i, part in enumerate((keys[:2], keys[2:])):
        torch.save({k: sd[k] for k in part}, src / f"pytorch_model-{i + 1:05d}-of-00002.bin")
    out = surgery.consolidate(str(src), str(dst))
    assert os.path.basename(out) == "pytorch_model.bin"
    assert ckpt_lib.shard_files(str(dst)) == [out]
    got = ckpt_lib.load_sharded(str(dst))
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
