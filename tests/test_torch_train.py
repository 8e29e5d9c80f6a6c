"""The port's training path against the JAX package on the toy dataset of
tests/test_serve_train.py: the collated batch (byte-identical), the tiny
`train_forward` losses, three `train_step`s from the same converted
parameters, the generation preview and the optimizer against optax; the
port alone: remat policies, the launcher (2 steps, save, resume), the
checkpoint and the native-loader shim. CPU, float32."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instructany2pix_tpu.llm import multimodal as j_mm
from instructany2pix_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
from instructany2pix_tpu.llm.tokenizer import initialize_vision_tokenizer as j_init_tok
from instructany2pix_tpu.train import data as j_data
from instructany2pix_tpu.train import native_loader as j_native
from instructany2pix_tpu.train import train_step as j_ts
from instructany2pix_tpu.utils import logging as j_logging
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.core import checkpoint as ckpt_lib
from instructany2pix_tpu_torch.llm import multimodal as mm
from instructany2pix_tpu_torch.llm.tokenizer import ByteTokenizer, initialize_vision_tokenizer
from instructany2pix_tpu_torch.models import llama as llama_lib
from instructany2pix_tpu_torch.train import data as data_lib
from instructany2pix_tpu_torch.train import launch
from instructany2pix_tpu_torch.train import native_loader
from instructany2pix_tpu_torch.train import train_step as ts
from instructany2pix_tpu_torch.utils import logging as logging_lib
from torch_port_helpers import assert_close, randn

# float32 on both sides (JAX matmuls at "highest"); the sums run in
# another order, and the losses sum over a few hundred positions
LOSS_TOL = 1e-5
# Parameters after three AdamW steps. Each update is lr * m / (sqrt(v) + eps),
# at most about lr per step. Where a gradient element is near eps (1e-8) and
# comes out of a sum whose float32 rounding in another order is of its own
# size, the update's factor m / (sqrt(v) + eps) moves by a few hundredths: so
# every element is held within a tenth of the summed learning rates (a sign
# error in an update moves it by twice that), and each tensor's mean
# difference within 1e-4 of them; both beside float32 rounding of the
# weights (1e-6 of the largest).
PARAM_MAX_OF_LR = 0.1
PARAM_MEAN_OF_LR = 1e-4
LR = 1e-3
SEED = 0



@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Another test file turns grad mode off when it is imported, and pytest
    imports every test file in each worker: these tests need it on."""
    with torch.enable_grad():
        yield


def _records():
    return [
        {"conversations": [{"from": "human", "value": "add [a dog] to [a cat]"},
                           {"from": "gpt", "value": "[a dog next to a cat]"}],
         "base": "base img", "target": "target img", "modality": "image",
         "additions": ["a dog"]},
        {"conversations": [{"from": "human", "value": "make a sound like [a dog]"},
                           {"from": "gpt", "value": "[dog barking]"}],
         "target": "target img", "modality": "audio"},
    ]


def _toy_files(tmp_path):
    feats = {}
    rs = np.random.RandomState(0)
    for name in ["a dog", "a cat", "base img", "target img"]:
        p = tmp_path / f"{name.replace(' ', '_')}.npz"
        np.savez(p, state=rs.randn(16).astype(np.float32))
        feats[name] = p.name
    dp = tmp_path / "data.json"
    dp.write_text(json.dumps(_records()))
    (tmp_path / "map.json").write_text(json.dumps(feats))
    return str(dp), feats


def _datasets(tmp_path, **kw):
    dp, feats = _toy_files(tmp_path)
    dcfg = dict(max_length=512, video_prob=0.8, base_drop_prob=0.2, audio_codec_dim=8, **kw)
    jtok, ptok = JByteTokenizer(), ByteTokenizer()
    jids, pids = j_init_tok(jtok), initialize_vision_tokenizer(ptok)
    assert jids == pids
    jds = j_data.InstructionDataset(dp, j_data.MediaMap(feats, str(tmp_path), 16), jtok, jids,
                                    j_data.DataConfig(**dcfg), seed=SEED)
    pds = data_lib.InstructionDataset(dp, data_lib.MediaMap(feats, str(tmp_path), 16), ptok,
                                      pids, data_lib.DataConfig(**dcfg), seed=SEED)
    return jds, pds


def _batches(jds, pds, cfg):
    jb = j_data.collate([jds[0], jds[1]], jds.tokenizer, jds.token_ids, jds.cfg,
                        codec_dim=cfg.image_codec_dim)
    pb = data_lib.collate([pds[0], pds[1]], pds.tokenizer, pds.token_ids, pds.cfg,
                          codec_dim=cfg.image_codec_dim)
    return jb, pb


def _models(token_ids):
    jcfg = j_mm.Any2PixLMConfig.tiny(token_ids)
    pcfg = mm.Any2PixLMConfig.tiny(token_ids)
    params = j_mm.init(jax.random.key(SEED), jcfg)
    module = convert.llm(convert.to_numpy(params), pcfg, trainable=True)
    return jcfg, pcfg, params, module


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_collate_byte_identical(tmp_path):
    jds, pds = _datasets(tmp_path)
    for _ in range(3):  # several draws of the datasets' rewrite streams
        jb, pb = _batches(jds, pds, j_mm.Any2PixLMConfig.tiny())
        assert sorted(jb) == sorted(pb)
        for k in jb:
            assert jb[k].dtype == pb[k].dtype and jb[k].shape == pb[k].shape, k
            assert jb[k].tobytes() == pb[k].tobytes(), k
    lengths = [5, -3, 10, 2, -8, 1] * 30
    assert np.array_equal(j_data.length_grouped_indices(lengths, 2, np.random.RandomState(1)),
                          data_lib.length_grouped_indices(lengths, 2, np.random.RandomState(1)))
    assert jds.modality_lengths == pds.modality_lengths


def test_rewrite_multimodal_audio_identical(tmp_path):
    _, feats = _toy_files(tmp_path)
    rec = {"conversations": [{"from": "human", "value": "what image matches <audio>?"},
                             {"from": "gpt", "value": "[a dog photo]"}],
           "target": "target img", "modality": "image",
           "multimodal_input": {"type": "audio", "src": "a dog"}}
    kw = dict(max_length=512, video_prob=1.0, base_drop_prob=0.0, audio_codec_dim=8)
    je = j_data.rewrite_example(rec, j_data.MediaMap(feats, str(tmp_path), 16),
                                j_data.DataConfig(**kw), np.random.RandomState(0))
    pe = data_lib.rewrite_example(rec, data_lib.MediaMap(feats, str(tmp_path), 16),
                                  data_lib.DataConfig(**kw), np.random.RandomState(0))
    assert je["conversations"] == pe["conversations"]
    assert je["extra_audio"].tobytes() == pe["extra_audio"].tobytes()
    ids = initialize_vision_tokenizer(ByteTokenizer())
    jb = j_data.collate([je], JByteTokenizer(), ids, j_data.DataConfig(**kw), codec_dim=16)
    pb = data_lib.collate([pe], ByteTokenizer(), ids, data_lib.DataConfig(**kw), codec_dim=16)
    assert all(jb[k].tobytes() == pb[k].tobytes() for k in jb) and sorted(jb) == sorted(pb)
    # the spliced audio frames reach the loss on both sides
    jcfg, pcfg, params, module = _models(ids)
    loss_j, _ = j_mm.train_forward(params, jcfg, {k: jnp.asarray(v) for k, v in jb.items()})
    loss, _ = mm.train_forward(module, pcfg, _torch_batch(pb))
    assert_close(loss, loss_j, LOSS_TOL, 0, rel=True, what="loss with extra audio")


def test_train_forward_matches_jax(tmp_path):
    jds, pds = _datasets(tmp_path)
    jb, pb = _batches(jds, pds, j_mm.Any2PixLMConfig.tiny())
    jcfg, pcfg, params, module = _models(jds.token_ids)
    loss_j, ind_j = j_mm.train_forward(params, jcfg, {k: jnp.asarray(v) for k, v in jb.items()})
    loss, ind = mm.train_forward(module, pcfg, _torch_batch(pb))
    assert sorted(ind) == sorted(ind_j) == ["loss_aud", "loss_extra", "loss_img", "loss_lang"]
    assert_close(loss, loss_j, LOSS_TOL, SEED, rel=True, what="loss")
    for k in ind_j:
        assert_close(ind[k], ind_j[k], LOSS_TOL, SEED, rel=True, what=k)


def test_three_train_steps_match_jax(tmp_path):
    jds, pds = _datasets(tmp_path)
    jb, pb = _batches(jds, pds, j_mm.Any2PixLMConfig.tiny())
    jcfg, pcfg, params, module = _models(jds.token_ids)
    tcfg = dict(learning_rate=LR, total_steps=100)
    j_init, j_step = j_ts.make_train_step(jcfg, j_ts.TrainConfig(**tcfg))
    init_state, step = ts.make_train_step(pcfg, ts.TrainConfig(**tcfg))
    jstate, state = j_init(params), init_state(module)
    jbatch, batch = {k: jnp.asarray(v) for k, v in jb.items()}, _torch_batch(pb)
    lr_sum = 0.0
    for i in range(3):
        jstate, jm = j_step(jstate, jbatch)
        state, m = step(state, batch)
        lr_sum += ts.learning_rate(ts.TrainConfig(**tcfg), i)
        assert sorted(m) == sorted(jm)
        for k in jm:
            assert_close(m[k], jm[k], LOSS_TOL, i, rel=True, what=f"step {i + 1} {k}")
    assert state["step"] == int(jstate["step"]) == 3
    jtree = convert.to_numpy(jstate["params"])
    ptree = convert.to_tree(module)
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(ptree)[0])
    assert len(flat_j) == len(flat_p)
    for path, a in flat_j:
        rounding = 1e-6 * float(np.abs(a).max())
        what = f"params {jax.tree_util.keystr(path)}"
        assert_close(flat_p[path], a, PARAM_MAX_OF_LR * lr_sum + rounding, SEED, what=what)
        mean = float(np.abs(flat_p[path] - a).mean())
        assert mean <= PARAM_MEAN_OF_LR * lr_sum + rounding, f"{what}: mean diff {mean:.3g}"


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(tmp_path, policy):
    import dataclasses

    jds, pds = _datasets(tmp_path)
    _, pb = _batches(jds, pds, j_mm.Any2PixLMConfig.tiny())
    _, pcfg, _, module = _models(jds.token_ids)
    batch = _torch_batch(pb)
    rcfg = dataclasses.replace(pcfg, llama=dataclasses.replace(
        pcfg.llama, remat=True, remat_policy=policy))
    params = list(module.parameters())
    grads = torch.autograd.grad(mm.train_forward(module, pcfg, batch)[0], params,
                                allow_unused=True)
    grads_r = torch.autograd.grad(mm.train_forward(module, rcfg, batch)[0], params,
                                  allow_unused=True)
    for (name, _), a, b in zip(module.named_parameters(), grads, grads_r):
        if a is None:
            assert b is None, name
            continue
        assert_close(b, a.numpy(), 1e-6 * max(float(a.abs().max()), 1e-30) + 1e-12, SEED,
                     what=f"{policy} grad {name}")


def test_kv_len_from_right_padding_only():
    m = torch.tensor([[1, 1, 1, 0], [1, 0, 0, 0]], dtype=torch.bool)
    assert llama_lib.prefix_lengths(m).tolist() == [3, 1]
    assert llama_lib.prefix_lengths(m).dtype == torch.int32
    for bad in ([[1, 0, 1, 0], [1, 1, 1, 1]], [[0, 0, 0, 0], [1, 1, 1, 1]],
                [[0, 1, 1, 1], [1, 1, 1, 1]]):
        assert llama_lib.prefix_lengths(torch.tensor(bad, dtype=torch.bool)) is None


def test_preview_generations_matches_jax(tmp_path):
    jds, pds = _datasets(tmp_path, )
    jds.cfg.video_prob = pds.cfg.video_prob = 1.0
    jb, pb = _batches(jds, pds, j_mm.Any2PixLMConfig.tiny())
    jcfg, pcfg, params, module = _models(jds.token_ids)
    gen_j = jax.device_get(j_ts.make_preview_step(jcfg)(params, {k: jnp.asarray(v)
                                                               for k, v in jb.items()}))
    gen = ts.make_preview_step(pcfg)(module, _torch_batch(pb))
    assert gen["has_gen"].tolist() == np.asarray(gen_j["has_gen"]).tolist() == [True, False]
    assert_close(gen["pred"], gen_j["pred"], LOSS_TOL, SEED, rel=True, what="pred")
    assert_close(gen["src"], gen_j["src"], 0.0, SEED, what="src")
    assert np.array_equal(logging_lib.embedding_heatmap(gen["pred"][0].numpy()),
                          j_logging.embedding_heatmap(gen["pred"][0].numpy()))


def test_optimizer_matches_optax():
    """The port's optimizer against the JAX package's optax chain over five
    steps of fixed gradients, with the global norm above the clip (steps
    0-2) and below it (3-4); the first update runs at lr 0. optax forms the
    bias corrections 1 - b^t in float32, where 1 - 0.999^t loses all but a
    few digits (an ulp of 0.999^t is 1.5e-5 of 1 - 0.999^4); the port forms
    them in double. So the parameters are held within 1e-4 of the summed
    learning rates, beside float32 rounding (1e-6 of the largest)."""
    cfg = dict(learning_rate=0.1, total_steps=8, weight_decay=0.01, max_grad_norm=1.0)
    tx = j_ts.make_optimizer(j_ts.TrainConfig(**cfg))
    opt = ts.make_optimizer(ts.TrainConfig(**cfg))
    shapes = [(4, 3), (5,), (2, 2, 2)]
    jp = [jnp.asarray(randn(i, *s)) for i, s in enumerate(shapes)]
    pp = [torch.tensor(np.asarray(x)) for x in jp]
    module = torch.nn.ParameterList([torch.nn.Parameter(x) for x in pp])
    state = opt.init(module)
    jstate = tx.init(jp)
    lr_sum = 0.0
    for step in range(5):
        scale = 3.0 if step < 3 else 0.05
        grads = [randn(10 + 3 * step + i, *s, scale=scale) for i, s in enumerate(shapes)]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        before = [p.detach().clone() for p in module]
        g_norm = opt.update(list(module), [torch.from_numpy(g) for g in grads], state)
        assert_close(g_norm, optax.global_norm([jnp.asarray(g) for g in grads]), 1e-6, step,
                     rel=True, what="grad norm")
        if step == 0:  # warmup from lr 0
            assert all(torch.equal(a, b) for a, b in zip(before, module))
        lr_sum += ts.learning_rate(ts.TrainConfig(**cfg), step)
        for a, b in zip(module, jp):
            assert_close(a, b, 1e-4 * lr_sum + 1e-6 * float(np.abs(b).max()), step,
                         what=f"params after step {step + 1}")
    schedule = optax.warmup_cosine_decay_schedule(0.0, 0.1, 1, 8, 0.0)
    for count in range(10):
        assert ts.learning_rate(ts.TrainConfig(**cfg), count) == pytest.approx(
            float(schedule(count)), rel=1e-6, abs=1e-9)


def test_clip_has_no_epsilon():
    """A gradient of norm exactly 2 with max_norm 1 is halved exactly, and
    one of norm exactly 1 is left alone (clip_grad_norm_ would scale both by
    max_norm / (norm + 1e-6))."""
    cfg = ts.TrainConfig(learning_rate=1.0, total_steps=4, warmup_ratio=0.0, max_grad_norm=1.0)
    for norm, factor in ((2.0, 0.5), (1.0, 1.0)):
        opt = ts.make_optimizer(cfg)
        p = torch.nn.Parameter(torch.zeros(4))
        state = opt.init(torch.nn.ParameterList([p]))
        state["count"] = 1  # past the lr-0 warmup step
        g = torch.tensor([norm, 0.0, 0.0, 0.0])
        opt.update([p], [g], state)
        # after one Adam step from zero moments: mu_hat = g', nu_hat = g'^2
        assert state["mu"][0][0].item() == pytest.approx((1 - cfg.b1) * norm * factor, rel=1e-7)


def test_launcher_trains_saves_and_resumes(tmp_path):
    dp, _ = _toy_files(tmp_path)
    args = ["--data", dp, "--media-map", str(tmp_path / "map.json"), "--media-root",
            str(tmp_path), "--tiny", "--batch-size", "2", "--max-length", "512",
            "--log-steps", "1", "--ckpt-dir", str(tmp_path / "ck"), "--preview-steps", "2",
            "--preview-dir", str(tmp_path / "preview")]
    first = launch.main(args + ["--steps", "2"], device="cpu")
    assert first["start_step"] == 0 and first["state"]["step"] == 2
    assert len(first["history"]) == 2 and all(np.isfinite(list(m.values())).all()
                                              for m in first["history"])
    assert (tmp_path / "preview" / "step_2.png").exists()
    assert first["saves"][-1]["step"] == 2 and first["saves"][-1]["bytes"] > 0
    second = launch.main(args + ["--steps", "4", "--resume"], device="cpu")
    assert second["start_step"] == 2 and second["state"]["step"] == 4
    assert len(second["history"]) == 2
    # the checkpoint holds what the run ended with
    blob = torch.load(launch.checkpoint_path(str(tmp_path / "ck")), weights_only=True)
    assert blob["step"] == 4 and blob["opt_state"]["count"] == 4
    sd = second["state"]["params"].state_dict()
    assert all(torch.equal(sd[k], blob["params"][k]) for k in sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(args + ["--steps", "1"])


def test_checkpoint_restore_round_trip(tmp_path):
    _, pcfg, _, module = _models(initialize_vision_tokenizer(ByteTokenizer()))
    init_state, _ = ts.make_train_step(pcfg, ts.TrainConfig(total_steps=10))
    state = init_state(module)
    for x in state["opt_state"]["mu"]:
        x.normal_()
    state["opt_state"]["count"], state["step"] = 7, 7
    path = str(tmp_path / "s.pt")
    assert ckpt_lib.save(path, state) > 0
    other = init_state(mm.init(pcfg, torch.Generator().manual_seed(3)))
    ckpt_lib.restore(path, other)
    assert other["step"] == 7 and other["opt_state"]["count"] == 7
    assert all(torch.equal(a, b) for a, b in zip(other["opt_state"]["mu"],
                                                 state["opt_state"]["mu"]))
    assert all(torch.equal(a, b) for a, b in zip(other["params"].parameters(),
                                                 module.parameters()))


def test_native_loader_shim(tmp_path):
    rs = np.random.RandomState(4)
    paths = []
    for i, n in enumerate((16, 10, 40)):
        p = tmp_path / f"f{i}.npz"
        np.savez(p, state=rs.randn(n).astype(np.float32))
        paths.append(str(p))
    np.save(tmp_path / "g.npy", rs.randn(3, 4).astype(np.float32))
    paths += [str(tmp_path / "g.npy"), str(tmp_path / "missing.npz")]
    plain = native_loader.load_numpy(paths, 16)
    assert np.array_equal(native_loader.load_feature_batch(paths, 16), plain)
    assert np.array_equal(j_native.load_feature_batch(paths, 16), plain)
    assert not plain[-1].any() and plain[1, 10:].sum() == 0
    assert native_loader.LIB_PATH.endswith("native/libia2p_loader.so")
    # MediaMap's batched lookup goes through the shim, renormed as JAX's is
    mapping = {f"c{i}": f"f{i}.npz" for i in range(3)}
    caps = ["c0", "c2", "unknown", "c1"]
    got = data_lib.MediaMap(mapping, str(tmp_path), 16).get_batch(caps)
    want = j_data.MediaMap(mapping, str(tmp_path), 16).get_batch(caps)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_metric_logger_writes_json_lines(tmp_path, capsys):
    log = logging_lib.MetricLogger(str(tmp_path / "m.jsonl"))
    log.log(3, {"loss": 1.5})
    rec = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[0])
    assert rec["step"] == 3 and rec["loss"] == 1.5
    assert '"loss": 1.5' in capsys.readouterr().out
    img = np.zeros((2, 8, 8, 3), np.uint8)
    assert log.dump_images(3, img, out_dir=str(tmp_path / "img")).endswith("step_3.png")
