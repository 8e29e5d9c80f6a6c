"""LoRA in the port against the JAX package at tiny sizes, float32:
`apply_lora`, `trainable_mask` (which parameters train), `merge_lora`,
`split_lora_state`; the LoRA branch of `layers.linear` on a quantized base
at decode shapes with the RMSNorm/SwiGLU prologue and residual composed
around an unfused K2 call; `load_pretrained_model(load_lora=True)` against
JAX's loader reading the same factors from an Orbax root the test writes;
and one LoRA train step (loss, the gradients of the adapters and heads, the
optimizer over the trainable parameters only, frozen weights unchanged)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu import loaders as jloaders
from instructany2pix_tpu.core import checkpoint as j_ckpt
from instructany2pix_tpu.core import tree as j_tree
from instructany2pix_tpu.llm import multimodal as j_mm
from instructany2pix_tpu.models import layers as jL
from instructany2pix_tpu.models import llama as j_llama
from instructany2pix_tpu.ops import quant as jQ
from instructany2pix_tpu.train import lora as j_lora
from instructany2pix_tpu.train import train_step as j_ts
from instructany2pix_tpu_torch import convert, loaders
from instructany2pix_tpu_torch.llm import multimodal as mm
from instructany2pix_tpu_torch.models import layers as L
from instructany2pix_tpu_torch.models import llama
from instructany2pix_tpu_torch.ops import quant as Q
from instructany2pix_tpu_torch.train import lora
from instructany2pix_tpu_torch.train import train_step as ts
from torch_port_helpers import assert_close, one_torch_thread, randn, t  # noqa: F401

TOL = 1e-5  # float32 both sides, sums in another order
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4  # relative to each gradient's largest element


def _jax_name(port_name: str) -> str:
    """A port parameter name in the JAX tree's leaf names."""
    head, _, leaf = port_name.rpartition(".")
    return f"{head}.{ {'weight': 'w', 'bias': 'b'}.get(leaf, leaf) }".replace(" ", "")


def _tiny_lm(seed=0):
    jcfg = j_mm.Any2PixLMConfig.tiny()
    pcfg = mm.Any2PixLMConfig.tiny()
    params = convert.to_numpy(j_mm.init(jax.random.key(seed), jcfg))
    return jcfg, pcfg, params, convert.llm(params, pcfg, trainable=True)


def _perturb_adapters(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in module.named_parameters():
            if n.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)


def test_apply_mask_merge_split_match_jax():
    jcfg, pcfg, params, module = _tiny_lm()
    lora.apply_lora(module, torch.Generator().manual_seed(1), rank=4, alpha=8.0)
    jl = dict(params, llama=j_lora.apply_lora(params["llama"], jax.random.key(1), rank=4, alpha=8.0))
    jflat = j_tree.flatten(jl)
    adapted = sorted(n for n in jflat if n.endswith("lora_a"))
    assert adapted == sorted(_jax_name(n) for n, _ in module.named_parameters()
                             if n.endswith("lora_a"))
    assert len(adapted) == 7 * pcfg.llama.num_layers
    assert module.llama.layer_0.q.weight.shape == (64, 64)  # the base name is kept
    assert "llama.layer_0.q.weight" in module.state_dict()

    mask = lora.trainable_mask(module)
    jmask = j_tree.flatten(j_lora.trainable_mask(jl))
    # lora_scale is a buffer in the port, a frozen leaf in JAX
    assert not any(v for k, v in jmask.items() if k.endswith("lora_scale"))
    assert {_jax_name(n): v for n, v in mask.items()} == {
        k: v for k, v in jmask.items() if not k.endswith("lora_scale")}
    assert mask["vae_predictor_image.fc1.weight"] and mask["llama.layer_1.down.lora_b"]
    assert not mask["llama.layer_0.q.weight"] and not mask["llama.lm_head.weight"]
    assert all(p.requires_grad == mask[n] for n, p in module.named_parameters())

    split = lora.split_lora_state(module)
    assert sorted(_jax_name(n) for n in split) == sorted(j_tree.flatten(j_lora.split_lora_state(jl)))

    # merge: the port's adapters carried into JAX, merged on both sides
    _perturb_adapters(module, 2)
    jtree = convert.to_tree(module)
    ids = np.random.RandomState(3).randint(0, 200, size=(2, 9)).astype(np.int32)
    before = llama.forward(module.llama, pcfg.llama, input_ids=t(ids))["logits"].detach()
    ref = j_llama.forward(jtree["llama"], jcfg.llama, input_ids=jnp.asarray(ids))["logits"]
    assert_close(before, ref, TOL, 3, rel=True, what="adapted forward")
    lora.merge_lora(module)
    assert not lora.split_lora_state(module) and not L.has_lora(module.llama.layer_0.q)
    jmerged = j_lora.merge_lora(jtree)
    for n, p in module.named_parameters():
        want = j_tree.flatten(jmerged)[_jax_name(n)]
        got = p.detach().numpy().T if p.dim() == 2 and "embed" not in n else p.detach().numpy()
        assert_close(torch.from_numpy(np.ascontiguousarray(got)), want, 1e-6, 3, what=n)
    after = llama.forward(module.llama, pcfg.llama, input_ids=t(ids))["logits"].detach()
    assert_close(after, before, TOL, 3, rel=True, what="merged forward")
    llama.fuse_projections(module.llama)  # allowed once merged
    assert hasattr(module.llama.layer_0, "qkv")


def test_fuse_and_merge_refuse_what_would_drop_adapters():
    _, pcfg, _, module = _tiny_lm()
    lora.apply_lora(module, torch.Generator().manual_seed(1), rank=2)
    with pytest.raises(ValueError, match="unmerged adapters"):
        llama.fuse_projections(module.llama)
    assert hasattr(module.llama.layer_0, "q") and not hasattr(module.llama.layer_0, "qkv")
    Q.quantize_llama(module.llama, bits=8)
    q = module.llama.layer_0.q
    assert isinstance(q, Q.QLinear) and L.has_lora(q)  # the adapters survive quantization
    with pytest.raises(ValueError, match="merge before quantizing"):
        lora.merge_lora(module)


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("fusion", ["norm", "swiglu_residual"])
def test_lora_quantized_linear_at_decode_shapes(m, fusion):
    """int4 group-128 base (K 256, N 128) with adapters: the JAX path
    composes the prologue and calls the matvec unfused; so does the port."""
    seed = 331 + m
    k, n, r = 256, 128, 8
    kin = 2 * k if fusion == "swiglu_residual" else k
    w = randn(seed, k, n, scale=0.05)
    jq = {kk: np.asarray(v) for kk, v in jQ.quantize_weight_int4_grouped(jnp.asarray(w)).items()}
    a, b = randn(seed + 1, k, r, scale=0.1), randn(seed + 2, r, n, scale=0.1)
    jp = dict(jq, lora_a=a, lora_b=b, lora_scale=np.float32(2.0))
    x = randn(seed + 3, m, kin)
    g = 1.0 + randn(seed + 4, kin, scale=0.1)
    res_ = randn(seed + 5, m, n)
    if fusion == "norm":
        kw_j, kw_p = dict(norm=(jnp.asarray(g), 1e-6)), dict(norm=(t(g), 1e-6))
    else:
        kw_j = dict(swiglu=True, residual=jnp.asarray(res_))
        kw_p = dict(swiglu=True, residual=t(res_))
    ref = jL.linear({kk: jnp.asarray(v) for kk, v in jp.items()}, jnp.asarray(x), **kw_j)
    ql = Q.QLinear({kk: t(v) for kk, v in jq.items()})
    with torch.no_grad():
        convert._load_lora(ql, jp, "q", set())
    assert ql.lora_a.shape == (r, k) and float(ql.lora_scale) == 2.0
    out = L.linear(ql, t(x), **kw_p)
    assert_close(out, ref, TOL, seed, rel=True, what=f"M={m} {fusion}")
    # the adapters matter, and without them the fused call is the same function
    plain = L.linear(Q.QLinear({kk: t(v) for kk, v in jq.items()}), t(x), **kw_p)
    assert (out - plain).abs().max() > 1e-3


def _write_llm(root, name):
    from ckpt_fixtures import _make_llm_dir, _write_llm_tokenizer
    from instructany2pix_tpu.llm.constants import SPECIAL_GEN_TOKENS

    tok_dir = os.path.join(root, name, "tokenizer")
    vocab = _write_llm_tokenizer(tok_dir) + len(SPECIAL_GEN_TOKENS)
    return tok_dir, vocab


def test_load_lora_matches_jax_orbax(tmp_path):
    from ckpt_fixtures import _make_llm_dir
    from instructany2pix_tpu.llm.tokenizer import initialize_vision_tokenizer, load_tokenizer

    base, lora_dir = str(tmp_path / "base"), str(tmp_path / "lora")
    tok_dir, vocab = _write_llm(str(tmp_path), "lora")
    ids = initialize_vision_tokenizer(load_tokenizer(tok_dir))
    jcfg = dataclasses.replace(j_mm.Any2PixLMConfig.tiny(ids), llama=dataclasses.replace(
        j_mm.Any2PixLMConfig.tiny().llama, vocab_size=vocab))
    pcfg = dataclasses.replace(mm.Any2PixLMConfig.tiny(ids), llama=dataclasses.replace(
        mm.Any2PixLMConfig.tiny().llama, vocab_size=vocab))
    _make_llm_dir(base, jcfg)

    # the finetune: adapters on every projection, the predictor heads moved
    trained = loaders.load_llm(base, pcfg, "cpu", torch.float32)
    lora.apply_lora(trained, torch.Generator().manual_seed(5), rank=4, alpha=8.0)
    _perturb_adapters(trained, 6)
    with torch.no_grad():
        trained.vae_predictor_image.fc1.weight.add_(0.5)
        trained.vae_predictor_audio.fc2.bias.add_(0.25)
    counts = lora.save_lora_checkpoint(trained, lora_dir)
    assert counts["adapter_model.bin"] == 2 * 7 * pcfg.llama.num_layers
    assert counts["non_lora_trainables.bin"] == 8
    saved = torch.load(os.path.join(lora_dir, "adapter_model.bin"))
    assert "base_model.model.model.layers.1.mlp.down_proj.lora_B.weight" in saved

    # the same factors and heads as a JAX tree, saved as the JAX loader's Orbax root
    tree = convert.to_tree(trained)
    flat = {k: v for k, v in j_tree.flatten(tree).items()
            if "lora" in k.rsplit(".", 1)[-1] or k.startswith("vae_predictor")}
    j_ckpt.save(os.path.join(lora_dir, "adapters"), j_tree.unflatten(flat))
    jparams, _, jids = jloaders.load_pretrained_model(lora_dir, base, load_lora=True)
    got, tok, got_ids = loaders.load_pretrained_model(lora_dir, base, load_lora=True, cfg=pcfg,
                                                      device="cpu", dtype=torch.float32)
    assert got_ids == jids and not lora.split_lora_state(got)
    want = convert.llm(convert.to_numpy(jparams), pcfg)
    wp = dict(want.named_parameters())
    for n, p in got.named_parameters():
        assert_close(p, wp[n].detach().numpy(), 1e-6, 5, what=n)
    assert torch.equal(got.vae_predictor_image.fc1.weight, trained.vae_predictor_image.fc1.weight)
    x = torch.from_numpy(np.random.RandomState(7).randint(0, vocab, (1, 6)))
    assert_close(llama.forward(got.llama, pcfg.llama, input_ids=x)["logits"],
                 llama.forward(trained.llama, pcfg.llama, input_ids=x)["logits"].detach(),
                 TOL, 7, rel=True, what="merged logits against the adapted model")

    with pytest.raises(ValueError, match="needs model_base"):
        loaders.load_pretrained_model(lora_dir, load_lora=True, cfg=pcfg, device="cpu")
    bad = torch.load(os.path.join(lora_dir, "adapter_model.bin"))
    bad["base_model.model.model.layers.0.self_attn.q_proj.lora_C.weight"] = torch.zeros(1)
    torch.save(bad, os.path.join(lora_dir, "adapter_model.bin"))
    with pytest.raises(KeyError, match="no counterpart"):
        loaders.load_pretrained_model(lora_dir, base, load_lora=True, cfg=pcfg, device="cpu")
    del bad["base_model.model.model.layers.0.self_attn.q_proj.lora_C.weight"]
    del bad["base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight"]
    torch.save(bad, os.path.join(lora_dir, "adapter_model.bin"))
    with pytest.raises(KeyError, match="need lora_a and lora_b"):
        loaders.load_pretrained_model(lora_dir, base, load_lora=True, cfg=pcfg, device="cpu")


def test_lora_train_step_matches_jax_and_freezes_the_base(tmp_path):
    from test_torch_train import _batches, _datasets, _torch_batch

    jds, pds = _datasets(tmp_path)
    jb, pb = _batches(jds, pds, j_mm.Any2PixLMConfig.tiny())
    jcfg = j_mm.Any2PixLMConfig.tiny(jds.token_ids)
    pcfg = mm.Any2PixLMConfig.tiny(jds.token_ids)
    module = convert.llm(convert.to_numpy(j_mm.init(jax.random.key(0), jcfg)), pcfg, trainable=True)
    lora.apply_lora(module, torch.Generator().manual_seed(1), rank=4, alpha=8.0)
    _perturb_adapters(module, 2)
    mask = lora.trainable_mask(module)
    frozen = {n: p.detach().clone() for n, p in module.named_parameters() if not mask[n]}
    start = {n: p.detach().clone() for n, p in module.named_parameters() if mask[n]}
    jtree = jax.tree.map(jnp.asarray, convert.to_tree(module))
    jbatch = {k: jnp.asarray(v) for k, v in jb.items()}

    # JAX: the loss and its gradient, then optax over the trainable leaves only
    names = [n for n, on in mask.items() if on]
    keys = [_jax_name(n) for n in names]

    def loss_of(sub):
        flat = j_tree.flatten(jtree)
        flat.update(sub)
        return j_mm.train_forward(j_tree.unflatten(flat), jcfg, jbatch)[0]

    sub = {k: j_tree.flatten(jtree)[k] for k in keys}
    jloss, jgrads = jax.value_and_grad(loss_of)(sub)
    tcfg = dict(learning_rate=1e-3, total_steps=100, warmup_ratio=0.0)
    tx = j_ts.make_optimizer(j_ts.TrainConfig(**tcfg))
    import optax

    # the first update runs at lr 0 (the schedule at count 0), so the second
    # sees the same parameters and gradients
    jstate = tx.init(sub)
    jnew = sub
    for _ in range(2):
        upd, jstate = tx.update(jgrads, jstate, jnew)
        jnew = optax.apply_updates(jnew, upd)

    init_state, step = ts.make_train_step(pcfg, ts.TrainConfig(**tcfg))
    state = init_state(module)
    assert len(state["opt_state"]["mu"]) == len(names)
    with torch.enable_grad():
        loss = mm.train_forward(module, pcfg, _torch_batch(pb))[0]
        grads = torch.autograd.grad(loss, [p for n, p in module.named_parameters() if mask[n]])
    assert_close(loss, jloss, LOSS_TOL, 0, rel=True, what="loss")
    for n, k, g in zip(names, keys, grads):
        jg = np.asarray(jgrads[k])
        got = g.numpy().T if g.dim() == 2 else g.numpy()
        assert np.abs(jg).max() > 0, n
        assert_close(torch.from_numpy(np.ascontiguousarray(got)), jg, GRAD_TOL, 0, rel=True,
                     what=f"grad {n}")
    for _ in range(2):
        state, metrics = step(state, _torch_batch(pb))
        assert torch.isfinite(metrics["loss"])
    for n, p in module.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), f"{n} moved"
        else:
            assert not torch.equal(p, start[n]), f"{n} did not move"
            got = p.detach().numpy().T if p.dim() == 2 else p.detach().numpy()
            assert_close(torch.from_numpy(np.ascontiguousarray(got)), np.asarray(jnew[_jax_name(n)]),
                         1e-6 + 0.1 * 1e-3, 0, what=f"updated {n}")


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_lora_gradients_under_remat(tmp_path, policy):
    """Checkpointed layers recompute or save the adapters' two products
    consistently: the same gradients, reaching only the trainable tensors."""
    from test_torch_train import _batches, _datasets, _torch_batch

    jds, pds = _datasets(tmp_path)
    _, pb = _batches(jds, pds, j_mm.Any2PixLMConfig.tiny())
    grads = {}
    for remat in (False, True):
        base = mm.Any2PixLMConfig.tiny(jds.token_ids)
        cfg = dataclasses.replace(base, llama=dataclasses.replace(base.llama, remat=remat,
                                                                  remat_policy=policy))
        module = mm.init(cfg, torch.Generator().manual_seed(0))
        lora.apply_lora(module, torch.Generator().manual_seed(1), rank=4)
        _perturb_adapters(module, 2)
        lora.trainable_mask(module)
        with torch.enable_grad():
            loss = mm.train_forward(module, cfg, _torch_batch(pb))[0]
            loss.backward()
        grads[remat] = {n: p.grad for n, p in module.named_parameters() if p.grad is not None}
        assert all(p.grad is None for p in module.parameters() if not p.requires_grad)
    assert grads[True].keys() == grads[False].keys()
    assert any(n.endswith("lora_a") for n in grads[True])
    for n, g in grads[False].items():
        assert_close(grads[True][n], g.numpy(), 1e-5, 0, rel=True, what=f"{policy} {n}")
