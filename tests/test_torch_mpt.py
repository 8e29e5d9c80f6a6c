"""The MPT backbone of the port against the JAX package: ALiBi slopes (also
for head counts that are not powers of two) and biases, the full forward
from a raw HF-layout (mosaicml `transformer.*`) state dict read by
`hf_keymap` and by `convert_from_mpt`, the key map over every key of every
option's dict, both ways, the cached decode against the full forward and
against JAX's cached decode, and every config option. Weights are drawn
with a seeded `torch.Generator`. CPU, float32, within TOL relative to the
largest logit of the JAX result. Nothing here reads the reference
checkout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import assert_close, one_torch_thread, t  # noqa: F401 (autouse)

from instructany2pix_tpu.models import mpt as jm
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.core import checkpoint as ckpt_lib
from instructany2pix_tpu_torch.models import layers as L
from instructany2pix_tpu_torch.models import mpt as tm

TOL = 1e-5

OPTIONS = {
    "default": {},
    "qk_ln": {"qk_ln": True},
    "clip_qkv": {"clip_qkv": 0.5},
    "softmax_scale": {"softmax_scale": 0.3},
    "logit_scale": {"logit_scale": 0.5},
    "inv_sqrt_d_model": {"logit_scale": "inv_sqrt_d_model"},
    "biases": {"no_bias": False},
    "learned_positions": {"alibi": False},
    "embedding_fraction": {"embedding_fraction": 0.25},
    "six_heads": {"d_model": 48, "n_heads": 6},
    "everything": {"qk_ln": True, "clip_qkv": 6.0, "logit_scale": "inv_sqrt_d_model",
                   "alibi": False, "no_bias": False, "embedding_fraction": 0.5},
}


def _cfg(opts):
    return dataclasses.replace(jm.MPTConfig.tiny(), **opts)


def _hf_state(cfg, seed=0):
    """An HF-layout MPT state dict for `cfg` (JAX config), biases and
    q/k norms and positions where the config has them."""
    gen = torch.Generator().manual_seed(seed)
    d, e = cfg.d_model, cfg.expansion_ratio

    def w(*shape, s=0.1):
        return torch.randn(*shape, generator=gen) * s

    def norm(pre):
        out = {f"{pre}.weight": 1 + w(d)}
        if not cfg.no_bias:
            out[f"{pre}.bias"] = w(d)
        return out

    def lin(pre, o, i):
        out = {f"{pre}.weight": w(o, i)}
        if not cfg.no_bias:
            out[f"{pre}.bias"] = w(o)
        return out

    sd = {"transformer.wte.weight": w(cfg.vocab_size, d, s=0.5), **norm("transformer.norm_f")}
    if not cfg.alibi:
        sd["transformer.wpe.weight"] = w(cfg.max_seq_len, d, s=0.5)
    for i in range(cfg.n_layers):
        pre = f"transformer.blocks.{i}"
        sd.update({**norm(f"{pre}.norm_1"), **norm(f"{pre}.norm_2"),
                   **lin(f"{pre}.attn.Wqkv", 3 * d, d), **lin(f"{pre}.attn.out_proj", d, d),
                   **lin(f"{pre}.ffn.up_proj", e * d, d), **lin(f"{pre}.ffn.down_proj", d, e * d)})
        if cfg.qk_ln:
            sd.update({**norm(f"{pre}.attn.q_ln"), **norm(f"{pre}.attn.k_ln")})
    return sd


def _port_from_state(sd, tcfg):
    with torch.device("meta"):
        m = tm.MPT(tcfg)
    m = L.materialize(m, torch.device("cpu"), torch.float32).eval().requires_grad_(False)
    ckpt_lib.load_module(m, tm.hf_keymap().to_port(sd, "mpt"), "mpt")
    return m


def _pair(opts, seed=0):
    jcfg = _cfg(opts)
    tcfg = tm.MPTConfig(**dataclasses.asdict(jcfg))
    sd = _hf_state(jcfg, seed)
    return jcfg, jm.convert_from_mpt({k: v.numpy() for k, v in sd.items()}, jcfg), \
        _port_from_state(sd, tcfg), sd


@pytest.mark.parametrize("h", [1, 3, 4, 6, 8, 12, 32])
def test_alibi_slopes_and_biases(h):
    assert_close(tm.gen_slopes(h), jm.gen_slopes(h), 1e-6, h, rel=True, what="slopes")
    assert_close(tm.gen_slopes(h, 4.0), jm.gen_slopes(h, 4.0), 1e-6, h, rel=True, what="max 4")
    for full in (False, True):
        assert_close(tm.build_alibi_bias(h, 16, full=full), jm.build_alibi_bias(h, 16, full=full),
                     1e-6, h, rel=True, what=f"bias full={full}")


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_forward_matches_jax(name):
    jcfg, params, module, _ = _pair(OPTIONS[name])
    ids = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 12))
    want = jm.forward(params, jcfg, input_ids=jnp.asarray(ids))
    got = tm.forward(module, module.cfg, input_ids=t(ids))
    assert_close(got["logits"], want["logits"], TOL, 0, rel=True, what=f"{name} logits")
    assert_close(got["hidden"], want["hidden"], TOL, 0, rel=True, what=f"{name} hidden")


def test_masks_prefix_bias_and_embeds():
    jcfg, params, module, _ = _pair({})
    rs = np.random.RandomState(1)
    ids = rs.randint(0, jcfg.vocab_size, (2, 12))  # the shapes of the other forwards
    mask = np.ones((2, 12), np.int32)
    mask[0, :3] = 0  # a left-padded row
    want = jm.forward(params, jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    got = tm.forward(module, module.cfg, input_ids=t(ids), attention_mask=t(mask))
    assert_close(got["logits"], want["logits"], TOL, 1, rel=True, what="attention mask")
    want = jm.forward(params, jcfg, input_ids=jnp.asarray(ids), prefix_lm_full_bias=True)
    got = tm.forward(module, module.cfg, input_ids=t(ids), prefix_lm_full_bias=True)
    assert_close(got["logits"], want["logits"], TOL, 1, rel=True, what="full bias")
    emb = rs.randn(2, 12, jcfg.d_model).astype(np.float32)
    want = jm.forward(params, jcfg, inputs_embeds=jnp.asarray(emb))
    got = tm.forward(module, module.cfg, inputs_embeds=t(emb))
    assert_close(got["logits"], want["logits"], TOL, 1, rel=True, what="inputs_embeds")
    with pytest.raises(ValueError):
        tm.forward(module, module.cfg)


@pytest.mark.parametrize("name", ["default", "everything"])
def test_keymap_covers_every_key_both_ways(name):
    jcfg, params, module, sd = _pair(OPTIONS[name])
    km = tm.hf_keymap()
    back = km.to_ref(dict(module.named_parameters()))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    # the JAX converter's tree loads into the same module, bit for bit
    conv = convert.mpt(convert.to_numpy(params), module.cfg)
    for (n, a), (_, b) in zip(module.named_parameters(), conv.named_parameters()):
        assert torch.equal(a, b), n
    with pytest.raises(KeyError):
        km.to_port({**sd, "transformer.blocks.0.attn.unknown": torch.zeros(1)})


@pytest.mark.parametrize("name", ["default", "learned_positions"])
def test_cached_decode_matches_full_forward_and_jax(name):
    jcfg, params, module, _ = _pair(OPTIONS[name])
    ids = np.random.RandomState(2).randint(0, jcfg.vocab_size, (2, 9))
    full = tm.forward(module, module.cfg, input_ids=t(ids))["logits"]
    cache = tm.init_cache(module.cfg, 2, 16)
    out = tm.forward(module, module.cfg, input_ids=t(ids[:, :5]), cache=cache)
    steps = [out["logits"]]
    jcache = jm.init_cache(jcfg, 2, 16)
    jout = jm.forward(params, jcfg, input_ids=jnp.asarray(ids[:, :5]), cache=jcache)
    jsteps = [jout["logits"]]
    for i in range(5, 9):
        out = tm.forward(module, module.cfg, input_ids=t(ids[:, i:i + 1]), cache=out["cache"])
        jout = jm.forward(params, jcfg, input_ids=jnp.asarray(ids[:, i:i + 1]),
                          cache=jout["cache"])
        steps.append(out["logits"])
        jsteps.append(jout["logits"])
    assert out["cache"].length == int(jout["cache"].length) == 9
    inc = torch.cat(steps, dim=1)
    assert_close(inc, full.numpy(), TOL, 2, rel=True, what="cached vs full")
    assert_close(inc, jnp.concatenate(jsteps, axis=1), TOL, 2, rel=True, what="cached vs JAX")
    assert_close(out["cache"].k, jout["cache"].k, TOL, 2, rel=True, what="cache k")


def test_random_init_and_mpt_7b_shapes():
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jm.MPTConfig.mpt_7b()))
    with torch.device("meta"):
        m = tm.MPT(tm.MPTConfig.mpt_7b())
    assert (sorted(p.numel() for p in m.parameters())
            == sorted(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)))
    assert sum(p.numel() for p in m.parameters()) == 6_649_286_656
    with torch.device("meta"):
        tiny = tm.MPT(tm.MPTConfig.tiny())
    tiny = tm.init_(L.materialize(tiny, torch.device("cpu"), torch.float32),
                    torch.Generator().manual_seed(0))
    assert torch.equal(tiny.block_0.norm_1.g, torch.ones(32))
    out = tm.forward(tiny, tiny.cfg, input_ids=torch.tensor([[1, 2, 3]]))
    assert torch.isfinite(out["logits"]).all()
