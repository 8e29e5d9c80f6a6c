"""The port's LLM vs the JAX package: a small Llama in which every decoder
linear qualifies for int4 group-128 (hidden 256, intermediate 512), so the
decode steps run K2's plain version in its production format; prefill and
cached decode with a left pad, `quantize_llama` bytes, `fuse_projections`,
greedy and sampled `generate`, and the multimodal splice and readout.
CPU, float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu.llm import generate as jgen
from instructany2pix_tpu.llm import multimodal as jmm
from instructany2pix_tpu.models import llama as jllama
from instructany2pix_tpu.ops import quant as jq
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.llm import generate as tgen
from instructany2pix_tpu_torch.llm import multimodal as tmm
from instructany2pix_tpu_torch.models import llama as tllama
from instructany2pix_tpu_torch.ops import quant as Q
from torch_port_helpers import assert_close, randn, t

CFG = dataclasses.replace(
    jllama.LlamaConfig.tiny(vocab_size=280), hidden_size=256, intermediate_size=512,
)
# float32 on both sides: the JAX CPU path composes the quantized products
# (XLA), the port's decode steps run K2's plain version; the sums differ
# in order only
TOL = 2e-5


def _tcfg():
    return tllama.LlamaConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(tllama.LlamaConfig)})


@pytest.fixture(scope="module")
def trees():
    params = jllama.init(jax.random.key(0), CFG)
    q = jq.quantize_llama(params, bits=4)
    return {"float": params, "quant": q, "fused": jllama.fuse_projections(q)}


def _port(tree):
    return convert.llama(convert.to_numpy(tree), _tcfg())


def test_every_decoder_linear_is_int4_grouped(trees):
    lay = trees["fused"]["layer_0"]
    for name in ("qkv", "o", "gate_up", "down"):
        assert set(lay[name]) == {"w_q4", "gscale"}, name
    assert set(trees["fused"]["lm_head"]) == {"w_q", "scale"}  # 280 wide: int8


def test_quantize_llama_bytes_match_jax(trees):
    port = convert.llama(convert.to_numpy(trees["float"]), _tcfg())
    Q.quantize_llama(port, bits=4)
    tllama.fuse_projections(port)
    fused = trees["fused"]
    for i in range(CFG.num_layers):
        for name in ("qkv", "o", "gate_up", "down"):
            mod = getattr(getattr(port, f"layer_{i}"), name)
            for k, v in fused[f"layer_{i}"][name].items():
                assert np.array_equal(mod.q[k].numpy(), np.asarray(v)), (i, name, k)
                # K2's wrapper takes contiguous buffers only; the float weight
                # it was quantized from is a transposed view
                assert mod.q[k].is_contiguous(), (i, name, k)
    for k, v in fused["lm_head"].items():
        assert np.array_equal(port.lm_head.q[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("kind", ["float", "quant", "fused"])
def test_prefill_and_cached_decode_match_jax(trees, kind):
    """A left-padded prompt through the cache, then three decode steps."""
    tree, port = trees[kind], _port(trees[kind])
    seed, s, pad, max_len = 11, 9, 3, 16
    ids = np.random.RandomState(seed).randint(0, CFG.vocab_size, (1, s))
    jc = jllama.KVCache.create(CFG, 1, max_len=max_len, dtype=jnp.float32)
    tc = tllama.KVCache.create(_tcfg(), 1, max_len=max_len, dtype=torch.float32)
    jo = jllama.forward(tree, CFG, input_ids=jnp.asarray(ids), cache=jc, prefix_pad=pad)
    to = tllama.forward(port, _tcfg(), input_ids=t(ids), cache=tc, prefix_pad=pad)
    for key in ("logits", "hidden", "hidden_norm"):
        assert_close(to[key][:, pad:], np.asarray(jo[key])[:, pad:], TOL, seed, rel=True,
                     what=f"{kind} prefill {key}")
    jc, tc = jo["cache"], to["cache"]
    for step in range(3):
        nxt = np.asarray([[7 + 31 * step]])
        jo = jllama.forward(tree, CFG, input_ids=jnp.asarray(nxt), cache=jc, prefix_pad=pad)
        to = tllama.forward(port, _tcfg(), input_ids=t(nxt), cache=tc, prefix_pad=pad)
        assert to["cache"].length == int(jo["cache"].length) == s + step + 1
        assert to["cache"].k.data_ptr() == tc.k.data_ptr()  # updated in place
        for key in ("logits", "hidden_norm"):
            assert_close(to[key], jo[key], TOL, seed, rel=True, what=f"{kind} step {step} {key}")
        jc, tc = jo["cache"], to["cache"]


def test_uncached_forward_matches_jax(trees):
    ids = np.random.RandomState(4).randint(0, CFG.vocab_size, (2, 12))
    jo = jllama.forward(trees["fused"], CFG, input_ids=jnp.asarray(ids))
    to = tllama.forward(_port(trees["fused"]), _tcfg(), input_ids=t(ids))
    assert_close(to["logits"], jo["logits"], TOL, 4, rel=True, what="logits")


def test_fuse_projections_preserves_forward(trees):
    unfused = _port(trees["quant"])
    ids = t(np.random.RandomState(5).randint(0, CFG.vocab_size, (1, 6)))
    cache = tllama.KVCache.create(_tcfg(), 1, max_len=8, dtype=torch.float32)
    a = tllama.forward(unfused, _tcfg(), input_ids=ids, cache=cache)["logits"]
    tllama.fuse_projections(unfused)
    assert hasattr(unfused.layer_0, "qkv") and not hasattr(unfused.layer_0, "q")
    cache = tllama.KVCache.create(_tcfg(), 1, max_len=8, dtype=torch.float32)
    b = tllama.forward(unfused, _tcfg(), input_ids=ids, cache=cache)["logits"]
    assert_close(b, a.numpy(), TOL, 5, rel=True, what="fused vs unfused")


def _embeds(tree, seed, s):
    ids = np.random.RandomState(seed).randint(0, CFG.vocab_size, (1, s))
    return np.asarray(jllama.embed(tree, jnp.asarray(ids)))


@pytest.mark.parametrize("stop_at", [None, 2])
def test_greedy_generate_matches_jax(trees, stop_at):
    """Temperature 0 with the 64-token bucket and dynamic stop: identical
    tokens, matching hiddens and done_at. With `stop_at` the EOS id is the
    token the model emits at that step, so both loops stop there."""
    tree, port = trees["fused"], _port(trees["fused"])
    emb = _embeds(tree, 9, 10)
    eos = 2
    if stop_at is not None:
        probe = jgen.generate(tree, CFG, jnp.asarray(emb), jax.random.key(0), max_new_tokens=8,
                              temperature=0.0, eos_id=-1, bucket=64)
        eos = int(probe.tokens[0, stop_at])
        assert eos not in np.asarray(probe.tokens[0, :stop_at]), "pick another seed"
    kw = dict(max_new_tokens=8, temperature=0.0, eos_id=eos, bucket=64, dynamic_stop=True)
    jr = jgen.generate(tree, CFG, jnp.asarray(emb), jax.random.key(0), **kw)
    tr = tgen.generate(port, _tcfg(), t(emb), None, **kw)
    assert np.array_equal(tr.tokens.numpy(), np.asarray(jr.tokens)), (tr.tokens, jr.tokens)
    assert tr.done_at.tolist() == np.asarray(jr.done_at).tolist()
    n = min(int(jr.done_at[0]) + 1, 8)
    assert_close(tr.hiddens[:, :n], np.asarray(jr.hiddens)[:, :n], TOL, 9, rel=True, what="hiddens")


def test_sampled_generate_matches_jax_with_its_gumbel_draws(trees):
    """Temperature 0.3: the port takes the Gumbel noise that
    `jax.random.categorical` draws from the same key sequence."""
    tree, port = trees["fused"], _port(trees["fused"])
    emb = _embeds(tree, 13, 7)
    steps, key = 6, jax.random.key(21)
    jr = jgen.generate(tree, CFG, jnp.asarray(emb), key, max_new_tokens=steps,
                       temperature=0.3, eos_id=-1)
    draws, k = [], key
    for _ in range(steps):
        k, sub = jax.random.split(k)
        draws.append(np.asarray(jax.random.gumbel(sub, (1, CFG.vocab_size), jnp.float32)))
    gumbel = t(np.stack(draws, axis=1))
    tr = tgen.generate(port, _tcfg(), t(emb), None, max_new_tokens=steps, temperature=0.3,
                       eos_id=-1, gumbel=gumbel)
    assert np.array_equal(tr.tokens.numpy(), np.asarray(jr.tokens)), (tr.tokens, jr.tokens)


def test_generate_with_a_generator_is_deterministic(trees):
    port = _port(trees["fused"])
    emb = t(_embeds(trees["fused"], 3, 5))
    a = tgen.generate(port, _tcfg(), emb, torch.Generator().manual_seed(1), max_new_tokens=5)
    b = tgen.generate(port, _tcfg(), emb, torch.Generator().manual_seed(1), max_new_tokens=5)
    assert torch.equal(a.tokens, b.tokens)


def test_splice_and_predict_match_jax(trees):
    mcfg = jmm.Any2PixLMConfig(llama=CFG, image_codec_dim=16, audio_codec_dim=8,
                               video_token_id=263)
    params = jmm.init(jax.random.key(3), mcfg)
    params["llama"] = jllama.fuse_projections(jq.quantize_llama(params["llama"], bits=4))
    tcfg = tmm.Any2PixLMConfig(llama=_tcfg(), image_codec_dim=16, audio_codec_dim=8,
                               video_token_id=263)
    port = convert.llm(convert.to_numpy(params), tcfg)
    ids = np.asarray([[1, 5, 263, 9, 263, 263, 4]])
    rep = randn(6, 2, 16)  # two rows for three <video> tokens: the third keeps its embedding
    je = jmm.splice_input_embeds(params, mcfg, jnp.asarray(ids), jnp.asarray(rep))
    te = tmm.splice_input_embeds(port, tcfg, t(ids), t(rep))
    assert_close(te, je, 1e-5, 6, rel=True, what="splice")
    h = randn(7, 3, 256)
    assert_close(tmm.predict_image_embedding(port, t(h)),
                 jmm.predict_image_embedding(params, jnp.asarray(h)), 1e-5, 7, rel=True,
                 what="predict")
