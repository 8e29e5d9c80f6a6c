"""The port's exact self-speculative decode (`llm/speculative.py`, with
`llama.forward(..., layers=L)` as the draft) against the port's own plain
greedy `generate(temperature=0)` and the JAX package's
`generate_speculative`: the token-identity cases of
`tests/test_speculative.py` (draft layers and window sizes, a quantized
tree whose decoder linears are int4 group 128 with fused projections, EOS
inside a window) and the pipeline flag. Tokens and `done_at` identical,
hiddens within 1e-4. CPU, float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_edit import media, pipes  # noqa: F401 (fixtures)
from torch_port_helpers import assert_close, one_torch_thread  # noqa: F401 (autouse)

from instructany2pix_tpu.llm import generate as jgen
from instructany2pix_tpu.llm import speculative as jspec
from instructany2pix_tpu.models import llama as jllama
from instructany2pix_tpu.ops import quant as jq
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch.llm import generate as tgen
from instructany2pix_tpu_torch.llm import speculative as tspec
from instructany2pix_tpu_torch.models import llama as tllama

# four layers (drafts of 1-3), and widths at which every decoder linear is
# int4 group 128 once quantized
CFG = jllama.LlamaConfig(vocab_size=128, hidden_size=256, intermediate_size=512, num_layers=4,
                         num_heads=4, num_kv_heads=4, max_seq_len=256)
HIDDEN_TOL = 1e-4
PROMPT = [[1, 5, 9, 20, 7, 3]]


def _tcfg():
    return tllama.LlamaConfig(**{f.name: getattr(CFG, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})


@pytest.fixture(scope="module")
def models():
    params = jllama.init(jax.random.key(0), CFG)
    fused = jllama.fuse_projections(jq.quantize_llama(params, bits=4))
    return {kind: (tree, convert.llama(convert.to_numpy(tree), _tcfg()))
            for kind, tree in (("float", params), ("int4", fused))}


def _check(models, kind, n_new, draft_layers, k_draft, eos=2):
    tree, port = models[kind]
    emb_j = jllama.embed(tree, jnp.asarray(PROMPT))
    emb_t = tllama.embed(port, torch.tensor(PROMPT))
    plain = tgen.generate(port, _tcfg(), emb_t, max_new_tokens=n_new, temperature=0.0, eos_id=eos)
    rounds = []
    got = tspec.generate_speculative(port, _tcfg(), emb_t, max_new_tokens=n_new, eos_id=eos,
                                     draft_layers=draft_layers, k_draft=k_draft, rounds=rounds)
    ref = jspec.generate_speculative(tree, CFG, emb_j, max_new_tokens=n_new, eos_id=eos,
                                     draft_layers=draft_layers, k_draft=k_draft, max_len=64)
    done = int(ref.done_at[0])
    assert int(got.done_at[0]) == int(plain.done_at[0]) == done
    n = min(done + 1, n_new)
    assert got.tokens[0, :n].tolist() == plain.tokens[0, :n].tolist() == np.asarray(
        ref.tokens[0, :n]).tolist()
    # the rounds emitted every token after the prefill's, none past the stop
    assert sum(rounds) == n - 1 and all(1 <= r <= k_draft for r in rounds)
    assert_close(got.hiddens[0, :n], np.asarray(plain.hiddens[0, :n]), HIDDEN_TOL, 0,
                 what="hiddens vs plain greedy")
    assert_close(got.hiddens[0, :n], ref.hiddens[0, :n], HIDDEN_TOL, 0, what="hiddens vs JAX")
    return got, rounds


@pytest.mark.parametrize("draft_layers,k_draft", [(1, 2), (2, 4), (3, 6)])
def test_greedy_exact_vs_plain_decode(models, draft_layers, k_draft):
    _check(models, "float", 24, draft_layers, k_draft)


def test_exact_on_quantized_tree(models):
    """int4 group 128 with fused projections, the production format: the
    draft and the verify run K2's plain version at M = 1 and M = k."""
    _, port = models["int4"]
    assert set(port.layer_0.qkv.q) == {"w_q4", "gscale"}
    _check(models, "int4", 16, 2, 4)


def test_eos_stops_mid_window(models):
    """EOS as the third greedy token: emission stops at it inside the window."""
    tree, port = models["float"]
    emb_t = tllama.embed(port, torch.tensor(PROMPT))
    free = tgen.generate(port, _tcfg(), emb_t, max_new_tokens=8, temperature=0.0, eos_id=-1)
    eos = int(free.tokens[0, 2])
    got, rounds = _check(models, "float", 8, 2, 4, eos=eos)
    assert int(got.done_at[0]) == 2 and (got.tokens[0, 3:] == eos).all()


def test_draft_layers_are_an_early_exit(models):
    """`forward(..., layers=L)` is the first L layers through the shared
    final norm and lm_head, as the JAX forward."""
    tree, port = models["float"]
    ids = np.asarray(PROMPT)
    for n in (1, 3):
        want = jllama.forward(tree, CFG, input_ids=jnp.asarray(ids), layers=n)
        got = tllama.forward(port, _tcfg(), input_ids=torch.as_tensor(ids), layers=n)
        assert_close(got["logits"], want["logits"], 1e-4, n, rel=True, what=f"logits, {n} layers")
    with pytest.raises(ValueError, match="layers"):
        tllama.forward(port, _tcfg(), input_ids=torch.as_tensor(ids), layers=5)


def test_pipeline_flag_matches_jax(pipes, media):
    """`llm_speculative_layers` routes `forward_llm` through the speculative
    path in both pipelines: the same tokens as the port's plain greedy decode
    and the same caption as JAX."""
    jp, tp = pipes
    jcfg, tcfg = jp.cfg, tp.cfg
    try:
        jp.cfg = dataclasses.replace(jcfg, llm_speculative_layers=1)
        tp.cfg = dataclasses.replace(tcfg, llm_speculative_layers=1)
        jp.cache = tp.cache = None
        j_out = jp.forward_llm("add <video> to <video>", media)
        t_out = tp.forward_llm("add <video> to <video>", media)
    finally:
        jp.cfg, tp.cfg = jcfg, tcfg
        jp.cache = tp.cache = None
    assert t_out[2] == j_out[2]
    assert sum(tp.last_rounds) >= 1
    aux = tp.embed_mm_data(media)
    _, emb = tp._prepare_llm_inputs("add <video> to <video>", aux)
    plain = tgen.generate(tp.models["llm"].llama, tcfg.llm.llama, emb, max_new_tokens=100,
                          temperature=0.0, eos_id=tp.tokenizer.eos_token_id)
    n = min(int(plain.done_at[0]) + 1, 100)
    assert tp.last_generate.tokens[0, :n].tolist() == plain.tokens[0, :n].tolist()
