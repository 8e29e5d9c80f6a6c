"""The port's serving on a mesh of gloo ranks against the JAX package's
serving on a mesh of the virtual CPU devices:

  * `BatchedDenoiser` at (2, 2) (3 requests: padded to the data axis by the
    last row, each data rank's rows through the UNet sharded over "model")
    within 2e-4 of JAX's TP denoiser at the same mesh
    (tests/test_serving.py:382);
  * tensor-parallel decodes at (2, 2) of a tiny LLaMA quantized as the TP
    server takes it (int4 projections, o and down at int8 and row-split,
    unfused) and all int4 (o and down replicated, their input gathered),
    with injected Gumbel draws: tokens equal and hidden states within 2e-5
    of JAX `generate` on the same weights;
  * `PipelineServer` at (1, 2) and (2, 1): rank 0 takes the requests, the
    other rank follows; a batch through the real batched decode and a
    batch of mixed requests (edits and a caption-only answer) through the
    diffusion stages, with the JAX draws injected: captions identical and
    images within 1 uint8 level of JAX's server at the same mesh.
CPU, float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instructany2pix_tpu import pipeline as jpl
from instructany2pix_tpu import serving as jserving
from instructany2pix_tpu.core.mesh import make_mesh
from instructany2pix_tpu.core.prng import KeyChain
from instructany2pix_tpu.llm import generate as jgen
from instructany2pix_tpu.models import llama as jllama
from instructany2pix_tpu.models import unet as junet
from instructany2pix_tpu.ops import quant as jq
from instructany2pix_tpu_torch import convert
from torch_port_helpers import random_tree, randn, spawn_ranks

DENOISE_TOL = 2e-4  # tests/test_serving.py:382, TP against unsharded
HIDDEN_TOL = 2e-5  # relative; float32 decode (as test_torch_serving)
UINT8_TOL = 1
NEW_TOKENS = 24  # the servers' decode length
LCFG = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=280), hidden_size=256,
                           intermediate_size=512)


def _jmesh(dims):
    return make_mesh(n_data=dims[0], n_model=dims[1], devices=jax.devices()[:dims[0] * dims[1]])


def _row_gumbel(seeds, steps, vocab):
    """JAX `generate`'s per-row Gumbel draws with (B,) keys."""
    out = []
    for s in seeds:
        k, draws = jax.random.key(s), []
        for _ in range(steps):
            k, sub = jax.random.split(k)
            draws.append(np.asarray(jax.random.gumbel(sub, (vocab,), jnp.float32)))
        out.append(np.stack(draws))
    return np.stack(out)


def test_tp_denoiser_and_decode_match_jax(tmp_path):
    seed = 31
    jcfg = junet.UNetConfig.tiny(with_ip=True)
    tree = random_tree(jax.eval_shape(lambda: junet.init(jax.random.key(0), jcfg)), seed)
    c = jcfg.cross_attention_dim
    reqs = [dict(latents=randn(seed + i, 16, 16, 4), ctx=randn(seed + 10 + i, 5, c),
                 ctx_uncond=randn(seed + 20 + i, 5, c), pooled=randn(seed + 30 + i, jcfg.pooled_dim),
                 pooled_uncond=randn(seed + 40 + i, jcfg.pooled_dim),
                 ip_tokens=randn(seed + 50 + i, 4, c), ip_tokens_uncond=randn(seed + 60 + i, 4, c),
                 num_inference_steps=2, guidance_scale=5.0, ip_scale=0.8) for i in range(3)]
    den = jserving.BatchedDenoiser(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                                   mesh=_jmesh((2, 2)))
    assert den._tp
    want = np.stack(den.run_batch([jserving.EditRequest(**r) for r in reqs]))

    # the LLaMA as the TP server quantizes it (unfused, o and down at int8:
    # row-split), and all int4 (o and down replicated, their input gathered)
    base = jax.tree_util.tree_map(
        jnp.asarray, random_tree(jax.eval_shape(lambda: jllama.init(jax.random.key(0), LCFG)), 5))
    trees = {"llama": jq.quantize_llama(base, bits=4, tp_rows_int8=True),
             "llama_int4": jq.quantize_llama(base, bits=4)}
    steps, seeds, pads = 8, [3, 4], np.asarray([0, 5], np.int32)
    emb = randn(seed + 70, 2, 12, LCFG.hidden_size, scale=0.5)
    emb[1, :5] = 0.0
    kw = dict(max_new_tokens=steps, temperature=0.3, eos_id=-1)
    keys = jnp.stack([jax.random.key(s) for s in seeds])
    jr = {k: jgen.generate(t, LCFG, jnp.asarray(emb), keys, prefix_pads=jnp.asarray(pads), **kw)
          for k, t in trees.items()}
    payload = {
        "mesh": (2, 2), "unet": tree, "unet_cfg": dataclasses.asdict(jcfg), "reqs": reqs,
        **{k: convert.to_numpy(t) for k, t in trees.items()},
        "llama_cfg": {f.name: getattr(LCFG, f.name) for f in dataclasses.fields(LCFG)
                      if f.name not in ("tie_embeddings", "scan_layers", "remat",
                                        "remat_policy")},
        "gen": {"emb": emb, "pads": pads, "gumbel": _row_gumbel(seeds, steps, LCFG.vocab_size),
                "kw": kw},
    }
    outs = spawn_ranks("tp_denoise", 4, tmp_path, payload)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["denoise"], want, atol=DENOISE_TOL, rtol=DENOISE_TOL,
                                   err_msg=f"rank {r}")
        # per CFG step: one all-reduce per row-parallel layer, one all-gather per conv
        assert o["denoise_counts"]["all-reduce"]["count"] > 0
        assert o["denoise_counts"]["all-gather"]["count"] > 0
        assert any(n.endswith("attn1.to_q") for n in o["sharded"])
        assert any(n.endswith("ff_in_g") for n in o["sharded"])
        for key, row_kind in (("llama", "row"), ("llama_int4", "row_gather")):
            got, ref = o[key], jr[key]
            assert got["kinds"]["layer_0.o"] == got["kinds"]["layer_0.down"] == row_kind
            assert got["kinds"]["layer_0.q"] == "col" and got["kinds"]["embed_tokens"] == "embed"
            assert got["kinds"]["lm_head"] == "col_gather"
            assert got["tokens"].tolist() == np.asarray(ref.tokens).tolist(), (r, key)
            np.testing.assert_array_equal(got["done_at"], np.asarray(ref.done_at))
            ref_h = np.asarray(ref.hiddens)
            assert np.abs(got["hiddens"] - ref_h).max() <= HIDDEN_TOL * np.abs(ref_h).max(), key
            # every decode step broadcasts the sampled token from model-rank 0
            assert got["counts"]["broadcast"]["count"] == steps
    assert np.abs(want[0] - want[1]).max() > 1e-3


def _jax_draws(seed, hl):
    shape = (hl, hl, 4)
    return {name: np.asarray(jax.random.normal(jax.random.key(seed + off), shape))
            for name, off in (("vae_noise", 0), ("polar_noise", 1), ("refiner_vae_noise", 2),
                              ("refiner_noise", 3))}


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("tp_media")
    rs = np.random.RandomState(0)
    paths = []
    for i in range(2):
        p = str(d / f"img{i}.png")
        Image.fromarray(rs.randint(0, 255, (72, 64, 3), np.uint8)).save(p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def tiny_tree():
    """Numpy weights of the tiny JAX pipeline, drawn from its shapes (the
    eager JAX init takes half a minute)."""
    obj = object.__new__(jpl.InstructAny2PixPipeline)
    obj.cfg = jpl.PipelineConfig.tiny()
    return random_tree(jax.eval_shape(lambda: obj._init_random(KeyChain(0))), 0)


@pytest.mark.parametrize("dims,refinement", [((1, 2), 0.0), ((2, 1), 0.5)])
def test_pipeline_server_on_a_mesh_matches_jax(tmp_path, media, tiny_tree, dims, refinement):
    # a pipeline of its own: the JAX server shards its LLM tree in place
    jp = jpl.InstructAny2PixPipeline(tiny=True, params=jax.tree_util.tree_map(jnp.asarray,
                                                                              tiny_tree))
    params = convert.pipeline_params(tiny_tree)
    js = jserving.PipelineServer(jp, mesh=_jmesh(dims), max_batch=4, max_new_tokens=NEW_TOKENS)
    emb_dim = jp.cfg.llm.image_codec_dim
    hl = jp.cfg.image_size // (2 ** (len(jp.cfg.vae.block_out_channels) - 1))
    common = dict(num_inference_steps=2, refinement=refinement, cfg=7.0)
    llm_specs = [(3, "edit <video>", [media[0]]),
                 (4, "add <video> to the scene, in the style of an old photograph", [media[1]])]
    stub_specs = [(7, [media[0]], (0.0, 0.4, 1.0), 0.7), (9, [], (0.0, 0.4, 1.0), 0.7),
                  (8, [media[1]], (0.2, 0.5, 0.8), 0.5)]

    def images(m):
        return [{"type": "image", "fname": p} for p in m]

    gumbel = _row_gumbel([s for s, _, _ in llm_specs], NEW_TOKENS, jp.cfg.llm.llama.vocab_size)
    llm_batch = [dict(inst=x, mm_data=images(m), seed=s, llm_gumbel=gumbel[i],
                      **common, **_jax_draws(s, hl)) for i, (s, x, m) in enumerate(llm_specs)]
    stub_batch = [dict(inst="stub: edit <video>", mm_data=images(m), h=h, alpha=a, seed=s,
                       **common, **_jax_draws(s, hl)) for s, m, h, a in stub_specs]
    try:
        j_llm = js._run_batch([jserving.PipelineRequest(x, images(m), seed=s, **common)
                               for s, x, m in llm_specs])

        def stage(reqs):
            outs = []
            for r in reqs:
                if not r.mm_data:
                    outs.append((None, None, "caption only", None, None))
                    continue
                rk = np.random.RandomState(r.seed)
                outs.append((jnp.asarray(rk.randn(1, emb_dim).astype(np.float32)),
                             jnp.asarray(rk.randn(emb_dim).astype(np.float32)),
                             f" a scene {r.seed}", r.mm_data[0]["fname"],
                             dict(all_objs=[], extra_embeds=[], extra_idx=[])))
            return outs

        js._llm_stage = stage
        j_stub = js._run_batch([jserving.PipelineRequest("edit <video>", images(m), h=h, alpha=a,
                                                         seed=s, **common)
                                for s, m, h, a in stub_specs])
    finally:
        js.stop()
    outs = spawn_ranks("pipeline_server", 2, tmp_path,
                       {"mesh": dims, "params": params, "max_new_tokens": NEW_TOKENS,
                        "batches": [("llm", llm_batch), ("stub", stub_batch)]})
    lead, follower = outs
    assert follower["released"]
    for name, want in (("llm", j_llm), ("stub", j_stub)):
        got = lead[name]
        assert [c for c, _ in got] == [w.caption for w in want], name
        for i, ((_, img), w) in enumerate(zip(got, want)):
            assert (img is None) == (w.image is None), (name, i)
            if img is not None:
                d = np.abs(img.astype(np.int32) - np.asarray(w.image).astype(np.int32))
                assert d.max() <= UINT8_TOL, (name, i, d.max(), int((d > 0).sum()))
    assert lead["stub"][1][1] is None and lead["stub"][0][1] is not None
    assert lead["llm_tokens"] is not None and lead["llm_tokens"].shape[0] == 2
    # every rank ran the same collectives: the batches' broadcasts and the
    # model's collectives
    for op in ("all-gather", "broadcast"):
        assert lead["counts"][op]["count"] == follower["counts"][op]["count"], op
    if dims[1] > 1:
        assert lead["counts"]["all-reduce"]["count"] > 0
