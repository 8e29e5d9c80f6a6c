"""The port's batched serving (`serving.py`) vs the JAX package's: the
scheduler's batching, FIFO order and bucket key; `BatchedDenoiser` against
JAX `sampler.denoise` at batch 3; the batched `generate` with per-row left
pads, per-row Gumbel draws and keyword stops against JAX `generate` with
(B,) keys; the `PipelineServer`'s LLM stage and diffusion stages against
the JAX server on a 1-device mesh, with the JAX draws handed to the port;
same-seed repeats, batch composition, the media cache and errors reaching
every future. `from_model_range` truncates to uint8, so a last-digit
difference may flip one level: images agree within 1. CPU, float32."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instructany2pix_tpu import pipeline as jpl
from instructany2pix_tpu import serving as jserving
from instructany2pix_tpu.core.mesh import make_mesh
from instructany2pix_tpu.diffusion import sampler as j_sampler
from instructany2pix_tpu.diffusion.schedulers import Schedule as JSchedule
from instructany2pix_tpu.llm import generate as jgen
from instructany2pix_tpu.models import llama as jllama
from instructany2pix_tpu.models import unet as j_unet
from instructany2pix_tpu.ops import quant as jq
from instructany2pix_tpu_torch import convert
from instructany2pix_tpu_torch import pipeline as tpl
from instructany2pix_tpu_torch import serving
from instructany2pix_tpu_torch.core.dtypes import FP32
from instructany2pix_tpu_torch.core.prng import row_normal
from instructany2pix_tpu_torch.diffusion.schedulers import Schedule
from instructany2pix_tpu_torch.llm import generate as tgen
from instructany2pix_tpu_torch.models import llama as tllama
from instructany2pix_tpu_torch.models import unet as t_unet
from instructany2pix_tpu_torch.utils import filecache
from torch_port_helpers import assert_close, one_torch_thread, randn, t  # noqa: F401 (autouse)

UINT8_TOL = 1
LOOP_REL_TOL = 1e-4  # relative to the output's max; float32, 3 UNet steps (as test_torch_sampler)
HIDDEN_TOL = 2e-5  # relative; float32 decode (as test_torch_llm)


# ------------------------------------------------------------- scheduler


def _dummy():
    return serving.EditRequest(
        latents=np.zeros((4, 4, 4), np.float32),
        ctx=np.zeros((3, 8), np.float32),
        ctx_uncond=np.zeros((3, 8), np.float32),
        pooled=np.zeros((8,), np.float32),
        pooled_uncond=np.zeros((8,), np.float32),
    )


def test_scheduler_batches_compatible_requests():
    calls = []

    def run_batch(reqs):
        calls.append(len(reqs))
        return [r.latents for r in reqs]

    sched = serving.BatchScheduler(run_batch, max_batch=4, max_wait_s=0.2).start()
    try:
        futs = [sched.submit(_dummy()) for _ in range(3)]
        outs = [f.result(timeout=10) for f in futs]
        assert len(outs) == 3
        assert max(calls) > 1  # batched at least once
    finally:
        sched.stop()


def test_scheduler_fifo_fairness_alternating_buckets():
    """Alternating-bucket traffic keeps arrival order: the first batch holds
    bucket A's requests in order, the next bucket B's."""
    order = []

    def run_batch(reqs):
        order.extend(id(r) for r in reqs)
        return [r.latents for r in reqs]

    sched = serving.BatchScheduler(run_batch, max_batch=8, max_wait_s=0.05)
    reqs = [_dummy() for _ in range(6)]
    for i, r in enumerate(reqs):
        r.num_inference_steps = 2 if i % 2 == 0 else 3
    futs = [sched.submit(r) for r in reqs]
    sched.start()
    try:
        for f in futs:
            f.result(timeout=10)
    finally:
        sched.stop()
    assert order == [id(reqs[i]) for i in (0, 2, 4, 1, 3, 5)]


def test_bucket_key_separates_ip_token_shapes():
    a, b = _dummy(), _dummy()
    a.ip_tokens = np.zeros((4, 8), np.float32)
    b.ip_tokens = np.zeros((8, 8), np.float32)
    sched = serving.BatchScheduler(lambda reqs: [r.latents for r in reqs])
    assert sched._bucket(a) != sched._bucket(b)
    c = _dummy()
    c.ctx = np.zeros((5, 8), np.float32)
    assert sched._bucket(_dummy()) != sched._bucket(c)


def test_scheduler_sets_a_batch_error_on_every_future():
    def run_batch(reqs):
        raise RuntimeError("card fault")

    sched = serving.BatchScheduler(run_batch, max_batch=4, max_wait_s=0.2).start()
    try:
        futs = [sched.submit(_dummy()) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="card fault"):
                f.result(timeout=10)
        assert sched._thread.is_alive()  # the worker serves the next batch
        sched._run = lambda reqs: [r.latents for r in reqs]
        assert sched.submit(_dummy()).result(timeout=10).shape == (4, 4, 4)
    finally:
        sched.stop()


# ------------------------------------------------------------ denoiser


def test_batched_denoiser_matches_jax_denoise():
    seed = 81
    jcfg = j_unet.UNetConfig.tiny(with_ip=True)
    tree = convert.to_numpy(j_unet.init(jax.random.key(seed), jcfg))
    pcfg = t_unet.UNetConfig(**dataclasses.asdict(jcfg))
    unet = convert.unet(tree, pcfg)
    den = serving.BatchedDenoiser(lambda: unet, pcfg, schedule=Schedule.create())
    c = jcfg.cross_attention_dim
    reqs = [serving.EditRequest(
        latents=randn(seed + i, 16, 16, 4), ctx=randn(seed + 10 + i, 5, c),
        ctx_uncond=randn(seed + 20 + i, 5, c), pooled=randn(seed + 30 + i, jcfg.pooled_dim),
        pooled_uncond=randn(seed + 40 + i, jcfg.pooled_dim), ip_tokens=randn(seed + 50 + i, 4, c),
        ip_tokens_uncond=randn(seed + 60 + i, 4, c), num_inference_steps=3, guidance_scale=5.0,
        ip_scale=0.8) for i in range(3)]
    outs = den.run_batch(reqs)

    def stack(name):
        return jnp.asarray(np.stack([getattr(r, name) for r in reqs]))

    ref = np.asarray(j_sampler.denoise(
        tree, jcfg, JSchedule.create(), stack("latents"), stack("ctx"), stack("ctx_uncond"),
        stack("pooled"), stack("pooled_uncond"), j_sampler.default_time_ids(128, 128, 3),
        num_inference_steps=3, guidance_scale=5.0, ip_tokens=stack("ip_tokens"),
        ip_tokens_uncond=stack("ip_tokens_uncond"), ip_scale=0.8))
    assert_close(np.stack(outs), ref, LOOP_REL_TOL, seed, rel=True, what="batched denoise")
    assert np.abs(outs[0] - outs[1]).max() > 1e-4


def test_a_mesh_of_several_devices_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serving._refuse_mesh(["cuda:0", "cuda:1"])
    serving._refuse_mesh(["cuda:0"])


# ------------------------------------------------------------- generate


LCFG = dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=280), hidden_size=256,
                           intermediate_size=512)


def _tcfg():
    return tllama.LlamaConfig(**{f.name: getattr(LCFG, f.name)
                                 for f in dataclasses.fields(tllama.LlamaConfig)})


def _row_gumbel(seeds, steps, vocab):
    """The Gumbel draws of JAX `generate` with (B,) keys: row i splits its
    own key once per step and samples from the second half."""
    out = []
    for s in seeds:
        k, draws = jax.random.key(s), []
        for _ in range(steps):
            k, sub = jax.random.split(k)
            draws.append(np.asarray(jax.random.gumbel(sub, (vocab,), jnp.float32)))
        out.append(np.stack(draws))
    return np.stack(out)


@pytest.fixture(scope="module")
def llama_trees():
    tree = jllama.fuse_projections(jq.quantize_llama(jllama.init(jax.random.key(0), LCFG), bits=4))
    return tree, convert.llama(convert.to_numpy(tree), _tcfg())


def test_batched_generate_with_pads_streams_and_stops_matches_jax(llama_trees):
    tree, port = llama_trees
    seed, steps, seeds = 17, 10, [5, 6, 7]
    pads = np.asarray([0, 3, 6], np.int32)
    emb = randn(seed, 3, 12, LCFG.hidden_size, scale=0.5)
    for i, p in enumerate(pads):
        emb[i, :p] = 0.0  # left pad slots (masked, never attended)
    keys = jnp.stack([jax.random.key(s) for s in seeds])
    kw = dict(max_new_tokens=steps, temperature=0.3, eos_id=-1)
    free = jgen.generate(tree, LCFG, jnp.asarray(emb), keys, prefix_pads=jnp.asarray(pads), **kw)
    # a keyword taken from row 0's own stream: it must stop there
    stop = (tuple(int(x) for x in np.asarray(free.tokens)[0, 2:4]), (277, 278, 279))
    jr = jgen.generate(tree, LCFG, jnp.asarray(emb), keys, prefix_pads=jnp.asarray(pads),
                       stop_sequences=stop, **kw)
    gumbel = t(_row_gumbel(seeds, steps, LCFG.vocab_size))
    for dynamic in (False, True):
        tr = tgen.generate(port, _tcfg(), t(emb), None, gumbel=gumbel, prefix_pads=t(pads),
                           stop_sequences=stop, dynamic_stop=dynamic, **kw)
        done = np.asarray(jr.done_at)
        assert done[0] <= 3, done
        assert tr.done_at.tolist() == done.tolist()
        for i in range(3):
            n = min(int(done[i]) + 1, steps)
            assert tr.tokens[i, :n].tolist() == np.asarray(jr.tokens)[i, :n].tolist(), i
            assert_close(tr.hiddens[i, :n], np.asarray(jr.hiddens)[i, :n], HIDDEN_TOL, seed, rel=True,
                         what=f"hiddens row {i}")
        if not dynamic:
            assert np.array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))


def test_per_row_generators_make_rows_independent(llama_trees):
    """Row i's tokens depend on generator i alone, not on the batch."""
    _, port = llama_trees
    e, other = randn(1, 1, 6, LCFG.hidden_size), randn(2, 1, 6, LCFG.hidden_size)
    kw = dict(max_new_tokens=6, temperature=0.7, eos_id=-1)
    solo = tgen.generate(port, _tcfg(), t(e), [torch.Generator().manual_seed(11)], **kw)
    batched = tgen.generate(port, _tcfg(), t(np.concatenate([other, e])),
                            [torch.Generator().manual_seed(22), torch.Generator().manual_seed(11)], **kw)
    assert torch.equal(solo.tokens[0], batched.tokens[1])


def test_row_normal_per_row_determinism():
    a = row_normal([torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)], (2, 4, 4))
    b = row_normal([torch.Generator().manual_seed(3), torch.Generator().manual_seed(1)], (2, 4, 4))
    assert torch.equal(a[0], b[1]) and not torch.equal(a[0], a[1])
    given = randn(4, 2, 4, 4)
    assert torch.equal(row_normal(given, (2, 4, 4)), t(given))
    with pytest.raises(ValueError):
        row_normal(given, (3, 4, 4))


# ------------------------------------------------------ pipeline server


@pytest.fixture(scope="module")
def pipes():
    jp = jpl.InstructAny2PixPipeline(tiny=True, seed=0)
    tp = tpl.InstructAny2PixPipeline(tpl.PipelineConfig.tiny(), params=convert.pipeline_params(jp.params),
                                     device="cpu", policy=FP32)
    return jp, tp


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("serve_media")
    rs = np.random.RandomState(0)
    paths = []
    for i in range(2):
        p = str(d / f"img{i}.png")
        Image.fromarray(rs.randint(0, 255, (72, 64, 3), np.uint8)).save(p)
        paths.append(p)
    return paths


def _servers(pipes, max_batch=4, max_wait_s=0.05, **kw):
    jp, tp = pipes
    mesh1 = make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    js = jserving.PipelineServer(jp, mesh=mesh1, max_batch=max_batch, max_wait_s=max_wait_s, **kw)
    ts = serving.PipelineServer(tp, max_batch=max_batch, max_wait_s=max_wait_s, **kw)
    return js, ts


def test_llm_stage_matches_jax_server(pipes):
    """Two prompts of different lengths (different left pads) in one batched
    decode, each row sampling from its own seed's stream."""
    js, ts = _servers(pipes)
    try:
        texts = ["short", "a much longer instruction with many more words, so that its prompt "
                          "falls in another place of the left-padded bucket"]
        seeds = [3, 4]
        jreqs = [jserving.PipelineRequest(x, [], seed=s) for x, s in zip(texts, seeds)]
        vocab = ts.pipe.cfg.llm.llama.vocab_size
        g = _row_gumbel(seeds, ts.max_new_tokens, vocab)
        treqs = [serving.PipelineRequest(x, [], seed=s, llm_gumbel=g[i])
                 for i, (x, s) in enumerate(zip(texts, seeds))]
        j_outs, t_outs = js._llm_stage(jreqs), ts._llm_stage(treqs)
    finally:
        js.stop()
        ts.stop()
    no_media = torch.zeros((0, ts.pipe.cfg.llm.image_codec_dim))
    lens = [ts.pipe._prepare_llm_inputs(x, no_media)[0].shape[1] for x in texts]
    assert lens[0] != lens[1]
    for i, (a, b) in enumerate(zip(t_outs, j_outs)):
        assert a[2] == b[2], (i, a[2], b[2])
        assert (a[0] is None) == (b[0] is None)
        if a[0] is not None:
            assert_close(a[0], np.asarray(b[0]), 1e-4, i, rel=True, what="image embeds")


def _stub(paths, emb_dim):
    """An LLM stage with fixed outcomes: an image edit per request with
    media, seeded from the request's seed; a caption otherwise."""
    def stage(reqs, to_array):
        outs = []
        for r in reqs:
            if not r.mm_data:
                outs.append((None, None, "caption only", None, None))
                continue
            rk = np.random.RandomState(r.seed)
            outs.append((to_array(rk.randn(1, emb_dim).astype(np.float32)),
                         to_array(rk.randn(emb_dim).astype(np.float32)), f" a scene {r.seed}",
                         r.mm_data[0]["fname"], dict(all_objs=[], extra_embeds=[], extra_idx=[])))
        return outs
    return stage


def _jax_draws(seed, hl):
    """The JAX server's per-row draws of one request."""
    shape = (hl, hl, 4)
    return {name: np.asarray(jax.random.normal(jax.random.key(seed + off), shape))
            for name, off in (("vae_noise", 0), ("polar_noise", 1), ("refiner_vae_noise", 2),
                              ("refiner_noise", 3))}


def _levels(a, b, what):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= UINT8_TOL, (f"{what}: max {d.max()} levels, mean {d.mean():.4g}, "
                                  f"{int((d > 0).sum())} differ")


@pytest.mark.parametrize("refinement", [0.0, 0.5])
def test_run_batch_matches_jax_server(pipes, images, refinement):
    js, ts = _servers(pipes)
    stage = _stub(images, ts.pipe.cfg.llm.image_codec_dim)
    js._llm_stage = lambda reqs: stage(reqs, jnp.asarray)
    ts._llm_stage = lambda reqs: stage(reqs, np.asarray)
    hl = ts.pipe._latent_size()
    specs = [(7, [images[0]], (0.0, 0.4, 1.0), 0.7), (9, [], (0.0, 0.4, 1.0), 0.7),
             (8, [images[1]], (0.2, 0.5, 0.8), 0.5)]
    common = dict(num_inference_steps=2, refinement=refinement, cfg=7.0)
    try:
        jreqs = [jserving.PipelineRequest("edit <video>", [{"type": "image", "fname": p} for p in m],
                                          h=h, alpha=a, seed=s, **common) for s, m, h, a in specs]
        treqs = [serving.PipelineRequest("edit <video>", [{"type": "image", "fname": p} for p in m],
                                         h=h, alpha=a, seed=s, **common, **_jax_draws(s, hl))
                 for s, m, h, a in specs]
        j_out, t_out = js._run_batch(jreqs), ts._run_batch(treqs)
    finally:
        js.stop()
        ts.stop()
    assert t_out[1].image is None and j_out[1].image is None
    assert t_out[1].caption == j_out[1].caption == "caption only"
    for i in (0, 2):
        assert t_out[i].caption == j_out[i].caption
        assert t_out[i].image.shape == (64, 64, 3) and t_out[i].image.dtype == np.uint8
        _levels(t_out[i].image, j_out[i].image, f"row {i} refinement {refinement}")
    assert not np.array_equal(t_out[0].image, t_out[2].image)


def test_repeats_batch_composition_and_single_request(pipes, images):
    """Same batch again: bit-identical. A row alone and in a batch: within
    1 level. The server's row against `__call__` with the same draws:
    within 1 level."""
    _, tp = pipes
    ts = serving.PipelineServer(tp, max_batch=4)
    stage = _stub(images, tp.cfg.llm.image_codec_dim)
    ts._llm_stage = lambda reqs: stage(reqs, np.asarray)
    hl = tp._latent_size()

    def req(seed, path, **draws):
        return serving.PipelineRequest("edit <video>", [{"type": "image", "fname": path}],
                                       num_inference_steps=2, refinement=0.5, seed=seed, **draws)
    try:
        a = ts._run_batch([req(7, images[0]), req(8, images[1])])
        b = ts._run_batch([req(7, images[0]), req(8, images[1])])
        alone = ts._run_batch([req(8, images[1])])
        draws = _jax_draws(7, hl)
        served = ts._run_batch([req(7, images[0], **draws)])[0].image
    finally:
        ts.stop()
    for x, y in zip(a, b):
        assert np.array_equal(x.image, y.image)
    _levels(alone[0].image, a[1].image, "alone vs batched")
    assert not np.array_equal(a[0].image, a[1].image)
    cache = stage([req(7, images[0])], np.asarray)[0]
    tp.cache = cache
    _, refined, _ = tp("edit <video>", [{"type": "image", "fname": images[0]}], use_cache=True,
                       num_inference_steps=2, refinement=0.5, cfg=10.0,
                       vae_noise=draws["vae_noise"][None], polar_noise=draws["polar_noise"][None],
                       refiner_vae_noise=draws["refiner_vae_noise"][None],
                       refiner_noise=draws["refiner_noise"][None])
    tp.cache = None
    _levels(served, refined, "server vs __call__")


def test_submit_serves_batches_and_reports_errors(pipes, images):
    """Through the scheduler's worker thread: images for edits, None for a
    caption-only answer, and a stage's error on every future of its batch."""
    _, tp = pipes
    ts = serving.PipelineServer(tp, max_batch=3, max_wait_s=0.5)
    stage = _stub(images, tp.cfg.llm.image_codec_dim)
    ts._llm_stage = lambda reqs: stage(reqs, np.asarray)
    try:
        reqs = [serving.PipelineRequest("edit <video>", m, num_inference_steps=2, seed=s)
                for s, m in ((1, [{"type": "image", "fname": images[0]}]), (2, []),
                             (3, [{"type": "image", "fname": images[1]}]))]
        outs = [f.result(timeout=300) for f in [ts.submit(r) for r in reqs]]
        assert outs[1].image is None and outs[1].caption == "caption only"
        for o in (outs[0], outs[2]):
            assert o.image.shape == (64, 64, 3) and o.image.std() > 0
        ts._llm_stage = lambda reqs: (_ for _ in ()).throw(RuntimeError("stage fault"))
        futs = [ts.submit(r) for r in reqs[:2]]
        for f in futs:
            with pytest.raises(RuntimeError, match="stage fault"):
                f.result(timeout=60)
    finally:
        ts.stop()
    with pytest.raises(ValueError, match="16"):
        serving.PipelineServer(tp, max_batch=17)


def test_media_cache_hits_and_refreshes(pipes, images, tmp_path):
    from PIL import Image

    _, tp = pipes
    path = str(tmp_path / "base.png")
    Image.fromarray(np.random.RandomState(1).randint(0, 255, (72, 64, 3), np.uint8)).save(path)
    first = tp.load_base_img(path)
    hits = filecache.MEDIA_CACHE.hits
    again = tp.load_base_img(path)
    assert filecache.MEDIA_CACHE.hits == hits + 1 and np.array_equal(first, again)
    emb = tp._embed_media({"type": "image", "fname": path})
    assert filecache.MEDIA_CACHE.hits == hits + 1  # another tag: computed once
    assert torch.equal(tp._embed_media({"type": "image", "fname": path}), emb)
    assert filecache.MEDIA_CACHE.hits == hits + 2
    # overwritten: the mtime key changes, so the file is read again
    Image.fromarray(np.random.RandomState(2).randint(0, 255, (72, 64, 3), np.uint8)).save(path)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    fresh = tp.load_base_img(path)
    assert not np.array_equal(first, fresh)
    assert np.array_equal(fresh, tpl.image_io.resize_and_crop(path, tp.cfg.image_size))
    os.environ["IA2P_MEDIA_CACHE"] = "0"
    try:
        hits = filecache.MEDIA_CACHE.hits
        tp.load_base_img(path)
        assert filecache.MEDIA_CACHE.hits == hits
    finally:
        del os.environ["IA2P_MEDIA_CACHE"]
