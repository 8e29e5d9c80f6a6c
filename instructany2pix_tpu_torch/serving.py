"""Batched edit serving on one GPU, counterpart of the JAX package's
`serving.py`.

The reference serves one request at a time through a gradio queue
(reference serve.py:115, no batching). This module serves many users from
one card, every model resident or staged (see below):

  * `BatchScheduler` — a microbatching request queue (max batch size, max
    wait), thread-safe, futures-based; one worker thread runs the batches.
  * `BatchedDenoiser` — the CFG denoise over a stacked batch of
    `EditRequest`s (`make_server` puts it behind a scheduler).
  * `PipelineServer` — the whole edit per microbatch: ImageBind, the LLM's
    left-padded batched decode, the prior, the prompt encode, VAE encode,
    DDIM inversion, the conditioning mix, polar noise and IP-Adapter
    projection, the CFG denoise, VAE decode and the refiner, each stage once
    per microbatch rather than once per request.
  * `serve_http` — a minimal aiohttp front end for `EditRequest`s
    (`aiohttp` is imported when it is called).

Unlike the JAX server, which compiles the single-chip edit into one
dispatch, the stages run in order, eagerly, each on the stacked batch.
Torch's inference mode is thread-local, so each batch enters it on the
worker thread; the kernels build at their first launch under
`ops/_build.py`'s lock, so a first launch on the worker cannot race
another build. A pipeline over a `core.staging.StagedParams` store (a card
that cannot hold every model) serves too: the denoiser resolves the UNet
from the store per batch (`params_provider`), and every stage looks its
module up where it uses it. One device only: the JAX server's
tensor-parallel mesh (ROADMAP Queue 1, item 10) is not ported, and a mesh
of more than one device raises.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .core.prng import row_normal
from .diffusion import sampler as sampler_lib
from .diffusion.schedulers import Schedule, SchedulerConfig
from .models import unet as unet_lib


def _refuse_mesh(mesh) -> None:
    if mesh is None:
        return
    size = mesh.size() if callable(getattr(mesh, "size", None)) else len(mesh)
    if size > 1:
        raise NotImplementedError(
            "the port serves from one device: a mesh of more than one is not ported yet "
            "(ROADMAP Queue 1, item 10)")


@dataclasses.dataclass
class EditRequest:
    latents: np.ndarray  # (h, w, 4) initial latents
    ctx: np.ndarray  # (S, ctx_dim) prompt embeds
    ctx_uncond: np.ndarray
    pooled: np.ndarray
    pooled_uncond: np.ndarray
    ip_tokens: Optional[np.ndarray] = None  # (n, ctx_dim)
    # uncond IP tokens (projection of zero embeds, not zero tokens,
    # reference ip_adapter.py:205-209); zeros when absent
    ip_tokens_uncond: Optional[np.ndarray] = None
    guidance_scale: float = 10.0
    num_inference_steps: int = 25
    ip_scale: float = 1.0


class BatchScheduler:
    """Groups compatible requests into microbatches."""

    def __init__(
        self,
        run_batch: Callable[[List[Any]], List[Any]],
        max_batch: int = 8,
        max_wait_s: float = 0.05,
        bucket_fn: Optional[Callable[[Any], Any]] = None,
    ):
        self._run = run_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._bucket_fn = bucket_fn
        self._q: "queue.Queue[Tuple[Any, Future]]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def submit(self, req) -> Future:
        fut: Future = Future()
        self._q.put((req, fut))
        return fut

    def _bucket(self, req):
        if self._bucket_fn is not None:
            return self._bucket_fn(req)
        # every array shape that is stacked into the batch must match:
        # latents, ctx and the IP token blocks (global and local IP embeds
        # give different token counts)
        return (
            req.num_inference_steps, req.latents.shape, req.guidance_scale,
            req.ip_scale, req.ctx.shape,
            None if req.ip_tokens is None else req.ip_tokens.shape,
            None if req.ip_tokens_uncond is None else req.ip_tokens_uncond.shape,
        )

    def _loop(self):
        # `pending` holds requests in arrival order; incompatible requests
        # keep their place rather than go to the tail, so traffic that
        # alternates between buckets stays first in, first out.
        pending: "deque[Tuple[Any, Future]]" = deque()
        while not self._stop.is_set():
            if not pending:
                try:
                    pending.append(self._q.get(timeout=0.1))
                except queue.Empty:
                    continue
            key = self._bucket(pending[0][0])
            deadline = time.monotonic() + self.max_wait_s
            while sum(1 for it in pending if self._bucket(it[0]) == key) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    pending.append(self._q.get(timeout=timeout))
                except queue.Empty:
                    break
            batch: List[Tuple[Any, Future]] = []
            rest: "deque[Tuple[Any, Future]]" = deque()
            for it in pending:
                if len(batch) < self.max_batch and self._bucket(it[0]) == key:
                    batch.append(it)
                else:
                    rest.append(it)
            pending = rest
            reqs = [r for r, _ in batch]
            futs = [f for _, f in batch]
            try:
                outs = self._run(reqs)
                for f, o in zip(futs, outs):
                    f.set_result(o)
            except Exception as e:  # noqa: BLE001 — every caller of the batch gets it
                for f in futs:
                    f.set_exception(e)


class BatchedDenoiser:
    """The CFG denoise over a stacked batch, on the UNet's device.

    `params_provider`: a zero-argument callable that returns the UNet,
    called once per batch instead of holding the module, so a
    `StagedParams` store may evict it between batches (the server passes
    `lambda: pipe.models["unet"]`, `make_server` `lambda: unet`)."""

    def __init__(self, params_provider: Callable[[], unet_lib.UNet],
                 unet_cfg: unet_lib.UNetConfig, schedule: Optional[Schedule] = None, mesh=None):
        _refuse_mesh(mesh)
        self._provider = params_provider
        self.cfg = unet_cfg
        self.schedule = schedule or Schedule.create(
            SchedulerConfig(), params_provider().conv_in.weight.device)

    def denoise(self, lat, ctx, ctx_u, pooled, pooled_u, tid, steps: int, guidance: float,
                ip=None, ip_u=None, ip_scale: float = 1.0) -> torch.Tensor:
        return sampler_lib.denoise(
            self._provider(), self.cfg, self.schedule, lat, ctx, ctx_u, pooled, pooled_u, tid,
            num_inference_steps=steps, guidance_scale=guidance, ip_tokens=ip,
            ip_tokens_uncond=ip_u, ip_scale=ip_scale,
        )

    def run_batch(self, reqs: List[EditRequest]) -> List[np.ndarray]:
        dev = self._provider().conv_in.weight.device

        def stack(get):
            return torch.as_tensor(np.stack([np.asarray(get(r), np.float32) for r in reqs]),
                                   device=dev)

        with torch.inference_mode():
            lat = stack(lambda r: r.latents)
            ip = ip_u = None
            if reqs[0].ip_tokens is not None:
                ip = stack(lambda r: r.ip_tokens)
                ip_u = (stack(lambda r: r.ip_tokens_uncond)
                        if reqs[0].ip_tokens_uncond is not None else torch.zeros_like(ip))
            size = lat.shape[1] * 8
            tid = sampler_lib.default_time_ids(size, size, lat.shape[0], dev)
            r0 = reqs[0]
            out = self.denoise(
                lat, stack(lambda r: r.ctx), stack(lambda r: r.ctx_uncond),
                stack(lambda r: r.pooled), stack(lambda r: r.pooled_uncond), tid,
                r0.num_inference_steps, r0.guidance_scale, ip, ip_u, r0.ip_scale,
            ).float().cpu().numpy()
        return [out[i] for i in range(len(reqs))]


def make_server(unet, unet_cfg: unet_lib.UNetConfig, max_batch: int = 8,
                max_wait_s: float = 0.05, mesh=None) -> BatchScheduler:
    den = BatchedDenoiser(lambda: unet, unet_cfg, mesh=mesh)
    return BatchScheduler(den.run_batch, max_batch, max_wait_s).start()


def serve_http(scheduler: BatchScheduler, host: str = "0.0.0.0", port: int = 8080):
    """Minimal aiohttp JSON endpoint: POST /edit with a base64 npz of the
    request tensors → a base64 npz of the latents. Needs `aiohttp`."""
    import asyncio
    import base64
    import io

    try:
        from aiohttp import web
    except ImportError as e:
        raise ImportError("serve_http needs the `aiohttp` package, which is not installed") from e

    async def edit(request: "web.Request") -> "web.Response":
        payload = await request.read()
        data = np.load(io.BytesIO(base64.b64decode(payload)))
        req = EditRequest(
            latents=data["latents"],
            ctx=data["ctx"],
            ctx_uncond=data["ctx_uncond"],
            pooled=data["pooled"],
            pooled_uncond=data["pooled_uncond"],
            ip_tokens=data.get("ip_tokens"),
            guidance_scale=float(data.get("guidance_scale", 10.0)),
            num_inference_steps=int(data.get("steps", 25)),
        )
        fut = scheduler.submit(req)
        out = await asyncio.wrap_future(fut)
        buf = io.BytesIO()
        np.savez(buf, latents=out)
        return web.Response(body=base64.b64encode(buf.getvalue()))

    app = web.Application()
    app.router.add_post("/edit", edit)
    web.run_app(app, host=host, port=port)


# ---------------------------------------------------------- full pipeline


@dataclasses.dataclass
class PipelineRequest:
    """Instruction-level request (what serve.run receives, reference
    serve.py:14-45). The optional draws replace the generators seeded from
    `seed` at their site (tests feed the JAX server's draws through them):
    `llm_gumbel` (max_new_tokens, V), the others (h, w, 4)."""

    inst: str
    mm_data: List[dict]
    alpha: float = 0.7
    h: tuple = (0.0, 0.4, 1.0)
    norm: float = 20.0
    num_inference_steps: int = 25
    cfg: float = 10.0
    scale: float = 1.0
    refinement: float = 0.0
    seed: int = 0
    llm_gumbel: Optional[np.ndarray] = None
    vae_noise: Optional[np.ndarray] = None
    polar_noise: Optional[np.ndarray] = None
    refiner_vae_noise: Optional[np.ndarray] = None
    refiner_noise: Optional[np.ndarray] = None


@dataclasses.dataclass
class PipelineResult:
    image: Optional[np.ndarray]
    caption: str


# the seed offset of each sampling site, the JAX server's convention: LLM
# sampling and the VAE posterior use `seed`, polar noise seed + 1, the
# refiner's VAE posterior seed + 2 and its img2img noise seed + 3
SEED_OFFSETS = {"llm": 0, "vae_noise": 0, "polar_noise": 1, "refiner_vae_noise": 2,
                "refiner_noise": 3}


class PipelineServer:
    """Batched full-pipeline server over an `InstructAny2PixPipeline`, resident
    or staged
    (BASELINE.json config 5): every stage runs once per microbatch.

    Batch compatibility (the scheduler's bucket): num_inference_steps, cfg,
    refinement, IP scale (and whether the LLM draws are injected). Prompts
    of different lengths batch together through per-row left pads
    (`generate(prefix_pads=...)`); requests whose LLM answer asks for no
    image return their caption without joining the diffusion stages; the
    refiner runs as one batched img2img when refinement > 0. Every row
    draws from generators of its own, seeded from its request's `seed`
    (`SEED_OFFSETS`), so on the CPU a request's result does not depend on
    what else is in its batch; on the card a batch of another size may
    take other GEMM algorithms. Subject consistency is a per-request
    feature and stays on the pipeline's `__call__`.

    `max_batch` stays at most 16, the largest M of the decode matvec
    (`ops.quant.QMV_MAX_M`), so every decode step of a batch runs on it.
    """

    def __init__(self, pipe, max_batch: int = 4, max_wait_s: float = 0.05, bucket: int = 64,
                 max_new_tokens: int = 100, mesh=None):
        from .ops import quant as Q

        _refuse_mesh(mesh)
        if max_batch > Q.QMV_MAX_M:
            raise ValueError(f"max_batch {max_batch} > {Q.QMV_MAX_M}: the decode matvec takes "
                             f"at most {Q.QMV_MAX_M} rows")
        self.pipe = pipe
        self.bucket = bucket
        self.max_new_tokens = max_new_tokens
        self.last_generate = None
        # a staged store may evict the UNet between batches: resolve it per batch
        self.denoiser = BatchedDenoiser(lambda: pipe.models["unet"], pipe.cfg.unet,
                                        schedule=pipe.schedule)
        self.scheduler = BatchScheduler(
            self._run_batch, max_batch, max_wait_s,
            bucket_fn=lambda req: (req.num_inference_steps, req.cfg, req.refinement, req.scale,
                                   req.llm_gumbel is not None),
        )
        self.scheduler.start()

    def submit(self, req: PipelineRequest) -> Future:
        return self.scheduler.submit(req)

    def stop(self):
        self.scheduler.stop()

    # ------------------------------------------------------------ stages

    def _rows(self, reqs: List[PipelineRequest], site: str, shape) -> torch.Tensor:
        """(B,) + shape noise of one sampling site: a request's injected
        draw, or one from a generator seeded with its seed + the site's offset."""
        dev = self.pipe.device
        rows = []
        for r in reqs:
            given = getattr(r, site)
            if given is None:
                gen = torch.Generator(dev).manual_seed(int(r.seed) + SEED_OFFSETS[site])
                rows.append(row_normal([gen], (1,) + tuple(shape))[0])
            else:
                rows.append(row_normal(np.asarray(given, np.float32)[None], (1,) + tuple(shape),
                                       device=dev)[0])
        return torch.stack(rows)

    def _batched_mm_embed(self, reqs: List[PipelineRequest]) -> List[torch.Tensor]:
        """ImageBind for the whole microbatch, one call per modality. Returns
        one renormed (N_i, D) aux matrix per request, as `embed_mm_data`."""
        from . import pipeline as pipeline_mod
        from .codecs import image_io
        from .models import imagebind as ib_lib
        from .utils.filecache import cached

        pipe = self.pipe
        c = pipe.cfg
        slots, vis_px, aud_clips = [], [], []
        for r in reqs:
            row = []
            for item in r.mm_data:
                if "embed" in item:
                    row.append(("embed", pipe._tensor(item["embed"]).reshape(1, -1)))
                elif item["type"] == "image":
                    size = c.imagebind_vision.image_size or 224
                    fname = item["fname"]
                    vis_px.append(cached(fname, ("ib_vis", size), lambda: ib_lib.preprocess_vision(
                        image_io.load_image(fname), size))[0])
                    row.append(("vis", len(vis_px) - 1))
                elif item["type"] == "audio":
                    fname = item["fname"]
                    aud_clips.append(cached(fname, "ib_aud", lambda: ib_lib.preprocess_audio(
                        pipeline_mod._load_wav(fname))))
                    row.append(("aud", len(aud_clips) - 1))
                else:
                    raise ValueError(item["type"])
            slots.append(row)
        vis_out = aud_out = None
        with pipe._stage("serve_imagebind"):
            if vis_px:
                vis_out = ib_lib.apply(pipe.models["imagebind_vision"], np.stack(vis_px),
                                       c.imagebind_vision).float()
            if aud_clips:
                nclips = aud_clips[0].shape[0]
                o = ib_lib.apply(pipe.models["imagebind_audio"], np.concatenate(aud_clips),
                                 c.imagebind_audio).float()
                aud_out = o.reshape(-1, nclips, o.shape[-1]).mean(dim=1)
        auxes = []
        for row in slots:
            embeds = [v if kind == "embed" else (vis_out[v] if kind == "vis" else aud_out[v])
                      .reshape(1, -1) for kind, v in row]
            a = (torch.cat(embeds, dim=0) if embeds
                 else torch.zeros((0, c.llm.image_codec_dim), device=pipe.device))
            auxes.append(a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-9)
                         * c.embed_norm)
        return auxes

    @torch.inference_mode()
    def _llm_stage(self, reqs: List[PipelineRequest]):
        """One batched KV-cached generate over left-padded prompts, each row
        sampling from its own stream; then the per-row bookkeeping."""
        from .llm import generate as gen_lib

        pipe = self.pipe
        aux = self._batched_mm_embed(reqs)
        prepared = [pipe._prepare_llm_inputs(r.inst, a) for r, a in zip(reqs, aux)]
        lens = [e.shape[1] for _, e in prepared]
        tgt = -(-max(lens) // self.bucket) * self.bucket
        emb = torch.cat([torch.nn.functional.pad(e, (0, 0, tgt - e.shape[1], 0))
                         for _, e in prepared])
        prefix_pads = torch.tensor([tgt - n for n in lens], device=pipe.device)
        eos_id = getattr(pipe.tokenizer, "eos_token_id", 2)
        gumbel = gens = None
        if reqs[0].llm_gumbel is not None:
            gumbel = torch.as_tensor(np.stack([np.asarray(r.llm_gumbel, np.float32) for r in reqs]))
        else:
            gens = [torch.Generator(pipe.device).manual_seed(int(r.seed) + SEED_OFFSETS["llm"])
                    for r in reqs]
        with pipe._stage("serve_llm"):
            result = gen_lib.generate(
                pipe.models["llm"].llama, pipe.cfg.llm.llama, emb, gens,
                max_new_tokens=self.max_new_tokens, temperature=0.3, eos_id=eos_id,
                prefix_pads=prefix_pads, dynamic_stop=True, gumbel=gumbel,
            )
        self.last_generate = result
        outs = []
        for i, (r, (ids, _)) in enumerate(zip(reqs, prepared)):
            n_out = min(int(result.done_at[i]) + 1, result.tokens.shape[1])
            outs.append(pipe._postprocess_llm(result.tokens[i, :n_out].cpu().numpy(),
                                              result.hiddens[i, :n_out], ids, aux[i], r.mm_data))
        return outs

    @torch.inference_mode()
    def _run_batch(self, reqs: List[PipelineRequest]) -> List[PipelineResult]:
        from . import pipeline as pipeline_mod
        from .codecs import image_io
        from .diffusion import img2img as i2i
        from .diffusion import ip_adapter as ipa
        from .models import clip as clip_lib
        from .models import vae as vae_lib
        from .prior import model as prior_lib

        pipe = self.pipe
        c = pipe.cfg
        dev = pipe.device
        llm_outs = self._llm_stage(reqs)

        # requests whose answer asks for no image are answered by their caption
        live = [i for i, o in enumerate(llm_outs) if o[0] is not None]
        results = [PipelineResult(None, o[2]) for o in llm_outs]
        if not live:
            return results
        rows = [reqs[i] for i in live]
        b = len(live)
        r0 = rows[0]  # steps, cfg, scale and refinement are the batch's (the bucket)
        img_e = torch.cat([pipe._tensor(llm_outs[i][0]).reshape(1, -1) for i in live])
        base_e = torch.cat([pipe._tensor(llm_outs[i][1]).reshape(1, -1) for i in live])
        captions = [llm_outs[i][2] for i in live]

        # ---- the prior: one batched no-diffusion refinement
        with pipe._stage("serve_prior"):
            th, tm = pipe._encode_prior_text("")
            src = img_e / (torch.linalg.vector_norm(img_e, dim=-1, keepdim=True) + 1e-9) * 100.0
            y = prior_lib.generate_diffusion(
                pipe.models["prior"], c.prior, prior_lib.MODALITY.VIDEO, prior_lib.MODALITY.IMAGE,
                src, th.expand(b, -1, -1), tm.expand(b, -1), guidance_scale=10.0, score=6.5,
                no_diffusion=True,
            )[:, 0].float()

        # ---- the batched prompt encode
        with pipe._stage("serve_prompt_encode"):
            prompts = ["best quality, high quality" + cap for cap in captions]
            ids1 = torch.cat([pipe._clip_ids(pipe.clip_tok1, p, c.text1.max_positions,
                                             c.text1.eos_token_id) for p in prompts])
            ids2 = torch.cat([pipe._clip_ids(pipe.clip_tok2, p, c.text2.max_positions,
                                             c.text2.eos_token_id) for p in prompts])
            ctx_p, pooled_p = pipe._encode_sdxl_ids(ids1, ids2)
            ctx_null, pooled_null = pipe._encode_sdxl_prompt("")
            ctx_nb, pooled_nb = ctx_null.expand(b, -1, -1), pooled_null.expand(b, -1)
        tid = sampler_lib.default_time_ids(c.image_size, c.image_size, b, dev)
        hl = pipe._latent_size()

        # ---- VAE encode and DDIM inversion of the base images
        with pipe._stage("serve_vae_encode"):
            x = torch.as_tensor(np.stack([image_io.to_model_range(pipe.load_base_img(llm_outs[i][3]))
                                          for i in live]), device=dev)
            src_lat = vae_lib.encode(pipe.models["vae"], x, self._rows(rows, "vae_noise", (hl, hl, 4)),
                                     c.vae).float()
        with pipe._stage("serve_inversion"):
            lat_inv = sampler_lib.ddim_invert(
                pipe.models["unet"], c.unet, pipe.schedule, src_lat, ctx_nb, pooled_nb, tid,
                num_inference_steps=r0.num_inference_steps)

        # ---- the conditioning mix (h0·base + h1·llm + h2·20·ŷ, renormed per
        # row), polar noise and the IP-Adapter projection, vectorized over rows
        h = torch.tensor([list(r.h) for r in rows], dtype=torch.float32, device=dev)
        norm = torch.tensor([r.norm for r in rows], dtype=torch.float32, device=dev)[:, None]
        alpha = torch.tensor([r.alpha for r in rows], dtype=torch.float32, device=dev)
        yn = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-9)
        la = h[:, 0:1] * base_e + h[:, 1:2] * img_e + h[:, 2:3] * 20.0 * yn
        la = la / (torch.linalg.vector_norm(la, dim=-1, keepdim=True) + 1e-9) * norm
        noise = self._rows(rows, "polar_noise", tuple(lat_inv.shape[1:]))
        a = alpha.view(-1, 1, 1, 1)
        xf, nf = lat_inv.float(), noise.float()
        mixed = a * xf + (1 - a) * nf

        def rnorm(t):  # one norm per row
            return torch.linalg.vector_norm(t.flatten(1), dim=1).view(-1, 1, 1, 1)

        lat2 = (mixed / (rnorm(mixed) + 1e-9) * (a * rnorm(xf) + (1 - a) * rnorm(nf))).to(lat_inv.dtype)
        ip_c, ip_u = ipa.get_image_embeds(pipe.models["image_proj"], c.image_proj,
                                          clip_image_embeds=la, mode="global")

        # ---- the CFG IP-Adapter denoise and the VAE decode
        with pipe._stage("serve_denoise"):
            lats = self.denoiser.denoise(lat2, ctx_p, ctx_nb, pooled_p, pooled_nb, tid,
                                         r0.num_inference_steps, r0.cfg, ip_c, ip_u, r0.scale)
        with pipe._stage("serve_vae_decode"):
            dec = vae_lib.decode(pipe.models["vae"], lats, c.vae)

        # ---- the refiner: one batched img2img on its 50-step grid
        if r0.refinement > 0:
            with pipe._stage("serve_refiner_prompt_encode"):
                rprompts = [cap + ",high quality,well-formed,award-winning" for cap in captions]
                rids = torch.cat([pipe._clip_ids(pipe.clip_tok2, p, c.text2.max_positions,
                                                 c.text2.eos_token_id) for p in rprompts])
                o2 = clip_lib.text_apply(pipe.models["text2"], rids, c.text2)
                o2n = clip_lib.text_apply(
                    pipe.models["text2"],
                    pipe._clip_ids(pipe.clip_tok2, "", c.text2.max_positions, c.text2.eos_token_id),
                    c.text2)
            rtid = torch.tensor([[c.image_size, c.image_size, 0, 0, 6.0]], device=dev).repeat(b, 1)
            rtid_u = torch.tensor([[c.image_size, c.image_size, 0, 0, 2.5]], device=dev).repeat(b, 1)
            with pipe._stage("serve_refiner_vae_encode"):
                # the uint8 round trip of the single-request path (its
                # non-refined image is uint8): floor, as numpy's cast truncates
                d8 = torch.floor(torch.clamp((dec.float() + 1.0) * 127.5, 0, 255)) / 127.5 - 1.0
                rlat = vae_lib.encode(pipe.models["vae"], d8,
                                      self._rows(rows, "refiner_vae_noise", (hl, hl, 4)),
                                      c.vae).float()
            with pipe._stage("serve_refiner"):
                rlat = i2i.img2img(
                    pipe.models["refiner"], c.refiner, pipe.schedule, rlat,
                    o2["hidden_states"][-2], o2n["hidden_states"][-2].expand(b, -1, -1),
                    o2.get("text_embeds", o2["pooled"]),
                    o2n.get("text_embeds", o2n["pooled"]).expand(b, -1), rtid,
                    num_inference_steps=pipeline_mod.REFINER_NUM_STEPS, strength=r0.refinement,
                    guidance_scale=5.0, time_ids_uncond=rtid_u,
                    noise=self._rows(rows, "refiner_noise", tuple(rlat.shape[1:])),
                )
            with pipe._stage("serve_refiner_vae_decode"):
                dec = vae_lib.decode(pipe.models["vae"], rlat, c.vae)

        out = dec.float().cpu().numpy()
        for j, i in enumerate(live):
            results[i] = PipelineResult(image_io.from_model_range(out[j]), captions[j])
        return results
