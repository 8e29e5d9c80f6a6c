"""What the benchmark takes from the measured program: its pipeline built
from the benchmark's weights, its batched server with the LLM stage
answered from each request's given answer, its schedule's DDIM steps (so
the comparison can follow each one), and its kernels' launch entry points
(so a traced run can record each call's shapes).

Everything here imports the program lazily, inside the functions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from . import configs

PROGRAM = "instructany2pix_tpu_torch"


def program_cfgs(cfg_json: dict):
    """The configuration file as the program's dataclasses."""
    from instructany2pix_tpu_torch.diffusion import ip_adapter as ipa
    from instructany2pix_tpu_torch.models import clip, gpt2, unet, vae
    from instructany2pix_tpu_torch.prior import model as prior

    return configs.dataclasses_of(cfg_json, unet.UNetConfig, vae.VAEConfig, clip.CLIPTextConfig,
                                  prior.PriorConfig, gpt2.GPT2Config, ipa.ImageProjConfig)


def build_pipeline(cfg_json: dict, published: Dict[str, Dict[str, torch.Tensor]], device,
                   scratch: str):
    """`InstructAny2PixPipeline` over modules loaded from `published`
    (file → {published key: tensor}) through the program's own key maps
    and `loaders.build`, as its checkpoint boot loads them. `scratch` is a
    directory with no checkpoints, so the tokenizers fall back to bytes."""
    from instructany2pix_tpu_torch import loaders
    from instructany2pix_tpu_torch.diffusion import ip_adapter as ipa
    from instructany2pix_tpu_torch.models import clip, unet, unet_convert, vae
    from instructany2pix_tpu_torch.pipeline import InstructAny2PixPipeline, PipelineConfig
    from instructany2pix_tpu_torch.prior import model as prior

    c = program_cfgs(cfg_json)
    dt = configs.torch_dtype(cfg_json)

    def build(make, tensors, what):
        return loaders.build(make, tensors, device, dt, what)

    ip_km = (ipa.ip_attn_keymap(unet_convert.cross_attn_paths(c["unet"]))
             + ipa.image_proj_keymap().prefixed(port="image_proj."))
    mapped = ip_km.to_port(published.pop("ip_adapter"), what="ip_adapter")
    proj = {n[len("image_proj."):]: t for n, t in mapped.items() if n.startswith("image_proj.")}
    unet_t = unet_convert.unet_keymap().to_port(published.pop("unet"), what="unet")
    unet_t.update({n: t for n, t in mapped.items() if not n.startswith("image_proj.")})
    text = clip.text_keymap()
    models = {
        "unet": build(lambda: unet.UNet(c["unet"]), unet_t, "unet"),
        "image_proj": build(lambda: ipa.ImageProj(c["image_proj"]), proj, "ip_adapter"),
    }
    del unet_t, proj, mapped
    for name, file, make, km in (
            ("refiner", "refiner", lambda: unet.UNet(c["refiner"]), unet_convert.unet_keymap()),
            ("vae", "vae", lambda: vae.VAE(c["vae"]), unet_convert.vae_keymap()),
            ("text1", "text_encoder", lambda: clip.CLIPText(c["text1"]), text),
            ("text2", "text_encoder_2", lambda: clip.CLIPText(c["text2"]), text),
            ("prior_text", "clip-vit-h", lambda: clip.CLIPText(c["prior_text"]), text),
            ("prior", "prior", lambda: prior.Prior(c["prior"], output_proj=c["prior_output_proj"]),
             prior.keymap())):
        models[name] = build(make, km.to_port(published.pop(file), what=file), file)
    pcfg = PipelineConfig(unet=c["unet"], refiner=c["refiner"], inpaint_unet=c["unet"],
                          vae=c["vae"], text1=c["text1"], text2=c["text2"],
                          prior_text=c["prior_text"], prior=c["prior"],
                          image_proj=c["image_proj"], image_size=cfg_json["image_size"])
    return InstructAny2PixPipeline(config=pcfg, models=models, device=device, ckpt=scratch)


def answer(pipe, req) -> tuple:
    """The LLM stage's answer for a request, in the pipeline's form:
    (image_embeds, base_embed, caption, base_img_path, extra_data)."""
    return (pipe._tensor(req.image_embeds).reshape(1, -1), pipe._tensor(req.base_embed),
            req.caption, req.base_path, dict(all_objs=[], extra_embeds=[], extra_idx=[]))


def make_server(pipe, max_batch: int, max_wait_s: float, recorder):
    """A `PipelineServer` whose LLM stage returns each request's given
    answer (the request's `given`), with `recorder.start(indices)` and
    `recorder.end(token, indices, ok)` around every microbatch.

    The microbatch's non-refined images, its first VAE decode, are kept as
    the program produced them (uint8, on the device, with no sync) in
    `recorder.non_refined[index]`: the served answer carries only the
    refined image, and the comparison reads both."""
    from instructany2pix_tpu_torch import serving
    from instructany2pix_tpu_torch.models import vae as vae_lib

    decode = vae_lib.decode
    batch = {"indices": None, "decodes": 0}

    def kept_decode(*a, **kw):
        out = decode(*a, **kw)
        if batch["indices"] is not None and batch["decodes"] == 0:
            u8 = torch.floor(torch.clamp((out.float() + 1.0) * 127.5, 0, 255)).to(torch.uint8)
            recorder.non_refined.update(zip(batch["indices"], u8))
        batch["decodes"] += 1
        return out

    class GivenAnswerServer(serving.PipelineServer):
        def _llm_stage(self, reqs):
            return [answer(self.pipe, r.given) for r in reqs]

        def _run_batch(self, reqs):
            indices = [r.given.index for r in reqs]
            token, ok = recorder.start(indices), False
            batch.update(indices=indices, decodes=0)
            try:
                out = super()._run_batch(reqs)
                ok = True
                return out
            finally:
                batch["indices"] = None
                recorder.end(token, indices, ok)

        def stop(self):
            super().stop()
            if not self.scheduler._thread.is_alive():
                vae_lib.decode = decode

    vae_lib.decode = kept_decode
    return GivenAnswerServer(pipe, max_batch=max_batch, max_wait_s=max_wait_s)


def served_request(given, steps: int, cfg: float, refinement: float, scale: float):
    """A `PipelineRequest` carrying the benchmark's draws and, under
    `given`, the request's LLM answer."""
    from instructany2pix_tpu_torch import serving

    @dataclasses.dataclass
    class GivenRequest(serving.PipelineRequest):
        given: Any = None

    return GivenRequest(
        inst="", mm_data=[], alpha=given.alpha, h=tuple(given.h), norm=given.norm,
        num_inference_steps=steps, cfg=cfg, scale=scale, refinement=refinement,
        seed=given.seed, vae_noise=given.vae_noise, polar_noise=given.polar_noise,
        refiner_vae_noise=given.refiner_vae_noise, refiner_noise=given.refiner_noise,
        given=given)


def single_edit(pipe, given, steps: int, cfg: float, refinement: float, scale: float):
    """`__call__` on the request's given answer → (non_refined, refined)."""
    pipe.cache = answer(pipe, given)
    non_refined, refined, _ = pipe(
        "", [{"type": "image", "fname": given.base_path}], alpha=given.alpha, h=tuple(given.h),
        norm=given.norm, refinement=refinement, num_inference_steps=steps, use_cache=True,
        cfg=cfg, scale=scale, seed=given.seed, vae_noise=given.vae_noise[None],
        polar_noise=given.polar_noise[None], refiner_vae_noise=given.refiner_vae_noise[None],
        refiner_noise=given.refiner_noise[None])
    return non_refined, refined


class StepLog:
    """While entered, keeps each DDIM step that the program's schedule
    takes (`Schedule.ddim_step` and `ddim_inverse_step`) in `unit`, when
    that is a list: ("fwd" or "inv", t from, t to, state in, state out),
    the states as device copies taken without a sync. A driver sets
    `unit` to a new list for each unit of work."""

    def __init__(self):
        self.unit: Optional[list] = None
        self._saved: Optional[tuple] = None

    def _keep(self, kind, t_from, t_to, state_in, state_out):
        if self.unit is not None:
            self.unit.append((kind, int(t_from.reshape(-1)[0]), int(t_to.reshape(-1)[0]),
                              state_in.detach().clone(), state_out.detach().clone()))

    def __enter__(self):
        from instructany2pix_tpu_torch.diffusion import schedulers

        cls = schedulers.Schedule
        fwd, inv = cls.ddim_step, cls.ddim_inverse_step
        keep = self._keep

        def ddim_step(sched, model_out, t, t_prev, sample, *a, **kw):
            out = fwd(sched, model_out, t, t_prev, sample, *a, **kw)
            keep("fwd", t, t_prev, sample, out)
            return out

        def ddim_inverse_step(sched, model_out, t, t_next, sample):
            out = inv(sched, model_out, t, t_next, sample)
            keep("inv", t, t_next, sample, out)
            return out

        self._saved = (fwd, inv)
        cls.ddim_step, cls.ddim_inverse_step = ddim_step, ddim_inverse_step
        return self

    def __exit__(self, *exc):
        from instructany2pix_tpu_torch.diffusion import schedulers

        schedulers.Schedule.ddim_step, schedulers.Schedule.ddim_inverse_step = self._saved
        return False


class KernelCalls:
    """While entered, records the shapes of every K1 and K3 launch
    (`ops/flash_attention.py`'s launch entry points): ("k1", q shape,
    k shape, causal) and ("k3", q shape)."""

    def __init__(self):
        self.calls: List[tuple] = []
        self._saved: Optional[tuple] = None

    def __enter__(self):
        from instructany2pix_tpu_torch.ops import flash_attention as fa

        fwd, rel = fa.flash_fwd_cuda, fa.flash_relpos2d_cuda
        calls = self.calls

        def k1(q, k, v, causal, scale, *a, **kw):
            calls.append(("k1", tuple(q.shape), tuple(k.shape), bool(causal), str(q.dtype)))
            return fwd(q, k, v, causal, scale, *a, **kw)

        def k3(q, k, v, bh, bw, scale):
            calls.append(("k3", tuple(q.shape), tuple(k.shape), False, str(q.dtype)))
            return rel(q, k, v, bh, bw, scale)

        # the program counts launches on its entry points' attributes
        k1.__dict__, k3.__dict__ = fwd.__dict__, rel.__dict__
        self._saved = (fwd, rel)
        fa.flash_fwd_cuda, fa.flash_relpos2d_cuda = k1, k3
        return self

    def __exit__(self, *exc):
        from instructany2pix_tpu_torch.ops import flash_attention as fa

        fa.flash_fwd_cuda, fa.flash_relpos2d_cuda = self._saved
        return False
