"""The edit (`InstructAny2PixPipeline.__call__` and `PipelineServer`,
with each request's given LLM answer): its reference dataclasses, its
traffic (`traffic.Traffic`), its program built from weights drawn in the
published layout (`weights.MODULE_ORDER`, `port.build_pipeline`), its
model FLOPs per unit (`flops.edit`), and what `correct.check` judges.

The numbers compared, each the worst over the sample: "encode", the gap
of the VAE encodes that start the inversion and the refiner; "steps", the
worst loop's step gaps from the reference's over the distance the
reference's steps move; "decode", an image's mean absolute difference
from the reference's decode of its loop's last latent, in 8-bit levels.
The program's trail of a sampled request, every DDIM step its three loops
took (`port.StepLog`) and its two images, is followed by
`reference.edit.follow` step by step.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict

import numpy as np
import torch

from portbench import configs, correct, flops, port, weights
from portbench.reference import edit as ref_edit
from portbench.reference import image_io as ref_io
from portbench.traffic import Traffic


def cfgs(cfg_json: dict) -> Dict[str, object]:
    return configs.reference_cfgs(cfg_json)


def traffic(run) -> Traffic:
    c = run.cfgs
    return Traffic(run.wl, run.seed, c["prior"].imagebind_dim, c["image_size"],
                   configs.latent_side(c), os.path.join(run.tmpdir, "images"))


def build(run):
    published = weights.draw_all(weights.MODULE_ORDER, run.cfgs, run.seed, run.device,
                                 run.cfgs["dtype"])
    run.pipe = port.build_pipeline(run.cfg_json, published, run.device,
                                   os.path.join(run.tmpdir, "no-checkpoints"))
    del published
    correct.free_cuda()


def unit_flops(run, unit) -> float:
    return sum(flops.edit(run.cfgs, unit["rows"], run.wl["steps"], run.wl["refinement"]).values())


def single_call(run, req, steps: int, refinement: float) -> dict:
    """One `__call__` (the `single` driver's unit) → its two images."""
    non_refined, refined = port.single_edit(run.pipe, req, steps, run.wl["cfg"], refinement,
                                            run.wl["scale"])
    return {"non_refined": non_refined, "refined": refined}


def sample_key(req) -> int:
    """The sample's first request is the one with the longest caption."""
    return len(req.caption)


def trail(outs: dict) -> ref_edit.Trail:
    """A program's answer as the reference reads it: row `outs["row"]` of
    its unit's steps (`port.StepLog`), on the host, and its images."""
    row = outs["row"]
    inv, fwd = [], []
    for kind, a, b, s_in, s_out in outs["steps"]:
        step = (a, b, s_in[row:row + 1].float().cpu(), s_out[row:row + 1].float().cpu())
        (inv if kind == "inv" else fwd).append(step)
    cut = next((i + 1 for i, s in enumerate(fwd) if s[1] < 0), len(fwd))

    def host(img):
        return img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)

    return ref_edit.Trail(inv, fwd[:cut], fwd[cut:], host(outs["non_refined"]),
                          host(outs["refined"]))


def inputs(req, wl: dict, image_size: int) -> ref_edit.EditInputs:
    """The reference's inputs for a request: the same given answer, the
    same draws and the same base image file, which it loads itself."""
    return ref_edit.EditInputs(
        caption=req.caption, image_embeds=req.image_embeds, base_embed=req.base_embed,
        base_image=ref_io.resize_and_crop(req.base_path, image_size),
        vae_noise=req.vae_noise, polar_noise=req.polar_noise,
        refiner_vae_noise=req.refiner_vae_noise, refiner_noise=req.refiner_noise,
        alpha=req.alpha, h=tuple(req.h), norm=req.norm, steps=wl["steps"], cfg=wl["cfg"],
        scale=wl["scale"], refinement=wl["refinement"])


def reference_models(cfgs, seed: int, device) -> ref_edit.EditModels:
    mods = {name: weights.reference_module(name, cfgs, seed, device)
            for name in weights.MODULE_ORDER}
    return ref_edit.EditModels(cfg=cfgs, **mods)


def worst_of(chosen, models, wl: dict, image_size: int, device) -> Dict[str, float]:
    """The worst of each number over the chosen (request, trail) pairs."""
    worst: Dict[str, float] = {}
    for req, tr in chosen:
        detail: Dict[str, float] = {}
        nums = ref_edit.follow(models, inputs(req, wl, image_size), tr, device, detail)
        print(f"reading request {req.index}: {json.dumps(nums)} by loop {json.dumps(detail)}",
              file=sys.stderr)
        for key, v in nums.items():
            worst[key] = max(worst.get(key, 0.0), v)
    return worst


def readings(run, chosen) -> Dict[str, float]:
    models = reference_models(run.cfgs, run.seed, run.device)
    return worst_of(chosen, models, run.wl, run.cfgs["image_size"], run.device)
