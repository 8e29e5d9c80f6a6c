"""What decides `correct`: once the window has closed and the program's
state is freed, a sample of the answered requests, drawn from the seed
with the longest caption in it, is judged by the float32 reference
(TF32 off) from the same inputs.

The program's trail of each sampled request, every DDIM step its three
loops took (kept on the device during the window by `port.StepLog`) and
its two images, is followed by `reference.edit.follow` step by step.
The numbers compared, each the worst over the sample and each held
against the cell's limit (its workload file's "limits"): "encode", the
gap of the VAE encodes that start the inversion and the refiner; "steps",
the worst loop's step gaps from the reference's over the distance the
reference's steps move; "decode", an image's mean absolute difference
from the reference's decode of its loop's last latent, in 8-bit levels.
The limits and the readings they were set from are in PERF.md.
"""

from __future__ import annotations

import gc
import json
import random
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import weights
from .reference import edit as ref_edit
from .reference import image_io as ref_io


def sample(answered: List[Tuple], seed: int, k: int) -> List[Tuple]:
    """`k` answered requests drawn from the seed, the one with the longest
    caption first."""
    if not answered:
        return []
    longest = max(range(len(answered)), key=lambda i: (len(answered[i][0].caption), -i))
    rest = [i for i in range(len(answered)) if i != longest]
    picked = [longest] + random.Random(int(seed)).sample(rest, min(k - 1, len(rest)))
    return [answered[i] for i in picked]


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


def readings(chosen, models, wl: dict, image_size: int, device) -> Dict[str, float]:
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


def judge(worst: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """(within every limit, {number: {"value", "limit"}}); a number that was
    not read counts as inf."""
    checks = {key: {"value": worst.get(key, float("inf")), "limit": lim}
              for key, lim in sorted(limits.items())}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def free_cuda():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(run, outcome) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {number: {"value", "limit"}}) for the run."""
    wl = run.wl
    chosen = [(req, trail(outs))
              for req, outs in sample(outcome["answered"], run.seed, wl["compare"])]
    outcome["answered"] = None
    for unit in outcome["units"]:
        unit.pop("steps", None)
    run.free_program()
    free_cuda()
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    models = reference_models(run.cfgs, run.seed, run.device)
    worst = readings(chosen, models, wl, run.cfgs["image_size"], run.device)
    del models
    free_cuda()
    within, checks = judge(worst, wl["limits"])
    return bool(chosen) and outcome["failed"] == 0 and within, checks
