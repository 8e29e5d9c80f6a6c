"""The plain reference of one edit's diffusion side, in float32.

It computes the edit as the reference project does once the LLM has
answered: the prior's refinement of the LLM's image embedding, the
conditioning mix, the VAE encode of the base image, the DDIM inversion,
the polar mix with noise, the IP-Adapter projection, the CFG IP denoise,
the VAE decode and the SDXL refiner's img2img on its 50-step grid. Every
random draw is handed in. Token ids come from the byte-level tokenizer
that the measured program falls back to when no vocabulary is on disk
(bos 1, bytes from 3, the CLIP end token appended), and are worked out
here again from the caption.

`edit` runs the whole edit and keeps its `Trail`: every DDIM step of the
three loops and both images. `follow` judges a trail, the program's or
the control's, step by step: each step is computed again from the state
the trail says it started from, with the reference's own conditioning, so
a rounding difference is measured where it is made and not as CFG at 10
amplifies it over the following steps. What joins the steps is checked
too: each loop's start against the reference's own (the VAE encode of the
base image, the polar mix of the trail's inverted latent, the refiner's
encode and noising of the trail's non-refined image), each step's start
against the step before's end, and each image against the reference's
decode of the loop's last state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import clip as clip_lib
from . import image_io
from . import ip_adapter as ipa
from . import prior as prior_lib
from . import sampler as sampler_lib
from . import unet as unet_lib
from . import vae as vae_lib
from .schedulers import Schedule, SchedulerConfig

REFINER_NUM_STEPS = 50  # the refiner's fixed grid, which `refinement` slices
QUALITY_PREFIX = "best quality, high quality"
REFINER_SUFFIX = ",high quality,well-formed,award-winning"
BOS, BYTE_OFFSET = 1, 3


def byte_ids(text: str, length: int, eos: Optional[int]) -> np.ndarray:
    """(1, length) ids: bos, the UTF-8 bytes, the end token when there is
    room, zero padding."""
    ids = ([BOS] + [BYTE_OFFSET + b for b in text.encode()])[:length]
    if eos is not None and ids[-1] != eos and len(ids) < length:
        ids.append(eos)
    return np.asarray([ids + [0] * (length - len(ids))], np.int64)


@dataclasses.dataclass
class EditModels:
    """The reference modules (float32) and their configurations."""

    unet: unet_lib.UNet
    refiner: unet_lib.UNet
    vae: vae_lib.VAE
    text1: clip_lib.CLIPText
    text2: clip_lib.CLIPText
    prior_text: clip_lib.CLIPText
    prior: prior_lib.Prior
    image_proj: ipa.ImageProj
    cfg: Dict  # component → its configuration dataclass; "image_size" → int


@dataclasses.dataclass
class EditInputs:
    """One request as both sides receive it. Noise arrays are (h, h, 4)."""

    caption: str
    image_embeds: np.ndarray  # (D,) the LLM's image embedding
    base_embed: np.ndarray  # (D,) the base image's embedding
    base_image: np.ndarray  # (H, W, 3) float32 in [0, 255], cropped to the edit's size
    vae_noise: np.ndarray
    polar_noise: np.ndarray
    refiner_vae_noise: np.ndarray
    refiner_noise: np.ndarray
    alpha: float = 0.7
    h: Sequence[float] = (0.0, 0.4, 1.0)
    norm: float = 20.0
    steps: int = 25
    cfg: float = 10.0
    scale: float = 1.0
    refinement: float = 0.5


def _ids(m: EditModels, name: str, text: str, dev) -> torch.Tensor:
    c = m.cfg[name]
    return torch.as_tensor(byte_ids(text, c.max_positions, c.eos_token_id), device=dev)


def _sdxl_prompt(m: EditModels, text: str, dev):
    o1 = clip_lib.text_apply(m.text1, _ids(m, "text1", text, dev), m.cfg["text1"])
    o2 = clip_lib.text_apply(m.text2, _ids(m, "text2", text, dev), m.cfg["text2"])
    return sampler_lib.sdxl_prompt_embeds(o1, o2)


def _prior_text(m: EditModels, dev):
    """CLIP-ViT-H last hidden state of the empty prompt and its mask (the
    tokens up to the first end token)."""
    c = m.cfg["prior_text"]
    ids = byte_ids("", m.cfg["prior"].text_len, c.eos_token_id)
    hidden = clip_lib.text_apply(m.prior_text, torch.as_tensor(ids, device=dev), c)["last_hidden_state"]
    n = int(np.nonzero(ids[0] == c.eos_token_id)[0][0]) + 1
    mask = (np.arange(ids.shape[1]) < n).astype(np.float32)[None]
    return hidden, torch.as_tensor(mask, device=dev)


Step = Tuple[int, int, torch.Tensor, torch.Tensor]  # (t from, t to, state in, state out)
LOOPS = ("inversion", "denoise", "refiner")


@dataclasses.dataclass
class Trail:
    """What one edit went through: each DDIM step of each loop, as (t from,
    t to, state in, state out) with float32 states (1, h, w, 4), and the
    two images, (H, W, 3) uint8."""

    inversion: List[Step]
    denoise: List[Step]
    refiner: List[Step]
    non_refined: np.ndarray
    refined: np.ndarray


def _t(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _decode(m: EditModels, lat: torch.Tensor) -> np.ndarray:
    return image_io.from_model_range(vae_lib.decode(m.vae, lat, m.cfg["vae"])[0].float().cpu().numpy())


def _encode(m: EditModels, img: np.ndarray, noise: np.ndarray, dev) -> torch.Tensor:
    px = _t(image_io.to_model_range(img)[None], dev)
    return vae_lib.encode(m.vae, px, _t(noise, dev)[None], m.cfg["vae"]).float()


class _Edit:
    """One request's conditioning, timesteps and single steps."""

    def __init__(self, m: EditModels, x: EditInputs, dev):
        self.m, self.x, self.dev = m, x, dev
        size = m.cfg["image_size"]
        self.sched = Schedule.create(SchedulerConfig(), dev)
        img_e = _t(x.image_embeds, dev).reshape(1, -1)
        base_e = _t(x.base_embed, dev).reshape(1, -1)
        th, tm = _prior_text(m, dev)
        src = img_e / (torch.linalg.vector_norm(img_e) + 1e-9) * 100.0
        y = prior_lib.generate_diffusion(
            m.prior, m.cfg["prior"], prior_lib.MODALITY.VIDEO, prior_lib.MODALITY.IMAGE, src, th,
            tm, guidance_scale=10.0, score=6.5)[:, 0].float()
        latent_la = sampler_lib.mix_latents(base_e, img_e, y / (torch.linalg.vector_norm(y) + 1e-9),
                                            tuple(x.h), x.norm)
        ctx_null, pooled_null = _sdxl_prompt(m, "", dev)
        ctx_p, pooled_p = _sdxl_prompt(m, QUALITY_PREFIX + x.caption, dev)
        tid = sampler_lib.default_time_ids(size, size, 1, dev)
        ip_c, ip_u = ipa.get_image_embeds(m.image_proj, m.cfg["image_proj"], latent_la)
        ucfg = m.cfg["unet"]
        self.eps = {
            "inversion": sampler_lib.make_cfg_eps_fn(m.unet, ucfg, ctx_null, None, pooled_null,
                                                     None, tid, guidance_scale=1.0),
            "denoise": sampler_lib.make_cfg_eps_fn(
                m.unet, ucfg, ctx_p, ctx_null, pooled_p, pooled_null, tid, x.cfg, ip_c, ip_u,
                x.scale, ip_step_window=(0, x.steps)),
        }
        ts = [int(t) for t in self.sched.timesteps(x.steps)]
        up = ts[::-1]
        self.pairs = {"inversion": list(zip([-1] + up[:-1], up)),
                      "denoise": list(zip(ts, ts[1:] + [-1])), "refiner": []}
        if x.refinement > 0:
            c2 = m.cfg["text2"]
            o2 = clip_lib.text_apply(m.text2, _ids(m, "text2", x.caption + REFINER_SUFFIX, dev), c2)
            o2n = clip_lib.text_apply(m.text2, _ids(m, "text2", "", dev), c2)
            rtid = torch.tensor([[size, size, 0, 0, 6.0]], device=dev)
            rtid_u = torch.tensor([[size, size, 0, 0, 2.5]], device=dev)
            self.eps["refiner"] = sampler_lib.make_cfg_eps_fn(
                m.refiner, m.cfg["refiner"], o2["hidden_states"][-2], o2n["hidden_states"][-2],
                o2.get("text_embeds", o2["pooled"]), o2n.get("text_embeds", o2n["pooled"]), rtid,
                guidance_scale=5.0, time_ids_uncond=rtid_u)
            rts, _ = sampler_lib.img2img_timesteps(self.sched, REFINER_NUM_STEPS, x.refinement)
            rts = [int(t) for t in rts]
            self.pairs["refiner"] = list(zip(rts, rts[1:] + [-1]))

    def step(self, loop: str, i: int, lat: torch.Tensor) -> torch.Tensor:
        a, b = self.pairs[loop][i]
        fn = sampler_lib.ddim_invert_step if loop == "inversion" else sampler_lib.ddim_step
        return fn(self.eps[loop], self.sched, lat, a, b, i)

    def start(self, loop: str, trail: Trail):
        """(the loop's first state as the reference makes it, from the
        inputs and, past the first loop, from what the trail handed on;
        the VAE encode inside it, or None; that encode's factor in it)."""
        x, dev = self.x, self.dev
        if loop == "inversion":
            lat = _encode(self.m, x.base_image, x.vae_noise, dev)
            return lat, lat, 1.0
        if loop == "denoise":
            inv = trail.inversion[-1][3].to(dev).float()
            return sampler_lib.polar_interpolate(inv, _t(x.polar_noise, dev)[None], x.alpha), None, None
        rlat = _encode(self.m, trail.non_refined, x.refiner_vae_noise, dev)
        t0 = torch.full((1,), self.pairs["refiner"][0][0])
        a0 = float(self.sched.alpha_bar(t0)[0])
        return self.sched.add_noise(rlat, _t(x.refiner_noise, dev)[None], t0), rlat, a0 ** 0.5


@torch.inference_mode()
def edit(m: EditModels, x: EditInputs, device) -> Trail:
    """The whole edit, with its trail."""
    dev = torch.device(device)
    e = _Edit(m, x, dev)
    logs: Dict[str, List[Step]] = {loop: [] for loop in LOOPS}
    trail = Trail(logs["inversion"], logs["denoise"], logs["refiner"], None, None)
    for loop in LOOPS:
        if not e.pairs[loop]:
            continue
        lat = e.start(loop, trail)[0]
        for i, (a, b) in enumerate(e.pairs[loop]):
            out = e.step(loop, i, lat)
            logs[loop].append((a, b, lat, out))
            lat = out
        image = _decode(m, lat)
        if loop == "denoise":
            trail.non_refined = trail.refined = image
        elif loop == "refiner":
            trail.refined = image
    return trail


def _sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum((a.double() - b.double()) ** 2)


def _mad(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@torch.inference_mode()
def follow(m: EditModels, x: EditInputs, trail: Trail, device,
           detail: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """The trail's gaps from the reference: its VAE encodes, its three
    loops step by step, its decodes.

    "encode": the worse of the two loops that start from a VAE encode (the
    inversion, from the base image; the refiner, from the non-refined
    image, noised), the distance from the trail's first state to the
    reference's over the norm of the reference's encoded latent in it.
    "steps": the worst loop's sqrt(Σ gap² / Σ move²) over its steps, each
    gap the distance from the trail's end of a step to the reference's
    step from the trail's start of it (and from the trail's start of it to
    the end of the step before, or, for the denoise, to the reference's
    polar mix of the trail's inverted latent), each move the distance the
    reference's step goes; a loop that takes other timesteps than the
    reference's reads inf. "decode": the worse of the two images' mean
    absolute difference, in 8-bit levels, from the reference's decode of
    the trail's last latent of their loop. `detail` gets each loop's
    number and its worst single step, as its gap over its move."""
    dev = torch.device(device)
    e = _Edit(m, x, dev)
    out: Dict[str, float] = {}
    images = {"denoise": trail.non_refined, "refiner": trail.refined}
    loops: Dict[str, float] = {}
    encode_gaps, decode_gaps = [], []
    for loop in LOOPS:
        want, steps = e.pairs[loop], getattr(trail, loop)
        if not want:
            continue
        if [(a, b) for a, b, _, _ in steps] != want:
            loops[loop] = float("inf")
            continue
        prev, enc, factor = e.start(loop, trail)
        if enc is not None:
            first = steps[0][2].to(dev).float()
            encode_gaps.append(float(torch.sqrt(_sq(first, prev))
                                     / (factor * torch.linalg.vector_norm(enc.double()))))
            prev = first
        gap2 = torch.zeros((), dtype=torch.float64, device=dev)
        move2 = torch.zeros_like(gap2)
        worst = 0.0
        for i, (_, _, s_in, s_out) in enumerate(steps):
            s_in, s_out = s_in.to(dev).float(), s_out.to(dev).float()
            ref = e.step(loop, i, s_in)
            g2 = _sq(s_in, prev) + _sq(s_out, ref)
            mv2 = _sq(ref, s_in)
            gap2, move2 = gap2 + g2, move2 + mv2
            worst = max(worst, float(torch.sqrt(g2 / mv2.clamp_min(1e-30))))
            prev = s_out
        loops[loop] = float(torch.sqrt(gap2 / move2.clamp_min(1e-30)))
        if detail is not None:
            detail[loop] = loops[loop]
            detail[f"{loop}_worst_step"] = worst
        if loop in images:
            decode_gaps.append(_mad(images[loop], _decode(m, prev)))
    if encode_gaps:
        out["encode"] = max(encode_gaps)
    if loops:
        out["steps"] = max(loops.values())
    if decode_gaps:
        out["decode"] = max(decode_gaps)
    return out
