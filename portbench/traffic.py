"""The one traffic generator: request `i` of a run is drawn from the run's
seed and `i` alone, by the parameters of the cell's workload file, so a
seed gives the same requests in the same order and two seeds give two
sets of requests with the same sizes.

Each request carries what the LLM stage would have answered (a caption,
the 1024-d image embedding, the base image's embedding and the base image,
written as a 1024² PNG under the temporary directory) and every noise
draw of the edit, so the program and the reference receive the same
inputs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

WORDS = (
    "a red fox in the snow, a quiet harbour at dawn, an old stone bridge over a river, "
    "a cat asleep on a windowsill, neon signs in the rain, a field of sunflowers, "
    "a lighthouse on a cliff, a bowl of ripe cherries, a street market at noon, "
    "watercolor, oil painting, photograph, soft light, golden hour, wide angle, "
    "misty mountains, a wooden cabin, autumn leaves, a sailing boat, city skyline"
).replace(",", " ,").split()


@dataclasses.dataclass
class Request:
    index: int
    seed: int  # the request's own seed
    caption: str
    image_embeds: np.ndarray  # (D,)
    base_embed: np.ndarray  # (D,)
    base_path: str
    vae_noise: np.ndarray  # (h, h, 4) each
    polar_noise: np.ndarray
    refiner_vae_noise: np.ndarray
    refiner_noise: np.ndarray
    alpha: float
    h: Sequence[float]
    norm: float


def _rng(seed: int, index: int, site: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(seed) % 2**64, index,
                                                                        site])))


def caption(rng: np.random.Generator, lo: int, hi: int) -> str:
    """Words until the caption holds a drawn number of bytes in [lo, hi]
    (the byte-level tokenizer's tokens), cut at that length."""
    n = int(rng.integers(lo, hi + 1))
    words = []
    while len(" ".join(words)) < n:
        words.append(WORDS[int(rng.integers(len(WORDS)))])
    return " ".join(words)[:n].strip() or WORDS[0]


def base_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """A smooth seeded picture: an 8×8 colour field upsampled bilinearly,
    with fine grain, (size, size, 3) uint8."""
    coarse = rng.uniform(0, 255, (8, 8, 3)).astype(np.float32)
    pos = (np.arange(size) + 0.5) * 8 / size - 0.5
    i0 = np.clip(np.floor(pos).astype(int), 0, 7)
    i1 = np.clip(i0 + 1, 0, 7)
    w = np.clip(pos - i0, 0, 1)
    rows = coarse[i0] * (1 - w)[:, None, None] + coarse[i1] * w[:, None, None]
    img = rows[:, i0] * (1 - w)[None, :, None] + rows[:, i1] * w[None, :, None]
    img += rng.normal(0, 6, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_image(path_stem: str, img: np.ndarray) -> str:
    """A PNG where PIL is installed (the program's loader reads it through
    PIL), else the `.npy` that its loader falls back to."""
    try:
        from PIL import Image
    except ImportError:
        np.save(path_stem + ".npy", img)
        return path_stem + ".npy"
    Image.fromarray(img).save(path_stem + ".png", compress_level=1)
    return path_stem + ".png"


class Traffic:
    """Requests of one run. `wl` is the workload file's parameters,
    `embed_dim` the LLM embedding's width, `image_size` the edit's and
    `latent_side` its latent's."""

    def __init__(self, wl: dict, seed: int, embed_dim: int, image_size: int, latent_side: int,
                 image_dir: str):
        self.wl, self.seed = wl, int(seed)
        self.embed_dim, self.image_size, self.latent_side = embed_dim, image_size, latent_side
        self.image_dir = image_dir
        os.makedirs(image_dir, exist_ok=True)

    def request(self, index: int) -> Request:
        rng = _rng(self.seed, index, 0)
        lo, hi = self.wl["caption_bytes"]
        cap = caption(rng, lo, hi)
        d, hl = self.embed_dim, self.latent_side
        img_e = rng.standard_normal(d).astype(np.float32)
        base_e = rng.standard_normal(d).astype(np.float32)
        base_e *= self.wl["norm"] / (np.linalg.norm(base_e) + 1e-9)
        noise = [rng.standard_normal((hl, hl, 4)).astype(np.float32) for _ in range(4)]
        path = write_image(os.path.join(self.image_dir, f"base-{index:05d}"),
                           base_image(_rng(self.seed, index, 1), self.image_size))
        return Request(index=index, seed=int(rng.integers(2**31)), caption=cap, image_embeds=img_e,
                       base_embed=base_e, base_path=path, vae_noise=noise[0],
                       polar_noise=noise[1], refiner_vae_noise=noise[2], refiner_noise=noise[3],
                       alpha=float(self.wl["alpha"]), h=tuple(self.wl["h"]),
                       norm=float(self.wl["norm"]))
