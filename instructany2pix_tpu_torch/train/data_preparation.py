"""Offline ImageBind feature extraction → `.npz` feature files; the
counterpart of the JAX package's `scripts/data_preparation.py` (reference
scripts/data_preparation.py:6-25).

Walks a directory's images (`.png`, `.jpg`, `.jpeg`, `.bmp`, `.webp`) and
audio (`.wav`, `.npy` at 16 kHz), embeds each with the ImageBind encoders
and writes `<stem>.npz` holding `state`, the (1024,) float32 embedding that
`train.data.MediaMap` reads. Each file is embedded as the pipeline embeds
media (`InstructAny2PixPipeline._embed_media`): the same preprocessing, the
encoder in its own dtype, the output cast to float32 (audio: the mean over
its three clips, taken in float32).

  python -m instructany2pix_tpu_torch.train.data_preparation \\
      --input <dir> --output <dir> [--ckpt ckpts/imagebind_huge.pth] \\
      [--dtype bfloat16] [--tiny]

The encoders are ImageBind-huge booted from `--ckpt` through
`loaders.load_imagebind`. A missing checkpoint raises; random tiny
encoders (for testing) are used only when `--tiny` is given. The JAX
script falls back to them silently when the checkpoint is missing; this
module does not. It runs on the card unless `device="cpu"` is passed to
`main`.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..codecs import image_io
from ..models import imagebind as imagebind_lib

IMAGE_EXT = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
AUDIO_EXT = {".wav", ".npy"}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@torch.inference_mode()
def process_one_image(vision: imagebind_lib.ViT, cfg: imagebind_lib.ViTConfig,
                      path: str) -> np.ndarray:
    x = imagebind_lib.preprocess_vision(image_io.load_image(path), cfg.image_size or 224)
    return imagebind_lib.apply(vision, x, cfg).float()[0].cpu().numpy()


@torch.inference_mode()
def process_one_audio(audio: imagebind_lib.ViT, cfg: imagebind_lib.ViTConfig,
                      path: str) -> np.ndarray:
    from ..pipeline import _load_wav

    clips = imagebind_lib.preprocess_audio(_load_wav(path))
    emb = imagebind_lib.apply(audio, clips, cfg)
    return emb.float().mean(dim=0).cpu().numpy()


def run(input_dir: str, output_dir: str, vision: imagebind_lib.ViT,
        vision_cfg: imagebind_lib.ViTConfig, audio: imagebind_lib.ViT,
        audio_cfg: imagebind_lib.ViTConfig, log=print,
        times: Optional[List[float]] = None) -> List[str]:
    """Embed every image and audio file of `input_dir` (sorted by name;
    other files are skipped) into `output_dir/<stem>.npz`. Returns the
    files written; `times` receives each file's seconds (read, embed,
    write)."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for name in sorted(os.listdir(input_dir)):
        stem, ext = os.path.splitext(name)
        src = os.path.join(input_dir, name)
        t0 = time.perf_counter()
        if ext.lower() in IMAGE_EXT:
            state = process_one_image(vision, vision_cfg, src)
        elif ext.lower() in AUDIO_EXT:
            state = process_one_audio(audio, audio_cfg, src)
        else:
            continue
        dst = os.path.join(output_dir, stem + ".npz")
        np.savez(dst, state=state)
        if times is not None:
            times.append(time.perf_counter() - t0)
        written.append(dst)
        if log is not None:
            log(f"{src} -> {dst} ({state.shape})")
    return written


def tiny_encoders(device, dtype: torch.dtype = torch.float32, seed: int = 0) -> Dict:
    """Random tiny ImageBind vision and audio encoders drawn from `seed`."""
    from ..models import layers as L

    g = torch.Generator().manual_seed(seed)
    vcfg = imagebind_lib.ViTConfig.tiny()
    acfg = imagebind_lib.ViTConfig.tiny(in_channels=1)
    out = {"vision_cfg": vcfg, "audio_cfg": acfg}
    for key, cfg, n in (("vision", vcfg, None), ("audio", acfg, imagebind_lib.audio_patches(acfg))):
        with torch.device("meta"):
            m = imagebind_lib.ViT(cfg, num_patches=n)
        m = L.init_(L.materialize(m, torch.device("cpu"), torch.float32), g)
        out[key] = m.to(device=device, dtype=dtype).eval().requires_grad_(False)
    return out


def huge_encoders(ckpt: str, device, dtype: torch.dtype) -> Dict:
    """ImageBind-huge vision and audio booted from the reference's
    `imagebind_huge.pth`."""
    from .. import loaders

    if not os.path.isfile(ckpt):
        raise FileNotFoundError(f"no ImageBind checkpoint at {ckpt}; pass --ckpt, or --tiny for "
                                "random tiny encoders")
    vcfg = imagebind_lib.ViTConfig.imagebind_vision()
    acfg = imagebind_lib.ViTConfig.imagebind_audio()
    vision, audio = loaders.load_imagebind(ckpt, vcfg, acfg, device, dtype)
    return {"vision": vision, "vision_cfg": vcfg, "audio": audio, "audio_cfg": acfg}


def main(argv: Optional[Sequence[str]] = None, device=None,
         times: Optional[List[float]] = None) -> List[str]:
    from ..core.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--ckpt", default="ckpts/imagebind_huge.pth")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    ap.add_argument("--tiny", action="store_true", help="random tiny encoders (testing)")
    args = ap.parse_args(argv)
    device = resolve_device(device)
    dtype = _DTYPES[args.dtype]
    enc = tiny_encoders(device, dtype) if args.tiny else huge_encoders(args.ckpt, device, dtype)
    return run(args.input, args.output, enc["vision"], enc["vision_cfg"], enc["audio"],
               enc["audio_cfg"], times=times)


if __name__ == "__main__":
    main()
