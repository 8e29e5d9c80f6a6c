"""Training launcher, the counterpart of the JAX package's `scripts/train.py`:

  python -m instructany2pix_tpu_torch.train.launch --data data.json \
      --media-map map.json --media-root feats/ [--tiny] [--steps N] ...

Same flags as the JAX launcher but `--scan-layers` (a JAX compile
artefact). Under `torchrun` (WORLD_SIZE > 1) or with `--n-model` the
process group starts from `env://` and the trainer runs on an
(n_data, n_model) mesh: FSDP over every rank, the batch over "data"
(`train_step.py`); logs, previews and checkpoints come from rank 0, and a
checkpoint gathers the whole state, so it is the one-process trainer's
file and `--resume` reads it at any mesh. `main(argv)`
parses the flags into a call of `train(cfg, train_cfg, dataset, ...)`, which
loops: length-grouped batches → `collate` → `train_step` → metrics every
`log_steps`, a generation preview (src|gen embedding heatmaps) every
`preview_steps`, and a checkpoint (`<ckpt_dir>/latest.pt`) every
`save_steps` and at the end; `resume` continues from that checkpoint's step
count. It runs on the GPU unless the caller passes `device="cpu"`, and
raises without one. Parameters are float32, as the JAX launcher's init
makes them; `train(params=...)` takes a model in another dtype (the
moments follow it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import checkpoint as ckpt_lib
from ..core import mesh as mesh_lib
from ..core.device import resolve_device
from ..llm import multimodal as mm
from ..llm.tokenizer import initialize_vision_tokenizer, load_tokenizer
from . import data as data_lib
from .train_step import (TrainConfig, full_state, make_preview_step, make_train_step,
                         restore_state)
from ..utils.logging import MetricLogger, embedding_heatmap


def checkpoint_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "latest.pt")


def train(
    cfg: mm.Any2PixLMConfig,
    train_cfg: TrainConfig,
    dataset: data_lib.InstructionDataset,
    *,
    batch_size: int = 4,
    ckpt_dir: str = "checkpoints",
    save_steps: int = 500,
    log_steps: int = 10,
    preview_steps: int = 50,
    preview_dir: str = "train_images",
    resume: bool = False,
    device=None,
    params: Optional[mm.Any2PixLM] = None,
    step_hook: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
    mesh: Optional[mesh_lib.Mesh] = None,
) -> Dict[str, Any]:
    """Train for `train_cfg.total_steps` steps (from the checkpoint's step
    with `resume`). `params` is a trainable Any2PixLM on `device`, else a
    float32 one is drawn from seed 0. `step_hook(step_index, metrics)` is called after
    each step, before logging, preview and checkpoint. Returns the state,
    the per-step metrics (floats), the checkpoint writes and the seconds
    taken. On a `mesh` every rank calls it with the same arguments (the
    same seed-0 draw and the same batches); rank 0 logs, previews and
    writes the checkpoints."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    if params is None:
        params = mm.init(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    init_state, train_step = make_train_step(cfg, train_cfg, mesh=mesh)
    state = init_state(params)
    start_step = 0
    latest = checkpoint_path(ckpt_dir)
    if resume and os.path.exists(latest):
        state = (restore_state(latest, state) if mesh is not None
                 else ckpt_lib.restore(latest, like=state))
        start_step = state["step"]
        if lead:
            print(f"resumed from step {start_step}")

    logger = MetricLogger()
    preview_step = None
    tokenizer, token_ids, dcfg = dataset.tokenizer, dataset.token_ids, dataset.cfg
    order = data_lib.length_grouped_indices(dataset.modality_lengths, batch_size,
                                            np.random.RandomState(0))
    history: List[Dict[str, torch.Tensor]] = []
    saves: List[Dict[str, float]] = []
    pos = 0
    t0 = time.time()
    for step_i in range(start_step, train_cfg.total_steps):
        idx = [order[(pos + i) % len(order)] for i in range(batch_size)]
        pos += batch_size
        batch_np = data_lib.collate([dataset[int(i)] for i in idx], tokenizer, token_ids, dcfg,
                                    codec_dim=cfg.image_codec_dim)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        state, metrics = train_step(state, batch)
        history.append(metrics)
        if step_hook is not None:
            step_hook(step_i, metrics)
        if lead and (step_i + 1) % log_steps == 0:
            logger.log(step_i + 1, {k: float(v) for k, v in metrics.items()})
        if preview_steps and (step_i + 1) % preview_steps == 0:
            if preview_step is None:
                preview_step = make_preview_step(cfg)
            gen = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
                   for k, v in preview_step(state["params"], batch).items()}
            rows = np.nonzero(gen["has_gen"])[0]
            if lead and rows.size:
                r = int(rows[0])
                pair = np.stack([embedding_heatmap(gen["src"][r]), embedding_heatmap(gen["pred"][r])])
                p = logger.dump_images(step_i + 1, pair, out_dir=preview_dir)
                print(f"preview (src|gen embeddings) -> {p}")
        if (step_i + 1) % save_steps == 0 or step_i + 1 == train_cfg.total_steps:
            t_save = time.time()
            whole = full_state(state) if mesh is not None else state  # every rank gathers
            if lead:
                nbytes = ckpt_lib.save(latest, whole)
                saves.append({"step": step_i + 1, "bytes": nbytes,
                              "seconds": time.time() - t_save})
                print(f"saved checkpoint at step {step_i + 1}")
    seconds = time.time() - t0
    if lead:
        print(f"done: {train_cfg.total_steps - start_step} steps in {seconds:.1f}s")
    return {"state": state, "start_step": start_step, "saves": saves, "seconds": seconds,
            "history": [{k: float(v) for k, v in m.items()} for m in history]}


def main(argv=None, device=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--media-map", default=None)
    ap.add_argument("--media-root", default="")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--max-length", type=int, default=2048)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--save-steps", type=int, default=500)
    ap.add_argument("--log-steps", type=int, default=10)
    ap.add_argument("--preview-steps", type=int, default=50,
                    help="every N steps, run the generation-preview forward and dump a "
                         "src/gen embedding pair; 0 disables")
    ap.add_argument("--preview-dir", default="train_images")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--remat-policy", default="dots", choices=["full", "dots"],
                    help="activation checkpointing per decoder layer: 'dots' saves the "
                         "projections' matmul outputs, 'full' recomputes everything")
    ap.add_argument("--n-model", type=int, default=None,
                    help="model axis of the (data, model) mesh over the torchrun ranks "
                         "(FSDP shards over every rank either way)")
    args = ap.parse_args(argv)
    mesh = None
    if args.n_model is not None or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh_lib.init_distributed()  # env://, as torchrun sets it
        mesh = mesh_lib.make_mesh(n_model=args.n_model or 1, device=device)

    tokenizer = load_tokenizer(None)
    token_ids = initialize_vision_tokenizer(tokenizer)
    cfg = (mm.Any2PixLMConfig.tiny(token_ids) if args.tiny
           else mm.Any2PixLMConfig().with_token_ids(token_ids))
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, remat=True, remat_policy=args.remat_policy))
    media_map = {}
    if args.media_map:
        with open(args.media_map) as f:
            media_map = json.load(f)
    media = data_lib.MediaMap(media_map, args.media_root, dim=cfg.image_codec_dim)
    dcfg = data_lib.DataConfig(max_length=args.max_length, audio_codec_dim=cfg.audio_codec_dim)
    ds = data_lib.InstructionDataset(args.data, media, tokenizer, token_ids, dcfg)
    dev = mesh.device if mesh is not None else resolve_device(device)
    if mesh is None or mesh.rank == 0:
        print(f"dataset: {len(ds)} examples; device: {dev}; mesh: {mesh}")
    return train(cfg, TrainConfig(learning_rate=args.lr, total_steps=args.steps), ds,
                 batch_size=args.batch_size, ckpt_dir=args.ckpt_dir, save_steps=args.save_steps,
                 log_steps=args.log_steps, preview_steps=args.preview_steps,
                 preview_dir=args.preview_dir, resume=args.resume, device=dev, mesh=mesh)


if __name__ == "__main__":
    main()
