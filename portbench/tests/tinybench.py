"""Tiny cells of the benchmark, added to a copy of it as a later change
would add a cell: new files and new entries of BENCHMARK.json, run on the
CPU."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = {
    "name": "tiny", "dtype": "float32", "image_size": 64, "prior_output_proj": True,
    "unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
             "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"], "layers_per_block": 1,
             "transformer_layers_per_block": [1, 1], "num_attention_heads": [2, 4],
             "cross_attention_dim": 64, "norm_num_groups": 8, "addition_embed_type": "text_time",
             "addition_time_embed_dim": 8, "projection_class_embeddings_input_dim": 72,
             "num_time_ids": 6, "use_linear_projection": True, "flip_sin_to_cos": True,
             "freq_shift": 0.0, "with_ip": True, "ip_num_tokens": 4},
    "refiner": {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
                "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"],
                "layers_per_block": 1, "transformer_layers_per_block": [1, 1],
                "num_attention_heads": [2, 4], "cross_attention_dim": 32, "norm_num_groups": 8,
                "addition_embed_type": "text_time", "addition_time_embed_dim": 8,
                "projection_class_embeddings_input_dim": 64, "num_time_ids": 5,
                "use_linear_projection": True, "flip_sin_to_cos": True, "freq_shift": 0.0,
                "with_ip": False, "ip_num_tokens": 4},
    "vae": {"in_channels": 3, "latent_channels": 4, "block_out_channels": [8, 16],
            "layers_per_block": 1, "norm_num_groups": 4, "scaling_factor": 0.13025},
    "text1": {"vocab_size": 300, "hidden_size": 32, "intermediate_size": 64, "num_layers": 2,
              "num_heads": 4, "max_positions": 16, "hidden_act": "quick_gelu",
              "projection_dim": None, "eos_token_id": 299},
    "text2": {"vocab_size": 300, "hidden_size": 32, "intermediate_size": 64, "num_layers": 2,
              "num_heads": 4, "max_positions": 16, "hidden_act": "gelu", "projection_dim": 24,
              "eos_token_id": 299},
    "prior_text": {"vocab_size": 300, "hidden_size": 32, "intermediate_size": 64,
                   "num_layers": 2, "num_heads": 4, "max_positions": 16, "hidden_act": "gelu",
                   "projection_dim": None, "eos_token_id": 299},
    "prior": {"embed_dim": 16, "output_dim": 16, "sequence_gen_length": 1, "imagebind_dim": 16,
              "text_dim": 32, "score_dim": 8, "text_len": 7,
              "gpt2": {"hidden_size": 16, "num_layers": 2, "num_heads": 4, "max_positions": 64,
                       "ln_eps": 1e-05},
              "sequence_input_key": [["src_type", 0], ["imagebind", 16], ["crossattn_clip", 32],
                                     ["score", 8], ["noisy_inputs", 0]]},
    "image_proj": {"cross_attention_dim": 64, "clip_embeddings_dim": 16, "num_tokens": 4,
                   "num_crops": 2},
}

COMMON = {"config": "tiny", "steps": 3, "cfg": 10.0, "refinement": 0.1, "scale": 1.0,
          "alpha": 0.7, "h": [0.0, 0.4, 1.0], "norm": 20.0, "caption_bytes": [8, 60],
          "warmup_steps": 2, "compare": 8}
LIMITS = {"encode": 0.01, "steps": 0.01, "decode": 0.5}
TINY_CELLS = {
    "tiny-serve": dict(COMMON, driver="serve", clients=4, max_batch=2, max_wait_s=0.05,
                       prefill=96, limits=LIMITS),
    "tiny-single": dict(COMMON, driver="single", prefill=48, limits=LIMITS),
}
SERVE_METRICS = ["between_batches_ms.serve", "non_unet_s.serve", "unet_step_ms.serve", "mfu.serve"]
EDIT_METRICS = ["non_unet_s.edit", "unet_step_ms.edit", "mfu.edit"]


def add_tiny_cells(root: str) -> None:
    """The tiny configuration and cells, as a later change would add them:
    new files and new entries of BENCHMARK.json."""
    with open(os.path.join(root, "portbench", "configs", "tiny.json"), "w") as f:
        json.dump(TINY, f)
    for name, wl in TINY_CELLS.items():
        with open(os.path.join(root, "portbench", "workloads", f"{name}.json"), "w") as f:
            json.dump(wl, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "portbench/tests", "reduced": [],
                             "file": "portbench/configs/tiny.json", "why": "CPU tests"})
    bench["workloads"] += [{"name": n, "config": "tiny", "traffic": n, "chips": 1, "why": "tests"}
                           for n in TINY_CELLS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            if m["name"] in SERVE_METRICS or m["name"] == "served_requests_per_s":
                m["workloads"].append("tiny-serve")
            if m["name"] in EDIT_METRICS or m["name"] == "request_latency_s":
                m["workloads"].append("tiny-single")
    with open(path, "w") as f:
        json.dump(bench, f)


def digests(root: str) -> dict:
    """Path under `root` → sha256 of every file of `root`'s portbench/."""
    out = {}
    for base, _, files in os.walk(os.path.join(root, "portbench")):
        if "__pycache__" in base:
            continue
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def copy_with_tiny_cells(dest: str) -> str:
    """A copy of the benchmark (BENCHMARK.json and portbench/) under
    `dest`, with the tiny cells added."""
    os.makedirs(dest, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), os.path.join(dest, "BENCHMARK.json"))
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_tiny_cells(dest)
    return dest


def run_tiny(root: str, cell: str, seed: int = 2**31 + 7, trace_on: bool = False,
             seconds: float = 2.0):
    """One CPU run of a tiny cell in `root` → its result."""
    import tempfile

    from portbench import run

    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        return run.run_cell(root, cell, seed, seconds, trace_on, "cpu", tmp)
