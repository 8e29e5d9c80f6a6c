"""The control of the comparison that decides `correct`: the reference put
in the program's place and computed with float8 products (e4m3, the step
below the configuration's bfloat16), on a cell's own requests at its own
sizes, and judged as a run judges the program: its trail followed by the
float32 reference and each number held against the cell's limit
(`correct.judge`). Its readings set the upper end of each limit
(PERF.md); the benchmark's own runs never run it. It is the edit's
control (`kinds/edit.py`); another kind brings its own.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List

import torch

from . import configs, correct
from .kinds import edit as edit_kind
from .reference import edit as ref_edit
from .reference import layers as ref_layers
from .traffic import Traffic


def workload(root: str, cell: str) -> dict:
    with open(os.path.join(root, "portbench", "workloads", f"{cell}.json")) as f:
        return json.load(f)


def readings(root: str, cell: str, seed: int, device, n: int) -> Dict[str, float]:
    """The worst of each number over `n` of the cell's requests drawn from
    `seed`, with the seed's weights, the control in the program's place."""
    wl = workload(root, cell)
    cfgs = configs.reference_cfgs(configs.load(wl["config"], os.path.join(root, "portbench",
                                                                          "configs")))
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        traffic = Traffic(wl, seed, cfgs["prior"].imagebind_dim, cfgs["image_size"],
                          configs.latent_side(cfgs), tmp)
        models = edit_kind.reference_models(cfgs, seed, device)
        chosen = []
        for i in range(n):
            req = traffic.request(i)
            with ref_layers.precision("fp8"):
                trail = ref_edit.edit(models, edit_kind.inputs(req, wl, cfgs["image_size"]), device)
            chosen.append((req, trail))
        worst = edit_kind.worst_of(chosen, models, wl, cfgs["image_size"], device)
        del models, chosen
        correct.free_cuda()
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=None,
                   help="requests per seed (default: as many as a run compares)")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 3
    root = os.getcwd()
    wl = workload(root, a.workload)
    out: List[Dict] = []
    for seed in (int(s) for s in a.seeds.split(",")):
        worst = readings(root, a.workload, seed, "cuda", a.requests or wl["compare"])
        within, checks = correct.judge(worst, wl["limits"])
        out.append({"seed": seed, "correct": within, "checks": checks})
        print(json.dumps(out[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
