#!/usr/bin/env python3
"""K3 (SAM's rel-pos flash attention) and K1 at head_dim 80 on the card:
this tree against another commit.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

  python3 benchmarks_torch/k3_ab.py --parent build/parent --out build/k3_ab.json
      DIR holds another commit unpacked (`git archive <rev> | tar -x -C DIR`).
      In four processes in turn, parent, this tree, this tree, parent, each
      building and importing its own tree's port and timing with its own
      chip_smoke.py: every K3_SHAPES row of its chip_smoke.py (checked and
      timed beside the plain version and SDPA with the bias as a dense
      mask), this tree's bf16 head_dim 80 K1 rows (K1_SHAPES and
      K1_KV_SHAPES), and one SAM ViT-H encoder (random bf16 weights from a
      seed, one 1024^2 image) timed whole and split into its global and
      window attentions with this tree's chip_smoke.sam_encode_split. The
      parent's router may send the window blocks to the plain version: the
      encoder's time is the pipeline's, whatever each tree routes. Each K3
      row and head_dim 80 K1 row is also timed without the host: device
      time per call from a CUDA graph of the calls, beside the host's cost
      of issuing one (the small rows are bound by it in eager timing).

The harness (builds, turns) is kernel_ab.py's. The last line of output is
the JSON summary; --out also writes every row.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import kernel_ab
from kernel_ab import ROOT

ENCODE_REPS = 5


def _rows(cs):
    """This tree's bf16 head_dim 80 K1 rows as (kind, args), kind "k1" or
    "kv" (K3's rows are each tree's own K3_SHAPES)."""
    out = [("k1", ["bfloat16", label, list(shape), sk, causal])
           for label, shape, sk, causal in cs.K1_SHAPES if shape[3] == 80]
    out += [("kv", [si, label, list(shape), sk, causal, list(kv), dname])
            for si, (label, shape, sk, causal, kv, dname) in enumerate(cs.K1_KV_SHAPES)
            if dname == "bfloat16" and shape[3] == 80]
    return out


def _here():
    """This tree's chip_smoke.py (for its SAM timer), whichever tree's port
    is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sam_encode(cs):
    """A random SAM ViT-H encoder in bf16 on one image: its time (mean of
    ENCODE_REPS after a warm-up) and the split of its attentions."""
    import torch

    from instructany2pix_tpu_torch.grounding import sam as sam_lib
    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(5)
    cfg = sam_lib.SAMConfig.vit_h()
    with torch.device("meta"):
        sam = sam_lib.SAM(cfg)
    sam = sam_lib.init_(L.materialize(sam, torch.device("cuda"), torch.bfloat16), gen).eval()
    x = torch.randn((1, cfg.img_size, cfg.img_size, 3), generator=gen, device="cuda").bfloat16()
    before = fa.flash_relpos2d_cuda.launches
    with torch.inference_mode():
        sam_lib.encoder_apply(sam.encoder, x, cfg)
        torch.cuda.synchronize()
        k3_per_encode = fa.flash_relpos2d_cuda.launches - before
        ms = cs.time_ms(lambda: sam_lib.encoder_apply(sam.encoder, x, cfg), ENCODE_REPS, 1)
    split = _here().sam_encode_split(sam_lib, sam.encoder, x, cfg)
    del sam
    torch.cuda.empty_cache()
    return {"encode_ms": ms, "k3_per_encode": k3_per_encode, **{f"split_{k}": v
                                                                for k, v in split.items()}}


def _unhosted(cs, rows_json):
    """Device and host time of every K3_SHAPES row and of the head_dim 80
    K1 rows without kv_len, on random contiguous bf16 inputs."""
    import torch

    from instructany2pix_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(6)
    out = []
    for label, b, h, g, d in cs.K3_SHAPES:
        q, k, v = (torch.randn((b, h, g * g, d), generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        bh, bw = (torch.randn((b, h, g * g, g), generator=gen, device="cuda") for _ in range(2))
        dev, host = kernel_ab.device_host(
            cs, lambda: fa.flash_relpos2d_cuda(q, k, v, bh, bw, d**-0.5))
        out.append({"kind": "k3", "label": label, "device_ms": dev, "host_ms": host})
    for kind, a in json.loads(rows_json):
        if kind != "k1":
            continue
        _, label, (b, h, sq, d), sk, causal = a
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        dev, host = kernel_ab.device_host(
            cs, lambda: fa.flash_fwd_cuda(q, k, v, causal, d**-0.5))
        out.append({"kind": "k1", "label": label, "device_ms": dev, "host_ms": host})
    return out


def child(tree, rows_json):
    """Time K3's rows, `rows` and the SAM encoder with the port and
    chip_smoke.py of `tree`."""
    import torch

    cs = kernel_ab.child_module(tree)
    failures = []
    rows = []
    for r in cs.phase_k3(failures, timed=True):
        rows.append({"kind": "k3", **{k: r.get(k) for k in (
            "label", "shape", "g", "path", "ok", "of_limit", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")}})
    for kind, a in json.loads(rows_json):
        if kind == "k1":
            dname, label, shape, sk, causal = a
            r = cs._k1_row(failures, True, getattr(torch, dname), dname, label, tuple(shape), sk,
                           causal)
        else:
            si, label, shape, sk, causal, kv, dname = a
            r = cs._k1_kv_row(failures, True, si, label, tuple(shape), sk, causal, tuple(kv),
                              dname)
            r["label"] = "kv_len " + label
        rows.append({"kind": "k1", **{k: r.get(k) for k in (
            "label", "shape", "sk", "path", "ok", "of_limit", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")}})
        torch.cuda.empty_cache()
    unhosted = _unhosted(cs, rows_json)
    sam = _sam_encode(cs)
    print(json.dumps({"tree": str(tree), "card": cs.card_line(), "rows": rows,
                      "unhosted": unhosted, "sam": sam, "failures": failures}))


def ab(parent, out):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    runs = kernel_ab.in_turns(__file__, "flash_fwd", parent, _rows(cs))
    summary = []
    for i, row in enumerate(runs[1]["rows"]):
        p = [runs[0]["rows"][i]["ms"], runs[3]["rows"][i]["ms"]]
        c = [runs[1]["rows"][i]["ms"], runs[2]["rows"][i]["ms"]]
        summary.append({"kind": row["kind"], "label": row["label"], "shape": row["shape"],
                        "path": row["path"], "parent_path": runs[0]["rows"][i]["path"],
                        "parent_ms": p, "change_ms": c, "change_vs_parent": sum(c) / sum(p) - 1,
                        "parent_spread": abs(p[0] - p[1]) / min(p),
                        "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
                        "bound_ms": row["bound_ms"]})
        print(f"{row['kind']} {row['label']:28s} {str(row['shape']):20s} {row['path']} "
              f"(parent {summary[-1]['parent_path']}) parent {p[0]:.4f} {p[1]:.4f} change "
              f"{c[0]:.4f} {c[1]:.4f} ({summary[-1]['change_vs_parent']:+.1%}, parent spread "
              f"{summary[-1]['parent_spread']:.1%}) library {row['library_ms']:.4f}", flush=True)
    for i, row in enumerate(runs[1]["unhosted"]):
        dev = [run["unhosted"][i]["device_ms"] for run in runs]
        host = [run["unhosted"][i]["host_ms"] for run in runs]
        summary.append({"kind": row["kind"] + " unhosted", "label": row["label"],
                        "device_ms": dev, "host_ms": host})
        print(f"{row['kind']} {row['label']:28s} device ms (parent, change, change, parent) "
              f"{dev}, host ms {[round(x, 4) for x in host]}", flush=True)
    sam = {run["name"] + f"#{i}": run["sam"] for i, run in enumerate(runs)}
    for name, s in sam.items():
        print(f"SAM ViT-H encode {name}: {s['encode_ms']:.3f} ms, K3 {s['k3_per_encode']} per "
              f"encode; split: encode {s['split_encode_ms']:.3f}, {s['split_global_calls']} global "
              f"{s['split_global_attention_ms']:.3f} ms, {s['split_window_calls']} window "
              f"{s['split_window_attention_ms']:.3f} ms", flush=True)
    return kernel_ab.finish({"card": runs[0]["card"], "summary": summary, "sam": sam,
                             "runs": runs}, out, [r for run in runs for r in run["failures"]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another commit, unpacked: time it against this tree")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write every row to this JSON file")
    args = ap.parse_args(argv)
    if args.child:
        child(Path(args.child[0]).resolve(), args.child[1])
        return 0
    if not args.parent:
        ap.error("give --parent")
    import torch

    if not torch.cuda.is_available():
        print("k3_ab: no CUDA device", file=sys.stderr)
        return 2
    return ab(Path(args.parent).resolve(), args.out)


if __name__ == "__main__":
    sys.exit(main())
