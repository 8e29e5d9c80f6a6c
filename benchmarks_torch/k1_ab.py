#!/usr/bin/env python3
"""K1 (the flash-attention forward) on the card: this tree against another
commit, and the wgmma path at other key-tile sizes.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

  python3 benchmarks_torch/k1_ab.py --parent build/parent --out build/k1_ab.json
      DIR holds another commit unpacked (`git archive <rev> | tar -x -C DIR`).
      Every K1 row of this tree's chip_smoke.py (K1_SHAPES in bf16 and float32,
      and K1_KV_SHAPES) is checked and timed in four processes in turn, parent,
      this tree, this tree, parent, each building and importing its own tree's
      port and timing with its own chip_smoke.py row functions, on the same
      shapes and seeds. The bf16 K1_SHAPES rows are also timed without the
      host (kernel_ab.device_host: device time from a CUDA graph of the calls,
      and the host's cost of issuing one), since the small ones are bound by
      the host in eager timing.
  python3 benchmarks_torch/k1_ab.py --keys 64 176 --out build/k1_keys.json
      Builds copies of csrc/flash_fwd.cu whose wgmma path takes N-key tiles at
      both head dims (under build/flash_fwd_copies/) and times the bf16
      head_dim 64 and 128 rows with each, between two runs of the tree's own
      tile size, in one process.

The harness (builds, turns, patched copies) is kernel_ab.py's.

The last line of output is the JSON summary (ms per row and run); --out
also writes every row.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import kernel_ab
from kernel_ab import ROOT


def _rows(cs):
    """This tree's K1 rows as (kind, args) with kind "k1" or "kv"."""
    out = []
    for dname in ("bfloat16", "float32"):
        for label, shape, sk, causal in cs.K1_SHAPES:
            out.append(("k1", [dname, label, list(shape), sk, causal]))
    for si, (label, shape, sk, causal, kv, dname) in enumerate(cs.K1_KV_SHAPES):
        out.append(("kv", [si, label, list(shape), sk, causal, list(kv), dname]))
    return out


def _unhosted(cs, dname, shape, sk, causal):
    """kernel_ab.device_host of one K1 call at a row's shape, on random
    inputs."""
    import torch

    from instructany2pix_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(7)
    b, h, sq, d = shape
    dtype = getattr(torch, dname)
    q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    return kernel_ab.device_host(cs, lambda: fa.flash_fwd_cuda(q, k, v, causal, d**-0.5))


def _time_rows(cs, rows, failures, unhosted=False):
    import torch

    out = []
    for kind, a in rows:
        dev = host = None
        if kind == "k1":
            dname, label, shape, sk, causal = a
            r = cs._k1_row(failures, True, getattr(torch, dname), dname, label, tuple(shape),
                           sk, causal)
            if unhosted and dname == "bfloat16":
                dev, host = _unhosted(cs, dname, shape, sk, causal)
        else:
            si, label, shape, sk, causal, kv, dname = a
            r = cs._k1_kv_row(failures, True, si, label, tuple(shape), sk, causal, tuple(kv),
                              dname)
            r["label"] = "kv_len " + label
        out.append({**{k: r.get(k) for k in ("label", "dtype", "shape", "sk", "causal", "path",
                                             "ok", "of_limit", "ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")},
                    "device_ms": dev, "host_ms": host})
        torch.cuda.empty_cache()
    return out


def child(tree, rows_json):
    """Time `rows` with the port and chip_smoke.py of `tree`."""
    cs = kernel_ab.child_module(tree)
    failures = []
    rows = _time_rows(cs, json.loads(rows_json), failures, unhosted=True)
    print(json.dumps({"tree": str(tree), "card": cs.card_line(), "rows": rows,
                      "failures": failures}))


def ab(parent, out):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    runs = kernel_ab.in_turns(__file__, "flash_fwd", parent, _rows(cs))
    summary = []
    for i, row in enumerate(runs[1]["rows"]):
        p = [runs[0]["rows"][i]["ms"], runs[3]["rows"][i]["ms"]]
        c = [runs[1]["rows"][i]["ms"], runs[2]["rows"][i]["ms"]]
        summary.append({"label": row["label"], "dtype": row["dtype"], "shape": row["shape"],
                        "sk": row["sk"], "path": row["path"],
                        "parent_path": runs[0]["rows"][i]["path"], "parent_ms": p,
                        "change_ms": c, "change_vs_parent": sum(c) / sum(p) - 1,
                        "parent_spread": abs(p[0] - p[1]) / min(p),
                        "library_ms": row["library_ms"], "bound_ms": row["bound_ms"],
                        "device_ms": [run["rows"][i]["device_ms"] for run in runs],
                        "host_ms": [run["rows"][i]["host_ms"] for run in runs]})
        unhosted = ""
        if row["host_ms"] is not None:
            unhosted = (f"; device ms (p, c, c, p) {summary[-1]['device_ms']}, host ms "
                        f"{[round(x, 4) for x in summary[-1]['host_ms']]}")
        print(f"{row['label']:28s} {row['dtype']:8s} {row['path']:6s} parent {p[0]:.4f} "
              f"{p[1]:.4f} change {c[0]:.4f} {c[1]:.4f} ({summary[-1]['change_vs_parent']:+.1%}, "
              f"parent spread {summary[-1]['parent_spread']:.1%}){unhosted}", flush=True)
    return kernel_ab.finish({"card": runs[0]["card"], "summary": summary, "runs": runs}, out,
                            [r for run in runs for r in run["failures"]])


def keys(sizes, out):
    """Time the bf16 D in {64, 128} rows with each key-tile size."""
    cs = kernel_ab.child_module(ROOT)
    from instructany2pix_tpu_torch.ops import _build

    hdr = (_build.CSRC / "flash_fwd_sm90.cuh").read_text()
    default = {d: int(hdr.split(f"struct Tile<{d}> {{ static constexpr int kKeys = ")[1]
                      .split(",")[0]) for d in (64, 128)}
    copies = {"default": {}}
    for n in sizes:
        copies[f"keys {n}"] = {"flash_fwd_sm90.cuh": [
            (f"struct Tile<{d}> {{ static constexpr int kKeys = {default[d]},",
             f"struct Tile<{d}> {{ static constexpr int kKeys = {n},") for d in (64, 128)]}
    libs, ptxas = kernel_ab.build_copies("flash_fwd", copies, "flash_fwd_wgmma")
    rows = [(k, a) for k, a in _rows(cs)
            if (k == "k1" and a[0] == "bfloat16" and a[2][3] in (64, 128))
            or (k == "kv" and a[6] == "bfloat16" and a[2][3] in (64, 128))]
    order = ["default", *[f"keys {n}" for n in sizes], "default"]
    runs, failures = [], []
    for name in order:
        with kernel_ab.loaded("flash_fwd", libs[name]):
            runs.append({"name": name, "rows": _time_rows(cs, rows, failures)})
    summary = []
    for i, row in enumerate(runs[0]["rows"]):
        ms = {f"{r['name']}#{j}" if r["name"] == "default" else r["name"]: r["rows"][i]["ms"]
              for j, r in enumerate(runs)}
        summary.append({"label": row["label"], "shape": row["shape"], "sk": row["sk"], "ms": ms})
        print(f"{row['label']:28s} " + " ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    return kernel_ab.finish({"card": cs.card_line(), "default_keys": default, "ptxas": ptxas,
                             "summary": summary, "failures": failures, "runs": runs}, out,
                            failures)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another commit, unpacked: time it against this tree")
    ap.add_argument("--keys", type=int, nargs="+", help="key-tile sizes of the wgmma path to time")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write every row to this JSON file")
    args = ap.parse_args(argv)
    if args.child:
        child(Path(args.child[0]).resolve(), args.child[1])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.parent:
        return ab(Path(args.parent).resolve(), args.out)
    if args.keys:
        return keys(args.keys, args.out)
    ap.error("give --parent or --keys")


if __name__ == "__main__":
    sys.exit(main())
