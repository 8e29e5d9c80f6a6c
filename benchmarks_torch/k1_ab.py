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
      shapes and seeds.
  python3 benchmarks_torch/k1_ab.py --keys 64 176 --out build/k1_keys.json
      Builds copies of csrc/flash_fwd.cu whose wgmma path takes N-key tiles at
      both head dims and times the bf16 head_dim 64 and 128 rows with each,
      between two runs of the tree's own tile size, in one process.

The last line of output is the JSON summary (ms per row and run); --out
also writes every row.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _rows(cs):
    """This tree's K1 rows as (kind, args) with kind "k1" or "kv"."""
    out = []
    for dname in ("bfloat16", "float32"):
        for label, shape, sk, causal in cs.K1_SHAPES:
            out.append(("k1", [dname, label, list(shape), sk, causal]))
    for si, (label, shape, sk, causal, kv, dname) in enumerate(cs.K1_KV_SHAPES):
        out.append(("kv", [si, label, list(shape), sk, causal, list(kv), dname]))
    return out


def _time_rows(cs, rows, failures):
    import torch

    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = []
    try:
        for kind, a in rows:
            if kind == "k1":
                dname, label, shape, sk, causal = a
                r = cs._k1_row(failures, True, getattr(torch, dname), dname, label, tuple(shape),
                               sk, causal)
            else:
                si, label, shape, sk, causal, kv, dname = a
                r = cs._k1_kv_row(failures, True, si, label, tuple(shape), sk, causal, tuple(kv),
                                  dname)
                r["label"] = "kv_len " + label
            out.append({k: r.get(k) for k in ("label", "dtype", "shape", "sk", "causal", "path",
                                              "ok", "of_limit", "ms", "plain_ms", "library_ms",
                                              "bound_ms", "bound_by")})
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    return out


def child(tree, rows_json):
    """Time `rows` with the port and chip_smoke.py of `tree`."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    rows = _time_rows(cs, json.loads(rows_json), failures)
    print(json.dumps({"tree": str(tree), "card": cs.card_line(), "rows": rows,
                      "failures": failures}))


def build(tree):
    return subprocess.Popen(
        [sys.executable, "-c", "from instructany2pix_tpu_torch.ops import _build; "
                               "_build.build(['flash_fwd'])"], cwd=tree)


def ab(parent, out):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    rows = json.dumps(_rows(cs))
    procs = [build(parent), build(ROOT)]
    if any(p.wait() for p in procs):
        raise SystemExit("k1_ab: a build failed")
    runs = []
    for name, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                       ("parent", parent)):
        r = subprocess.run([sys.executable, __file__, "--child", str(tree), rows],
                           capture_output=True, text=True, cwd=tree)
        if r.returncode:
            raise SystemExit(f"k1_ab: the {name} run failed:\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["name"] = name
        runs.append(res)
        print(f"{name}: {len(res['rows'])} rows, failures {res['failures']}", flush=True)
    summary = []
    for i, row in enumerate(runs[1]["rows"]):
        p = [runs[0]["rows"][i]["ms"], runs[3]["rows"][i]["ms"]]
        c = [runs[1]["rows"][i]["ms"], runs[2]["rows"][i]["ms"]]
        summary.append({"label": row["label"], "dtype": row["dtype"], "shape": row["shape"],
                        "sk": row["sk"], "path": row["path"],
                        "parent_path": runs[0]["rows"][i]["path"], "parent_ms": p,
                        "change_ms": c, "change_vs_parent": sum(c) / sum(p) - 1,
                        "parent_spread": abs(p[0] - p[1]) / min(p),
                        "library_ms": row["library_ms"], "bound_ms": row["bound_ms"]})
        print(f"{row['label']:28s} {row['dtype']:8s} {row['path']:6s} parent {p[0]:.4f} "
              f"{p[1]:.4f} change {c[0]:.4f} {c[1]:.4f} ({summary[-1]['change_vs_parent']:+.1%}, "
              f"parent spread {summary[-1]['parent_spread']:.1%})", flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps({"runs": runs, "summary": summary}, indent=1))
    print(json.dumps({"card": runs[0]["card"], "summary": summary}))
    bad = [r for run in runs for r in run["failures"]]
    return 1 if bad else 0


def keys(sizes, out):
    """Time the bf16 D in {64, 128} rows with each key-tile size."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from instructany2pix_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    hdr = (_build.CSRC / "flash_fwd_sm90.cuh").read_text()
    src = (_build.CSRC / "flash_fwd.cu").read_text()
    default = {d: int(hdr.split(f"struct Tile<{d}> {{ static constexpr int kKeys = ")[1]
                      .split(",")[0]) for d in (64, 128)}
    libs = {"default": _build.build(["flash_fwd"])["flash_fwd"]}
    procs = []
    for n in sizes:
        d = _build.BUILD_DIR.parent / "k1_keys" / str(n)
        d.mkdir(parents=True, exist_ok=True)
        text = hdr
        for dim in (64, 128):
            old = f"struct Tile<{dim}> {{ static constexpr int kKeys = {default[dim]},"
            assert text.count(old) == 1
            text = text.replace(old, f"struct Tile<{dim}> {{ static constexpr int kKeys = {n},")
        (d / "flash_fwd_sm90.cuh").write_text(text)
        (d / "flash_fwd.cu").write_text(src)
        so = d / "flash_fwd.so"
        log = (d / "flash_fwd.log").open("w")
        procs.append((f"keys {n}", so, subprocess.Popen(
            _build.nvcc_command(d / "flash_fwd.cu", so), stdout=log, stderr=subprocess.STDOUT)))
        log.close()
    for name, so, p in procs:
        if p.wait():
            raise SystemExit(f"k1_ab: nvcc failed for {name}: see {so.with_suffix('.log')}")
        libs[name] = so
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    rows = [(k, a) for k, a in _rows(cs)
            if (k == "k1" and a[0] == "bfloat16" and a[2][3] in (64, 128))
            or (k == "kv" and a[6] == "bfloat16" and a[2][3] in (64, 128))]
    order = ["default", *[f"keys {n}" for n in sizes], "default"]
    runs, failures = [], []
    for name in order:
        _build._LOADED["flash_fwd"] = ctypes.CDLL(str(libs[name]))
        runs.append({"name": name, "rows": _time_rows(cs, rows, failures)})
    _build._LOADED.pop("flash_fwd", None)
    summary = []
    for i, row in enumerate(runs[0]["rows"]):
        ms = {f"{r['name']}#{j}" if r["name"] == "default" else r["name"]: r["rows"][i]["ms"]
              for j, r in enumerate(runs)}
        summary.append({"label": row["label"], "shape": row["shape"], "sk": row["sk"], "ms": ms})
        print(f"{row['label']:28s} " + " ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps({"default_keys": default, "runs": runs,
                                         "summary": summary}, indent=1))
    print(json.dumps({"card": cs.card_line(), "default_keys": default, "summary": summary,
                      "failures": failures}))
    return 1 if failures else 0


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
