#!/usr/bin/env python3
"""K4 (the flash-attention backward) on the card: this tree against another
commit, and copies of the fused kernel with one design decision changed.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

  python3 benchmarks_torch/k4_ab.py --parent build/parent --out build/k4_ab.json
      DIR holds another commit unpacked (`git archive <rev> | tar -x -C DIR`).
      Every bf16 row of this tree's chip_smoke.py K4_SHAPES is checked and
      timed in four processes in turn, parent, this tree, this tree, parent,
      each building and importing its own tree's port and timing with its own
      chip_smoke.py row function, on the same shapes and seeds. A tree whose
      rows time the whole backward in one call (`ms`, the fused kernel with
      its dq accumulator's zeroing and cast) is read as that; a tree that
      times only K4a and K4b (`ms_dq`, `ms_dkv`) as their sum. Each row also
      carries the path the backward took, SDPA's backward and the bound of
      the 5 products one backward needs, from this tree's runs. At the rows
      K4a then K4b serve, each tree also times its two wrappers in one timed
      call (`pair_ms`), `flash_bwd_cuda` where it has one (`whole_ms`), and
      the host's cost of a call of each (`*_host_ms`: the wall time of
      issuing calls the card has not caught up with, per call).
  python3 benchmarks_torch/k4_ab.py --variants --out build/k4_variants.json
      Builds each VARIANTS copy of csrc/flash_bwd_sm90.cuh (and of
      csrc/flash_bwd.cu where the kernel's arguments change) under
      build/flash_bwd_copies/; in one process every copy runs
      `flash_bwd_cuda` at VARIANT_SHAPES, twice in turn (the accumulator's
      zeroing and cast included), and every copy that computes the same
      function is held against the plain backward within chip_smoke.K4_TOL.
      The diag_* copies drop a piece of the work to show what it costs and
      give wrong gradients. The zeroing and cast are also timed alone.
  python3 benchmarks_torch/k4_ab.py --device --out build/k4_device.json
      This tree only: every bf16 row's whole backward (`flash_bwd_cuda`,
      the accumulator's zeroing and cast included) timed eagerly with CUDA
      events, on the device alone from a CUDA graph of its calls, and the
      host's cost of issuing one call: a row whose eager time is near its
      host cost is host-bound.

The harness (builds, turns, patched copies) is kernel_ab.py's. The last
line of output is the JSON summary; --out also writes every row.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import kernel_ab
from kernel_ab import ROOT

KEYS = ("label", "dtype", "shape", "sk", "causal", "kv_len", "path", "ok", "of_limit", "ms",
        "ms_with_delta", "ms_dq", "ms_dkv", "plain_ms", "library_ms", "bound_ms", "bound_by")


def _rows(cs):
    """This tree's bf16 K4 rows, each with its index in K4_SHAPES (the seed)."""
    return [[si, label, list(shape), sk, causal, list(kv) if kv else None, dname]
            for si, (label, shape, sk, causal, kv, dname) in enumerate(cs.K4_SHAPES)
            if dname == "bfloat16"]


def backward_ms(row):
    """The whole backward's time of a row: one call where the tree times
    one, else K4a plus K4b."""
    return row["ms"] if row.get("ms") is not None else row["ms_dq"] + row["ms_dkv"]


def _inputs(si, shape, sk, causal, kv, dname):
    """A row's inputs as chip_smoke's _k4_row makes them (seed 3000 + si),
    with lse and delta: the arguments of every K4 wrapper."""
    import torch

    from instructany2pix_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dname)
    b, h, sq, d = shape
    gen = torch.Generator("cuda").manual_seed(3000 + si)
    q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    kv_len = None if kv is None else torch.tensor(kv, dtype=torch.int32, device="cuda")
    o, lse = fa._reference_attention(q, k, v, causal, d**-0.5, True, kv_len)
    return q, k, v, g, lse, fa.flash_delta(g, o), causal, d**-0.5, kv_len


def _two_kernel_costs(cs, row_args):
    """At a row K4a then K4b serve: the tree's two wrappers in one timed call
    against its `flash_bwd_cuda` (where it has one), twice in turn, and the
    host's cost of a call of each."""
    import torch

    from instructany2pix_tpu_torch.ops import flash_attention as fa

    args = _inputs(*row_args)
    calls = {"pair": lambda: (fa.flash_bwd_dq_cuda(*args), fa.flash_bwd_dkv_cuda(*args))}
    if hasattr(fa, "flash_bwd_cuda"):
        calls["whole"] = lambda: fa.flash_bwd_cuda(*args)
    out = {}
    for _ in range(2):
        for name, fn in calls.items():
            out.setdefault(f"{name}_ms", []).append(cs.time_ms(fn, 50))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):  # ~0.3 ms of card time each: the host runs ahead
                fn()
            out.setdefault(f"{name}_host_ms", []).append((time.perf_counter() - t0) / 20 * 1e3)
            torch.cuda.synchronize()
    return out


def child(tree, rows_json):
    """Time `rows` with the port and chip_smoke.py of `tree`."""
    import torch

    cs = kernel_ab.child_module(tree)
    failures, out = [], []
    for si, label, shape, sk, causal, kv, dname in json.loads(rows_json):
        r = cs._k4_row(failures, True, si, label, tuple(shape), sk, causal,
                       tuple(kv) if kv else None, dname)
        row = {k: r.get(k) for k in KEYS}
        if row["path"] != "wgmma":
            row.update(_two_kernel_costs(cs, (si, tuple(shape), sk, causal, kv, dname)))
        out.append(row)
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(tree), "card": cs.card_line(), "rows": out,
                      "failures": failures}))


def ab(parent, out):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    runs = kernel_ab.in_turns(__file__, "flash_bwd", parent, _rows(cs))
    summary = []
    for i, row in enumerate(runs[1]["rows"]):
        p = [backward_ms(runs[0]["rows"][i]), backward_ms(runs[3]["rows"][i])]
        c = [backward_ms(runs[1]["rows"][i]), backward_ms(runs[2]["rows"][i])]
        summary.append({"label": row["label"], "shape": row["shape"], "sk": row["sk"],
                        "causal": row["causal"], "kv_len": row["kv_len"], "path": row["path"],
                        "parent_path": runs[0]["rows"][i]["path"], "parent_ms": p,
                        "change_ms": c, "change_vs_parent": sum(c) / sum(p) - 1,
                        "parent_spread": abs(p[0] - p[1]) / min(p),
                        "change_with_delta_ms": [runs[j]["rows"][i]["ms_with_delta"]
                                                 for j in (1, 2)],
                        "library_ms": [runs[j]["rows"][i]["library_ms"] for j in (1, 2)],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "of_limit": max(run["rows"][i]["of_limit"] for run in runs)})
        s = summary[-1]
        print(f"{row['label']:24s} {row['path']:6s} parent {p[0]:.4f} {p[1]:.4f} change "
              f"{c[0]:.4f} {c[1]:.4f} ({s['change_vs_parent']:+.1%}, parent spread "
              f"{s['parent_spread']:.1%}) sdpa bwd {s['library_ms'][0]:.4f} bound "
              f"{s['bound_ms']:.4f}", flush=True)
        if row["path"] != "wgmma":
            s["two_kernel"] = {run["name"] + str(j): {
                k: v for k, v in run["rows"][i].items() if k.startswith(("pair", "whole"))}
                for j, run in enumerate(runs)}
            print("  " + "; ".join(f"{n}: " + ", ".join(
                f"{k} " + "/".join(f"{x:.4f}" for x in v) for k, v in t.items())
                for n, t in s["two_kernel"].items()), flush=True)
    return kernel_ab.finish({"card": runs[0]["card"], "summary": summary, "runs": runs}, out,
                            [r for run in runs for r in run["failures"]])


_GROUP = "constexpr int kHeadGroup = 8;"
_ATOMICS = """      const int dq_rows = min(kQRows, p.Sq - q0);
      float* acc = p.dq_acc + b * p.qab + h * p.qah + dq_col0 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        if (row < dq_rows) {
          float* arow = acc + (int64_t)(q0 + row) * p.qas;
#pragma unroll
          for (int j = 0; j < L::kDqCols / 8; ++j) {
            atomicAdd(reinterpret_cast<float2*>(arow + 8 * j),
                      make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]));
          }
        }
      }
"""


def variants(header):
    """{copy: ({file: patches}, computes the same function)}: the decisions
    PERF.md cites, each changed alone."""
    start = '      if (ct == 0) asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");\n'
    end = '        asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");\n      }\n'
    a = header.index(start)
    reduce_block = header[a:header.index(end, a) + len(end)]  # the dQ tile's reduce-adds
    hdr, src = "flash_bwd_sm90.cuh", "flash_bwd.cu"
    return {
        "tree": ({}, True),
        # every head's first key block before any second one (the first build's order)
        "all_heads_first": ({hdr: [(_GROUP, "constexpr int kHeadGroup = 1 << 20;")]}, True),
        "heads_1": ({hdr: [(_GROUP, "constexpr int kHeadGroup = 1;")]}, True),
        "heads_4": ({hdr: [(_GROUP, "constexpr int kHeadGroup = 4;")]}, True),
        "heads_16": ({hdr: [(_GROUP, "constexpr int kHeadGroup = 16;")]}, True),
        "stages_3": ({hdr: [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]}, True),
        # dQ added by float32 atomics (two columns an instruction) from registers
        "atomics": ({hdr: [(reduce_block, _ATOMICS),
                           ("  __nv_bfloat16* dk;\n",
                            "  float* dq_acc;\n  int64_t qab, qah, qas;\n  __nv_bfloat16* dk;\n")],
                     src: [("    p.delta = delta;\n",
                            "    p.delta = delta;\n    p.dq_acc = dq_acc;\n    p.qab = strides[21], "
                            "p.qah = strides[22], p.qas = strides[23];\n")]}, True),
        "diag_no_dq_add": ({hdr: [("tma_reduce_add(&maps.dq,",
                                   "if (box < 0) tma_reduce_add(&maps.dq,")]}, False),
        "diag_no_dq": ({hdr: [("Wgmma<64>::tt(part<0, 32>(dq),",
                               "if (kk < 0) Wgmma<64>::tt(part<0, 32>(dq),"),
                              ("tma_reduce_add(&maps.dq,", "if (box < 0) tma_reduce_add(&maps.dq,")]},
                       False),
        "diag_no_exp": ({hdr: [("float x = ex2(s[4 * j + e] * scale2",
                                "float x = (s[4 * j + e] * scale2")]}, False),
    }


VARIANT_SHAPES = [  # chip_smoke.K4_SHAPES rows by label
    "llama train", "llama train ragged", "unet self 64x64",
]


def run_variants(out):
    cs = kernel_ab.child_module(ROOT)
    import torch

    from instructany2pix_tpu_torch.ops import _build
    from instructany2pix_tpu_torch.ops import flash_attention as fa

    table = variants((_build.CSRC / "flash_bwd_sm90.cuh").read_text())
    libs, ptxas = kernel_ab.build_copies(
        "flash_bwd", {name: files for name, (files, _) in table.items()}, "flash_bwd_wgmma")
    rows, failures = [], []
    for si, label, shape, sk, causal, kv, dname in _rows(cs):
        if label not in VARIANT_SHAPES:
            continue
        args = _inputs(si, tuple(shape), sk, causal, kv, dname)
        q, k, v, g, lse, delta, _, scale, kv_len = args
        o, _ = fa._reference_attention(q, k, v, causal, scale, True, kv_len)
        ref = fa.flash_bwd_reference(q, k, v, o, lse, g, causal, scale, kv_len, delta)
        sigmas = cs.k4_sigmas(fa, q, k, v, g, lse, delta, causal, scale, kv_len)
        row = {"label": label, "shape": shape, "sk": sk, "causal": causal, "kv_len": kv,
               "ms": {}, "of_limit": {}}

        def call():
            return fa.flash_bwd_cuda(*args)

        for name, so in libs.items():
            if table[name][1]:
                with kernel_ab.loaded("flash_bwd", so):
                    got = call()
                readings = [cs._reading(x, r, sg, cs.K4_TOL[dname])
                            for x, r, sg in zip(got, ref, sigmas)]
                row["of_limit"][name] = max(r["of_limit"] for r in readings)
                if not all(r["ok"] for r in readings):
                    failures.append(f"{name} {label}: outside K4_TOL")
                del got
        for _ in range(2):  # every copy twice, in turn
            for name, so in libs.items():
                with kernel_ab.loaded("flash_bwd", so):
                    row["ms"].setdefault(name, []).append(cs.time_ms(call, 20))
        # what the wrapper adds around the fused kernel: zeroing the float32
        # accumulator and rounding it into dq
        dq = torch.empty_like(q)
        row["zero_cast_ms"] = cs.time_ms(
            lambda: dq.copy_(torch.zeros_like(q, dtype=torch.float32)), 20)
        print(f"{label}: " + ", ".join(f"{n} {ms[0]:.4f}/{ms[1]:.4f}" for n, ms in row["ms"].items())
              + f"; zeroing and cast {row['zero_cast_ms']:.4f}", flush=True)
        rows.append(row)
        del q, k, v, g, o, lse, delta, ref, sigmas, dq, args
        torch.cuda.empty_cache()
    return kernel_ab.finish({"card": cs.card_line(), "ptxas": ptxas, "rows": rows,
                             "failures": failures}, out, failures)


def run_device(out):
    cs = kernel_ab.child_module(ROOT)
    import torch

    from instructany2pix_tpu_torch.ops import flash_attention as fa

    rows = []
    for si, label, shape, sk, causal, kv, dname in _rows(cs):
        args = _inputs(si, tuple(shape), sk, causal, kv, dname)

        def call():
            return fa.flash_bwd_cuda(*args)

        eager = cs.time_ms(call, 20)
        device, host = kernel_ab.device_host(cs, call)
        rows.append({"label": label, "shape": shape, "sk": sk, "causal": causal, "kv_len": kv,
                     "eager_ms": eager, "device_ms": device, "host_ms": host,
                     "bound_ms": cs.k4_bound(tuple(shape), sk, causal, kv, dname)["bwd"][0]})
        r = rows[-1]
        print(f"{label:24s} eager {eager:.4f} device {device} host {host:.4f} bound "
              f"{r['bound_ms']:.4f}", flush=True)
        del args
        torch.cuda.empty_cache()
    return kernel_ab.finish({"card": cs.card_line(), "rows": rows}, out, [])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another commit, unpacked: time it against this tree")
    ap.add_argument("--variants", action="store_true",
                    help="time the VARIANTS copies of the fused kernel")
    ap.add_argument("--device", action="store_true",
                    help="time this tree's rows eagerly, on the device and on the host")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write every row to this JSON file")
    args = ap.parse_args(argv)
    if args.child:
        child(Path(args.child[0]).resolve(), args.child[1])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k4_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.parent:
        return ab(Path(args.parent).resolve(), args.out)
    if args.variants:
        return run_variants(args.out)
    if args.device:
        return run_device(args.out)
    ap.error("give --parent, --variants or --device")


if __name__ == "__main__":
    sys.exit(main())
