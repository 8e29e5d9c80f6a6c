#!/usr/bin/env python3
"""K2 (the quantized decode matvec) on the card: this tree against another
commit.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

  python3 benchmarks_torch/k2_ab.py --parent build/parent --out build/k2_ab.json
      DIR holds another commit unpacked (`git archive <rev> | tar -x -C DIR`).
      In four processes in turn, parent, this tree, this tree, parent, each
      building and importing its own tree's port and timing with its own
      chip_smoke.py:
        * every QMV_SHAPES row of its chip_smoke.py (phase_qmv: checked
          against the plain version, then timed on weight copies larger
          than L2 as a CUDA graph of the calls and eagerly, beside the plain
          version and F.linear on bf16 weights); rows are matched between
          the trees by label and M;
        * FMA_ROWS, made here the same way in both trees: the CUDA-core
          path at int8 (quantize_llama's default bits; weight copies larger
          than L2) and at float32 activations with the tiny decode's
          shapes (its weights stay in L2, so one call is replayed);
        * the full-width decode step: a random Vicuna-7B decoder (int4
          group 128, fused projections, int8 lm_head, bf16; weights from a
          seed, the same in both trees) after a PROMPT-token prefill, the
          median of DECODE_STEPS steps (host clock around a synced step),
          and K2's share of the kernel time of three profiled steps
          (chip_smoke.profile_window).

  python3 benchmarks_torch/k2_ab.py --plans --out build/k2_plans.json
      In one process, every (cluster, ring) the kernel takes (clusters of
      1, 2, 4, 8 chunks; rings of 4 or 8 stages) at the 7B shapes and the
      int8 row, M = 1 and 16: checked against the plain version and timed
      as phase_qmv times K2. Prints the fastest of each shape as the
      entries of ops/quant.py's _PLANS.

  python3 benchmarks_torch/k2_ab.py --variants --out build/k2_variants.json
      Builds patched copies of csrc/qmv.cu under build/qmv_copies/ (VARIANTS:
      each undoes one design decision PERF.md cites, and computes the same
      function; TIMELINE: %globaltimer stamps at the kernel's phase
      boundaries) and, in one process, holds every copy against the plain
      version and times it (a CUDA graph over weight copies larger than L2)
      at the four 7B shapes at M = 1, the tree's own copy first and last;
      then the stamped copy gives each phase's time per block (median and
      max over the blocks of one call) at the four 7B shapes, M = 1 and 16.

The harness (builds, turns, patched copies) is kernel_ab.py's. The last
line of output is the JSON summary; --out also writes every row.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import sys
from pathlib import Path

import kernel_ab
from kernel_ab import ROOT

PROMPT = 320  # prefill tokens, about forward_llm's spliced prompt
DECODE_STEPS = 21
SEVEN_B = ("7B qkv + norm", "7B o + residual", "7B gate_up + norm", "7B down + swiglu + residual")
# each undoes one decision of csrc/qmv.cu; every one computes the same function
VARIANTS = {
    "tree": [],
    # the whole ring goes out right after x's requests, prologue or not
    "ring_before_prologue": [("  const bool late = p.has_norm || p.swiglu;",
                              "  const bool late = false;")],
    # the weights through L2 with the default policy
    "no_evict_first": [("    sm90::tma_load_2d_hint(sm90::smem_addr(ring + slot * kStageBytes), "
                        "&wmap, full + 8 * slot, n0,\n                           (s0 + s) * "
                        "kStageRows, stream_policy);",
                        "    sm90::tma_load_2d(sm90::smem_addr(ring + slot * kStageBytes), &wmap, "
                        "full + 8 * slot, n0, (s0 + s) * kStageRows);")],
    # silu from the IEEE exp and divide
    "precise_silu": [("round_act(__fdividef(v[j], 1.0f + __expf(-v[j])), p.act)",
                      "round_act(v[j] / (1.0f + expf(-v[j])), p.act)")],
}
PLAN_SHAPES = SEVEN_B + ("int8 per-channel",)
FMA_ROWS = [
    # (label, K, N, format, fusion, rows M, activations)
    ("fma int8 per-channel", 4096, 4096, "int8", "none", (1, 16), "bfloat16"),
    ("fma tiny fp32 qkv + norm", 256, 768, "int4g", "norm", (1,), "float32"),
    ("fma tiny fp32 o + residual", 256, 256, "int4g", "residual", (1,), "float32"),
    ("fma tiny fp32 gate_up + norm", 256, 1024, "int4g", "norm", (1,), "float32"),
    ("fma tiny fp32 down + swiglu + residual", 512, 256, "int4g", "swiglu+residual", (1,),
     "float32"),
]
TIMELINE_PHASES = ("x requested and staged", "statistics and x'", "main loop (warp 0)",
                   "warps' sums, pushed", "cluster barrier")
_STAMP = "  if (tid == 0) qmv_stamps[blockIdx.y * gridDim.x + blockIdx.x][{}] = stamp_now();\n"


def timeline_patches():
    """Patches of csrc/qmv.cu that stamp %globaltimer (ns) at each phase
    boundary of every block (by thread 0) and export the stamps."""
    fin = "  cluster.sync();\n  for (int i = tid; i < p.M * cols; i += kThreads) {"
    last = 'extern "C" int ia2p_qmv_last_path() { return g_last_path; }'
    return [
        ("namespace cg = cooperative_groups;",
         "namespace cg = cooperative_groups;\n__device__ unsigned long long qmv_stamps[8192][8];\n"
         "__device__ __forceinline__ unsigned long long stamp_now() {\n  unsigned long long t;\n"
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n  return t;\n}'),
        ("  const bool producer = warp == kConsumers;\n",
         "  const bool producer = warp == kConsumers;\n" + _STAMP.format(0)),
        ("    // 2. RMSNorm statistics:", _STAMP.format(1) + "    // 2. RMSNorm statistics:"),
        ("      // 4. consumer warp w takes", _STAMP.format(2) + "      // 4. consumer warp w takes"),
        ("    // 5. every warp's sums are in the ring",
         _STAMP.format(3) + "    // 5. every warp's sums are in the ring"),
        ("  // 6. rank r finishes", _STAMP.format(4) + "  // 6. rank r finishes"),
        (fin, fin.replace("  for (int i", _STAMP.format(5) + "  for (int i")),
        (last, last + '\nextern "C" int ia2p_qmv_stamps(void* dst, int n) {\n  return (int)'
         "cudaMemcpyFromSymbol(dst, qmv_stamps, size_t(n) * 64);\n}"),
    ]


def _decoder(seed=3):
    """Random Vicuna-7B decoder on the card, quantized layer by layer as
    the pipeline does (int4 group 128, int8 lm_head), projections fused."""
    import torch

    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.models import llama as llama_lib
    from instructany2pix_tpu_torch.ops import quant as Q

    cfg = llama_lib.LlamaConfig.vicuna_7b()
    gen = torch.Generator("cuda").manual_seed(seed)
    with torch.device("meta"):
        lm = llama_lib.Llama(cfg)
    with torch.no_grad():
        for name, child in list(lm.named_children()):
            setattr(lm, name, L.init_(L.materialize(child, torch.device("cuda"), torch.bfloat16),
                                      gen))
            Q.quantize_llama(lm, bits=4)
        llama_lib.fuse_projections(lm)
    return cfg, lm.eval().requires_grad_(False)


def _decode(cs):
    """Median decode step (ms) and K2's share of the profiled steps."""
    import time

    import torch

    from instructany2pix_tpu_torch.models import llama as llama_lib
    from instructany2pix_tpu_torch.ops import quant as Q

    cfg, lm = _decoder()
    gen = torch.Generator("cuda").manual_seed(4)
    emb = torch.randn((1, PROMPT, cfg.hidden_size), generator=gen, device="cuda").bfloat16()
    with torch.inference_mode():
        cache = llama_lib.KVCache.create(cfg, 1, max_len=PROMPT + DECODE_STEPS + 16,
                                         dtype=torch.bfloat16, device="cuda")
        o = llama_lib.forward(lm, cfg, inputs_embeds=emb, cache=cache)
        state = {"cache": o["cache"], "tok": o["logits"][:, -1].argmax(-1)}

        def step():
            o = llama_lib.forward(lm, cfg, inputs_embeds=llama_lib.embed(lm, state["tok"][:, None]),
                                  cache=state["cache"])
            state["cache"], state["tok"] = o["cache"], o["logits"][:, -1].argmax(-1)

        step()
        torch.cuda.synchronize()
        before = Q.qmv_cuda.launches
        times = []
        for _ in range(DECODE_STEPS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_step = (Q.qmv_cuda.launches - before) / DECODE_STEPS
        prof = cs.profile_window(step, "decode step", n=3)
    times.sort()
    out = {"decode_ms_median": times[len(times) // 2], "decode_ms_range": [times[0], times[-1]],
           "k2_launches_per_step": per_step}
    if prof is not None:
        k2 = prof["by_class"].get("k2", 0.0)
        out.update({"kernel_ms": prof["kernel_ms"], "k2_kernel_ms": k2,
                    "k2_of_kernel_time": k2 / prof["kernel_ms"],
                    "k2_kernels": prof.get("k2_kernels")})
    del lm
    torch.cuda.empty_cache()
    return out


def _shape_inputs(cs, label, m):
    """chip_smoke's inputs of the QMV_SHAPES row `label` at M = m, and the
    row."""
    si, row = next((i, r) for i, r in enumerate(cs.QMV_SHAPES) if r[0] == label)
    _, k, n, fmt, fusion, _, dname = row
    return cs._qmv_inputs(k, n, fmt, fusion, m, 1000 + si, dname), (k, n, fmt, fusion)


def _graph_ms(cs, Q, inputs):
    """K2's device time per call from a CUDA graph over weight copies that
    together exceed L2, as chip_smoke.phase_qmv times it."""
    q, x, gain, swiglu, r = inputs
    packed = q["w_q4"] if "w_q4" in q else q["w_q"]
    copies = [q] + [{kk: v.clone() for kk, v in q.items()}
                    for _ in range(-(-2 * cs.L2_BYTES // packed.numel()) - 1)]
    ms = cs.graph_ms([lambda c=c: Q.qmv_cuda(x, c, gain, 1e-6, swiglu, r) for c in copies])
    del copies
    return ms


def _fma_inputs(k, n, fmt, fusion, m, seed, dname):
    """Inputs of an FMA_ROWS row that both trees' kernels take: float32
    RMSNorm gains."""
    import torch

    from instructany2pix_tpu_torch.ops import quant as Q

    g = torch.Generator("cuda").manual_seed(seed)
    quant = {"int8": Q.quantize_weight, "int4g": Q.quantize_weight_int4_grouped}[fmt]
    q = quant(torch.randn((k, n), generator=g, device="cuda") * k**-0.5)
    swiglu = "swiglu" in fusion
    xk = 2 * k if swiglu else k
    dtype = getattr(torch, dname)
    x = torch.randn((m, xk), generator=g, device="cuda").to(dtype)
    gain = torch.randn(xk, generator=g, device="cuda") * 0.1 + 1.0 if "norm" in fusion else None
    r = torch.randn((m, n), generator=g, device="cuda").to(dtype) if "residual" in fusion else None
    return q, x, gain, swiglu, r


def _fma_rows(cs):
    """Every FMA_ROWS row on this tree's K2: its error against the plain
    version and its device time."""
    import torch

    from instructany2pix_tpu_torch.ops import quant as Q

    rows = []
    for si, (label, k, n, fmt, fusion, ms_, dname) in enumerate(FMA_ROWS):
        for m in ms_:
            inputs = _fma_inputs(k, n, fmt, fusion, m, 2000 + si, dname)
            q, x, gain, swiglu, r = inputs
            y = Q.qmv_cuda(x, q, gain, 1e-6, swiglu, r)
            err = (y.float() - Q._qmv_reference(x, q, gain, 1e-6, swiglu, r).float()).abs().max()
            packed = q["w_q4"] if "w_q4" in q else q["w_q"]
            cold = packed.numel() > cs.L2_BYTES // 8
            ms = (_graph_ms(cs, Q, inputs) if cold
                  else cs.graph_ms([lambda: Q.qmv_cuda(x, q, gain, 1e-6, swiglu, r)]))
            rows.append({"label": label, "m": m, "k": k, "n": n, "format": fmt, "dtype": dname,
                         "err": err.item(), "ms": ms, "weights": "cold" if cold else "in L2"})
            del inputs, q, x, gain, r, y
    torch.cuda.empty_cache()
    return rows


def run_plans(out):
    """Every (cluster, ring) at PLAN_SHAPES, M = 1 and 16."""
    cs = kernel_ab.child_module(ROOT)
    import torch

    from instructany2pix_tpu_torch.ops import quant as Q

    chosen = Q.qmv_plan
    failures, rows, best = [], [], []
    try:
        for label in PLAN_SHAPES:
            for m in (1, 16):
                inputs, (k, n, fmt, fusion) = _shape_inputs(cs, label, m)
                q, x, gain, swiglu, r = inputs
                base = chosen(m, k, n, fmt, x.dtype, swiglu, gain is not None)
                kstage = base.chunk // base.chunk_stages
                times, seen = {}, set()
                for cluster, ring in itertools.product((1, 2, 4, 8), (4, 8)):
                    cst = -(-base.stages // cluster)
                    plan = base._replace(chunk_stages=cst, chunk=cst * kstage,
                                         cluster=-(-base.stages // cst), ring=min(ring, cst))
                    if (plan.cluster, plan.ring) in seen:
                        continue
                    seen.add((plan.cluster, plan.ring))
                    Q.qmv_plan = lambda *a, _p=plan, **kw: _p
                    y = Q.qmv_cuda(x, q, gain, 1e-6, swiglu, r)
                    reading = cs.qmv_reading(y, Q._qmv_reference(x, q, gain, 1e-6, swiglu, r), q,
                                             x, gain, swiglu, r)
                    name = f"{plan.cluster}x{plan.ring}"
                    if not reading["ok"]:
                        failures.append(f"{label} M={m} plan {name}: {reading['of_limit']:.3g} "
                                        "of its limit")
                    times[name] = _graph_ms(cs, Q, inputs)
                    Q.qmv_plan = chosen
                fastest = min(times, key=times.get)
                row = {"label": label, "m": m, "k": k, "n": n, "format": fmt, "fusion": fusion,
                       "ms": times, "fastest": fastest}
                rows.append(row)
                print(json.dumps(row), flush=True)
                c, g = (int(v) for v in fastest.split("x"))
                best.append(f"    ({m}, {k}, {n}, {fmt!r}, {str(x.dtype).rpartition('.')[2]!r}, "
                            f"{swiglu}, {gain is not None}): ({c}, {g}),")
                del inputs, q, x, gain, r
                torch.cuda.empty_cache()
    finally:
        Q.qmv_plan = chosen
    print("_PLANS = {\n" + "\n".join(best) + "\n}", flush=True)
    return kernel_ab.finish({"card": cs.card_line(), "plans": rows, "table": best}, out, failures)


def _timeline(cs, Q, lib, label, m):
    """Each phase's time per block of one call (us): median and max."""
    import numpy as np
    import torch

    inputs, (k, n, fmt, fusion) = _shape_inputs(cs, label, m)
    q, x, gain, swiglu, r = inputs
    copies = [q] + [{kk: v.clone() for kk, v in q.items()} for _ in range(3)]
    for c in copies[1:] + copies[:1]:  # the weights of the stamped call come cold
        Q.qmv_cuda(x, c, gain, 1e-6, swiglu, r)
    torch.cuda.synchronize()
    plan = Q.qmv_plan(m, k, n, fmt, x.dtype, swiglu, gain is not None)
    blocks = plan.cluster * n // plan.tile
    stamps = np.zeros((blocks, 8), np.uint64)
    rc = lib.ia2p_qmv_stamps(ctypes.c_void_p(stamps.ctypes.data), blocks)
    if rc:
        raise RuntimeError(f"reading the stamps failed with CUDA error {rc}")
    t = stamps[:, :6].astype(np.int64)
    us = np.diff(t, axis=1) / 1e3
    out = {"label": label, "m": m, "blocks": blocks, "cluster": plan.cluster, "ring": plan.ring,
           "end_us": {"median": float(np.median((t[:, 5] - t[:, 0].min()) / 1e3)),
                      "max": float((t[:, 5].max() - t[:, 0].min()) / 1e3)},
           "start_spread_us": float((t[:, 0].max() - t[:, 0].min()) / 1e3)}
    for i, name in enumerate(TIMELINE_PHASES):
        out[name] = {"median": float(np.median(us[:, i])), "max": float(us[:, i].max())}
    return out


def run_variants(out):
    """Every VARIANTS copy checked and timed at the 7B shapes (M = 1), the
    tree's own first and last; then the stamped copy's phase times."""
    cs = kernel_ab.child_module(ROOT)
    import torch

    from instructany2pix_tpu_torch.ops import _build
    from instructany2pix_tpu_torch.ops import quant as Q

    copies = {name: {"qmv.cu": patches} for name, patches in VARIANTS.items()}
    copies["timeline"] = {"qmv.cu": timeline_patches()}
    libs, ptxas = kernel_ab.build_copies("qmv", copies, "qmv_kernel")
    failures, rows = [], []
    for name in list(VARIANTS) + ["tree"]:
        with kernel_ab.loaded("qmv", libs[name]):
            row = {"variant": name}
            for label in SEVEN_B:
                inputs, _ = _shape_inputs(cs, label, 1)
                q, x, gain, swiglu, r = inputs
                y = Q.qmv_cuda(x, q, gain, 1e-6, swiglu, r)
                reading = cs.qmv_reading(y, Q._qmv_reference(x, q, gain, 1e-6, swiglu, r), q, x,
                                         gain, swiglu, r)
                if not reading["ok"]:
                    failures.append(f"{name} {label}: {reading['of_limit']:.3g} of its limit")
                row[label] = _graph_ms(cs, Q, inputs)
                del inputs, y
                torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    timeline = []
    with kernel_ab.loaded("qmv", libs["timeline"]):
        lib = _build._LOADED["qmv"]
        lib.ia2p_qmv_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for label in SEVEN_B:
            for m in (1, 16):
                timeline.append(_timeline(cs, Q, lib, label, m))
                print(json.dumps(timeline[-1]), flush=True)
    return kernel_ab.finish({"card": cs.card_line(), "variants": rows, "timeline": timeline,
                             "ptxas": ptxas}, out, failures)


def child(tree, rows_json):
    """Time every QMV_SHAPES row and the decode step with the port and
    chip_smoke.py of `tree`."""
    cs = kernel_ab.child_module(tree)
    failures = []
    rows = []
    for r in cs.phase_qmv(failures, timed=True):
        rows.append({k: r.get(k) for k in (
            "label", "m", "k", "n", "format", "fusion", "dtype", "path", "cluster", "ok",
            "of_limit", "ms", "ms_eager", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    fma = _fma_rows(cs)
    decode = _decode(cs)
    print(json.dumps({"tree": str(tree), "card": cs.card_line(), "rows": rows, "fma": fma,
                      "decode": decode, "failures": failures}))


def ab(parent, out):
    runs = kernel_ab.in_turns(__file__, "qmv", parent, [])
    summary = []
    for row in runs[1]["rows"]:
        key = (row["label"], row["m"])
        match = [next((r for r in run["rows"] if (r["label"], r["m"]) == key), None)
                 for run in runs]
        if any(r is None for r in match):
            summary.append({"label": row["label"], "m": row["m"], "note": "not in both trees",
                            "change_ms": [row["ms"]]})
            continue
        p = [match[0]["ms"], match[3]["ms"]]
        c = [match[1]["ms"], match[2]["ms"]]
        pe = [match[0]["ms_eager"], match[3]["ms_eager"]]
        ce = [match[1]["ms_eager"], match[2]["ms_eager"]]
        summary.append({"label": row["label"], "m": row["m"], "path": row.get("path"),
                        "parent_ms": p, "change_ms": c, "change_vs_parent": sum(c) / sum(p) - 1,
                        "parent_eager_ms": pe, "change_eager_ms": ce,
                        "eager_change_vs_parent": sum(ce) / sum(pe) - 1,
                        "bound_ms": row["bound_ms"], "library_ms": row["library_ms"],
                        "plain_ms": row["plain_ms"]})
        s = summary[-1]
        print(f"K2 {row['label']:34s} M={row['m']:<2d} graph parent {p[0]:.4f} {p[1]:.4f} change "
              f"{c[0]:.4f} {c[1]:.4f} ({s['change_vs_parent']:+.1%}); eager parent {pe[0]:.4f} "
              f"{pe[1]:.4f} change {ce[0]:.4f} {ce[1]:.4f} ({s['eager_change_vs_parent']:+.1%}); "
              f"bound {row['bound_ms']:.4f} F.linear {row['library_ms']:.4f}", flush=True)
    for row in runs[1]["fma"]:
        key = (row["label"], row["m"])
        ms = [next(r["ms"] for r in run["fma"] if (r["label"], r["m"]) == key) for run in runs]
        p, c = [ms[0], ms[3]], [ms[1], ms[2]]
        summary.append({"label": row["label"], "m": row["m"], "path": "fma",
                        "weights": row["weights"], "parent_ms": p, "change_ms": c,
                        "change_vs_parent": sum(c) / sum(p) - 1,
                        "err": [r["err"] for run in runs for r in run["fma"]
                                if (r["label"], r["m"]) == key]})
        print(f"K2 {row['label']:34s} M={row['m']:<2d} graph ({row['weights']}) parent "
              f"{p[0]:.4f} {p[1]:.4f} change {c[0]:.4f} {c[1]:.4f} "
              f"({summary[-1]['change_vs_parent']:+.1%})", flush=True)
    decode = {f"{run['name']}#{i}": run["decode"] for i, run in enumerate(runs)}
    for name, d in decode.items():
        print(f"decode step {name}: median {d['decode_ms_median']:.3f} ms "
              f"(range {d['decode_ms_range'][0]:.3f}-{d['decode_ms_range'][1]:.3f}), K2 launches "
              f"{d['k2_launches_per_step']:.0f} per step, K2 {d.get('k2_kernel_ms', 0):.3f} ms = "
              f"{d.get('k2_of_kernel_time', 0):.1%} of {d.get('kernel_ms', 0):.3f} ms of kernels",
              flush=True)
    return kernel_ab.finish({"card": runs[0]["card"], "summary": summary, "decode": decode,
                             "runs": runs}, out, [r for run in runs for r in run["failures"]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another commit, unpacked: time it against this tree")
    ap.add_argument("--plans", action="store_true",
                    help="time every cluster and ring size at the 7B shapes")
    ap.add_argument("--variants", action="store_true",
                    help="time the VARIANTS copies of the kernel and the stamped copy's phases")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write every row to this JSON file")
    args = ap.parse_args(argv)
    if args.child:
        child(Path(args.child[0]).resolve(), args.child[1])
        return 0
    if not (args.parent or args.variants or args.plans):
        ap.error("give --parent, --plans or --variants")
    import torch

    if not torch.cuda.is_available():
        print("k2_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.plans:
        return run_plans(args.out)
    if args.variants:
        return run_variants(args.out)
    return ab(Path(args.parent).resolve(), args.out)


if __name__ == "__main__":
    sys.exit(main())
