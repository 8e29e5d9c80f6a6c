#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure makes the exit code non-zero; the last line is
printed only when every phase passed):
  1. print the card (nvidia-smi name, power limit); build every CUDA
     source in instructany2pix_tpu_torch/csrc with nvcc, one process per
     source, all at once, and print the build time and ptxas report;
  2. K1 (flash-attention forward) against its plain PyTorch version on
     the card, bf16 and fp32, at the shapes the SDXL path gives it plus
     the ImageBind and Llama shapes, on contiguous inputs and on the
     (B, S, H, D) views the router passes, within a limit scaled to each
     element (TOL); times K1, the plain version and
     F.scaled_dot_product_attention (the yardstick, never called by the
     port) with CUDA events;
  3. K2 (the quantized decode matvec) against its plain version in bf16
     at the four fused Vicuna-7B decode shapes (M = 1 and 16), the unfused
     int8 and int4 formats and the four shapes of the TPU probe, within a
     limit scaled to each element (QMV_TOL); times K2 on weights that do
     not stay in L2 (device time from a CUDA graph of the calls, and the
     eager time with the host's launch cost), the plain version, and
     F.linear on bf16 weights dequantized ahead of time (the yardstick,
     never called by the port);
  4. the full width: PipelineConfig() in bf16 with random weights from a
     seed: Vicuna-7B int4 group-128 with fused projections (int8 lm_head),
     ImageBind-huge vision and audio, the GPT-2 prior and its CLIP-ViT-H
     text tower, SDXL base with IP, the refiner, the VAE, CLIP-L and bigG.
     Two text2img requests (plain, and IP) with exact K1 counts; one CFG
     UNet step timed and profiled; then the edit: `forward_llm` on a
     written PNG and WAV (K2 launched exactly 128 times per decode step,
     K1 by the ImageBind trunks), the prefill and per-token decode times
     against their bound with K2's share of a decode step from
     torch.profiler, and `__call__` on a seeded LLM cache (finite
     1024x1024 images, exact K1 count, seconds per stage, peak memory);
  5. the tiny config in fp32 on the card against the same weights on the
     CPU, with a small int4-grouped LLM: text2img and edit images agree
     within 1 level (the edit also with subject consistency through a tiny
     SAM), greedy tokens are identical.
After phase 3, K3 (SAM's rel-pos flash attention) against its plain
version in bf16 at the SAM ViT-H global and window shapes, two ragged
grids and head_dim 64, on contiguous inputs, on (B, N, H, D) views and
on the chunks of a fused qkv projection that SAM passes (TOL), timed
beside F.scaled_dot_product_attention with the bias as a (B, H, N, N)
mask (the yardstick); float32 must be refused. Phase 4 then
adds the full-width subject consistency: `__call__` with
`subject_strength` through a random SAM ViT-H segmentor in bf16 (K3
launched exactly 4 times per segmentor call, a non-empty mask, a finite
1024x1024 image, seconds per stage, peak memory), and the random
GroundingDINO Swin-T grounder (float32) on the edited image. Every
main-path run reads the K1, K2 and K3 counters, set to 0 just before it;
K3 must stay at 0 outside subject consistency.
Then a {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}. `--out PATH` also writes every reading
as JSON.

`python3 chip_smoke.py --planted-faults` runs the checks of phases 2 and
3 and of K3 against deliberately broken copies of K1 (FAULTS), K2
(QMV_FAULTS) and K3 (K3_FAULTS) instead, and exits 0 only if the real
kernels pass at every shape and each broken copy is refused.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

STEPS = 10  # denoise steps per full-width request
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense (data sheet)
HBM_BYTES_PER_S = 3.35e12
# K1 vs the plain version, per element of o:
#   |o - o_ref| <= RTOL * |o_ref| + STOL * sigma,  sigma = sqrt(sum_j p_j^2 v_j^2)
# sigma is the scale of the noise that independent relative errors in the
# p_j put into o. In bf16 both sides round o to bf16 (together at most one
# ulp, <= 2^-7 |o|) and round p at different points (K1 the unnormalized
# p, the plain version the normalized one), each at most 2^-8 relative per
# key: a sum over keys whose standard deviation stays under 2^-8 sigma, so
# 2^-5 sigma is 8 of those. In fp32 the two differ only in summation order
# and the last bits of exp, a few units of 2^-24 per term: 2^-15 leaves
# room for the sums over up to 4096 keys. The lse is float32 on both sides
# and differs only in summation order.
TOL = {
    "bfloat16": {"rtol": 2**-7, "stol": 2**-5, "lse": 1e-4},
    "float32": {"rtol": 2**-15, "stol": 2**-15, "lse": 1e-4},
}
# Deliberately broken copies of K1 that the check above must refuse
# (`--planted-faults`): (what it breaks, source text, replacement).
FAULTS = {
    "mma_skip_rescale": (
        "tensor-core path: the accumulator of the first row of each fragment is "
        "not rescaled when the running max grows",
        "      oacc[n][0] *= alpha[0];\n      oacc[n][1] *= alpha[0];\n", ""),
    "mma_drop_first_tile": (
        "tensor-core path: the first 64-key tile is skipped",
        "for (int kt = 0; kt < kend; kt += kMmaKeys)",
        "for (int kt = kMmaKeys; kt < kend; kt += kMmaKeys)"),
    "mma_q_row_stride": (
        "tensor-core path: q rows are read with stride D, right only for (B,H,S,D) "
        "contiguous q",
        "(qp + (int64_t)row * st.qs + col)", "(qp + (int64_t)row * D + col)"),
    "fma_skip_rescale": (
        "scalar path: the accumulator is not rescaled when the running max grows",
        "for (int i = 0; i < DT; ++i) acc[i] *= alpha;",
        "for (int i = 0; i < DT; ++i) acc[i] *= 1.f;"),
}
K1_SHAPES = [
    # (label, (B, H, Sq, D), Sk, causal)
    ("unet self 64x64", (2, 10, 4096, 64), 4096, False),
    ("unet self 32x32", (2, 20, 1024, 64), 1024, False),
    ("unet text cross", (2, 10, 4096, 64), 77, False),
    ("unet ip cross", (2, 10, 4096, 64), 4, False),
    ("imagebind vit-h", (1, 16, 257, 80), 257, False),
    ("llama causal", (1, 32, 600, 128), 600, True),
    ("llama causal sq<sk", (1, 32, 64, 128), 600, True),
    ("head_dim 72 (fma path)", (1, 4, 300, 72), 200, False),
]

# K2 vs its plain version, per output element:
#   |y - y_ref| <= 2^-7 max(|y_ref|, |y_ref - r|) + 2^-6 sigma + 2^-14 A
# with sigma = sqrt(sum_k (x'_k W_kn)^2) and A = sum_k |x'_k W_kn| over the
# dequantized W. Both sides round the float32 sum to bf16 and again after
# the residual r: one bf16 ulp (2^-7) of either value. The prologue's
# statistics and silu are computed in another order on each side, so a
# rounded x'_k may land on the neighbouring bf16 value (2^-8 relative): a
# sum whose spread is under 2^-8 sigma, and 2^-6 sigma is 4 of those. The
# float32 sums over K <= 11008 terms in another order differ by about
# sqrt(K) 2^-24 A < 2^-17 A; 2^-14 A is 8 of those.
QMV_TOL = {"ulp": 2.0**-7, "stol": 2.0**-6, "atol": 2.0**-14}
QMV_SHAPES = [
    # (label, K, N, format, fusion, rows M)
    ("7B qkv + norm", 4096, 12288, "int4g", "norm", (1, 16)),
    ("7B o + residual", 4096, 4096, "int4g", "residual", (1, 16)),
    ("7B gate_up + norm", 4096, 22016, "int4g", "norm", (1, 16)),
    ("7B down + swiglu + residual", 11008, 4096, "int4g", "swiglu+residual", (1, 16)),
    ("int8 per-channel", 4096, 4096, "int8", "none", (1,)),
    ("int4 per-channel", 4096, 11008, "int4", "none", (1,)),
    # the TPU probe's shapes (benchmarks/qmv_dma_probe.py:29), int4 group 128
    ("probe qkv", 4096, 12288, "int4g", "none", (1,)),
    ("probe o", 4096, 4096, "int4g", "none", (1,)),
    ("probe up", 4096, 11008, "int4g", "none", (1,)),
    ("probe down", 11008, 4096, "int4g", "none", (1,)),
]
# Deliberately broken copies of K2 that the check must refuse.
QMV_FAULTS = {
    "hi_nibble_unsigned": (
        "int4: the high nibble is read without sign extension",
        "const float hi = (float)(int32_t(wd << (24 - 8 * c)) >> 28);",
        "const float hi = (float)((wd >> (8 * c + 4)) & 0xFu);"),
    "group_scale_first": (
        "int4 group 128: every group of a chunk takes the chunk's first group scale",
        "const int gidx = k0 / p.group + gs / gb;", "const int gidx = k0 / p.group;"),
    "residual_dropped": (
        "the residual is not added",
        "  if (p.residual) y = round_act(y + load_act(p.residual, o, p.act), p.act);\n", ""),
}
# K3 vs its plain version: the limit of K1 (TOL, bfloat16); K3 takes bf16 only.
K3_SHAPES = [
    # (label, B, H, g, D): N = g^2 tokens
    ("sam global block", 1, 16, 64, 80),
    ("sam window block", 25, 16, 14, 80),
    ("ragged g=40", 2, 16, 40, 80),
    ("ragged g=9", 3, 4, 9, 80),
    ("head_dim 64", 1, 12, 64, 64),
]
# Deliberately broken copies of K3 (its bias policy in csrc/flash_fwd.cu)
# that the check must refuse.
K3_FAULTS = {
    "bias_indices_swapped": (
        "bh is read at the key's column and bw at its row",
        "smem[lrow * gp + c.u] + smem[(kMmaRows + lrow) * gp + c.w];",
        "smem[lrow * gp + c.w] + smem[(kMmaRows + lrow) * gp + c.u];"),
    "bias_first_tile_only": (
        "the bias is added in the first 64-key tile only",
        "const float logit = bias.add(s[j][e] * scale, bias_s, lrows[r], bc);",
        "const float logit = kt == 0 ? bias.add(s[j][e] * scale, bias_s, lrows[r], bc) : s[j][e] * scale;"),
    "bias_rows_unpadded": (
        "bh is staged with an unpadded row stride and read with the padded one",
        "smem[r * gp + c] = ok ? bh[base + i] : 0.f;", "smem[r * G + c] = ok ? bh[base + i] : 0.f;"),
}
SUBJECT_STRENGTH = 0.5  # subject inpaint at full width: 25 steps of the 50-step grid
L2_BYTES = 50 * 2**20
EDIT_STEPS = 10  # edit inversion and denoise steps at full width (the refiner keeps its 50-step grid)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(calls, min_calls=24, reps=5):
    """Device time per call, from a CUDA graph replaying the calls (cycled
    to at least `min_calls`): the host's launch cost is left out, which
    eager timing of a call of a few microseconds cannot do."""
    import torch

    calls = calls * -(-min_calls // len(calls))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(calls))
    del graph
    return ms


def k1_bound(shape, sk, causal, dtype_name):
    b, h, sq, d = shape
    if causal:
        off = sk - sq
        pairs = sum(min(sk, max(0, i + off + 1)) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4.0 * b * h * d * pairs
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * b * h * d * (2 * sq + 2 * sk)  # q, k, v read once, o written once
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes"), flops


def bshd_view(x):
    """The same values with the strides the router passes to K1: a (B, S,
    H, D) tensor viewed as (B, H, S, D)."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def k1_reference(fa, q, k, v, causal, scale):
    """The plain version's o and lse, and the per-element limit on
    |o - o_ref| (see TOL)."""
    import torch

    o_ref, lse_ref = fa._reference_attention(q, k, v, causal, scale, return_lse=True)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        s = s.masked_fill(~torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq),
                          fa.NEG_INF)
    p = torch.softmax(s, dim=-1)
    del s
    sigma = torch.matmul(p.square_(), v.float().square()).sqrt_()
    tol = TOL[str(q.dtype).split(".")[-1]]
    return o_ref, lse_ref, tol["rtol"] * o_ref.float().abs() + tol["stol"] * sigma


def k1_reading(o, lse, ref):
    """Max |o - o_ref|, the largest share of its limit, max |lse - lse_ref|,
    and whether every element is within its limit (NaN fails)."""
    o_ref, lse_ref, limit = ref
    diff = (o.float() - o_ref.float()).abs()
    err_l = (lse - lse_ref).abs().max().item()
    tol = TOL[str(o.dtype).split(".")[-1]]
    ok = bool((diff <= limit).all()) and err_l <= tol["lse"]
    return {"err_o": diff.max().item(), "of_limit": (diff / limit).max().item(),
            "err_lse": err_l, "ok": ok}


def phase_kernels(failures, timed=True):
    """K1 against its plain version at every K1_SHAPES entry, in bf16 and
    fp32, on (B, H, S, D)-contiguous inputs and on the (B, S, H, D) views
    the router passes; with `timed`, also K1, the plain version and SDPA
    timed with CUDA events."""
    import torch

    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    # the plain version's bf16 P.V accumulates in fp32 all the way through
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rows = []
    try:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            for label, shape, sk, causal in K1_SHAPES:
                rows.append(_k1_row(failures, timed, dtype, dname, label, shape, sk, causal))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    torch.cuda.empty_cache()
    return rows


def _k1_row(failures, timed, dtype, dname, label, shape, sk, causal):
    import torch
    import torch.nn.functional as F

    from instructany2pix_tpu_torch.ops import flash_attention as fa

    b, h, sq, d = shape
    g = torch.Generator("cuda").manual_seed(1234)
    q = torch.randn(shape, generator=g, device="cuda").to(dtype)
    k = torch.randn((b, h, sk, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, h, sk, d), generator=g, device="cuda").to(dtype)
    scale = d**-0.5
    ref = k1_reference(fa, q, k, v, causal, scale)
    views = tuple(bshd_view(x) for x in (q, k, v))
    readings = []
    for lq, lk, lv in ((q, k, v), views):
        o, lse = fa.flash_fwd_cuda(lq, lk, lv, causal, scale, return_lse=True)
        readings.append(k1_reading(o, lse, ref))
    ok = all(r["ok"] for r in readings)
    # the tensor-core path takes bf16 with head_dim 64, 80 or 128 on 16-byte
    # aligned rows (all of these tensors)
    path = "mma" if dname == "bfloat16" and d in (64, 80, 128) else "fma"
    row = {
        "label": label, "dtype": dname, "path": path, "shape": list(shape), "sk": sk,
        "causal": causal, "ok": ok,
        "err_o": max(r["err_o"] for r in readings),
        "of_limit": max(r["of_limit"] for r in readings),
        "of_limit_bhsd": readings[0]["of_limit"],
        "of_limit_bshd": readings[1]["of_limit"],
        "err_lse": max(r["err_lse"] for r in readings),
        "limit_median": ref[2].median().item(),
    }
    if not ok:
        failures.append(f"K1 {label} {dname}: |o| {row['err_o']:.3g} = {row['of_limit']:.3g} of "
                        f"its limit, |lse| {row['err_lse']:.3g}")
    msg = (f"K1 {label:22s} {dname:8s} {path} {str(shape):18s} sk={sk:<5d} causal={int(causal)} "
           f"|o|={row['err_o']:.3g} (of limit: bhsd {row['of_limit_bhsd']:.3f}, bshd "
           f"{row['of_limit_bshd']:.3f}; limit median {row['limit_median']:.3g}) "
           f"|lse|={row['err_lse']:.3g} (tol {TOL[dname]['lse']:g})")
    if timed:
        iters = 20 if sq * sk >= 1 << 20 else 100
        row["ms"] = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale), iters)
        row["ms_bshd"] = time_ms(lambda: fa.flash_fwd_cuda(*views, causal, scale), iters)
        row["plain_ms"] = time_ms(lambda: fa._reference_attention(q, k, v, causal, scale), iters)
        # SDPA as the yardstick: is_causal lets it keep its fused kernels when
        # Sq == Sk; end-aligned causal with Sq < Sk needs an explicit mask
        sdpa = {"scale": scale}
        if causal and sq == sk:
            sdpa["is_causal"] = True
        elif causal:
            sdpa["attn_mask"] = torch.ones(sq, sk, dtype=torch.bool, device="cuda").tril(sk - sq)
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), iters)
        row["bound_ms"], row["bound_by"], flops = k1_bound(shape, sk, causal, dname)
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        msg += (f" ms={row['ms']:.4f} (bshd {row['ms_bshd']:.4f}) plain={row['plain_ms']:.4f} "
                f"sdpa={row['library_ms']:.4f} bound={row['bound_ms']:.4f} ({row['bound_by']}) "
                f"{row['tflops']:.1f} TFLOP/s")
    log(msg + (" ok" if ok else " FAIL"))
    return row


def qmv_bound(m, k, n, xk, fmt, fusion):
    """Least time for one K2 call: bytes (packed W, scales, x, g, residual,
    out, each once) over 3.35 TB/s, or the multiply-adds over the peak for
    their type (int4 formats multiply float32 activations, 67 TFLOP/s on
    the CUDA cores; int8 multiplies bf16 ones, 989 TFLOP/s)."""
    wbytes = (k // 2 if fmt != "int8" else k) * n
    sbytes = 4 * n * (k // 128 if fmt == "int4g" else 1)
    nbytes = wbytes + sbytes + 2 * m * xk + 2 * m * n
    if "norm" in fusion:
        nbytes += 4 * xk
    if "residual" in fusion:
        nbytes += 2 * m * n
    flops = 2.0 * m * k * n
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["float32" if fmt != "int8" else "bfloat16"]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations"), nbytes


def _qmv_inputs(k, n, fmt, fusion, m, seed):
    import torch

    from instructany2pix_tpu_torch.ops import quant as Q

    g = torch.Generator("cuda").manual_seed(seed)
    quant = {"int8": Q.quantize_weight, "int4": Q.quantize_weight_int4,
             "int4g": Q.quantize_weight_int4_grouped}[fmt]
    q = quant(torch.randn((k, n), generator=g, device="cuda") * k**-0.5)
    swiglu = "swiglu" in fusion
    xk = 2 * k if swiglu else k
    x = torch.randn((m, xk), generator=g, device="cuda").bfloat16()
    gain = (torch.randn(xk, generator=g, device="cuda") * 0.1 + 1.0) if "norm" in fusion else None
    r = (torch.randn((m, n), generator=g, device="cuda").bfloat16() if "residual" in fusion
         else None)
    return q, x, gain, swiglu, r


def _dequant(q):
    import torch

    from instructany2pix_tpu_torch.ops import quant as Q

    if "w_q" in q:
        return q["w_q"].float() * q["scale"][None]
    w = Q.unpack_int4(q["w_q4"]).float()
    if "gscale" in q:
        return w * q["gscale"].repeat_interleave(w.shape[0] // q["gscale"].shape[0], 0)
    return w * q["scale"][None]


def qmv_reading(y, ref, q, x, gain, swiglu, r):
    """Max |y - y_ref|, the largest share of its limit (QMV_TOL) and
    whether every element is within it (NaN fails)."""
    import torch

    from instructany2pix_tpu_torch.ops import quant as Q

    xin = x if "w_q" in q or gain is not None or swiglu else x.float()
    h = Q._prologue(xin, gain, 1e-6, swiglu).float()
    wd = _dequant(q)
    sigma = torch.sqrt((h * h) @ (wd * wd))
    a = h.abs() @ wd.abs()
    del wd
    ref = ref.float()
    pre = ref - r.float() if r is not None else ref
    limit = (QMV_TOL["ulp"] * torch.maximum(ref.abs(), pre.abs()) + QMV_TOL["stol"] * sigma
             + QMV_TOL["atol"] * a)
    diff = (y.float() - ref).abs()
    return {"err": diff.max().item(), "of_limit": (diff / limit).max().item(),
            "ok": bool((diff <= limit).all())}


def phase_qmv(failures, timed=True):
    """K2 against its plain version at every QMV_SHAPES entry, in bf16; with
    `timed`, K2 (rotating weight copies that together exceed L2, as decode
    finds its weights cold; a CUDA graph of the calls, and eager), the
    plain version and F.linear on bf16 weights dequantized ahead of time,
    timed with CUDA events."""
    import torch
    import torch.nn.functional as F

    from instructany2pix_tpu_torch.ops import quant as Q

    rows = []
    for si, (label, k, n, fmt, fusion, ms_) in enumerate(QMV_SHAPES):
        for m in ms_:
            q, x, gain, swiglu, r = _qmv_inputs(k, n, fmt, fusion, m, 1000 + si)
            xk = x.shape[1]
            y = Q.qmv_cuda(x, q, gain, 1e-6, swiglu, r)
            ref = Q._qmv_reference(x, q, gain, 1e-6, swiglu, r)
            row = {"label": label, "format": fmt, "fusion": fusion, "m": m, "k": k, "n": n,
                   **qmv_reading(y, ref, q, x, gain, swiglu, r)}
            chunk, ksplit = Q.qmv_plan(m, k, n, 128 if fmt == "int4g" else 0)
            row["chunk"], row["ksplit"] = chunk, ksplit
            if not row["ok"]:
                failures.append(f"K2 {label} M={m}: |y| {row['err']:.3g} = "
                                f"{row['of_limit']:.3g} of its limit")
            msg = (f"K2 {label:28s} {fmt:5s} M={m:<2d} K={k:<5d} N={n:<5d} split {ksplit:2d}x{chunk:<4d} "
                   f"|y|={row['err']:.3g} (of limit {row['of_limit']:.3f})")
            if timed:
                row["bound_ms"], row["bound_by"], nbytes = qmv_bound(m, k, n, xk, fmt, fusion)
                wkey = "w_q4" if "w_q4" in q else "w_q"
                copies = [q] + [{kk: v.clone() for kk, v in q.items()}
                                for _ in range(-(-2 * L2_BYTES // q[wkey].numel()) - 1)]
                calls = [lambda c=c: Q.qmv_cuda(x, c, gain, 1e-6, swiglu, r) for c in copies]
                row["ms"] = graph_ms(calls)
                it = iter(range(1 << 30))
                row["ms_eager"] = time_ms(lambda: calls[next(it) % len(calls)](), 200, warmup=5)
                row["weight_copies"] = len(copies)
                del copies, calls
                row["plain_ms"] = time_ms(lambda: Q._qmv_reference(x, q, gain, 1e-6, swiglu, r), 3, 1)
                h = Q._prologue(x, gain, 1e-6, swiglu)
                wt = _dequant(q).T.contiguous().bfloat16()
                lib = [wt] + [wt.clone() for _ in range(-(-2 * L2_BYTES // (2 * wt.numel())) - 1)]
                row["library_ms"] = graph_ms([lambda w=w: F.linear(h, w) for w in lib])
                del lib, wt
                row["gbps"] = nbytes / (row["ms"] * 1e-3) / 1e9
                msg += (f" ms={row['ms']:.4f} (eager {row['ms_eager']:.4f}) plain={row['plain_ms']:.4f} "
                        f"F.linear(bf16 W)={row['library_ms']:.4f} bound={row['bound_ms']:.4f} "
                        f"({row['bound_by']}) {row['gbps']:.0f} GB/s")
            log(msg + (" ok" if row["ok"] else " FAIL"))
            rows.append(row)
            del q, x, gain, r, y, ref
    torch.cuda.empty_cache()
    return rows


def k3_bound(b, h, g, d):
    """Least time for one K3 call: 4·B·H·N²·D operations over the bf16
    tensor-core peak, or q, k, v, o (bf16) and bh, bw (float32) moved once
    over 3.35 TB/s."""
    n = g * g
    flops = 4.0 * b * h * n * n * d
    nbytes = 2 * 4 * b * h * n * d + 4 * 2 * b * h * n * g
    t_ops, t_mem = flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes"), flops


def _k3_inputs(b, h, g, d, seed):
    import torch

    n = g * g
    gen = torch.Generator("cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").bfloat16() for _ in range(3))
    # rel-pos biases of SAM's size: q . R, |R| ~ 1 per dim, over sqrt(d)
    bh, bw = (torch.randn((b, h, n, g), generator=gen, device="cuda") for _ in range(2))
    return q, k, v, bh, bw


def k3_reference(fa, q, k, v, bh, bw, scale):
    """The plain version's o and the per-element limit (TOL, bf16)."""
    import torch

    b, h, n, _ = q.shape
    g = bh.shape[-1]
    o_ref = fa._reference_relpos2d(q, k, v, bh, bw, scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = (s.view(b, h, n, g, g) + bh[..., :, None] + bw[..., None, :]).view(b, h, n, n)
    p = torch.softmax(s, dim=-1)
    del s
    sigma = torch.matmul(p.square_(), v.float().square()).sqrt_()
    tol = TOL["bfloat16"]
    return o_ref, tol["rtol"] * o_ref.float().abs() + tol["stol"] * sigma


def qkv_views(q, k, v):
    """The same values with the strides SAM's encoder passes to K3: q, k
    and v as (B, N, H, D) chunks of one fused (B, N, 3*H*D) projection,
    viewed as (B, H, N, D) (a token stride of 3*H*D)."""
    import torch

    b, h, n, d = q.shape
    qkv = torch.cat([x.transpose(1, 2).reshape(b, n, h * d) for x in (q, k, v)], dim=-1)
    return tuple(t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))


def phase_k3(failures, timed=True):
    """K3 against its plain version at every K3_SHAPES entry, in bf16, on
    (B, H, N, D)-contiguous inputs, on (B, N, H, D) views and on the
    chunks of a fused qkv projection that SAM's encoder passes; float32
    must be refused. With `timed`, K3, the plain version and SDPA
    with the bias as a dense mask, timed with CUDA events."""
    import torch
    import torch.nn.functional as F

    from instructany2pix_tpu_torch.ops import flash_attention as fa

    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rows = []
    try:
        for si, (label, b, h, g, d) in enumerate(K3_SHAPES):
            q, k, v, bh, bw = _k3_inputs(b, h, g, d, 2000 + si)
            scale = d**-0.5
            o_ref, limit = k3_reference(fa, q, k, v, bh, bw, scale)
            views = tuple(bshd_view(x) for x in (q, k, v))
            readings = []
            for lq, lk, lv in ((q, k, v), views, qkv_views(q, k, v)):
                o = fa.flash_relpos2d_cuda(lq, lk, lv, bh, bw, scale)
                diff = (o.float() - o_ref.float()).abs()
                readings.append({"err": diff.max().item(), "of_limit": (diff / limit).max().item(),
                                 "ok": bool((diff <= limit).all())})
            row = {"label": label, "shape": [b, h, g * g, d], "g": g, "dtype": "bfloat16",
                   "ok": all(r["ok"] for r in readings),
                   "err_o": max(r["err"] for r in readings),
                   "of_limit": max(r["of_limit"] for r in readings),
                   "of_limit_bhsd": readings[0]["of_limit"], "of_limit_bshd": readings[1]["of_limit"],
                   "of_limit_qkv": readings[2]["of_limit"]}
            if not row["ok"]:
                failures.append(f"K3 {label}: |o| {row['err_o']:.3g} = {row['of_limit']:.3g} of its limit")
            msg = (f"K3 {label:17s} (B,H,N,D)=({b},{h},{g * g},{d}) g={g:<3d} |o|={row['err_o']:.3g} "
                   f"(of limit: bhsd {row['of_limit_bhsd']:.3f}, bshd {row['of_limit_bshd']:.3f}, "
                   f"qkv {row['of_limit_qkv']:.3f})")
            if timed:
                iters = 20 if g * g >= 1024 else 100
                row["ms"] = time_ms(lambda: fa.flash_relpos2d_cuda(q, k, v, bh, bw, scale), iters)
                row["ms_bshd"] = time_ms(lambda: fa.flash_relpos2d_cuda(*views, bh, bw, scale), iters)
                row["plain_ms"] = time_ms(lambda: fa._reference_relpos2d(q, k, v, bh, bw, scale), iters)
                n = g * g
                mask = (bh[..., :, None] + bw[..., None, :]).view(b, h, n, n).bfloat16()
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale), iters)
                del mask
                row["bound_ms"], row["bound_by"], flops = k3_bound(b, h, g, d)
                row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
                msg += (f" ms={row['ms']:.4f} (bshd {row['ms_bshd']:.4f}) plain={row['plain_ms']:.4f} "
                        f"sdpa+mask={row['library_ms']:.4f} bound={row['bound_ms']:.4f} "
                        f"({row['bound_by']}) {row['tflops']:.1f} TFLOP/s")
            log(msg + (" ok" if row["ok"] else " FAIL"))
            rows.append(row)
            del q, k, v, bh, bw, o_ref, limit, views
        # K3 takes bf16 only: its wrapper refuses float32 rather than run it
        x, bias = torch.zeros((1, 2, 64, 80), device="cuda"), torch.zeros((1, 2, 64, 8), device="cuda")
        try:
            fa.flash_relpos2d_cuda(x, x, x, bias, bias, 0.1)
            failures.append("K3: the wrapper took float32 q/k/v")
        except ValueError as e:
            log(f"K3 float32: refused by the wrapper ({e})")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    torch.cuda.empty_cache()
    return rows


def _build_faults(src_name, faults):
    """Write and build each broken copy of csrc/<src_name>.cu under
    build/faults; returns {fault: library path}."""
    from instructany2pix_tpu_torch.ops import _build

    src = (_build.CSRC / f"{src_name}.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, old, new) in faults.items():
        if src.count(old) != 1:
            raise RuntimeError(f"fault {name}: its source text is not in {src_name}.cu exactly once")
        cu = out_dir / f"{src_name}_{name}.cu"
        cu.write_text(src.replace(old, new))
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for fault {name}:\n{out}")
    return {name: so for name, (so, _) in procs.items()}


def planted_faults(failures):
    """Build each FAULTS copy of K1, QMV_FAULTS copy of K2 and K3_FAULTS copy
    of K3 (under build/faults), run the kernel's check with it in place of
    the kernel, and require that the real kernels pass at every shape while
    each copy is refused at one shape at least."""
    import ctypes

    from instructany2pix_tpu_torch.ops import _build

    result = {"faults": {}}
    kernels = (
        ("K1", "flash_fwd", FAULTS, phase_kernels,
         lambda r: f"{r['label']} {r['dtype']}", lambda r: [r["of_limit_bhsd"], r["of_limit_bshd"]]),
        ("K2", "qmv", QMV_FAULTS, phase_qmv, lambda r: f"{r['label']} M={r['m']}",
         lambda r: r["of_limit"]),
        ("K3", "flash_fwd", K3_FAULTS, phase_k3, lambda r: r["label"],
         lambda r: [r["of_limit_bhsd"], r["of_limit_bshd"], r["of_limit_qkv"]]),
    )
    for kernel, src_name, faults, check, key, reading in kernels:
        built = _build_faults(src_name, faults)
        log(f"real {kernel} ({src_name}):")
        sound = check(failures, timed=False)
        result[f"{kernel}_sound_of_limit"] = {key(r): r["of_limit"] for r in sound}
        try:
            for name, so in built.items():
                log(f"fault {name}: {faults[name][0]}")
                _build._LOADED[src_name] = ctypes.CDLL(str(so))
                refused = []
                rows = check(refused, timed=False)
                result["faults"][name] = {
                    "kernel": kernel, "source": src_name, "refused": bool(refused),
                    "refused_at": [key(r) for r in rows if not r["ok"]],
                    "of_limit": {key(r): reading(r) for r in rows},
                }
                if not refused:
                    failures.append(f"fault {name} passed every check")
        finally:
            _build._LOADED.pop(src_name, None)
    return result


def _full_config():
    """PipelineConfig() with the special-token ids of the tokenizer the
    pipeline will load (the byte tokenizer: no vocab is on disk), as the
    JAX pipeline does for its checkpoint-free path."""
    import dataclasses

    from instructany2pix_tpu_torch.llm.multimodal import Any2PixLMConfig
    from instructany2pix_tpu_torch.llm.tokenizer import initialize_vision_tokenizer, load_tokenizer
    from instructany2pix_tpu_torch.pipeline import PipelineConfig

    ids = initialize_vision_tokenizer(load_tokenizer(None))
    # the base UNet inpaints, as with real checkpoints: no second SDXL UNet
    return dataclasses.replace(PipelineConfig(), llm=Any2PixLMConfig().with_token_ids(ids),
                               inpaint_unet=PipelineConfig().unet)


def _weight_bytes(module):
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))


def phase_full_width(failures):
    import numpy as np
    import torch

    import instructany2pix_tpu_torch.models.vae as vae_lib
    from instructany2pix_tpu_torch.diffusion import sampler as sampler_lib
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.pipeline import InstructAny2PixPipeline

    cfg = _full_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe = InstructAny2PixPipeline(cfg, seed=0, llm_quant_bits=4)
    torch.cuda.synchronize()
    sizes = {name: _weight_bytes(m) / 2**30 for name, m in pipe.models.items()}
    out = {"build_seconds": time.time() - t0, "weights_gib": sizes,
           "build_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"full width: built in {out['build_seconds']:.1f} s, weights {sum(sizes.values()):.2f} GiB ("
        + ", ".join(f"{k} {v:.2f}" for k, v in sizes.items())
        + f"), build peak {out['build_peak_gib']:.2f} GiB")

    # record whether the decoded float image was finite (the entry points return uint8)
    finite = []
    decode = vae_lib.decode

    def checked_decode(*a, **kw):
        img = decode(*a, **kw)
        finite.append(bool(torch.isfinite(img).all()))
        return img

    vae_lib.decode = checked_decode
    per_unet = 2 * 70  # CFG: self + text cross per transformer block, 70 blocks
    requests = [
        ("plain", {}, STEPS * per_unet),
        ("ip", {"ip_embeds": np.random.RandomState(0).randn(1024).astype(np.float32)},
         STEPS * (per_unet + 70)),
    ]
    out.update({"steps": STEPS, "requests": []})
    try:
        for name, kw, expected in requests:
            fa.flash_fwd_cuda.launches = 0
            fa.flash_relpos2d_cuda.launches = 0
            Q.qmv_cuda.launches = 0
            t0 = time.time()
            img = pipe.text2img("a photo of a cat in an antique shop", num_inference_steps=STEPS,
                                seed=1, **kw)
            torch.cuda.synchronize()
            dt = time.time() - t0
            launches = fa.flash_fwd_cuda.launches
            k2, k3 = Q.qmv_cuda.launches, fa.flash_relpos2d_cuda.launches
            ok = (img.shape == (1024, 1024, 3) and img.dtype == np.uint8 and finite[-1]
                  and launches == expected and k3 == 0)
            if not ok:
                failures.append(f"request {name}: shape {img.shape} {img.dtype} finite "
                                f"{finite[-1]} K1 launches {launches} (expected {expected}), "
                                f"K3 launches {k3} (expected 0)")
            out["requests"].append({"name": name, "seconds": dt, "k1_launches": launches,
                                    "k1_expected": expected, "k2_launches": k2,
                                    "k3_launches": k3, "mean_pixel": float(img.mean())})
            log(f"request {name}: {dt:.3f} s, {STEPS} steps, K1 launches {launches} "
                f"(expected {expected}), K2 {k2}, K3 {k3} (expected 0), image {img.shape} "
                f"{img.dtype} mean {img.mean():.2f}, finite {finite[-1]}")
        out["text2img_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

        # per-step and per-stage times, measured after the counted requests
        with torch.inference_mode():
            ctx_p, pooled_p = pipe._encode_sdxl_prompt("a photo of a cat in an antique shop")
            ctx_n, pooled_n = pipe._encode_sdxl_prompt("")
            tid = sampler_lib.default_time_ids(1024, 1024, 1, pipe.device)
            eps_fn = sampler_lib.make_cfg_eps_fn(
                pipe.models["unet"], cfg.unet, ctx_p, ctx_n, pooled_p, pooled_n, tid, 5.0)
            lat = torch.randn((1, 128, 128, 4), device="cuda")

            def step():
                return eps_fn(lat, 500, 0)

            time_ms(step, 1, warmup=1)
            samples = sorted(time_ms(step, 1, warmup=0) for _ in range(7))
            out["unet_step_ms"] = samples[3]  # median of 7; the step is host-bound, so it spreads
            out["unet_step_ms_range"] = [samples[0], samples[-1]]
            out["vae_decode_ms"] = time_ms(lambda: vae_lib.decode(pipe.models["vae"], lat, cfg.vae), 3, 1)
            out["prompt_encode_ms"] = time_ms(lambda: pipe._encode_sdxl_prompt("a cat"), 5, 1)
            out["unet_step_profile"] = profile_window(step, "CFG UNet step")
        prof = out["unet_step_profile"]
        if prof is not None:
            log(f"UNet step device busy without the profiler: {prof['kernel_ms']:.2f} ms of kernels "
                f"in {out['unet_step_ms']:.2f} ms = {prof['kernel_ms'] / out['unet_step_ms']:.1%}")
        log(f"UNet step (CFG batch 2, 1024^2): median {out['unet_step_ms']:.2f} ms of 7 "
            f"(min {samples[0]:.2f}, max {samples[-1]:.2f}); VAE decode "
            f"{out['vae_decode_ms']:.2f} ms; prompt encode {out['prompt_encode_ms']:.2f} ms")
        out["edit"] = phase_edit(pipe, failures, finite)
        out["subject"] = phase_subject(pipe, failures, finite)
    finally:
        vae_lib.decode = decode
    del pipe
    torch.cuda.empty_cache()
    return out


def _write_media(d):
    """A random 512x384 PNG and a 3 s 16 kHz mono WAV (tone plus noise)."""
    import os
    import wave

    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(11)
    png = os.path.join(d, "input.png")
    Image.fromarray(rs.randint(0, 255, (384, 512, 3), np.uint8)).save(png)
    wav = os.path.join(d, "input.wav")
    sig = np.sin(2 * np.pi * 440 * np.arange(48000) / 16000) * 0.5 + rs.randn(48000) * 0.05
    with wave.open(wav, "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype(np.int16).tobytes())
    return png, wav


def decode_bound_ms(llama_module, max_len):
    """Least time of one decode step of the LLM: every weight byte of the
    decoder and the vocab head read once, plus the padded KV cache, over
    3.35 TB/s; and K2's share of it (the quantized decoder linears)."""
    from instructany2pix_tpu_torch.ops import quant as Q

    k2 = head = other = 0
    for name, m in llama_module.named_modules():
        if isinstance(m, Q.QLinear):
            nbytes = _weight_bytes(m)
            if name == "lm_head":
                head += nbytes
            else:
                k2 += nbytes
    cfg = llama_module.cfg
    other = sum(p.numel() * p.element_size() for n, p in llama_module.named_parameters()
                if "norm" in n) + 2 * cfg.hidden_size
    kv = 2 * cfg.num_layers * max_len * cfg.num_kv_heads * cfg.head_dim * 2
    ms = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
    return {"k2_ms": ms(k2), "lm_head_ms": ms(head), "kv_ms": ms(kv),
            "step_ms": ms(k2 + head + kv + other), "k2_bytes": k2, "lm_head_bytes": head}


def phase_edit(pipe, failures, finite):
    """The edit at full width: `forward_llm` on a written PNG and WAV, then
    `__call__` on a seeded LLM cache, each with the launch counts set to 0
    just before and read just after."""
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.llm import multimodal as mm_lib
    from instructany2pix_tpu_torch.models import llama as llama_lib
    from instructany2pix_tpu_torch.models import unet as unet_lib
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q

    out = {}
    cfg = pipe.cfg
    lm = pipe.models["llm"].llama
    with tempfile.TemporaryDirectory() as d:
        png, wav = _write_media(d)
        media = [{"type": "image", "fname": png}, {"type": "audio", "fname": wav}]
        inst = "Put the sound of <video> into the picture <video> and draw it."

        # ---- the LLM half
        torch.cuda.reset_peak_memory_stats()
        pipe.stage_times = {}
        fa.flash_fwd_cuda.launches = 0
        fa.flash_relpos2d_cuda.launches = 0
        Q.qmv_cuda.launches = 0
        t0 = time.time()
        res = pipe.forward_llm(inst, media, generator=torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        out["forward_llm_seconds"] = time.time() - t0
        k1, k2, k3 = fa.flash_fwd_cuda.launches, Q.qmv_cuda.launches, fa.flash_relpos2d_cuda.launches
        gen = pipe.last_generate
        t_max = gen.tokens.shape[1]
        steps = min(int(gen.done_at[0]), t_max - 1)  # decode steps the loop ran
        k1_expected = cfg.imagebind_vision.layers + cfg.imagebind_audio.layers
        per_step = 4 * cfg.llm.llama.num_layers
        out.update({"k1_launches": k1, "k1_expected": k1_expected, "k2_launches": k2,
                    "k3_launches": k3, "decode_steps": steps, "k2_expected": per_step * steps,
                    "stage_seconds": dict(pipe.stage_times), "caption": res[2][:120],
                    "tokens": gen.tokens[0, :steps + 1].tolist(),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        ok = (isinstance(res, tuple) and len(res) == 5 and isinstance(res[2], str)
              and k1 == k1_expected and k2 == per_step * steps and steps > 0 and k3 == 0)
        if not ok:
            failures.append(f"forward_llm: K1 {k1} (expected {k1_expected}), K2 {k2} (expected "
                            f"{per_step} x {steps} decode steps), K3 {k3} (expected 0), "
                            f"result {type(res)}")
        log(f"forward_llm: {out['forward_llm_seconds']:.3f} s ({', '.join(f'{k} {v:.3f} s' for k, v in pipe.stage_times.items())}), "
            f"{steps} decode steps, K2 launches {k2} (expected {per_step * steps}), K1 launches "
            f"{k1} (expected {k1_expected}: the ImageBind trunks), K3 launches {k3} (expected 0), "
            f"caption {res[2][:60]!r}")

        # one <video> row per media item was spliced
        with torch.inference_mode():
            aux = pipe.embed_mm_data(media)
            ids, emb = pipe._prepare_llm_inputs(inst, aux)
            pos = np.nonzero(ids[0] == cfg.llm.video_token_id)[0]
            proj = mm_lib._mlp2(pipe.models["llm"].vae_projector_image,
                                aux.to(emb.dtype)).to(emb.dtype)
            plain = llama_lib.embed(lm, torch.as_tensor(ids, device="cuda"))
            spliced = [bool(torch.equal(emb[0, p], proj[j])) for j, p in enumerate(pos)]
            rest = np.setdiff1d(np.arange(ids.shape[1]), pos)
            untouched = bool(torch.equal(emb[0, rest], plain[0, rest]))
        out["video_rows"] = len(pos)
        if len(pos) != len(media) or not all(spliced) or not untouched:
            failures.append(f"splice: {len(pos)} <video> rows for {len(media)} media, spliced "
                            f"{spliced}, others untouched {untouched}")
        log(f"splice: {len(pos)} <video> rows for {len(media)} media items, each the projected "
            f"embedding: {all(spliced)}, other rows the token embeddings: {untouched}")

        # prefill and per-token decode, timed on the same spliced prompt
        with torch.inference_mode():
            s = emb.shape[1]
            pp = -(-s // 64) * 64 - s
            padded = torch.nn.functional.pad(emb, (0, 0, pp, 0))
            max_len = s + pp + 100
            ccfg = cfg.llm.llama

            def prefill():
                cache = llama_lib.KVCache.create(ccfg, 1, max_len=max_len, dtype=emb.dtype,
                                                 device="cuda")
                return llama_lib.forward(lm, ccfg, inputs_embeds=padded, cache=cache,
                                         prefix_pad=pp)

            prefill()
            torch.cuda.synchronize()
            tp = []
            for _ in range(3):
                t0 = time.perf_counter()
                o = prefill()
                torch.cuda.synchronize()
                tp.append((time.perf_counter() - t0) * 1e3)
            cache = o["cache"]
            tok = o["logits"][:, -1].argmax(-1)

            def decode_step():
                nonlocal cache, tok
                o = llama_lib.forward(lm, ccfg, inputs_embeds=llama_lib.embed(lm, tok[:, None]),
                                      cache=cache, prefix_pad=pp)
                cache, tok = o["cache"], o["logits"][:, -1].argmax(-1)

            decode_step()
            td = sorted(time_ms(decode_step, 1, warmup=0) for _ in range(21))
            bound = decode_bound_ms(lm, max_len)
            prof = profile_window(decode_step, "decode step", n=3)
        out.update({"prefill_tokens": s + pp, "prefill_ms": sorted(tp)[1],
                    "decode_ms_median": td[10], "decode_ms_range": [td[0], td[-1]],
                    "decode_bound": bound, "decode_profile": prof})
        k2_share = None
        if prof is not None:
            k2_ms = prof["by_class"].get("k2", 0.0)
            k2_share = {"k2_kernel_ms": k2_ms, "of_kernel_time": k2_ms / prof["kernel_ms"],
                        "of_step": k2_ms / td[10]}
            out["k2_share"] = k2_share
        log(f"prefill ({s + pp} tokens, {pp} of them left pad): {out['prefill_ms']:.2f} ms; decode "
            f"step median {td[10]:.3f} ms of 21 (min {td[0]:.3f}, max {td[-1]:.3f}) against a "
            f"bound of {bound['step_ms']:.3f} ms (K2's weights {bound['k2_ms']:.3f} ms, int8 "
            f"lm_head {bound['lm_head_ms']:.3f} ms, KV cache {bound['kv_ms']:.3f} ms)"
            + (f"; K2 kernels {k2_share['k2_kernel_ms']:.3f} ms = {k2_share['of_kernel_time']:.1%}"
               f" of kernel time, {k2_share['of_step']:.1%} of the step" if k2_share else ""))

        # ---- the diffusion half, on a seeded LLM cache (a random 7B never
        # emits <im_gen>...<video>), as the JAX package's tests do
        rs = np.random.RandomState(7)
        d_img = cfg.llm.image_codec_dim
        pipe.cache = (rs.randn(1, d_img).astype(np.float32), rs.randn(d_img).astype(np.float32),
                      " a cat in an antique shop", png,
                      dict(all_objs=[], extra_embeds=np.zeros((0, d_img), np.float32), extra_idx=[]))
        def blocks(name):
            return sum(isinstance(m, unet_lib.TBlock) for m in pipe.models[name].modules())

        # K1 per UNet forward: self + text cross per transformer block, + IP
        # cross in the denoise; inversion runs without CFG, the rest with it
        ref_steps = int(50 * 0.5)
        expected = (EDIT_STEPS * 2 * blocks("unet") + EDIT_STEPS * 3 * blocks("unet")
                    + ref_steps * 2 * blocks("refiner"))
        torch.cuda.reset_peak_memory_stats()
        pipe.stage_times = {}
        fa.flash_fwd_cuda.launches = 0
        fa.flash_relpos2d_cuda.launches = 0
        Q.qmv_cuda.launches = 0
        n_decoded = len(finite)
        t0 = time.time()
        non_refined, refined, msg = pipe(inst, media, num_inference_steps=EDIT_STEPS,
                                         refinement=0.5, seed=1, use_cache=True)
        torch.cuda.synchronize()
        out["call_seconds"] = time.time() - t0
        k1, k3 = fa.flash_fwd_cuda.launches, fa.flash_relpos2d_cuda.launches
        out.update({"call_stage_seconds": dict(pipe.stage_times), "call_k1_launches": k1,
                    "call_k1_expected": expected, "call_k2_launches": Q.qmv_cuda.launches,
                    "call_k3_launches": k3,
                    "call_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "mean_pixels": [float(non_refined.mean()), float(refined.mean())]})
        pipe.stage_times = None
        size = cfg.image_size
        images_ok = all(a.shape == (size, size, 3) and a.dtype == np.uint8
                        for a in (non_refined, refined))
        all_finite = len(finite) - n_decoded == 2 and all(finite[n_decoded:])
        if not (images_ok and all_finite and msg == "SUCCESS!" and k1 == expected and k3 == 0):
            failures.append(f"__call__: images ok {images_ok}, finite {all_finite}, msg {msg!r}, "
                            f"K1 {k1} (expected {expected}), K3 {k3} (expected 0)")
        log(f"__call__ (edit, {EDIT_STEPS} inversion + {EDIT_STEPS} denoise steps, refiner "
            f"{ref_steps} of 50): {out['call_seconds']:.3f} s; " + ", ".join(
                f"{k} {v:.3f} s" for k, v in out["call_stage_seconds"].items())
            + f"; K1 launches {k1} (expected {expected}), K3 {k3} (expected 0); images {non_refined.shape} "
            f"{non_refined.dtype}, finite {all_finite}; peak {out['call_peak_gib']:.2f} GiB")
        pipe.cache = None
    return out


def phase_subject(pipe, failures, finite):
    """Subject consistency at full width: `__call__` with `subject_strength`
    on a seeded LLM cache naming one image subject, through a random SAM
    ViT-H segmentor in bf16 and the whole-image grounder (so a box exists
    with random weights), with the launch counts set to 0 just before and
    read just after; then the random GroundingDINO Swin-T grounder (float32)
    on the edited image."""
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.grounding import gdino as gdino_lib
    from instructany2pix_tpu_torch.grounding import lib as grounding_lib
    from instructany2pix_tpu_torch.grounding import sam as sam_lib
    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.models import unet as unet_lib
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q

    cfg = pipe.cfg
    out = {}
    t0 = time.time()
    gen = torch.Generator("cuda").manual_seed(5)
    scfg, gcfg = sam_lib.SAMConfig.vit_h(), gdino_lib.GDinoConfig.swint()
    with torch.device("meta"):
        sam, gd = sam_lib.SAM(scfg), gdino_lib.GDino(gcfg)
    sam = sam_lib.init_(L.materialize(sam, torch.device("cuda"), torch.bfloat16), gen).eval()
    gd = gdino_lib.init_(L.materialize(gd, torch.device("cuda"), torch.float32), gcfg, gen).eval()
    sam.requires_grad_(False)
    gd.requires_grad_(False)
    segment = sam_lib.make_segmentor(sam, scfg)
    torch.cuda.synchronize()
    out.update({"build_seconds": time.time() - t0, "sam_gib": _weight_bytes(sam) / 2**30,
                "gdino_gib": _weight_bytes(gd) / 2**30})
    masks = []

    def segmentor(image, box):
        masks.append(segment(image, box))
        return masks[-1]

    saved = pipe.segmentor, pipe.grounder
    pipe.segmentor, pipe.grounder = segmentor, grounding_lib.cosine_fallback_grounder(None)

    def blocks(name):
        return sum(isinstance(m, unet_lib.TBlock) for m in pipe.models[name].modules())

    inpaint_steps = int(50 * SUBJECT_STRENGTH)
    k1_expected = (EDIT_STEPS * 5 * blocks("unet") + int(50 * 0.5) * 2 * blocks("refiner")
                   + inpaint_steps * 3 * blocks("unet"))  # the inpaint: CFG with IP tokens
    with tempfile.TemporaryDirectory() as d:
        png, _ = _write_media(d)
        media = [{"type": "image", "fname": png}]
        rs = np.random.RandomState(8)
        dd = cfg.llm.image_codec_dim
        pipe.cache = (rs.randn(1, dd).astype(np.float32), rs.randn(dd).astype(np.float32),
                      " a cat in an antique shop", png,
                      dict(all_objs=["cat"], extra_embeds=rs.randn(1, dd).astype(np.float32),
                           extra_idx=np.array([0])))
        torch.cuda.reset_peak_memory_stats()
        pipe.stage_times = {}
        fa.flash_fwd_cuda.launches = 0
        fa.flash_relpos2d_cuda.launches = 0
        Q.qmv_cuda.launches = 0
        n_decoded = len(finite)
        t0 = time.time()
        non_refined, edited, msg = pipe("Put <video> into the picture.", media,
                                        num_inference_steps=EDIT_STEPS, refinement=0.5, seed=2,
                                        use_cache=True, subject_strength=SUBJECT_STRENGTH)
        torch.cuda.synchronize()
        out["call_seconds"] = time.time() - t0
        k1, k3 = fa.flash_fwd_cuda.launches, fa.flash_relpos2d_cuda.launches
        pipe.cache = None
    out.update({"stage_seconds": dict(pipe.stage_times), "k1_launches": k1,
                "k1_expected": k1_expected, "k3_launches": k3, "segmentor_calls": len(masks),
                "k2_launches": Q.qmv_cuda.launches,
                "mask_fraction": [float(m.mean()) for m in masks],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "inpaint_steps": inpaint_steps, "mean_pixel": float(edited.mean())})
    pipe.stage_times = None
    all_finite = len(finite) - n_decoded == 3 and all(finite[n_decoded:])
    ok = (edited.shape == (cfg.image_size, cfg.image_size, 3) and edited.dtype == np.uint8
          and all_finite and msg == "SUCCESS!" and len(masks) == 1 and k3 == 4 * len(masks)
          and k1 == k1_expected and 0 < masks[0].mean() and not np.array_equal(edited, non_refined))
    if not ok:
        failures.append(f"subject consistency: image {edited.shape} {edited.dtype}, finite "
                        f"{all_finite}, msg {msg!r}, segmentor calls {len(masks)}, K3 {k3} "
                        f"(expected 4 per call), K1 {k1} (expected {k1_expected}), mask fractions "
                        f"{out['mask_fraction']}")
    log(f"__call__ with subject consistency (strength {SUBJECT_STRENGTH}: {inpaint_steps} inpaint "
        f"steps of 50): {out['call_seconds']:.3f} s; " + ", ".join(
            f"{k} {v:.3f} s" for k, v in out["stage_seconds"].items())
        + f"; K3 launches {k3} ({len(masks)} segmentor call, expected 4 each); K1 launches {k1} "
        f"(expected {k1_expected}); mask fraction {out['mask_fraction']}; image {edited.shape} "
        f"finite {all_finite}; peak {out['peak_gib']:.2f} GiB; SAM ViT-H {out['sam_gib']:.2f} GiB "
        f"bf16, GroundingDINO {out['gdino_gib']:.2f} GiB f32, built in {out['build_seconds']:.1f} s")

    with torch.inference_mode():
        x = torch.randn((1, scfg.img_size, scfg.img_size, 3), device="cuda").bfloat16()
        out["sam_encode_ms"] = time_ms(lambda: sam_lib.encoder_apply(sam.encoder, x, scfg), 3, 1)
        grounder = gdino_lib.make_grounder(gd, gcfg)
        grounder(edited, "cat")
        torch.cuda.synchronize()
        t0 = time.time()
        boxes, scores, phrases = grounder(edited, "cat")
        out["grounder_seconds"] = time.time() - t0
        xg = gdino_lib.preprocess(edited, device="cuda")
        ids, _ = gdino_lib.simple_tokenize("cat", gcfg.bert.vocab_size)
        t0 = time.time()
        rb, rl = gdino_lib.forward(gd, gcfg, xg, ids, np.ones_like(ids))
        torch.cuda.synchronize()
        out["gdino_forward_seconds"] = time.time() - t0
    shapes_ok = (tuple(rb.shape) == (1, gcfg.num_queries, 4)
                 and tuple(rl.shape) == (1, gcfg.num_queries, ids.shape[1]))
    finite_ok = bool(torch.isfinite(rb).all()) and bool(torch.isfinite(rl).all())
    out.update({"gdino_input": list(xg.shape), "gdino_boxes_shape": list(rb.shape),
                "gdino_logits_shape": list(rl.shape), "gdino_finite": finite_ok,
                "grounder_kept": len(boxes), "grounder_phrases": phrases[:5]})
    if not (shapes_ok and finite_ok and len(boxes) == len(scores) == len(phrases)):
        failures.append(f"GroundingDINO: boxes {tuple(rb.shape)}, logits {tuple(rl.shape)}, "
                        f"finite {finite_ok}, kept {len(boxes)}/{len(scores)}/{len(phrases)}")
    log(f"SAM ViT-H encoder (bf16, 1024^2): {out['sam_encode_ms']:.2f} ms; GroundingDINO Swin-T "
        f"grounder on the edited image: {out['grounder_seconds']:.3f} s, forward "
        f"{out['gdino_forward_seconds']:.3f} s on {tuple(xg.shape)}, boxes {tuple(rb.shape)}, logits "
        f"{tuple(rl.shape)}, finite {finite_ok}, {len(boxes)} boxes kept at 0.35/0.25")
    pipe.segmentor, pipe.grounder = saved
    del sam, gd, segment, grounder
    torch.cuda.empty_cache()
    return out


def _kernel_class(name):
    n = name.lower()
    if "relpos2d" in n:
        return "k3"
    if "flash_fwd" in n:
        return "k1"
    if "qmv_" in n:
        return "k2"
    if any(s in n for s in ("conv", "fprop", "implicit")):  # cuDNN's implicit GEMMs too
        return "conv"
    if any(s in n for s in ("gemm", "nvjet", "cutlass")):
        return "gemm"
    if any(s in n for s in ("reduce", "norm")):
        return "reduce"
    return "elementwise"


def profile_window(step, label, n=2):
    """Device time by kernel over `n` calls of `step` (torch.profiler),
    grouped into K1 / K2 / GEMM / conv / reductions / elementwise, and the
    share of the host-clock window the device was busy. None when the
    profiler fails or sees no device time (a measurement aid, not a check)."""
    try:
        return _profile(step, label, n)
    except RuntimeError as e:
        log(f"profile: torch.profiler failed ({e}); breakdown not measured")
        return None


def _profile(step, label, n):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        window_ms = (time.time() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kernels.append((us / 1e3 / n, e.count // n, e.key))
    kernels.sort(reverse=True)
    total = sum(k[0] for k in kernels)
    if total == 0:
        log("profile: no device time in the trace (not measured)")
        return None
    by_class = {}
    for ms, _, name in kernels:
        c = _kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + ms
    busy = total / (window_ms / n)
    launches = sum(k[1] for k in kernels)
    log(f"profile of one {label} (mean of {n}): {launches} kernels, {total:.2f} ms, "
        f"window {window_ms / n:.2f} ms (profiled), device busy {busy:.1%}; " + ", ".join(
            f"{c} {ms:.2f} ms" for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1])))
    for ms, count, name in kernels[:12]:
        log(f"  {ms:8.3f} ms {count:5d}x  {_kernel_class(name):11s} {name[:90]}")
    return {"kernel_ms": total, "launches": launches, "window_ms": window_ms / n, "busy": busy,
            "by_class": by_class,
            "top": [{"ms": ms, "count": c, "name": nm[:120]} for ms, c, nm in kernels[:12]]}


def _tiny_config():
    """PipelineConfig.tiny() with a small LLM whose decoder linears all
    qualify for int4 group 128 (hidden 256, intermediate 512)."""
    import dataclasses

    from instructany2pix_tpu_torch.llm.multimodal import Any2PixLMConfig
    from instructany2pix_tpu_torch.pipeline import PipelineConfig

    llm = Any2PixLMConfig.tiny()
    llm = dataclasses.replace(llm, llama=dataclasses.replace(
        llm.llama, hidden_size=256, intermediate_size=512))
    return dataclasses.replace(PipelineConfig.tiny(), llm=llm)


def phase_tiny_reference(failures):
    """The tiny config in fp32, on the card against the same weights on
    the CPU: text2img and the edit (seeded LLM cache, the same injected
    noise), also with subject consistency through a tiny SAM, within 1
    uint8 level; greedy decode (K2 in fp32 on the card) token-identical."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.core.dtypes import FP32
    from instructany2pix_tpu_torch.grounding import sam as sam_lib
    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.llm import generate as gen_lib
    from instructany2pix_tpu_torch.models import llama as llama_lib
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.pipeline import InstructAny2PixPipeline

    cfg = _tiny_config()
    cpu = InstructAny2PixPipeline(cfg, seed=0, device="cpu", policy=FP32, llm_quant_bits=4)
    gpu = InstructAny2PixPipeline(cfg, seed=1, policy=FP32, llm_quant_bits=4)
    for name, m in gpu.models.items():
        m.load_state_dict(cpu.models[name].state_dict())
    out = {}

    def levels(a, b, what):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        log(f"tiny fp32 GPU vs CPU, {what}: max {d.max()} levels, mean {d.mean():.6f}, "
            f"{int((d > 0).sum())} of {d.size} differ")
        # from_model_range truncates, so a last-digit difference can flip one level
        if d.max() > 1:
            failures.append(f"tiny GPU vs CPU {what} differ by {d.max()} levels")
        return int(d.max())

    h = cfg.image_size // 2 ** (len(cfg.vae.block_out_channels) - 1)
    lat = np.random.RandomState(3).randn(1, h, h, 4).astype(np.float32)
    emb = np.random.RandomState(4).randn(cfg.image_proj.clip_embeddings_dim).astype(np.float32)
    kw = dict(num_inference_steps=3, ip_embeds=emb, latents=lat)
    out["text2img_max_levels"] = levels(cpu.text2img("a cat", **kw), gpu.text2img("a cat", **kw),
                                        "text2img")

    with tempfile.TemporaryDirectory() as d:
        png, _ = _write_media(d)
        rs = np.random.RandomState(5)
        dd = cfg.llm.image_codec_dim
        cache = (rs.randn(1, dd).astype(np.float32), rs.randn(dd).astype(np.float32),
                 " a tiny caption", png, dict(all_objs=[], extra_embeds=np.zeros((0, dd)), extra_idx=[]))
        noise = {k: np.random.RandomState(20 + i).randn(1, h, h, 4).astype(np.float32)
                 for i, k in enumerate(("vae_noise", "polar_noise", "refiner_vae_noise",
                                        "refiner_noise"))}
        imgs = []
        for p in (cpu, gpu):
            p.cache = cache
            imgs.append(p("edit <video>", [{"type": "image", "fname": png}], num_inference_steps=3,
                          refinement=0.5, seed=0, use_cache=True, **noise))
        out["edit_max_levels"] = [levels(imgs[0][0], imgs[1][0], "edit non-refined"),
                                  levels(imgs[0][1], imgs[1][1], "edit refined")]

        # with subject consistency: the same tiny SAM (float32, so the plain
        # attention on both devices) and the whole-image grounder
        scfg = sam_lib.SAMConfig.tiny()
        with torch.device("meta"):
            sam = sam_lib.SAM(scfg)
        sam = sam_lib.init_(L.materialize(sam, torch.device("cpu"), torch.float32),
                            torch.Generator().manual_seed(31))
        cpu.segmentor = sam_lib.make_segmentor(sam, scfg, dtype=None)
        gpu.segmentor = sam_lib.make_segmentor(copy.deepcopy(sam).cuda(), scfg, dtype=None)
        subject_noise = [{k: np.random.RandomState(30 + i).randn(1, h, h, 4).astype(np.float32)
                          for i, k in enumerate(("vae", "masked_vae", "inpaint"))}]
        subject_cache = cache[:4] + (dict(all_objs=["cat"], extra_embeds=rs.randn(1, dd).astype(np.float32),
                                          extra_idx=np.array([0])),)
        imgs = []
        for p in (cpu, gpu):
            p.cache = subject_cache
            imgs.append(p("edit <video>", [{"type": "image", "fname": png}], num_inference_steps=3,
                          refinement=0.5, seed=0, use_cache=True, subject_strength=0.7,
                          subject_noise=subject_noise, **noise))
        out["subject_edit_max_levels"] = levels(imgs[0][1], imgs[1][1],
                                                "edit with subject consistency")

    # greedy decode: the card's decode steps run K2 in fp32
    with torch.inference_mode():
        aux = torch.zeros((0, cfg.llm.image_codec_dim))
        _, emb_c = cpu._prepare_llm_inputs("describe a cat in an antique shop", aux)
        lcfg = cfg.llm.llama
        kw = dict(max_new_tokens=16, temperature=0.0, eos_id=-1, bucket=64)
        before = Q.qmv_cuda.launches
        tc = gen_lib.generate(cpu.models["llm"].llama, lcfg, emb_c, None, **kw).tokens[0]
        tg = gen_lib.generate(gpu.models["llm"].llama, lcfg, emb_c.cuda(), None, **kw).tokens[0].cpu()
        out["greedy_k2_launches"] = Q.qmv_cuda.launches - before
        same = bool(torch.equal(tc, tg))
        out["greedy_tokens_identical"] = same
        # teacher-forced logits over the CPU's tokens, both devices
        seq = torch.cat([emb_c, llama_lib.embed(cpu.models["llm"].llama, tc[None, :-1])], dim=1)
        lc = llama_lib.forward(cpu.models["llm"].llama, lcfg, inputs_embeds=seq)["logits"]
        lg = llama_lib.forward(gpu.models["llm"].llama, lcfg, inputs_embeds=seq.cuda())["logits"].cpu()
        rel = ((lg - lc).abs().max() / lc.abs().max()).item()
        out["teacher_forced_logits_rel"] = rel
        msg = f"tiny fp32 greedy decode, 16 tokens: identical {same}; teacher-forced logits max rel diff {rel:.3g}"
        if not same:
            i = int((tc != tg).nonzero()[0])
            top2 = lc[0, emb_c.shape[1] - 1 + i].topk(2).values
            gap = (top2[0] - top2[1]).item()
            out["first_difference"] = {"index": i, "cpu_top2_gap": gap}
            msg += f"; first difference at token {i}, CPU top-2 gap {gap:.3g}"
            if gap > 1e-3 * lc.abs().max().item():
                failures.append(f"tiny greedy tokens differ at {i} with a top-2 gap of {gap:.3g}")
        if rel > 1e-4:
            failures.append(f"tiny teacher-forced logits differ by {rel:.3g} of their largest")
        log(msg + f" (K2 launches on the card: {out['greedy_k2_launches']})")
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--planted-faults", action="store_true",
                    help="instead of the phases: build broken copies of K1 (FAULTS), K2 "
                         "(QMV_FAULTS) and K3 (K3_FAULTS) and show that the checks refuse each "
                         "while the real kernels pass")
    ap.add_argument("--out", help="also write every reading to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from instructany2pix_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.time()
    card = card_line()
    log(card)
    t0 = time.time()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    built = _build.build(sources)
    log(f"built {sources} in {time.time() - t0:.2f} s")
    for name, so in built.items():
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    failures: list = []
    if args.planted_faults:
        result = planted_faults(failures)
        result["card"] = card
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        log(json.dumps({"planted_faults": result}))
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1 if failures else 0
    t0 = time.time()
    rows = phase_kernels(failures)
    t_k1 = time.time() - t0
    t0 = time.time()
    qrows = phase_qmv(failures)
    t_k2 = time.time() - t0
    t0 = time.time()
    k3rows = phase_k3(failures)
    t_k3 = time.time() - t0
    t0 = time.time()
    full = phase_full_width(failures)
    t_full = time.time() - t0
    t0 = time.time()
    tiny = phase_tiny_reference(failures)
    seconds = {"k1_checks": t_k1, "k2_checks": t_k2, "k3_checks": t_k3, "full_width": t_full,
               "tiny": time.time() - t0, "total": time.time() - t_start}
    edit, subject = full["edit"], full["subject"]

    head = next(r for r in rows if r["dtype"] == "bfloat16")
    k1_paths = {"text2img": sum(r["k1_launches"] for r in full["requests"]),
                "forward_llm": edit["k1_launches"], "edit_call": edit["call_k1_launches"],
                "subject_call": subject["k1_launches"]}
    k1 = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "instructany2pix_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "instructany2pix_tpu/ops/flash_attention.py:44",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        "max_abs_err": max(r["err_o"] for r in rows if r["dtype"] == "bfloat16"),
        "max_abs_err_fp32": max(r["err_o"] for r in rows if r["dtype"] == "float32"),
        "max_err_of_limit": max(r["of_limit"] for r in rows),
        "ms": head["ms"],
        "ms_bshd": head["ms_bshd"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "headline_shape": f"{head['label']} {head['shape']} sk={head['sk']} bf16",
        "shapes": rows,
    }
    qhead = next(r for r in qrows if r["label"] == "7B qkv + norm" and r["m"] == 1)
    k2 = {
        "name": "qmv",
        "route": "cuda",
        "source": "instructany2pix_tpu_torch/csrc/qmv.cu",
        "replaces": "instructany2pix_tpu/ops/quant.py:294",
        "also_replaces": ["instructany2pix_tpu/ops/quant.py:417",
                          "benchmarks/qmv_dma_probe.py:32"],
        "launches": edit["k2_launches"],
        "launches_by_path": {"text2img": sum(r["k2_launches"] for r in full["requests"]),
                             "forward_llm": edit["k2_launches"],
                             "edit_call": edit["call_k2_launches"],
                             "subject_call": subject["k2_launches"]},
        "max_abs_err": max(r["err"] for r in qrows),
        "max_err_of_limit": max(r["of_limit"] for r in qrows),
        "ms": qhead["ms"],
        "plain_ms": qhead["plain_ms"],
        "bound_ms": qhead["bound_ms"],
        "bound_by": qhead["bound_by"],
        "library_ms": qhead["library_ms"],
        "headline_shape": "7B qkv + RMSNorm, M=1, K=4096, N=12288, int4 group 128, bf16",
        "shapes": [{k: r[k] for k in ("label", "m", "k", "n", "format", "fusion", "ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by", "err", "of_limit")}
                   for r in qrows],
    }
    k3head = next(r for r in k3rows if r["label"] == "sam global block")
    k3 = {
        "name": "flash_relpos2d",
        "route": "cuda",
        "source": "instructany2pix_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "instructany2pix_tpu/ops/flash_attention.py:174",
        "launches": subject["k3_launches"],
        "launches_by_path": {"text2img": sum(r["k3_launches"] for r in full["requests"]),
                             "forward_llm": edit["k3_launches"], "edit_call": edit["call_k3_launches"],
                             "subject_call": subject["k3_launches"]},
        "max_abs_err": max(r["err_o"] for r in k3rows),
        "max_err_of_limit": max(r["of_limit"] for r in k3rows),
        "ms": k3head["ms"],
        "ms_bshd": k3head["ms_bshd"],
        "plain_ms": k3head["plain_ms"],
        "bound_ms": k3head["bound_ms"],
        "bound_by": k3head["bound_by"],
        "library_ms": k3head["library_ms"],
        "library_call": "F.scaled_dot_product_attention with the bias as a (B, H, N, N) bf16 mask",
        "headline_shape": "SAM ViT-H global block (1, 16, 4096, 80), g=64, bf16",
        "shapes": [{k: r[k] for k in ("label", "shape", "g", "ms", "ms_bshd", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "err_o", "of_limit", "of_limit_qkv")}
                   for r in k3rows],
    }
    result = {"card": card, "k2_shapes": qrows, "full_width": full, "tiny_reference": tiny,
              "seconds": seconds}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "kernels": [k1, k2, k3]}, f, indent=1, default=str)
    summary = {k: v for k, v in full.items() if k not in ("edit", "subject", "unet_step_profile")}
    log(json.dumps({"full_width": summary, "tiny_reference": tiny, "seconds": seconds}))
    log(json.dumps({"edit": {k: v for k, v in edit.items() if k != "decode_profile"}}))
    log(json.dumps({"subject": subject}, default=str))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    log(card)
    log(json.dumps({"kernels": [k1, k2, k3]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
