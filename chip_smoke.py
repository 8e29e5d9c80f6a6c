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
  3. the slice at full width: PipelineConfig() (SDXL base with IP, SDXL
     VAE, CLIP-L, OpenCLIP-bigG) in bf16 with random weights from a seed,
     answering two text2img requests (plain, and with a 1024-d IP
     embedding); checks the images, that the float images were finite and
     that K1's launch count is exactly what the router should send; then
     times one CFG UNet step, the VAE decode and the prompt encode, and
     breaks one UNet step down by kernel class with torch.profiler;
  4. the tiny config in fp32 on the card against the same weights on the
     CPU (the plain attention path): uint8 images agree within 1 level.
Then a {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}.

`python3 chip_smoke.py --planted-faults` runs phase 2's check against
deliberately broken copies of K1 (FAULTS) instead, and exits 0 only if
the real K1 passes at every shape and each broken copy is refused.
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


def planted_faults(failures):
    """Build each FAULTS copy of K1 (under build/faults), run the phase-2
    check with it in place of K1, and require that the real K1 passes at
    every shape while each copy is refused at one shape at least."""
    import ctypes

    from instructany2pix_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_fwd.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, old, new) in FAULTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"fault {name}: its source text is not in flash_fwd.cu exactly once")
        cu = out_dir / f"flash_fwd_{name}.cu"
        cu.write_text(src.replace(old, new))
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for fault {name}:\n{out}")

    log("real K1:")
    sound = phase_kernels(failures, timed=False)
    result = {"sound_of_limit": {f"{r['label']} {r['dtype']}": r["of_limit"] for r in sound},
              "faults": {}}
    try:
        for name, (so, _) in procs.items():
            log(f"fault {name}: {FAULTS[name][0]}")
            _build._LOADED["flash_fwd"] = ctypes.CDLL(str(so))
            refused = []
            rows = phase_kernels(refused, timed=False)
            result["faults"][name] = {
                "refused": bool(refused),
                "refused_at": [f"{r['label']} {r['dtype']}" for r in rows if not r["ok"]],
                "of_limit": {f"{r['label']} {r['dtype']}": [r["of_limit_bhsd"], r["of_limit_bshd"]]
                             for r in rows},
            }
            if not refused:
                failures.append(f"fault {name} passed every check")
    finally:
        _build._LOADED.pop("flash_fwd", None)
    return result


def phase_full_width(failures):
    import numpy as np
    import torch

    import instructany2pix_tpu_torch.models.vae as vae_lib
    from instructany2pix_tpu_torch.diffusion import sampler as sampler_lib
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.pipeline import InstructAny2PixPipeline, PipelineConfig

    cfg = PipelineConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe = InstructAny2PixPipeline(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in pipe.models.values() for p in m.parameters())
    log(f"full width: built {n_params / 1e9:.3f}B params (bf16) in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # record whether the decoded float image was finite (text2img returns uint8)
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
    out = {"steps": STEPS, "requests": []}
    try:
        for name, kw, expected in requests:
            fa.flash_fwd_cuda.launches = 0
            t0 = time.time()
            img = pipe.text2img("a photo of a cat in an antique shop", num_inference_steps=STEPS,
                                seed=1, **kw)
            torch.cuda.synchronize()
            dt = time.time() - t0
            launches = fa.flash_fwd_cuda.launches
            ok = (img.shape == (1024, 1024, 3) and img.dtype == np.uint8 and finite[-1]
                  and launches == expected)
            if not ok:
                failures.append(f"request {name}: shape {img.shape} {img.dtype} finite "
                                f"{finite[-1]} K1 launches {launches} (expected {expected})")
            out["requests"].append({"name": name, "seconds": dt, "k1_launches": launches,
                                    "k1_expected": expected, "mean_pixel": float(img.mean())})
            log(f"request {name}: {dt:.3f} s, {STEPS} steps, K1 launches {launches} "
                f"(expected {expected}), image {img.shape} {img.dtype} mean {img.mean():.2f}, "
                f"finite {finite[-1]}")
    finally:
        vae_lib.decode = decode
    out["k1_launches"] = sum(r["k1_launches"] for r in out["requests"])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

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
        try:
            out["unet_step_profile"] = profile_unet_step(step)
        except RuntimeError as e:  # the breakdown is a measurement aid, not a check
            log(f"profile: torch.profiler failed ({e}); breakdown not measured")
            out["unet_step_profile"] = None
    prof = out["unet_step_profile"]
    if prof is not None:
        log(f"UNet step device busy without the profiler: {prof['kernel_ms']:.2f} ms of kernels "
            f"in {out['unet_step_ms']:.2f} ms = {prof['kernel_ms'] / out['unet_step_ms']:.1%}")
    log(f"UNet step (CFG batch 2, 1024^2): median {out['unet_step_ms']:.2f} ms of 7 "
        f"(min {samples[0]:.2f}, max {samples[-1]:.2f}); VAE decode "
        f"{out['vae_decode_ms']:.2f} ms; prompt encode {out['prompt_encode_ms']:.2f} ms; "
        f"peak memory {out['peak_gib']:.2f} GiB")
    del pipe
    torch.cuda.empty_cache()
    return out


def _kernel_class(name):
    n = name.lower()
    if "flash_fwd" in n:
        return "k1"
    if any(s in n for s in ("conv", "fprop", "implicit")):  # cuDNN's implicit GEMMs too
        return "conv"
    if any(s in n for s in ("gemm", "nvjet", "cutlass")):
        return "gemm"
    if any(s in n for s in ("reduce", "norm")):
        return "reduce"
    return "elementwise"


def profile_unet_step(step, n=2):
    """Device time by kernel over `n` UNet steps (torch.profiler), grouped
    into K1 / GEMM / conv / reductions / elementwise, and the share of the
    host-clock window the device was busy."""
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
    log(f"profile of one CFG UNet step (mean of {n}): {launches} kernels, {total:.2f} ms, "
        f"window {window_ms / n:.2f} ms (profiled), device busy {busy:.1%}; " + ", ".join(
            f"{c} {ms:.2f} ms" for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1])))
    for ms, count, name in kernels[:12]:
        log(f"  {ms:8.3f} ms {count:5d}x  {_kernel_class(name):11s} {name[:90]}")
    return {"kernel_ms": total, "launches": launches, "window_ms": window_ms / n, "busy": busy,
            "by_class": by_class,
            "top": [{"ms": ms, "count": c, "name": nm[:120]} for ms, c, nm in kernels[:12]]}


def phase_tiny_reference(failures):
    import numpy as np
    import torch

    from instructany2pix_tpu_torch.core.dtypes import FP32
    from instructany2pix_tpu_torch.pipeline import InstructAny2PixPipeline, PipelineConfig

    cfg = PipelineConfig.tiny()
    cpu = InstructAny2PixPipeline(cfg, seed=0, device="cpu", policy=FP32)
    gpu = InstructAny2PixPipeline(cfg, seed=1, policy=FP32)
    for name, m in gpu.models.items():
        m.load_state_dict(cpu.models[name].state_dict())
    h = cfg.image_size // 2 ** (len(cfg.vae.block_out_channels) - 1)
    lat = np.random.RandomState(3).randn(1, h, h, 4).astype(np.float32)
    emb = np.random.RandomState(4).randn(cfg.image_proj.clip_embeddings_dim).astype(np.float32)
    kw = dict(num_inference_steps=3, ip_embeds=emb, latents=lat)
    a = cpu.text2img("a cat", **kw)
    b = gpu.text2img("a cat", **kw)
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    log(f"tiny fp32 GPU vs CPU: max {d.max()} levels, mean {d.mean():.6f}, "
        f"{int((d > 0).sum())} of {d.size} differ")
    # from_model_range truncates, so a last-digit difference can flip one level
    if d.max() > 1:
        failures.append(f"tiny GPU vs CPU differ by {d.max()} levels")
    return {"max_levels": int(d.max()), "mean_levels": float(d.mean())}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--planted-faults", action="store_true",
                    help="instead of the phases: build broken copies of K1 (FAULTS) and show "
                         "that phase 2's check refuses each while the real K1 passes")
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
        log(json.dumps({"planted_faults": result}))
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1 if failures else 0
    rows = phase_kernels(failures)
    full = phase_full_width(failures)
    tiny = phase_tiny_reference(failures)

    head = next(r for r in rows if r["dtype"] == "bfloat16")
    k1 = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "instructany2pix_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "instructany2pix_tpu/ops/flash_attention.py:44",
        "launches": full["k1_launches"],
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
    log(json.dumps({"full_width": full, "tiny_reference": tiny,
                    "seconds": time.time() - t_start}))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    log(card)
    log(json.dumps({"kernels": [k1]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
