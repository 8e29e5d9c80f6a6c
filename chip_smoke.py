#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure makes the exit code non-zero; the last line is
printed only when every phase passed):
  1. print the card (nvidia-smi name, power limit); build every CUDA
     source in instructany2pix_tpu_torch/csrc with nvcc, one process per
     source, all at once, and print the build time and ptxas report;
  2. K1 (flash-attention forward) against its plain PyTorch version on
     the card, bf16 and fp32, at the shapes the SDXL base and refiner give
     it plus the ImageBind and Llama shapes, on contiguous inputs and on the
     (B, S, H, D) views the router passes, within a limit scaled to each
     element (TOL), each row on the path the kernel must take (it reports
     the one it took: wgmma for bf16 at head_dim 64, 80 and 128, fma
     otherwise); times K1, the plain version and
     F.scaled_dot_product_attention (the yardstick, never called by the
     port) with CUDA events;
  3. K2 (the quantized decode matvec) against its plain version in bf16
     at the four fused Vicuna-7B decode shapes (M = 1 and 16), the unfused
     int8 and int4 formats and the four shapes of the TPU probe, and in
     float32 at two shapes, within a limit scaled to each element
     (QMV_TOL), each row on the path the kernel must take (it reports the
     one it took: mma for bf16 with int4 weights, fma otherwise) with its
     cluster schedulable (cudaOccupancyMaxActiveClusters, printed); times
     K2 on weights that do not stay in L2 (device time from a CUDA graph
     of the calls, and the eager time with the host's launch cost), the
     plain version, and F.linear on bf16 weights dequantized ahead of time
     (the yardstick, never called by the port);
  4. the full width: a checkpoint tree in the reference's layout written
     to a temporary directory from random port modules drawn from a seed
     (fp16 LLM shards and SDXL directories; float32 prior, ImageBind, SAM
     and GroundingDINO; about 33 GB, removed at exit), then
     `InstructAny2PixPipeline(PipelineConfig(), ckpt=tree, llm_quant_bits=4)`
     booted from it in bf16: Vicuna-7B int4 group-128 with fused
     projections (int8 lm_head), ImageBind-huge vision and audio, the GPT-2
     prior and its CLIP-ViT-H text tower, SDXL base with IP, the refiner,
     the VAE, CLIP-L and bigG, SAM ViT-H (bf16) and GroundingDINO Swin-T.
     Bytes and seconds written, boot seconds (read, map and cast,
     quantize), boot peak device memory and host peak RSS; every loaded
     tensor that is not quantized against the checksum of what was
     written, the int4 bytes and scales of the first and last decoder
     layers and the int8 vocab head against the plain quantizer on the
     written fp16 weights. Two text2img requests (plain, and IP) with exact K1 counts; one CFG
     UNet step timed and profiled; then the edit: `forward_llm` on a
     written PNG and WAV (K2 launched exactly 128 times per decode step,
     all on its mma path, K1 by the ImageBind trunks), the prefill and per-token decode times
     against their bound with K2's share of a decode step from
     torch.profiler, and `__call__` on a seeded LLM cache (finite
     1024x1024 images, exact K1 count, seconds per stage, peak memory);
  5. the tiny config in fp32 on the card against the same weights on the
     CPU, with a small int4-grouped LLM: text2img and edit images agree
     within 1 level (the edit also with subject consistency through a tiny
     SAM), greedy tokens are identical (K2 on its fma path).
After phase 3, K3 (SAM's rel-pos flash attention) against its plain
version in bf16 at the SAM ViT-H global and window shapes, two ragged
grids and head_dim 64, on contiguous inputs, on (B, N, H, D) views and
on the chunks of a fused qkv projection that SAM passes (TOL), each on
the wgmma path, timed beside F.scaled_dot_product_attention with the
bias as a (B, H, N, N) mask (the yardstick); float32 must be refused.
Phase 4 then adds the full-width subject consistency: `__call__` with
`subject_strength` through the SAM ViT-H segmentor loaded from the tree (K3
launched exactly once per encoder block, 32 times per segmentor call:
4 global and 28 window blocks, all on the wgmma path; a non-empty mask,
a finite 1024x1024 image, seconds per stage, peak memory), the SAM
encoder timed and split into its global and window attentions, and the
GroundingDINO Swin-T grounder loaded from the tree (float32) on the
edited image.

Training (slice 4): after K3, K1 with a per-row key count (`kv_len`)
against the router's plain masked path, and K4 (the flash backward)
against the plain backward at the Llama training shape with and without
ragged rows, sq != sk, ragged D = 80, the UNet shape, the scalar path and
float32, on contiguous inputs and (B, S, H, D) views (K4_TOL): the whole
backward (`flash_bwd_cuda`: the fused TMA/wgmma kernel at bf16 head_dim 64
and 128, which every such row must report, K4a then K4b otherwise) and,
at the rows K4a then K4b serve, K4a and K4b on their own, each timed
beside its bound, the plain backward and SDPA's backward. After phase 4 (its pipeline freed),
the trainer at full width: `train.launch.train` on Vicuna-7B's widths with
4 of 32 layers, bf16, remat "dots", batch 4 x 2048 of a synthetic dataset
through the port's collate, 5 steps with a preview and a checkpoint
(finite losses, exact K1 and K4 launches per step, the fused path each
time, K4a = K4b = K2 = K3 = 0; step time, tokens/s, peak memory, one step
profiled). After phase 5, the tiny trainer in fp32 on the card against
the CPU (3 steps on K4's fma path, then a falling loss at lr 5e-3, then a
save and a resume).

Every main-path run reads the K1, K2, K3, K4, K4a and K4b counters, set to
0 just before it (K1's, K2's and K4's also by the path each launch took);
K2 must stay at 0 outside `forward_llm`, K3 outside subject consistency,
K4 outside training, and K4a and K4b (the two-kernel entry points)
everywhere.
Then a {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}. `--out PATH` also writes every reading
as JSON.

`python3 chip_smoke.py --planted-faults` runs the checks of phases 2 and
3, of K3 and of K4 against deliberately broken copies of K1 (FAULTS), K2
(QMV_FAULTS), K3 (K3_FAULTS) and K4 (K4_FAULTS) instead, and exits 0 only
if the real kernels pass at every shape and each broken copy is refused.
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
# (`--planted-faults`): (what it breaks, source text, replacement[, file]),
# the file in csrc/ that holds the text when it is not flash_fwd.cu. The
# fma_* ones show on the scalar shapes; the wgmma_* ones patch the Hopper
# loop (flash_fwd_sm90.cuh), the d80_* ones its head_dim 80 tail boxes.
FAULTS = {
    "fma_skip_rescale": (
        "scalar path: the accumulator is not rescaled when the running max grows",
        "for (int i = 0; i < DT; ++i) acc[i] *= alpha;",
        "for (int i = 0; i < DT; ++i) acc[i] *= 1.f;"),
    "wgmma_skip_rescale": (
        "wgmma path: the o accumulator is not rescaled when the running max grows",
        "for (int i = 0; i < DO / 2; ++i) o[i] *= alpha[(i >> 1) & 1];",
        "for (int i = 0; i < DO / 2; ++i) o[i] *= 1.f;", "flash_fwd_sm90.cuh"),
    "wgmma_drop_first_tile": (
        "wgmma path: the first key tile is never loaded (tile i holds the keys of tile i + 1)",
        "const int key0 = it * kKeys;", "const int key0 = (it + 1) * kKeys;",
        "flash_fwd_sm90.cuh"),
    "wgmma_no_key_tail_mask": (
        "wgmma path: keys past Sk (or kv_len) are not masked, so the zero-filled tail of the "
        "last tile counts",
        "const bool valid = col < skb && (!causal || col <= rows[r] + offset);",
        "const bool valid = !causal || col <= rows[r] + offset;", "flash_fwd_sm90.cuh"),
    "wgmma_causal_tile_short": (
        "wgmma path: the causal tile bound is one key tile short",
        "kend = max(0, min(skb, last + offset + 1));",
        "kend = max(0, min(skb, last + offset + 1 - kKeys));", "flash_fwd_sm90.cuh"),
    "wgmma_neighbour_stage": (
        "wgmma path: Q.K^T reads k from the neighbouring stage of the ring",
        "const uint32_t k_tile = sk + stage * kTileBytes;",
        "const uint32_t k_tile = sk + ((stage + 1) % kStages) * kTileBytes;",
        "flash_fwd_sm90.cuh"),
    "d80_k_tail_columns": (
        "head_dim 80: k's tail box is loaded from columns 0-15 instead of 64-79",
        "tma_load(k_dst + kHalves * kKHalf, &maps.k_tail, k_full + 8 * stage, kMainCols, key0, h, b);",
        "tma_load(k_dst + kHalves * kKHalf, &maps.k_tail, k_full + 8 * stage, 0, key0, h, b);",
        "flash_fwd_sm90.cuh"),
    "d80_qk_tail_step_dropped": (
        "head_dim 80: Q.K^T skips its 5th k-step (columns 64-79)",
        "if constexpr (kTail > 0) {  // Q.K^T's last k-step",
        "if constexpr (false) {  // Q.K^T's last k-step", "flash_fwd_sm90.cuh"),
    "d80_pv_tail_dropped": (
        "head_dim 80: P.V never computes o's last 16 columns",
        "Wgmma<kTail>::rs(", "if (false) Wgmma<kTail>::rs(", "flash_fwd_sm90.cuh"),
    "d80_o_tail_unswizzled": (
        "head_dim 80: o's last 16 columns are written to shared memory without the 32-byte "
        "swizzle the store's map reads them with",
        "const int chunk = (j - 8 * kHalves) ^ ((lrow >> 2) & 1);",
        "const int chunk = j - 8 * kHalves;", "flash_fwd_sm90.cuh"),
}
K1_SHAPES = [
    # (label, (B, H, Sq, D), Sk, causal)
    ("unet self 64x64", (2, 10, 4096, 64), 4096, False),
    ("unet self 32x32", (2, 20, 1024, 64), 1024, False),
    ("unet text cross", (2, 10, 4096, 64), 77, False),
    ("unet ip cross", (2, 10, 4096, 64), 4, False),
    ("refiner self 64x64", (2, 12, 4096, 64), 4096, False),
    ("refiner self 32x32", (2, 24, 1024, 64), 1024, False),
    ("ragged d=64", (2, 10, 1000, 64), 999, False),
    ("imagebind vit-h", (1, 16, 257, 80), 257, False),
    ("non-causal d=80 sq!=sk", (2, 8, 333, 80), 517, False),
    ("llama causal", (1, 32, 600, 128), 600, True),
    ("llama causal sq<sk", (1, 32, 64, 128), 600, True),
    ("non-causal d=128 sq!=sk", (2, 8, 333, 128), 517, False),
    ("head_dim 72 (fma path)", (1, 4, 300, 72), 200, False),
]


def k1_path_expected(dname, d):
    """The path K1 must take for rows with 16-byte aligned strides (every
    checked tensor): wgmma for bf16 at head_dim 64, 80 and 128, the scalar
    fma loop otherwise."""
    if dname != "bfloat16":
        return "fma"
    return "wgmma" if d in (64, 80, 128) else "fma"


def reset_k1(fa):
    fa.flash_fwd_cuda.launches = 0
    fa.flash_fwd_cuda.launches_by_path = dict.fromkeys(fa.K1_PATHS, 0)


def k1_paths_of(fa, fn, counter=None):
    """Run fn and return (its result, the K1 paths it launched, in order of
    K1_PATHS, each with its count); K3's with `counter` =
    fa.flash_relpos2d_cuda."""
    counter = counter or fa.flash_fwd_cuda
    before = dict(counter.launches_by_path)
    out = fn()
    return out, {p: n - before[p] for p, n in counter.launches_by_path.items() if n != before[p]}


def reset_k3(fa):
    fa.flash_relpos2d_cuda.launches = 0
    fa.flash_relpos2d_cuda.launches_by_path = dict.fromkeys(fa.K1_PATHS, 0)

# K2 vs its plain version, per output element:
#   |y - y_ref| <= 2^-7 max(|y_ref|, |y_ref - r|) + 2^-6 sigma + 2^-14 A
# with sigma = sqrt(sum_k (x'_k W_kn)^2) and A = sum_k |x'_k W_kn| over the
# dequantized W. Both sides round the float32 sum to bf16 and again after
# the residual r: one bf16 ulp (2^-7) of either value. The prologue's
# statistics and silu are computed in another order on each side, so a
# rounded x'_k may land on the neighbouring bf16 value (2^-8 relative): a
# sum whose spread is under 2^-8 sigma, and 2^-6 sigma is 4 of those. The
# float32 sums over K <= 28672 terms in another order differ by about
# sqrt(K) 2^-24 A < 2^-16 A; 2^-14 A is 4 of those. On the mma path the
# tensor cores sum each group's 128 exact products (bf16 x' times int4)
# before the float32 running sum: the same float32 terms in another order.
QMV_TOL = {"ulp": 2.0**-7, "stol": 2.0**-6, "atol": 2.0**-14}
QMV_SHAPES = [
    # (label, K, N, format, fusion, rows M, activations)
    ("7B qkv + norm", 4096, 12288, "int4g", "norm", (1, 16), "bfloat16"),
    ("7B o + residual", 4096, 4096, "int4g", "residual", (1, 16), "bfloat16"),
    ("7B gate_up + norm", 4096, 22016, "int4g", "norm", (1, 16), "bfloat16"),
    ("7B down + swiglu + residual", 11008, 4096, "int4g", "swiglu+residual", (1, 16), "bfloat16"),
    ("int8 per-channel", 4096, 4096, "int8", "none", (1, 16), "bfloat16"),
    ("int4 per-channel", 4096, 11008, "int4", "none", (1,), "bfloat16"),
    # the TPU probe's shapes (benchmarks/qmv_dma_probe.py:29), int4 group 128
    ("probe qkv", 4096, 12288, "int4g", "none", (1,), "bfloat16"),
    ("probe o", 4096, 4096, "int4g", "none", (1,), "bfloat16"),
    ("probe up", 4096, 11008, "int4g", "none", (1,), "bfloat16"),
    ("probe down", 11008, 4096, "int4g", "none", (1,), "bfloat16"),
    # the fma path with float32 activations, as the tiny decode runs it
    ("fp32 qkv + norm", 4096, 4096, "int4g", "norm", (3, 16), "float32"),
    ("fp32 int4 down + swiglu + residual", 11008, 4096, "int4", "swiglu+residual", (4,),
     "float32"),
    # int4 groups other than 128 (the format's suffix): a multiple of 128 on
    # the tensor cores, a group that ends inside a stage on the CUDA cores
    ("int4 group 256 + residual", 4096, 4096, "int4g256", "residual", (1,), "bfloat16"),
    ("int4 group 64 + norm", 4096, 4096, "int4g64", "norm", (1, 16), "bfloat16"),
    # K % 8 != 0: x, up and the gains read at any alignment, the last
    # vector partial
    ("int8 K=4099 + norm", 4099, 4096, "int8", "norm", (1,), "bfloat16"),
    ("int4 K=2052 + swiglu + residual", 2052, 4096, "int4", "swiglu+residual", (3,), "bfloat16"),
    # chunks whose x' does not fit the shared memory, staged in windows
    ("70B down K + swiglu + norm", 28672, 4096, "int4g", "swiglu+norm", (16,), "bfloat16"),
    ("fp32 K=16384 + swiglu + norm", 16384, 4096, "int4g", "swiglu+norm", (16,), "float32"),
]
# Deliberately broken copies of K2 (csrc/qmv.cu) that the check must refuse.
QMV_FAULTS = {
    "nibble_xor_dropped": (
        "mma path: the nibbles are read as offset binary without the XOR with 8",
        '"r"(0x000F000Fu), "r"(0x43084308u)', '"r"(0x000F000Fu), "r"(0x43004300u)'),
    "high_nibble_next_byte": (
        "mma path: the odd row's nibble taken from the next byte, not bits 4-7 of its own",
        "v4[q] = v[q] >> 4;", "v4[q] = v[q] >> 8;"),
    "group_scale_first": (
        "int4 group 128: every stage of a chunk takes the chunk's first group scale",
        "(s0 + s) * kK / p.group);", "s0 * kK / p.group);"),
    "cluster_rank_dropped": (
        "the partial sums of cluster rank 0 are left out of the DSMEM sum",
        "for (int q = 0; q < csize; ++q) s += recv[(q * p.M + m) * cols + cl];",
        "for (int q = 1; q < csize; ++q) s += recv[(q * p.M + m) * cols + cl];"),
    "norm_stats_own_chunk": (
        "RMSNorm statistics from the block's own chunk of the row only",
        "for (int q = 0; q < csize; ++q) t += ss[q * kMaxM + tid];",
        "t = ss[rank * kMaxM + tid];"),
    "columns_unpermuted": (
        "mma path: the output columns written under the unpermuted fragment mapping",
        "const int col = 8 * slot_of(e < 2 ? g : g + 8) + j;",
        "const int col = 8 * (e < 2 ? g : g + 8) + j;"),
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
# Deliberately broken copies of K3 (the RelPos2dBias policy of the wgmma
# kernel in csrc/flash_fwd_sm90.cuh) that the check must refuse.
K3_FAULTS = {
    "bias_indices_swapped": (
        "bh is read at the key's grid column and bw at its grid row",
        "return x + row[c.u] + row[kWarpRows * gp + c.w];",
        "return x + row[c.w] + row[kWarpRows * gp + c.u];", "flash_fwd_sm90.cuh"),
    "bias_first_tile_only": (
        "the bias is added in the first 128-key tile only",
        "float x = bias.add(s[i] * scale2, brows[r], bc);",
        "float x = kt == 0 ? bias.add(s[i] * scale2, brows[r], bc) : s[i] * scale2;",
        "flash_fwd_sm90.cuh"),
    "bias_rows_unpadded": (
        "the bias rows are staged with an unpadded stride and read with the padded one",
        "dst[r * gp + c] = e4[e] * kLog2e;", "dst[r * G + c] = e4[e] * kLog2e;",
        "flash_fwd_sm90.cuh"),
    "bias_natural_units": (
        "the bias is added in natural units to logits in base-2 units (log2 e not folded in)",
        "dst[r * gp + c] = e4[e] * kLog2e;", "dst[r * gp + c] = e4[e];", "flash_fwd_sm90.cuh"),
    "bias_other_warpgroup": (
        "each consumer warp stages the bias rows of the other warpgroup's queries",
        "bias.stage(warp_bias, bh, wg_row0 + 16 * warp, lane);",
        "bias.stage(warp_bias, bh, row0 + 64 * (1 - cw) + 16 * warp, lane);",
        "flash_fwd_sm90.cuh"),
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
    (o, lse), taken = k1_paths_of(fa, lambda: fa.flash_fwd_cuda(q, k, v, causal, scale,
                                                                 return_lse=True))
    readings.append(k1_reading(o, lse, ref))
    (o, lse), taken_bshd = k1_paths_of(fa, lambda: fa.flash_fwd_cuda(*views, causal, scale,
                                                                      return_lse=True))
    readings.append(k1_reading(o, lse, ref))
    # the path the kernel reports, for both layouts; every tensor here has
    # 16-byte aligned rows
    path = "/".join(sorted({*taken, *taken_bshd}))
    expected = k1_path_expected(dname, d)
    path_ok = taken == taken_bshd == {expected: 1}
    ok = all(r["ok"] for r in readings) and path_ok
    row = {
        "label": label, "dtype": dname, "path": path, "path_expected": expected,
        "shape": list(shape), "sk": sk, "causal": causal, "ok": ok,
        "err_o": max(r["err_o"] for r in readings),
        "of_limit": max(r["of_limit"] for r in readings),
        "of_limit_bhsd": readings[0]["of_limit"],
        "of_limit_bshd": readings[1]["of_limit"],
        "err_lse": max(r["err_lse"] for r in readings),
        "limit_median": ref[2].median().item(),
    }
    if not ok:
        failures.append(f"K1 {label} {dname}: |o| {row['err_o']:.3g} = {row['of_limit']:.3g} of "
                        f"its limit, |lse| {row['err_lse']:.3g}, path {path} (expected "
                        f"{expected})")
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


def qmv_bound(m, k, n, xk, fmt, fusion, dname="bfloat16"):
    """Least time for one K2 call: bytes (packed W, scales, x, g, residual,
    out, each once) over 3.35 TB/s, or the multiply-adds over the peak for
    their type: bf16 activations times int4 or int8 weights are exact bf16
    products (989 TFLOP/s on the tensor cores), float32 activations run on
    the CUDA cores (67 TFLOP/s)."""
    fmt, group = qmv_format(fmt)
    wbytes = (k // 2 if fmt != "int8" else k) * n
    sbytes = 4 * n * (k // group if fmt == "int4g" else 1)
    act = 2 if dname == "bfloat16" else 4
    nbytes = wbytes + sbytes + act * m * xk + act * m * n
    if "norm" in fusion:
        nbytes += act * xk  # the gains, in x's dtype
    if "residual" in fusion:
        nbytes += act * m * n
    flops = 2.0 * m * k * n
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dname]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations"), nbytes


def qmv_format(fmt):
    """A QMV_SHAPES format and its group: "int4g" is group 128, "int4g64"
    group 64."""
    if fmt.startswith("int4g"):
        return "int4g", int(fmt[5:] or 128)
    return fmt, 128


def _qmv_inputs(k, n, fmt, fusion, m, seed, dname="bfloat16"):
    import torch

    from instructany2pix_tpu_torch.ops import quant as Q

    g = torch.Generator("cuda").manual_seed(seed)
    fmt, group = qmv_format(fmt)
    quant = {"int8": Q.quantize_weight, "int4": Q.quantize_weight_int4,
             "int4g": lambda w: Q.quantize_weight_int4_grouped(w, group)}[fmt]
    q = quant(torch.randn((k, n), generator=g, device="cuda") * k**-0.5)
    swiglu = "swiglu" in fusion
    xk = 2 * k if swiglu else k
    dtype = getattr(torch, dname)
    x = torch.randn((m, xk), generator=g, device="cuda").to(dtype)
    # the gain in x's dtype, as the model holds its norm weights
    gain = ((torch.randn(xk, generator=g, device="cuda") * 0.1 + 1.0).to(dtype) if "norm" in fusion
            else None)
    r = (torch.randn((m, n), generator=g, device="cuda").to(dtype) if "residual" in fusion
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
    """K2 against its plain version at every QMV_SHAPES entry; each row on
    the path the kernel must take (Q.qmv_path: mma for bf16 with int4
    weights, fma otherwise), which it reports, with its cluster
    schedulable (cudaOccupancyMaxActiveClusters > 0); with `timed`, K2
    (rotating weight copies that together exceed L2, as decode finds its
    weights cold; a CUDA graph of the calls, and eager), the plain version
    and F.linear on bf16 weights dequantized ahead of time, timed with
    CUDA events."""
    import torch
    import torch.nn.functional as F

    from instructany2pix_tpu_torch.ops import quant as Q

    rows = []
    for si, (label, k, n, fmt, fusion, ms_, dname) in enumerate(QMV_SHAPES):
        for m in ms_:
            q, x, gain, swiglu, r = _qmv_inputs(k, n, fmt, fusion, m, 1000 + si, dname)
            xk = x.shape[1]
            before = dict(Q.qmv_cuda.launches_by_path)
            y = Q.qmv_cuda(x, q, gain, 1e-6, swiglu, r)
            taken = {p: c - before[p] for p, c in Q.qmv_cuda.launches_by_path.items()
                     if c != before[p]}
            ref = Q._qmv_reference(x, q, gain, 1e-6, swiglu, r)
            base, group = qmv_format(fmt)
            plan = Q.qmv_plan(m, k, n, base, x.dtype, swiglu, gain is not None, group)
            expected = Q.qmv_path(base, x.dtype, group)
            clusters = Q.qmv_max_active_clusters(q, m, x.dtype, swiglu, gain is not None)
            reading = qmv_reading(y, ref, q, x, gain, swiglu, r)
            row = {"label": label, "format": fmt, "fusion": fusion, "dtype": dname, "m": m,
                   "k": k, "n": n, **reading, "path": "/".join(sorted(taken)),
                   "path_expected": expected, "chunk": plan.chunk, "cluster": plan.cluster,
                   "blocks": plan.cluster * n // plan.tile, "max_active_clusters": clusters}
            row["ok"] = reading["ok"] and taken == {expected: 1} and clusters > 0
            if not row["ok"]:
                failures.append(f"K2 {label} M={m}: |y| {row['err']:.3g} = "
                                f"{row['of_limit']:.3g} of its limit, path {row['path']} "
                                f"(expected {expected}), {clusters} clusters schedulable")
            msg = (f"K2 {label:34s} {fmt:8s} {dname[:4]} M={m:<2d} K={k:<5d} N={n:<5d} "
                   f"{row['path']} cluster {plan.cluster}x{plan.chunk:<4d} "
                   f"({row['blocks']} blocks, {clusters} clusters resident) "
                   f"|y|={row['err']:.3g} (of limit {row['of_limit']:.3f})")
            if timed:
                row["bound_ms"], row["bound_by"], nbytes = qmv_bound(m, k, n, xk, fmt, fusion,
                                                                     dname)
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
                h = Q._prologue(x, gain, 1e-6, swiglu).bfloat16()
                wt = _dequant(q).T.contiguous().bfloat16()
                lib = [wt] + [wt.clone() for _ in range(-(-2 * L2_BYTES // (2 * wt.numel())) - 1)]
                row["library_ms"] = graph_ms([lambda w=w: F.linear(h, w) for w in lib])
                del lib, wt
                row["gbps"] = nbytes / (row["ms"] * 1e-3) / 1e9
                row["of_bound"] = row["ms"] / row["bound_ms"]
                msg += (f" ms={row['ms']:.4f} (eager {row['ms_eager']:.4f}) plain={row['plain_ms']:.4f} "
                        f"F.linear(bf16 W)={row['library_ms']:.4f} bound={row['bound_ms']:.4f} "
                        f"({row['bound_by']}, x{row['of_bound']:.2f}) {row['gbps']:.0f} GB/s")
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
    chunks of a fused qkv projection that SAM's encoder passes, each call
    on the wgmma path; float32 must be refused. With `timed`, K3, the plain version and SDPA
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
            readings, taken = [], []
            for lq, lk, lv in ((q, k, v), views, qkv_views(q, k, v)):
                o, paths = k1_paths_of(fa, lambda: fa.flash_relpos2d_cuda(lq, lk, lv, bh, bw, scale),
                                       fa.flash_relpos2d_cuda)
                taken.append(paths)
                diff = (o.float() - o_ref.float()).abs()
                readings.append({"err": diff.max().item(), "of_limit": (diff / limit).max().item(),
                                 "ok": bool((diff <= limit).all())})
            path = "/".join(sorted({p for t in taken for p in t}))
            row = {"label": label, "shape": [b, h, g * g, d], "g": g, "dtype": "bfloat16",
                   "path": path, "ok": all(r["ok"] for r in readings)
                   and all(t == {"wgmma": 1} for t in taken),
                   "err_o": max(r["err"] for r in readings),
                   "of_limit": max(r["of_limit"] for r in readings),
                   "of_limit_bhsd": readings[0]["of_limit"], "of_limit_bshd": readings[1]["of_limit"],
                   "of_limit_qkv": readings[2]["of_limit"]}
            if not row["ok"]:
                failures.append(f"K3 {label}: |o| {row['err_o']:.3g} = {row['of_limit']:.3g} of its "
                                f"limit, paths {taken} (expected wgmma on each layout)")
            msg = (f"K3 {label:17s} {path} (B,H,N,D)=({b},{h},{g * g},{d}) g={g:<3d} "
                   f"|o|={row['err_o']:.3g} (of limit: bhsd {row['of_limit_bhsd']:.3f}, bshd "
                   f"{row['of_limit_bshd']:.3f}, qkv {row['of_limit_qkv']:.3f})")
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


# K4a/K4b (the flash backward) vs the plain backward, per element of dq, dk
# and dv:  |x - x_ref| <= RTOL * |x_ref| + STOL * sigma
# with dq = sum_j ds_j k_j, dk = sum_i ds_i q_i, dv = sum_i p_i dO_i. Both
# sides round ds and p to the operand dtype before the products, from
# float32 values that came out of sums in another order, so a rounded
# operand may land on the neighbouring bf16 value (2^-8 relative). For ds
# that step is relative to m = p (|dp| + |delta|) scale, the size of the
# terms ds is formed from (dp - delta cancels), not to ds itself. sigma is
# sqrt(sum_j (m_j k_j)^2) for dq, sqrt(sum_i (m_i q_i)^2) for dk and
# sqrt(sum_i (p_i dO_i)^2) for dv: the scale of the noise those steps put
# into the sums, whose standard deviation stays under 2^-8 sigma; 2^-5 sigma
# is 8 of those, as for K1. Both sides round the output to bf16: together at
# most one ulp (2^-7 |x|). In fp32 the sides differ only in summation order
# and the last bits of exp: 2^-15 both, as for K1.
K4_TOL = {
    "bfloat16": {"rtol": 2**-7, "stol": 2**-5},
    "float32": {"rtol": 2**-15, "stol": 2**-15},
}
K4_SHAPES = [
    # (label, (B, H, Sq, D), Sk, causal, kv_len per row or None, dtype)
    ("llama train", (4, 32, 2048, 128), 2048, True, None, "bfloat16"),
    ("llama train ragged", (4, 32, 2048, 128), 2048, True, (2048, 1900, 1537, 1000), "bfloat16"),
    ("non-causal sq!=sk", (2, 8, 333, 128), 517, False, None, "bfloat16"),
    ("causal sq<sk", (1, 32, 64, 128), 600, True, None, "bfloat16"),
    ("ragged d=80", (2, 16, 1000, 80), 1000, True, (1000, 613), "bfloat16"),
    ("unet self 64x64", (2, 10, 4096, 64), 4096, False, None, "bfloat16"),
    ("head_dim 72 (fma path)", (1, 4, 300, 72), 200, False, None, "bfloat16"),
    ("float32 ragged", (2, 4, 300, 64), 300, True, (300, 123), "float32"),
]
# K1 with kv_len vs the plain masked path the router took before (TOL)
K1_KV_SHAPES = [
    ("llama train ragged", (4, 32, 2048, 128), 2048, True, (2048, 1900, 1537, 1000), "bfloat16"),
    ("ragged d=80", (2, 16, 1000, 80), 1000, True, (1000, 613), "bfloat16"),
    ("float32 ragged", (2, 4, 300, 64), 300, True, (300, 123), "float32"),
]
# The autograd Function through the router (K1 forward, delta, K4a and K4b
# backward) against the plain backward on its own output (K4_TOL)
FN_SHAPES = [
    # (label, (B, S, H, D) as the Llama passes it, kv_len per row, dtype)
    ("llama train ragged", (4, 2048, 32, 128), (2048, 1900, 1537, 1000), "bfloat16"),
    ("ragged d=80", (2, 1000, 16, 80), (1000, 613), "bfloat16"),
    ("float32 ragged", (2, 300, 4, 64), (300, 123), "float32"),
]
# Deliberately broken copies of K4 that the check must refuse: the first four
# patch the two-kernel path (csrc/flash_bwd.cu), which the whole backward
# takes at D = 80, 72 and in float32 and the check also runs on its own
# there; the fused_* ones patch the fused wgmma kernel (flash_bwd_sm90.cuh).
K4_FAULTS = {
    "delta_dropped": (
        "K4a: ds = p * dp * scale, without delta",
        "s[j][e] = p * (dp[j][e] - delta_r[r]) * a.scale;", "s[j][e] = p * dp[j][e] * a.scale;"),
    "causal_start_late": (
        "K4b: the causal query loop starts one tile late",
        "if (a.causal) qt0 = (max(key0 - offset, 0) / kTile) * kTile;",
        "if (a.causal) qt0 = (max(key0 - offset, 0) / kTile + 1) * kTile;"),
    "ds_scale_missing": (
        "K4b: ds = p * (dp - delta), without the scale",
        "dp[j][e] = p * (dp[j][e] - dl) * a.scale;", "dp[j][e] = p * (dp[j][e] - dl);"),
    "kv_len_ignored": (
        "K4a and K4b: every row sees all Sk keys (kv_len is not passed on to the kernels)",
        "  a.kv_len = kv_len;\n", "  a.kv_len = nullptr;\n"),
    "fused_delta_dropped": (
        "fused path: ds = p * dp * scale, without delta",
        "dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dlt) * p.scale;",
        "dp[4 * j + e] = s[4 * j + e] * dp[4 * j + e] * p.scale;", "flash_bwd_sm90.cuh"),
    "fused_causal_start_late": (
        "fused path: the causal query loop starts one tile late",
        "const int qt0 = p.causal ? max(key0 - offset, 0) / kQRows : 0;",
        "const int qt0 = p.causal ? max(key0 - offset, 0) / kQRows + 1 : 0;", "flash_bwd_sm90.cuh"),
    "fused_dq_partial_tile_dropped": (
        "fused path: dq of a partial query tile (Sq not a multiple of 64) is never added",
        "if (ct == 0) {  // one thread issues both reduce-adds",
        "if (ct == 0 && q0 + kQRows <= p.Sq) {  // one thread issues both reduce-adds",
        "flash_bwd_sm90.cuh"),
    "fused_kv_len_tail_unmasked": (
        "fused path: keys at or past kv_len[b] are not masked",
        "const bool valid = row < Sq && key < skb && (!causal || key <= row + offset);",
        "const bool valid = row < Sq && (!causal || key <= row + offset);", "flash_bwd_sm90.cuh"),
    "fused_neighbour_stage": (
        "fused path: the consumers read q and dO from the neighbouring stage of the ring",
        "const uint32_t q_tile = ring + stage * L::kStageBytes;",
        "const uint32_t q_tile = ring + ((stage + 1) % kStages) * L::kStageBytes;",
        "flash_bwd_sm90.cuh"),
}


def k4_path_expected(dname, d):
    """The path of the whole backward (`flash_bwd_cuda`) for rows with
    16-byte aligned strides: the fused wgmma kernel for bf16 at head_dim 64
    and 128, K4a and K4b on mma.sync for bf16 at 80, on the scalar fma loop
    otherwise."""
    if dname != "bfloat16":
        return "fma"
    return {64: "wgmma", 128: "wgmma", 80: "mma"}.get(d, "fma")


def reset_k4(fa):
    fa.flash_bwd_cuda.launches = 0
    fa.flash_bwd_cuda.launches_by_path = dict.fromkeys(fa.K4_PATHS, 0)
    fa.flash_bwd_dq_cuda.launches = 0
    fa.flash_bwd_dkv_cuda.launches = 0


def no_k4(fa, failures, path):
    """K4, K4a and K4b launches of an inference path (set to 0 just before
    it), which must be 0: nothing there needs a gradient."""
    f, a, b = (fa.flash_bwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
               fa.flash_bwd_dkv_cuda.launches)
    if f or a or b:
        failures.append(f"{path}: K4 {f}, K4a {a} and K4b {b} launches (expected 0)")
    return {"k4_launches": f, "k4a_launches": a, "k4b_launches": b}


def _kv_tensor(kv):
    import torch

    return None if kv is None else torch.tensor(kv, dtype=torch.int32, device="cuda")


def visible_pairs(b, h, sq, sk, causal, kv):
    """(query, key) pairs the masks leave visible: the work a kernel with
    exact masking must do for these inputs."""
    import numpy as np

    rows = np.arange(sq)
    total = 0
    for bi in range(b):
        lim = sk if kv is None else min(sk, kv[bi])
        vis = np.minimum(lim, rows + (sk - sq) + 1) if causal else np.full(sq, lim)
        total += int(np.clip(vis, 0, None).sum())
    return h * total


def k4_bound(shape, sk, causal, kv, dtype_name):
    """Least time of the whole backward and of K4a and K4b alone: the
    backward does 5 products of 2 D flops per visible pair (q.k, dO.v,
    p^T.dO, ds^T.q, ds.k), K4a 3 (q.k, dO.v, ds.k), K4b 4 (q.k, dO.v,
    p^T.dO, ds^T.q), over the peak for the dtype; bytes: q, k, v, dO read
    once, lse and delta read, dq, dk and dv (K4a: dq; K4b: dk and dv)
    written, over 3.35 TB/s."""
    b, h, sq, d = shape
    pairs = visible_pairs(b, h, sq, sk, causal, kv)
    elem = 2 if dtype_name == "bfloat16" else 4
    out = {}
    for name, products, nbytes in (
            ("bwd", 5, elem * b * h * d * (3 * sq + 4 * sk) + 8 * b * h * sq),
            ("dq", 3, elem * b * h * d * (3 * sq + 2 * sk) + 8 * b * h * sq),
            ("dkv", 4, elem * b * h * d * (2 * sq + 4 * sk) + 8 * b * h * sq)):
        flops = 2.0 * products * d * pairs
        t_ops, t_mem = flops / PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes", flops)
    return out


def k4_sigmas(fa, q, k, v, g, lse, delta, causal, scale, kv_len):
    """sigma for dq, dk and dv (see K4_TOL), from the float32 p and dp."""
    import torch

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    vis = fa._visible(q.shape[2], k.shape[2], causal, kv_len, q.device)
    p = s.sub_(lse[..., None]).exp_().masked_fill_(~vis, 0.0)
    del s
    m = torch.matmul(g.float(), v.float().transpose(-1, -2)).abs_()
    m.add_(delta.abs()[..., None]).mul_(p).mul_(scale).square_()
    sig_dq = torch.matmul(m, k.float().square()).sqrt_()
    sig_dk = torch.matmul(m.transpose(-1, -2), q.float().square()).sqrt_()
    del m
    sig_dv = torch.matmul(p.square_().transpose(-1, -2), g.float().square()).sqrt_()
    return sig_dq, sig_dk, sig_dv


def _reading(x, ref, sigma, tol):
    """Max |x - x_ref|, the largest share of its limit and whether every
    element is within it (NaN fails; where the limit is 0 only 0 passes)."""
    import torch

    ref = ref.float()
    diff = (x.float() - ref).abs()
    limit = tol["rtol"] * ref.abs() + tol["stol"] * sigma
    share = torch.where(diff == 0, torch.zeros_like(diff), diff / limit)
    return {"err": diff.max().item(), "of_limit": share.max().item(),
            "ok": bool((diff <= limit).all())}


def k4_paths_of(fa, fn):
    """Run fn and return (its result, the paths of the whole backward it
    launched, each with its count)."""
    before = dict(fa.flash_bwd_cuda.launches_by_path)
    out = fn()
    return out, {p: n - before[p] for p, n in fa.flash_bwd_cuda.launches_by_path.items()
                 if n != before[p]}


def _k4_row(failures, timed, si, label, shape, sk, causal, kv, dname):
    """The whole backward (`flash_bwd_cuda`, on the path k4_path_expected
    names) against the plain backward, on contiguous inputs and on
    (B, S, H, D) views, every element of dq, dk and dv within K4_TOL; where
    that path is K4a then K4b (not the fused kernel), also K4a and K4b
    called on their own. With `timed`, the whole backward (its
    accumulator's zeroing and cast included; also with delta), there K4a
    and K4b alone, the plain backward and SDPA's backward."""
    import torch
    import torch.nn.functional as F

    from instructany2pix_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dname)
    b, h, sq, d = shape
    gen = torch.Generator("cuda").manual_seed(3000 + si)
    q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    kv_len = _kv_tensor(kv)
    scale = d**-0.5
    o, lse = fa._reference_attention(q, k, v, causal, scale, True, kv_len)
    delta = fa.flash_delta(g, o)
    ref = fa.flash_bwd_reference(q, k, v, o, lse, g, causal, scale, kv_len, delta)
    sigmas = k4_sigmas(fa, q, k, v, g, lse, delta, causal, scale, kv_len)
    tol = K4_TOL[dname]
    views = tuple(bshd_view(x) for x in (q, k, v, g))

    def reading(grads):
        return {n: _reading(x, r, sg, tol)
                for n, x, r, sg in zip(("dq", "dk", "dv"), grads, ref, sigmas)}

    expected = k4_path_expected(dname, d)
    two_kernel = expected != "wgmma"  # K4a and K4b are the route of this row
    readings = {"fused": [], "two": []}  # per layout: bhsd, then bshd
    taken = {}
    for lq, lk, lv, lg in ((q, k, v, g), views):
        grads, paths = k4_paths_of(fa, lambda: fa.flash_bwd_cuda(
            lq, lk, lv, lg, lse, delta, causal, scale, kv_len))
        readings["fused"].append(reading(grads))
        for p_, n in paths.items():
            taken[p_] = taken.get(p_, 0) + n
        del grads
        if two_kernel:
            dq = fa.flash_bwd_dq_cuda(lq, lk, lv, lg, lse, delta, causal, scale, kv_len)
            dk, dv = fa.flash_bwd_dkv_cuda(lq, lk, lv, lg, lse, delta, causal, scale, kv_len)
            readings["two"].append(reading((dq, dk, dv)))
            del dq, dk, dv
    torch.cuda.synchronize()
    every = readings["fused"] + readings["two"]
    row = {"label": label, "dtype": dname, "path": "/".join(sorted(taken)),
           "path_expected": expected, "shape": list(shape), "sk": sk, "causal": causal,
           "kv_len": list(kv) if kv else None,
           "ok": all(r[n]["ok"] for r in every for n in r) and taken == {expected: 2}}
    for n in ("dq", "dk", "dv"):
        row[f"err_{n}"] = max(r[n]["err"] for r in every)
        row[f"of_limit_{n}"] = max(r[n]["of_limit"] for r in every)
    row["of_limit"] = max(row[f"of_limit_{n}"] for n in ("dq", "dk", "dv"))
    for key, rs in (("fused", readings["fused"]), ("two_kernel", readings["two"]),
                    ("bhsd", every[0::2]), ("bshd", every[1::2])):
        row[f"of_limit_{key}"] = max((r[n]["of_limit"] for r in rs for n in r), default=None)
    row["err"] = max(row[f"err_{n}"] for n in ("dq", "dk", "dv"))
    if not row["ok"]:
        failures.append(f"K4 {label} {dname}: " + ", ".join(
            f"|{n}| {row['err_' + n]:.3g} = {row['of_limit_' + n]:.3g} of its limit"
            for n in ("dq", "dk", "dv")) + f"; path {row['path']} (expected {expected})")
    msg = (f"K4 {label:22s} {dname:8s} {row['path']:5s} {str(shape):18s} sk={sk:<5d} "
           f"causal={int(causal)} kv_len={kv} of limit: dq {row['of_limit_dq']:.3f} dk "
           f"{row['of_limit_dk']:.3f} dv {row['of_limit_dv']:.3f} (whole backward "
           f"{row['of_limit_fused']:.3f}"
           + (f", K4a+K4b alone {row['of_limit_two_kernel']:.3f}" if two_kernel else "")
           + f"; bhsd {row['of_limit_bhsd']:.3f}, bshd {row['of_limit_bshd']:.3f})")
    del sigmas, ref
    if timed:
        iters = 10 if sq * sk >= 1 << 22 else 50
        row["ms"] = time_ms(
            lambda: fa.flash_bwd_cuda(q, k, v, g, lse, delta, causal, scale, kv_len), iters)
        row["ms_bshd"] = time_ms(
            lambda: fa.flash_bwd_cuda(*views, lse, delta, causal, scale, kv_len), iters)
        row["ms_with_delta"] = time_ms(lambda: fa.flash_bwd_cuda(
            q, k, v, g, lse, fa.flash_delta(g, o), causal, scale, kv_len), iters)
        if two_kernel:
            row["ms_dq"] = time_ms(
                lambda: fa.flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale, kv_len), iters)
            row["ms_dkv"] = time_ms(
                lambda: fa.flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale, kv_len),
                iters)
        row["plain_ms"] = time_ms(lambda: fa.flash_bwd_reference(
            q, k, v, o, lse, g, causal, scale, kv_len, delta), 3, 1)
        # SDPA's backward as the yardstick (never called by the port): dq, dk
        # and dv in one call, its own delta included
        sdpa = {"scale": scale}
        if causal and sq == sk and kv is None:
            sdpa["is_causal"] = True
        elif causal or kv is not None:
            sdpa["attn_mask"] = fa._visible(sq, sk, causal, kv_len, q.device)
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(qr, kr, vr, **sdpa)
        row["library_ms"] = time_ms(
            lambda: torch.autograd.grad(out, (qr, kr, vr), g, retain_graph=True), iters)
        del out, qr, kr, vr
        bounds = k4_bound(shape, sk, causal, kv, dname)
        row["bound_ms"], row["bound_by"], flops = bounds["bwd"]
        row["bound_ms_dq"], row["bound_by_dq"], flops_dq = bounds["dq"]
        row["bound_ms_dkv"], row["bound_by_dkv"], flops_dkv = bounds["dkv"]
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        msg += (f" K4 {row['ms']:.4f} ms (bshd {row['ms_bshd']:.4f}, with delta "
                f"{row['ms_with_delta']:.4f}, bound {row['bound_ms']:.4f} {row['bound_by']}, "
                f"{row['tflops']:.1f} TFLOP/s)")
        if two_kernel:
            row["tflops_dq"] = flops_dq / (row["ms_dq"] * 1e-3) / 1e12
            row["tflops_dkv"] = flops_dkv / (row["ms_dkv"] * 1e-3) / 1e12
            msg += f" K4a {row['ms_dq']:.4f} K4b {row['ms_dkv']:.4f}"
        msg += f" plain bwd {row['plain_ms']:.4f} sdpa bwd {row['library_ms']:.4f}"
    log(msg + (" ok" if row["ok"] else " FAIL"))
    del q, k, v, g, o, lse, delta, views
    return row


def _k1_kv_row(failures, timed, si, label, shape, sk, causal, kv, dname):
    """K1 with kv_len against the router's plain masked path (a (B, Sk)
    key mask and the causal mask), within K1's limit (TOL); with `timed`,
    K1, the plain masked path and SDPA with the same mask, beside K1's
    bound over the visible pairs."""
    import torch
    import torch.nn.functional as F

    from instructany2pix_tpu_torch.ops import attention as attn
    from instructany2pix_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dname)
    b, h, sq, d = shape
    gen = torch.Generator("cuda").manual_seed(4000 + si)
    q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
    kv_len = _kv_tensor(kv)
    scale = d**-0.5
    mask = torch.arange(sk, device="cuda")[None, :] < kv_len[:, None]
    def plain():
        return attn.dot_product_attention(*(x.transpose(1, 2) for x in (q, k, v)), mask=mask,
                                          causal=causal, scale=scale, impl="xla").transpose(1, 2)

    o_ref = plain()
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s.masked_fill_(~fa._visible(sq, sk, causal, kv_len, s.device), fa.NEG_INF)
    lse_ref = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    del s
    sigma = torch.matmul(p.square_(), v.float().square()).sqrt_()
    del p
    tol = TOL[dname]
    ref = (o_ref, lse_ref, tol["rtol"] * o_ref.float().abs() + tol["stol"] * sigma)
    readings, taken = [], {}
    for lq, lk, lv in ((q, k, v), tuple(bshd_view(x) for x in (q, k, v))):
        (o, lse), paths = k1_paths_of(fa, lambda: fa.flash_fwd_cuda(
            lq, lk, lv, causal, scale, return_lse=True, kv_len=kv_len))
        readings.append(k1_reading(o, lse, ref))
        for p_, n in paths.items():
            taken[p_] = taken.get(p_, 0) + n
    expected = k1_path_expected(dname, d)
    row = {"label": label, "dtype": dname, "shape": list(shape), "sk": sk, "causal": causal,
           "kv_len": list(kv), "path": "/".join(sorted(taken)), "path_expected": expected,
           "ok": all(r["ok"] for r in readings) and taken == {expected: 2},
           "err_o": max(r["err_o"] for r in readings),
           "of_limit": max(r["of_limit"] for r in readings),
           "err_lse": max(r["err_lse"] for r in readings)}
    if not row["ok"]:
        failures.append(f"K1 kv_len {label} {dname}: |o| {row['err_o']:.3g} = "
                        f"{row['of_limit']:.3g} of its limit, |lse| {row['err_lse']:.3g}, path "
                        f"{row['path']} (expected {expected})")
    msg = (f"K1 kv_len {label:18s} {dname:8s} {row['path']} {str(shape):18s} kv_len={kv} "
           f"|o|={row['err_o']:.3g} "
           f"(of limit {row['of_limit']:.3f}) |lse|={row['err_lse']:.3g}")
    if timed:
        iters = 10 if sq * sk >= 1 << 22 else 50
        row["ms"] = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale, kv_len=kv_len), iters)
        row["plain_ms"] = time_ms(plain, 3, 1)
        vis = fa._visible(sq, sk, causal, kv_len, q.device)
        row["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=vis, scale=scale), iters)
        flops = 4.0 * d * visible_pairs(b, h, sq, sk, causal, kv)
        elem = 2 if dname == "bfloat16" else 4
        t_ops = flops / PEAK_FLOPS[dname]
        t_mem = elem * b * h * d * (2 * sq + 2 * sk) / HBM_BYTES_PER_S
        row["bound_ms"] = max(t_ops, t_mem) * 1e3
        row["bound_by"] = "operations" if t_ops >= t_mem else "bytes"
        msg += (f" ms={row['ms']:.4f} plain masked={row['plain_ms']:.4f} sdpa+mask="
                f"{row['library_ms']:.4f} bound={row['bound_ms']:.4f} ({row['bound_by']})")
    log(msg + (" ok" if row["ok"] else " FAIL"))
    return row


def _function_row(failures, si, label, shape, kv, dname):
    """Gradients of the flash Function with causal=True and kv_len, twice:
    through `dot_product_attention(q, k, v, causal=True, kv_len=...)` on
    (B, S, H, D) tensors that require them (the path the Llama's training
    forward takes; the kernels see (B, S, H, D) views), and through
    `flash_attention` on contiguous (B, H, S, D) tensors. Each run launches
    K1, delta from autograd's dO and K4 (`flash_bwd_cuda`). Each of dq, dk
    and dv must lie within K4_TOL of `flash_bwd_reference` run on the
    Function's own output o, the plain lse and delta = rowsum(dO o): the two
    sides then differ by K4's roundings only, and lse by K1's (1e-4, far
    under 2^-8). Each run must launch K1 once and K4 once on the expected
    path (k4_path_expected), and K4a and K4b not at all."""
    import torch

    from instructany2pix_tpu_torch.ops import attention as attn
    from instructany2pix_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dname)
    b, s, h, d = shape
    gen = torch.Generator("cuda").manual_seed(5000 + si)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    kv_len = _kv_tensor(kv)
    scale = d**-0.5
    expected = k4_path_expected(dname, d)
    counters = (fa.flash_fwd_cuda, fa.flash_bwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, g))
    _, lse = fa._reference_attention(qt, kt, vt, True, scale, True, kv_len)
    row = {"label": label, "dtype": dname, "shape_bshd": list(shape), "kv_len": list(kv),
           "path_expected": expected, "ok": True}
    def run(layout):
        """(o, dq, dk, dv), all (B, H, S, D)."""
        if layout == "bshd":
            qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
            with torch.enable_grad():
                o = attn.dot_product_attention(qr, kr, vr, causal=True, kv_len=kv_len)
                grads = torch.autograd.grad(o, (qr, kr, vr), g)
            return tuple(x.detach().transpose(1, 2) for x in (o, *grads))
        qr, kr, vr = (x.contiguous().requires_grad_() for x in (qt, kt, vt))
        with torch.enable_grad():
            o = fa.flash_attention(qr, kr, vr, True, scale, kv_len=kv_len)
            grads = torch.autograd.grad(o, (qr, kr, vr), gt.contiguous())
        return (o.detach(), *grads)

    for layout in ("bshd", "bhsd"):
        before = [c.launches for c in counters]
        (ot, *grads), paths = k4_paths_of(fa, lambda: run(layout))
        launched = [c.launches - n for c, n in zip(counters, before)]
        delta = fa.flash_delta(gt, ot)
        ref = fa.flash_bwd_reference(qt, kt, vt, ot, lse, gt, True, scale, kv_len, delta)
        sigmas = k4_sigmas(fa, qt, kt, vt, gt, lse, delta, True, scale, kv_len)
        readings = {n: _reading(x, r, sg, K4_TOL[dname])
                    for n, x, r, sg in zip(("dq", "dk", "dv"), grads, ref, sigmas)}
        ok = (all(r["ok"] for r in readings.values()) and launched == [1, 1, 0, 0]
              and paths == {expected: 1})
        row["ok"] &= ok
        row[layout] = {"launches_k1_k4_k4a_k4b": launched, "k4_paths": paths}
        for n, r in readings.items():
            row[layout][f"err_{n}"], row[layout][f"of_limit_{n}"] = r["err"], r["of_limit"]
        if not ok:
            failures.append(f"flash Function {label} {dname} {layout}: " + ", ".join(
                f"|{n}| {r['err']:.3g} = {r['of_limit']:.3g} of its limit"
                for n, r in readings.items())
                + f"; launches K1/K4/K4a/K4b {launched} (expected [1, 1, 0, 0]), K4 paths "
                f"{paths} (expected {{{expected!r}: 1}})")
        log(f"flash Function {label:18s} {dname:8s} {layout} {str(shape):20s} kv_len={kv} of "
            "limit: " + " ".join(f"{n} {r['of_limit']:.3f}" for n, r in readings.items())
            + f" launches K1/K4/K4a/K4b {launched} K4 {paths}" + (" ok" if ok else " FAIL"))
        del ot, grads, ref, sigmas, delta
    for n in ("dq", "dk", "dv"):
        row[f"err_{n}"] = max(row[lay][f"err_{n}"] for lay in ("bshd", "bhsd"))
        row[f"of_limit_{n}"] = max(row[lay][f"of_limit_{n}"] for lay in ("bshd", "bhsd"))
    row["of_limit"] = max(row[f"of_limit_{n}"] for n in ("dq", "dk", "dv"))
    del q, k, v, g, lse
    return row


def _empty_calls(failures):
    """K1, K4, K4a and K4b on empty inputs (no query rows; no key rows):
    zeros or empty outputs and no launch counted."""
    import torch

    from instructany2pix_tpu_torch.ops import flash_attention as fa

    counters = (fa.flash_fwd_cuda, fa.flash_bwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda)
    before = [c.launches for c in counters]
    ok = True
    for sq, sk in ((0, 64), (64, 0)):
        q, g = (torch.ones(1, 2, sq, 128, dtype=torch.bfloat16, device="cuda") for _ in range(2))
        k, v = (torch.ones(1, 2, sk, 128, dtype=torch.bfloat16, device="cuda") for _ in range(2))
        stats = torch.zeros(1, 2, sq, device="cuda")
        dq = fa.flash_bwd_dq_cuda(q, k, v, g, stats, stats, True, 0.1)
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, g, stats, stats, True, 0.1)
        whole = fa.flash_bwd_cuda(q, k, v, g, stats, stats, True, 0.1)
        if sq == 0:
            fa.flash_fwd_cuda(q, k, v, True, 0.1, return_lse=True)
        ok &= not (dq.any() or dk.any() or dv.any() or any(x.any() for x in whole))
    counted = [c.launches - n for c, n in zip(counters, before)]
    if counted != [0, 0, 0, 0] or not ok:
        failures.append(f"empty calls: launches counted K1/K4/K4a/K4b {counted}, zero outputs "
                        f"{ok}")
    log(f"empty calls: launches counted K1/K4/K4a/K4b {counted}, zero outputs {ok}")
    return {"launches_counted": counted, "zero_outputs": ok}


def phase_k4(failures, timed=True):
    """K1 with kv_len against the plain masked path at K1_KV_SHAPES; K4 (the
    whole backward, and where it is their route K4a and K4b on their own)
    against the plain backward at every K4_SHAPES entry, on contiguous
    inputs and on the (B, S, H, D) views the router passes (K4_TOL); with
    `timed`, the same, the plain backward and SDPA's backward timed with
    CUDA events beside the bounds.
    Then the autograd Function's gradients at FN_SHAPES and the empty
    calls."""
    import torch

    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {"k1_kv_len": [], "k4": [], "function": []}
    try:
        for si, row in enumerate(K1_KV_SHAPES):
            out["k1_kv_len"].append(_k1_kv_row(failures, timed, si, *row))
            torch.cuda.empty_cache()
        for si, row in enumerate(K4_SHAPES):
            out["k4"].append(_k4_row(failures, timed, si, *row))
            torch.cuda.empty_cache()
        for si, row in enumerate(FN_SHAPES):
            out["function"].append(_function_row(failures, si, *row))
            torch.cuda.empty_cache()
        out["empty_calls"] = _empty_calls(failures)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    return out


def _build_faults(src_name, faults):
    """Build each broken copy of csrc/<src_name>.cu, or of the csrc/ header
    its entry names, under build/faults/<src_name>/<fault>; returns
    {fault: library path}."""
    from instructany2pix_tpu_torch.ops import _build

    copies = {name: {where[0] if where else f"{src_name}.cu": [(old, new)]}
              for name, (_, old, new, *where) in faults.items()}
    built = _build.build_copies(src_name, copies, _build.BUILD_DIR.parent / "faults" / src_name)
    return {name: so for name, (so, _) in built.items()}


def planted_faults(failures):
    """Build each FAULTS copy of K1, QMV_FAULTS copy of K2, K3_FAULTS copy of
    K3 and K4_FAULTS copy of K4 (under build/faults), run the kernel's check with it in place of
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
        ("K4", "flash_bwd", K4_FAULTS, lambda f, timed: phase_k4(f, timed)["k4"],
         lambda r: f"{r['label']} {r['dtype']}",
         lambda r: [r["of_limit_dq"], r["of_limit_dk"], r["of_limit_dv"]]),
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


TREE_LAYERS_PER_SHARD = 4  # decoder layers per LLM shard file: 8 shards of about 1.7 GB
TREE_FREE_BYTES = 36 * 2**30  # the written tree is about 33 GB
TREE_FP16 = ("llm", "unet", "ip_adapter", "refiner", "vae", "text1", "text2")  # as published
CHECKSUM_CHUNK = 1 << 24


def checksum(t):
    """A position-weighted sum of the bit patterns of `t`, on its device
    (int64 arithmetic, wrapping): equal tensors of one dtype and shape give
    equal sums, and a changed, moved or missing element changes it."""
    import torch

    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    flat = t.detach().contiguous().reshape(-1).view(bits)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for start in range(0, flat.numel(), CHECKSUM_CHUNK):
        part = flat[start:start + CHECKSUM_CHUNK].long()
        w = torch.arange(start, start + part.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
        total += (part * w).sum()
    return [str(t.dtype), list(t.shape), int(total)]


def _tree_dir():
    """A new directory for the tree, under the temporary directory or,
    where that is short of space, under the checkout's (git-ignored)
    build/; None when neither has TREE_FREE_BYTES free."""
    import os
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    for base in (tempfile.gettempdir(), os.path.join(here, "build")):
        os.makedirs(base, exist_ok=True)
        free = shutil.disk_usage(base).free
        log(f"tree: {free / 2**30:.1f} GiB free under {base}")
        if free >= TREE_FREE_BYTES:
            return tempfile.mkdtemp(prefix="ia2p-ckpts-", dir=base)
    return None


def write_reference_tree(root, cfg, policy_dtype, seed=0, device="cuda"):
    """Write a full-width checkpoint tree in the reference's layout under
    `root`: random port modules drawn on the card with the port's own
    initializers (the LLM one child at a time, never quantized), renamed to
    the reference's keys through each model's KeyMap read backward, cast
    to the published dtype (fp16 for the LLM shards and the SDXL
    directories, float32 for the prior, ImageBind, SAM and GroundingDINO)
    and saved with torch.save. Returns bytes and seconds per component and,
    per component, the checksum of each port parameter as the loader must
    produce it: the written tensor mapped forward and cast to the dtype it
    is loaded in (`policy_dtype`; SAM bf16, GroundingDINO float32)."""
    import copy
    import math
    import os

    import torch

    from instructany2pix_tpu_torch.diffusion import ip_adapter as ipa
    from instructany2pix_tpu_torch.grounding import gdino as gdino_lib
    from instructany2pix_tpu_torch.grounding import sam as sam_lib
    from instructany2pix_tpu_torch.llm import multimodal as mm_lib
    from instructany2pix_tpu_torch.models import clip as clip_lib
    from instructany2pix_tpu_torch.models import imagebind as imagebind_lib
    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.models import unet as unet_lib
    from instructany2pix_tpu_torch.models import unet_convert
    from instructany2pix_tpu_torch.models import vae as vae_lib
    from instructany2pix_tpu_torch.prior import model as prior_lib

    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    out = {"bytes": {}, "seconds": {}, "checksums": {}}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def draw(make, init=L.init_):
        with torch.device("meta"):
            m = make()
        return init(L.materialize(m, dev, torch.float32), gen)

    def params(m, prefix=""):
        return {prefix + n: p.detach() for n, p in m.named_parameters()}

    def save(comp, path, km, named, file_dtype, load_dtype):
        """Write `named` (port tensors) under the reference keys of `km`;
        record the checksums the loader must reproduce."""
        ref = {k: v.to(file_dtype) for k, v in km.to_ref(named).items()}
        sums = out["checksums"].setdefault(comp, {})
        for n, t in km.to_port(ref).items():
            sums[n] = checksum(t.to(load_dtype))
        host = {k: v.contiguous().cpu() for k, v in ref.items()}
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(host, path)
        out["bytes"][comp] = out["bytes"].get(comp, 0) + sum(
            v.numel() * v.element_size() for v in host.values())

    def timed(comp, fn):
        t0 = time.time()
        fn()
        sync()
        out["seconds"][comp] = out["seconds"].get(comp, 0.0) + time.time() - t0

    f16, f32, pol = torch.float16, torch.float32, policy_dtype
    sdxl = os.path.join(root, "sdxl-base")

    def llm():
        """Shard k holds decoder layers [4(k-1), 4k): the embeddings go with
        the first, the final norm, vocab head and projector/predictor heads
        with the last."""
        km = mm_lib.keymap()
        with torch.device("meta"):
            m = mm_lib.Any2PixLM(cfg.llm)
        n_layers = cfg.llm.llama.num_layers
        n_shards = math.ceil(n_layers / TREE_LAYERS_PER_SHARD)
        shard, k = {}, 1
        parts = [(f"llama.{n}.", c) for n, c in m.llama.named_children()]
        parts += [(f"{n}.", c) for n, c in m.named_children() if n != "llama"]
        for prefix, child in parts:
            # a copy of the meta child, so a written shard's layers are freed
            shard.update(params(draw(lambda c=child: copy.deepcopy(c)), prefix))
            last_of_shard = (prefix.startswith("llama.layer_")
                             and int(prefix.split("_")[1][:-1]) % TREE_LAYERS_PER_SHARD
                             == TREE_LAYERS_PER_SHARD - 1 and k < n_shards)
            if last_of_shard:
                save("llm", os.path.join(root, "llm-retrained",
                                         f"pytorch_model-{k:05d}-of-{n_shards:05d}.bin"),
                     km, shard, f16, pol)
                shard, k = {}, k + 1
        save("llm", os.path.join(root, "llm-retrained", f"pytorch_model-{k:05d}-of-{n_shards:05d}.bin"),
             km, shard, f16, pol)

    def unet_and_ip():
        unet = draw(lambda: unet_lib.UNet(cfg.unet))
        proj = draw(lambda: ipa.ImageProj(cfg.image_proj))
        named = params(unet)
        ip = {n: t for n, t in named.items() if "_ip." in n}
        save("unet", os.path.join(sdxl, "unet", "diffusion_pytorch_model.bin"),
             unet_convert.unet_keymap(), {n: t for n, t in named.items() if n not in ip}, f16, pol)
        km = (ipa.ip_attn_keymap(unet_convert.cross_attn_paths(cfg.unet))
              + ipa.image_proj_keymap().prefixed(port="image_proj."))
        save("ip_adapter", os.path.join(root, "sdxl", "ip_adapter_global_local_2_view.bin"), km,
             {**ip, **params(proj, "image_proj.")}, f16, pol)

    def imagebind():
        from instructany2pix_tpu_torch.models.imagebind import audio_patches

        # ImageBind-huge's layout: the audio trunk has bias_k/bias_v, a
        # LayerNorm in its stem and none before its blocks
        v = draw(lambda: imagebind_lib.ViT(cfg.imagebind_vision))
        a = draw(lambda: imagebind_lib.ViT(cfg.imagebind_audio,
                                           num_patches=audio_patches(cfg.imagebind_audio),
                                           bias_kv=True, patch_norm=True, pre_ln=False))
        save("imagebind", os.path.join(root, "imagebind_huge.pth"), imagebind_lib.file_keymap(),
             {**params(v, "vision."), **params(a, "audio.")}, f32, pol)

    def grounding():
        scfg = cfg.sam or sam_lib.SAMConfig.vit_h()
        gcfg = cfg.gdino or gdino_lib.GDinoConfig.swint()
        sam = draw(lambda: sam_lib.SAM(scfg), sam_lib.init_)
        save("sam", os.path.join(root, "gdino", "sam_vit_h_4b8939.pth"), sam_lib.keymap(scfg),
             params(sam), f32, torch.bfloat16)
        del sam
        gd = draw(lambda: gdino_lib.GDino(gcfg), lambda m, g: gdino_lib.init_(m, gcfg, g))
        save("gdino", os.path.join(root, "gdino", "gdino.pth"), gdino_lib.keymap(gcfg), params(gd),
             f32, f32)
        words = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                   "[MASK]", ".", "a", "cat", "dog"]
        with open(os.path.join(root, "gdino", "vocab.txt"), "w") as f:
            f.write("\n".join(words) + "\n")

    steps = [
        ("llm", llm),
        ("prior", lambda: save("prior", os.path.join(root, "prior", "model.bin"),
                               prior_lib.keymap(),
                               params(draw(lambda: prior_lib.Prior(cfg.prior, output_proj=True))),
                               f32, pol)),
        ("unet", unet_and_ip),
        ("refiner", lambda: save("refiner", os.path.join(root, "sdxl-refiner", "unet",
                                                         "diffusion_pytorch_model.bin"),
                                 unet_convert.unet_keymap(),
                                 params(draw(lambda: unet_lib.UNet(cfg.refiner))), f16, pol)),
        ("vae", lambda: save("vae", os.path.join(sdxl, "vae", "diffusion_pytorch_model.bin"),
                             unet_convert.vae_keymap(),
                             params(draw(lambda: vae_lib.VAE(cfg.vae))), f16, pol)),
    ]
    for comp, d, tcfg in (("text1", os.path.join(sdxl, "text_encoder"), cfg.text1),
                          ("text2", os.path.join(sdxl, "text_encoder_2"), cfg.text2),
                          ("prior_text", os.path.join(root, "clip-vit-h"), cfg.prior_text)):
        dt = f16 if comp in TREE_FP16 else f32
        steps.append((comp, lambda comp=comp, d=d, tcfg=tcfg, dt=dt: save(
            comp, os.path.join(d, "pytorch_model.bin"), clip_lib.text_keymap(),
            params(draw(lambda: clip_lib.CLIPText(tcfg))), dt, pol)))
    steps += [("imagebind", imagebind), ("grounding", grounding)]
    for comp, fn in steps:
        timed(comp, fn)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def check_boot(pipe, written, tree, failures):
    """Every loaded parameter that is not quantized against the checksum of
    what was written; the int4 bytes and scales of the first and last
    decoder layers, and the int8 vocab head, against the port's plain
    quantizer applied to the fp16 weights read back from the shard files."""
    import glob
    import os

    import torch

    from instructany2pix_tpu_torch.core import checkpoint as ckpt_lib
    from instructany2pix_tpu_torch.ops import quant as Q

    loaded = {name: dict(m.named_parameters()) for name, m in pipe.models.items()}
    loaded["imagebind"] = {**{f"vision.{n}": p for n, p in loaded.pop("imagebind_vision").items()},
                           **{f"audio.{n}": p for n, p in loaded.pop("imagebind_audio").items()}}
    ip = {n: p for n, p in loaded["unet"].items() if "_ip." in n}
    loaded["ip_adapter"] = {**ip, **{f"image_proj.{n}": p
                                     for n, p in loaded.pop("image_proj").items()}}
    loaded["unet"] = {n: p for n, p in loaded["unet"].items() if n not in ip}
    loaded["sam"] = dict(pipe.segmentor.params.named_parameters())
    loaded["gdino"] = dict(pipe.grounder.params.named_parameters())
    out = {"tensors": 0, "mismatched": [], "unchecked": []}
    for comp, sums in written["checksums"].items():
        have = loaded.get(comp, {})
        for name, want in sums.items():
            if name not in have:
                if not (comp == "llm" and _quantized(name)):
                    out["unchecked"].append(f"{comp}:{name}")
                continue
            out["tensors"] += 1
            if checksum(have[name]) != want:
                out["mismatched"].append(f"{comp}:{name}")
        for name in have:
            if name not in sums:
                out["unchecked"].append(f"{comp}:{name} (loaded, never written)")

    # the quantizer check reads the written fp16 weights back
    lm = pipe.models["llm"].llama
    n_layers = pipe.cfg.llm.llama.num_layers
    wanted = {f"model.layers.{i}.{p}.weight": (i, p) for i in (0, n_layers - 1)
              for p in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                        "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")}
    wanted["lm_head.weight"] = (None, "lm_head")
    found = {}
    dev, dtype = pipe.device, pipe.policy.param_dtype
    for f in sorted(glob.glob(os.path.join(tree, "llm-retrained", "*.bin"))):
        sd = ckpt_lib.load_torch_state_dict(f)
        found.update({k: sd[k].to(dev, dtype) for k in wanted if k in sd})
        del sd
    fused = {"self_attn.q_proj": ("qkv", 0), "self_attn.k_proj": ("qkv", 1),
             "self_attn.v_proj": ("qkv", 2), "self_attn.o_proj": ("o", 0),
             "mlp.gate_proj": ("gate_up", 0), "mlp.up_proj": ("gate_up", 1),
             "mlp.down_proj": ("down", 0)}
    out["quantized_checked"] = []
    for key, (i, proj) in wanted.items():
        w = found.get(key)
        if w is None:
            out["mismatched"].append(f"llm:{key} (not in the shards)")
            continue
        m = torch.nn.ModuleDict({"w": torch.nn.Linear(w.shape[1], w.shape[0], bias=False,
                                                      device=dev, dtype=dtype)})
        m["w"].weight.data.copy_(w)
        Q.quantize_tree(m, lambda _n: True, bits=4)
        want = m["w"].q
        if i is None:
            have, part = lm.lm_head.q, 0
        else:
            attr, part = fused[proj]
            have = getattr(lm, f"layer_{i}").__getattr__(attr).q
        ok = set(have) == set(want)
        for b, wt in want.items():
            if not ok:
                break
            dim = 0 if b == "scale" else 1  # packed bytes and group scales: columns on axis 1
            n = wt.shape[dim]
            ok = torch.equal(have[b].narrow(dim, part * n, n), wt)
        out["quantized_checked"].append(key)
        if not ok:
            out["mismatched"].append(f"llm:{key} (quantized)")
    if out["mismatched"] or out["unchecked"] or not out["tensors"]:
        failures.append(f"boot checks: {len(out['mismatched'])} mismatched, e.g. "
                        f"{out['mismatched'][:5]}; {len(out['unchecked'])} unchecked, e.g. "
                        f"{out['unchecked'][:5]}; {out['tensors']} checked")
    return out


def _quantized(name):
    import re

    return bool(re.fullmatch(r"llama\.(layer_\d+\.(q|k|v|o|gate|up|down)|lm_head)\.weight", name))


class PeakRSS:
    """Host peak resident memory over a block, from /proc/self/status
    sampled every 5 ms by a thread (VmRSS, which counts touched pages of
    memory-mapped files)."""

    def __enter__(self):
        import threading

        self.peak, self._stop = self._rss(), threading.Event()

        def run():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, self._rss())

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())

    @staticmethod
    def _rss():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0


def _weight_bytes(module):
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))


def phase_full_width(failures):
    """Phase 4: write the full-width tree, boot the pipeline from it, check
    the boot, then drive text2img, the edit and subject consistency."""
    import atexit
    import shutil

    cfg = _full_config()
    root = _tree_dir()
    if root is None:
        raise RuntimeError(f"the full-width checkpoint tree needs {TREE_FREE_BYTES / 2**30:.0f} GiB "
                           "free under the temporary directory or the checkout's build/")
    atexit.register(shutil.rmtree, root, True)
    try:
        return _full_width_from(root, cfg, failures)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _full_width_from(root, cfg, failures):
    import numpy as np
    import torch

    import instructany2pix_tpu_torch.models.vae as vae_lib
    from instructany2pix_tpu_torch.diffusion import sampler as sampler_lib
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.pipeline import InstructAny2PixPipeline

    card = card_line()
    t0 = time.time()
    written = write_reference_tree(root, cfg, torch.bfloat16)
    tree = {"root_bytes": sum(written["bytes"].values()), "write_seconds": time.time() - t0,
            "bytes": written["bytes"], "component_seconds": written["seconds"], "card": card}
    log(f"tree: wrote {tree['root_bytes'] / 1e9:.2f} GB in {tree['write_seconds']:.1f} s; GB "
        + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in written["bytes"].items())
        + "; seconds to draw and write " + ", ".join(f"{k} {v:.1f}"
                                                    for k, v in written["seconds"].items())
        + f" [{card}]")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rss_before = PeakRSS._rss()
    with PeakRSS() as rss:
        t0 = time.time()
        pipe = InstructAny2PixPipeline(cfg, ckpt=root, llm_quant_bits=4)
        torch.cuda.synchronize()
        boot_s = time.time() - t0
    sizes = {name: _weight_bytes(m) / 2**30 for name, m in pipe.models.items()}
    boot = {"seconds": boot_s, **{f"{k}_seconds": v for k, v in pipe.boot_times.items()},
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            "host_peak_rss_gib": rss.peak / 2**30, "host_rss_before_gib": rss_before / 2**30,
            "card": card}
    out = {"tree": tree, "boot": boot, "build_seconds": boot_s, "weights_gib": sizes,
           "build_peak_gib": boot["peak_device_gib"]}
    log(f"boot from the tree: {boot_s:.1f} s (read {boot['read_seconds']:.1f}, map and cast "
        f"{boot['cast_seconds']:.1f}, quantize {boot['quantize_seconds']:.1f}), peak device "
        f"{boot['peak_device_gib']:.2f} GiB, host peak RSS {boot['host_peak_rss_gib']:.2f} GiB "
        f"(before the boot {boot['host_rss_before_gib']:.2f}); "
        f"weights {sum(sizes.values()):.2f} GiB ("
        + ", ".join(f"{k} {v:.2f}" for k, v in sizes.items())
        + f"; SAM {_weight_bytes(pipe.segmentor.params) / 2**30:.2f}, GroundingDINO "
        f"{_weight_bytes(pipe.grounder.params) / 2**30:.2f}) [{card}]")
    t0 = time.time()
    out["boot_checks"] = check_boot(pipe, written, root, failures)
    chk = out["boot_checks"]
    log(f"boot checks: {chk['tensors']} tensors against their written checksums, "
        f"{len(chk['quantized_checked'])} quantized weights against the plain quantizer, "
        f"{len(chk['mismatched'])} mismatched, {len(chk['unchecked'])} unchecked "
        f"({time.time() - t0:.1f} s)")

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
            reset_k1(fa)
            reset_k3(fa)
            Q.reset_qmv_counts()
            reset_k4(fa)
            t0 = time.time()
            img = pipe.text2img("a photo of a cat in an antique shop", num_inference_steps=STEPS,
                                seed=1, **kw)
            torch.cuda.synchronize()
            dt = time.time() - t0
            launches = fa.flash_fwd_cuda.launches
            k2, k3 = Q.qmv_cuda.launches, fa.flash_relpos2d_cuda.launches
            k4 = no_k4(fa, failures, f"request {name}")
            ok = (img.shape == (1024, 1024, 3) and img.dtype == np.uint8 and finite[-1]
                  and launches == expected and k2 == 0 and k3 == 0)
            if not ok:
                failures.append(f"request {name}: shape {img.shape} {img.dtype} finite "
                                f"{finite[-1]} K1 launches {launches} (expected {expected}), "
                                f"K2 {k2}, K3 launches {k3} (expected 0)")
            out["requests"].append({"name": name, "seconds": dt, "k1_launches": launches,
                                    "k1_by_path": dict(fa.flash_fwd_cuda.launches_by_path),
                                    "k1_expected": expected, "k2_launches": k2,
                                    "k2_by_path": dict(Q.qmv_cuda.launches_by_path),
                                    "k3_launches": k3, **k4, "mean_pixel": float(img.mean())})
            log(f"request {name}: {dt:.3f} s, {STEPS} steps, K1 launches {launches} "
                f"(expected {expected}), K2 {k2}, K3 {k3} (both expected 0), image {img.shape} "
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
        reset_k1(fa)
        reset_k3(fa)
        Q.reset_qmv_counts()
        reset_k4(fa)
        t0 = time.time()
        res = pipe.forward_llm(inst, media, generator=torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        out["forward_llm_seconds"] = time.time() - t0
        k1, k2, k3 = fa.flash_fwd_cuda.launches, Q.qmv_cuda.launches, fa.flash_relpos2d_cuda.launches
        out.update(no_k4(fa, failures, "forward_llm"))
        gen = pipe.last_generate
        t_max = gen.tokens.shape[1]
        steps = min(int(gen.done_at[0]), t_max - 1)  # decode steps the loop ran
        k1_expected = cfg.imagebind_vision.layers + cfg.imagebind_audio.layers
        per_step = 4 * cfg.llm.llama.num_layers
        out.update({"k1_launches": k1, "k1_expected": k1_expected, "k2_launches": k2,
                    "k2_by_path": dict(Q.qmv_cuda.launches_by_path),
                    "k1_by_path": dict(fa.flash_fwd_cuda.launches_by_path),
                    "k3_launches": k3, "decode_steps": steps, "k2_expected": per_step * steps,
                    "stage_seconds": dict(pipe.stage_times), "caption": res[2][:120],
                    "tokens": gen.tokens[0, :steps + 1].tolist(),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        # the ImageBind trunks are bf16 at head_dim 80 (vision) and 64 (audio): all wgmma
        ok = (isinstance(res, tuple) and len(res) == 5 and isinstance(res[2], str)
              and k1 == k1_expected and out["k1_by_path"]["wgmma"] == k1
              and k2 == per_step * steps and out["k2_by_path"]["mma"] == k2 and steps > 0
              and k3 == 0)
        if not ok:
            failures.append(f"forward_llm: K1 {k1} by path {out['k1_by_path']} (expected "
                            f"{k1_expected}, all wgmma), K2 {k2} by path {out['k2_by_path']} "
                            f"(expected {per_step} x {steps} decode steps, all mma), K3 {k3} "
                            f"(expected 0), result {type(res)}")
        log(f"forward_llm: {out['forward_llm_seconds']:.3f} s ({', '.join(f'{k} {v:.3f} s' for k, v in pipe.stage_times.items())}), "
            f"{steps} decode steps, K2 launches {k2} {out['k2_by_path']} (expected "
            f"{per_step * steps}, all mma), K1 launches "
            f"{k1} {out['k1_by_path']} (expected {k1_expected}: the ImageBind trunks, all wgmma), "
            f"K3 launches {k3} (expected 0), "
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
            # one launch per qmatmul call: qmv_kernel alone, once per linear
            names = prof["k2_kernels"]
            if (sum(names.values()) != per_step
                    or any("qmv_kernel" not in name for name in names)):
                failures.append(f"decode step profile: K2 kernels {names} (expected "
                                f"{per_step} launches of qmv_kernel alone)")
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
        reset_k1(fa)
        reset_k3(fa)
        Q.reset_qmv_counts()
        reset_k4(fa)
        n_decoded = len(finite)
        t0 = time.time()
        non_refined, refined, msg = pipe(inst, media, num_inference_steps=EDIT_STEPS,
                                         refinement=0.5, seed=1, use_cache=True)
        torch.cuda.synchronize()
        out["call_seconds"] = time.time() - t0
        k1, k3 = fa.flash_fwd_cuda.launches, fa.flash_relpos2d_cuda.launches
        out.update({"call_" + k: v for k, v in no_k4(fa, failures, "__call__").items()})
        out.update({"call_stage_seconds": dict(pipe.stage_times), "call_k1_launches": k1,
                    "call_k1_by_path": dict(fa.flash_fwd_cuda.launches_by_path),
                    "call_k1_expected": expected, "call_k2_launches": Q.qmv_cuda.launches,
                    "call_k2_by_path": dict(Q.qmv_cuda.launches_by_path),
                    "call_k3_launches": k3,
                    "call_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "mean_pixels": [float(non_refined.mean()), float(refined.mean())]})
        pipe.stage_times = None
        size = cfg.image_size
        images_ok = all(a.shape == (size, size, 3) and a.dtype == np.uint8
                        for a in (non_refined, refined))
        all_finite = len(finite) - n_decoded == 2 and all(finite[n_decoded:])
        k2 = out["call_k2_launches"]
        if not (images_ok and all_finite and msg == "SUCCESS!" and k1 == expected and k2 == 0
                and k3 == 0):
            failures.append(f"__call__: images ok {images_ok}, finite {all_finite}, msg {msg!r}, "
                            f"K1 {k1} (expected {expected}), K2 {k2}, K3 {k3} (expected 0)")
        log(f"__call__ (edit, {EDIT_STEPS} inversion + {EDIT_STEPS} denoise steps, refiner "
            f"{ref_steps} of 50): {out['call_seconds']:.3f} s; " + ", ".join(
                f"{k} {v:.3f} s" for k, v in out["call_stage_seconds"].items())
            + f"; K1 launches {k1} (expected {expected}), K2 {k2}, K3 {k3} (both expected 0); images {non_refined.shape} "
            f"{non_refined.dtype}, finite {all_finite}; peak {out['call_peak_gib']:.2f} GiB")
        pipe.cache = None
    return out


def sam_encode_split(sam_lib, encoder, x, cfg, reps=3):
    """The SAM encoder's time on the card, split by its attentions: CUDA
    events around each `_attn_with_relpos` call (the bias einsums and K3 or
    the plain version) of `reps` encodes after one warm-up, summed per
    encode over the global blocks and over the windowed ones. The events sit
    in the stream between the calls, so a gap the host leaves inside an
    attention counts to it. `sam_lib` is the grounding.sam module of the
    port being timed."""
    import torch

    real = sam_lib._attn_with_relpos
    spans = []

    def timed(q, k, v, p, hw, heads):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        o = real(q, k, v, p, hw, heads)
        ev[1].record()
        spans.append((hw, ev))
        return o

    sam_lib._attn_with_relpos = timed
    try:
        with torch.inference_mode():
            sam_lib.encoder_apply(encoder, x, cfg)
            spans.clear()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                sam_lib.encoder_apply(encoder, x, cfg)
            end.record()
            torch.cuda.synchronize()
    finally:
        sam_lib._attn_with_relpos = real
    grid = cfg.img_size // cfg.patch
    out = {"encode_ms": start.elapsed_time(end) / reps}
    for name, keep in (("global", lambda hw: hw == grid), ("window", lambda hw: hw != grid)):
        mine = [ev for hw, ev in spans if keep(hw)]
        out[f"{name}_calls"] = len(mine) // reps
        out[f"{name}_attention_ms"] = sum(a.elapsed_time(b) for a, b in mine) / reps
    return out

def phase_subject(pipe, failures, finite):
    """Subject consistency at full width: `__call__` with `subject_strength`
    on a seeded LLM cache naming one image subject, through the SAM ViT-H
    segmentor the pipeline loaded from the tree (bf16) and the whole-image
    grounder (random weights box nothing), with the launch counts set to 0
    just before and read just after; then the GroundingDINO Swin-T grounder
    loaded from the tree (float32, wordpiece captions) on the edited image."""
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.grounding import gdino as gdino_lib
    from instructany2pix_tpu_torch.grounding import lib as grounding_lib
    from instructany2pix_tpu_torch.grounding import sam as sam_lib
    from instructany2pix_tpu_torch.models import unet as unet_lib
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q

    cfg = pipe.cfg
    out = {}
    scfg, gcfg = sam_lib.SAMConfig.vit_h(), gdino_lib.GDinoConfig.swint()
    segment, grounder = pipe.segmentor, pipe.grounder  # loaded from the tree's gdino/
    sam, gd = segment.params, grounder.params
    if next(sam.parameters()).dtype != torch.bfloat16:
        failures.append(f"SAM from the tree is {next(sam.parameters()).dtype}, not bf16")
    out.update({"sam_gib": _weight_bytes(sam) / 2**30, "gdino_gib": _weight_bytes(gd) / 2**30})
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
        reset_k1(fa)
        reset_k3(fa)
        Q.reset_qmv_counts()
        reset_k4(fa)
        n_decoded = len(finite)
        t0 = time.time()
        non_refined, edited, msg = pipe("Put <video> into the picture.", media,
                                        num_inference_steps=EDIT_STEPS, refinement=0.5, seed=2,
                                        use_cache=True, subject_strength=SUBJECT_STRENGTH)
        torch.cuda.synchronize()
        out["call_seconds"] = time.time() - t0
        k1, k3 = fa.flash_fwd_cuda.launches, fa.flash_relpos2d_cuda.launches
        k1_by_path = dict(fa.flash_fwd_cuda.launches_by_path)
        k3_by_path = dict(fa.flash_relpos2d_cuda.launches_by_path)
        out.update(no_k4(fa, failures, "subject __call__"))
        pipe.cache = None
    out.update({"stage_seconds": dict(pipe.stage_times), "k1_launches": k1,
                "k1_by_path": k1_by_path,
                "k1_expected": k1_expected, "k3_launches": k3, "k3_by_path": k3_by_path,
                "k3_expected": scfg.depth * len(masks), "segmentor_calls": len(masks),
                "k2_launches": Q.qmv_cuda.launches,
                "k2_by_path": dict(Q.qmv_cuda.launches_by_path),
                "mask_fraction": [float(m.mean()) for m in masks],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "inpaint_steps": inpaint_steps, "mean_pixel": float(edited.mean())})
    pipe.stage_times = None
    all_finite = len(finite) - n_decoded == 3 and all(finite[n_decoded:])
    ok = (edited.shape == (cfg.image_size, cfg.image_size, 3) and edited.dtype == np.uint8
          and all_finite and msg == "SUCCESS!" and len(masks) == 1
          and k3 == scfg.depth * len(masks) and k3_by_path.get("wgmma") == k3
          and out["k2_launches"] == 0
          and k1 == k1_expected and 0 < masks[0].mean() and not np.array_equal(edited, non_refined))
    if not ok:
        failures.append(f"subject consistency: image {edited.shape} {edited.dtype}, finite "
                        f"{all_finite}, msg {msg!r}, segmentor calls {len(masks)}, K3 {k3} by path "
                        f"{k3_by_path} (expected {scfg.depth} per call, all wgmma), K2 "
                        f"{out['k2_launches']} (expected 0), K1 {k1} "
                        f"(expected {k1_expected}), mask fractions {out['mask_fraction']}")
    log(f"__call__ with subject consistency (strength {SUBJECT_STRENGTH}: {inpaint_steps} inpaint "
        f"steps of 50): {out['call_seconds']:.3f} s; " + ", ".join(
            f"{k} {v:.3f} s" for k, v in out["stage_seconds"].items())
        + f"; K3 launches {k3} {k3_by_path} ({len(masks)} segmentor call, expected {scfg.depth} "
        f"each: every encoder block); K1 launches {k1} "
        f"(expected {k1_expected}); mask fraction {out['mask_fraction']}; image {edited.shape} "
        f"finite {all_finite}; peak {out['peak_gib']:.2f} GiB; SAM ViT-H {out['sam_gib']:.2f} GiB "
        f"bf16, GroundingDINO {out['gdino_gib']:.2f} GiB f32, both loaded from the tree")

    with torch.inference_mode():
        x = torch.randn((1, scfg.img_size, scfg.img_size, 3), device="cuda").bfloat16()
        out["sam_encode_ms"] = time_ms(lambda: sam_lib.encoder_apply(sam.encoder, x, scfg), 3, 1)
        out["sam_encode_split"] = sam_encode_split(sam_lib, sam.encoder, x, scfg)
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
    split = out["sam_encode_split"]
    log(f"SAM ViT-H encoder (bf16, 1024^2): {out['sam_encode_ms']:.2f} ms; with events around its "
        f"attentions {split['encode_ms']:.2f} ms, of which {split['global_calls']} global "
        f"attentions {split['global_attention_ms']:.3f} ms and {split['window_calls']} window "
        f"attentions {split['window_attention_ms']:.3f} ms (bias einsums and K3)")
    log(f"GroundingDINO Swin-T "
        f"grounder on the edited image: {out['grounder_seconds']:.3f} s, forward "
        f"{out['gdino_forward_seconds']:.3f} s on {tuple(xg.shape)}, boxes {tuple(rb.shape)}, logits "
        f"{tuple(rl.shape)}, finite {finite_ok}, {len(boxes)} boxes kept at 0.35/0.25")
    pipe.segmentor, pipe.grounder = saved
    del sam, gd, segment, grounder
    return out


def _write_train_dataset(d, row_chars, codec_dim, seed):
    """A synthetic instruction dataset in `d`: one record per entry of
    `row_chars` (the length of its gpt reply in characters; the byte
    tokenizer gives about one token each), image targets but for the last
    record (audio), bracketed captions, a base and an addition, and a random
    `codec_dim` .npz feature per caption. Returns (data.json path, media map)."""
    import json
    import os

    import numpy as np

    rs = np.random.RandomState(seed)
    words = ["red", "cat", "moves", "a", "bright", "under", "sky", "with", "the", "dog", "over",
             "soft", "light", "blue", "music", "plays"]
    feats, records = {}, []
    for i, n in enumerate(row_chars):
        caps = {"src": f"source image {i}", "base": f"base image {i}", "tgt": f"target {i}",
                "add": f"subject {i}"}
        for cap in caps.values():
            path = os.path.join(d, cap.replace(" ", "_") + ".npz")
            np.savez(path, state=rs.randn(codec_dim).astype(np.float32))
            feats[cap] = os.path.basename(path)
        reply = " ".join(rs.choice(words, n))[:n]
        records.append({
            "conversations": [
                {"from": "human", "value": f"change [{caps['src']}] so that it shows more"},
                {"from": "gpt", "value": f"[{caps['tgt']}] {reply}"}],
            "base": caps["base"], "target": caps["tgt"], "additions": [caps["add"]],
            "modality": "audio" if i == len(row_chars) - 1 else "image"})
    data = os.path.join(d, "data.json")
    with open(data, "w") as f:
        json.dump(records, f)
    return data, feats


TRAIN_LAYERS = 4  # of Vicuna-7B's 32 decoder layers; every width is kept
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS = 4, 2048, 5
TRAIN_ROW_CHARS = (2400, 1650, 1290, 750)  # rows of about 2650 (cut to 2048), 1900, 1540, 1000 tokens


# the launch counters a training run reads: K1; K4 (whole backward calls),
# also by the path each took; K4a and K4b called on their own; K2; K3
COUNT_KEYS = ("k1", "k4", "k4_wgmma", "k4_mma", "k4_fma", "k4a", "k4b", "k2", "k3")


def _counts(fa, Q):
    by = fa.flash_bwd_cuda.launches_by_path
    return (fa.flash_fwd_cuda.launches, fa.flash_bwd_cuda.launches, by["wgmma"], by["mma"],
            by["fma"], fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches,
            Q.qmv_cuda.launches, fa.flash_relpos2d_cuda.launches)


def _launches(**nonzero):
    """Launch counts keyed as COUNT_KEYS, 0 where not given."""
    return {k: nonzero.get(k, 0) for k in COUNT_KEYS}


def phase_train(failures):
    """The trainer at full width: `train.launch.train` on Any2PixLMConfig()
    with Vicuna-7B's widths, TRAIN_LAYERS decoder layers, bf16 parameters and
    moments, remat "dots", batch 4 x max_length 2048 from the port's collate
    over a synthetic dataset; TRAIN_STEPS steps, a preview and a checkpoint.
    Every step: finite losses and grad_norm, and exact K1 and K4 launches,
    each K4 call on the fused wgmma path; K4a, K4b, K2 and K3 stay at 0.
    Then one step profiled by kernel class."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.llm import multimodal as mm
    from instructany2pix_tpu_torch.llm.tokenizer import initialize_vision_tokenizer, load_tokenizer
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.train import data as data_lib
    from instructany2pix_tpu_torch.train import launch
    from instructany2pix_tpu_torch.train.train_step import TrainConfig, make_train_step

    tok = load_tokenizer(None)
    ids = initialize_vision_tokenizer(tok)
    base = mm.Any2PixLMConfig().with_token_ids(ids)
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, num_layers=TRAIN_LAYERS, remat=True, remat_policy="dots"))
    L = cfg.llama.num_layers
    # per step with remat: K1 once in the forward and once more when the
    # backward recomputes each checkpointed layer; K4 once per layer
    per_step = _launches(k1=2 * L, k4=L, k4_wgmma=L)
    train_cfg = TrainConfig(total_steps=TRAIN_STEPS)
    out = {"layers": L, "of_layers": base.llama.num_layers, "batch": TRAIN_BATCH,
           "max_length": TRAIN_LEN, "steps": TRAIN_STEPS, "per_step_expected": per_step}
    with tempfile.TemporaryDirectory() as d:
        data, feats = _write_train_dataset(d, TRAIN_ROW_CHARS, cfg.image_codec_dim, 21)
        dcfg = data_lib.DataConfig(max_length=TRAIN_LEN, audio_codec_dim=cfg.audio_codec_dim)
        make_ds = lambda: data_lib.InstructionDataset(  # noqa: E731
            data, data_lib.MediaMap(feats, d, cfg.image_codec_dim), tok, ids, dcfg)
        # the first batch, as train() will collate it (same order, same rewrite stream)
        ds0 = make_ds()
        order = data_lib.length_grouped_indices(ds0.modality_lengths, TRAIN_BATCH,
                                                np.random.RandomState(0))
        first = data_lib.collate([ds0[int(i)] for i in order[:TRAIN_BATCH]], tok, ids, dcfg,
                                 codec_dim=cfg.image_codec_dim)
        lengths = first["attention_mask"].sum(1).tolist()
        out["row_lengths"] = lengths
        if max(lengths) != TRAIN_LEN or len(set(lengths)) != TRAIN_BATCH:
            failures.append(f"train: row lengths {lengths}, expected ragged with a {TRAIN_LEN} row")
        params = mm.init(cfg, torch.Generator("cuda").manual_seed(0), device="cuda",
                         dtype=torch.bfloat16)
        out["params"] = sum(p.numel() for p in params.parameters())
        steps = []
        t_last = [0.0]

        def hook(step_i, metrics):
            torch.cuda.synchronize()
            now = time.perf_counter()
            c = _counts(fa, Q)
            prev = steps[-1]["counts"] if steps else (0,) * len(COUNT_KEYS)
            vals = {k: float(v) for k, v in metrics.items()}
            steps.append({"step": step_i + 1, "seconds": now - t_last[0], "counts": c,
                          "launches": dict(zip(COUNT_KEYS, [a - b for a, b in zip(c, prev)])),
                          "metrics": vals,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
            t_last[0] = now

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_k1(fa)
        reset_k3(fa)
        Q.reset_qmv_counts()
        reset_k4(fa)
        t_last[0] = time.perf_counter()
        res = launch.train(cfg, train_cfg, make_ds(), batch_size=TRAIN_BATCH,
                           ckpt_dir=os.path.join(d, "ck"), save_steps=TRAIN_STEPS, log_steps=1,
                           preview_steps=TRAIN_STEPS, preview_dir=os.path.join(d, "preview"),
                           device="cuda", params=params, step_hook=hook)
        torch.cuda.synchronize()
        run = dict(zip(COUNT_KEYS, _counts(fa, Q)))
        out["k1_by_path"] = dict(fa.flash_fwd_cuda.launches_by_path)
        # the preview after the last step runs one forward without remat
        run_expected = {k: TRAIN_STEPS * v for k, v in per_step.items()}
        run_expected["k1"] += L
        out.update({"steps_run": [{k: v for k, v in st.items() if k != "counts"} for st in steps],
                    "launches": run, "launches_expected": run_expected, "saves": res["saves"],
                    "preview_written": os.path.exists(os.path.join(d, "preview",
                                                                   f"step_{TRAIN_STEPS}.png"))})
        for st in steps:
            finite = all(np.isfinite(v) for v in st["metrics"].values())
            if not finite or st["launches"] != per_step:
                failures.append(f"train step {st['step']}: finite {finite} ({st['metrics']}), "
                                f"launches {st['launches']} (expected {per_step})")
        if run != run_expected or len(steps) != TRAIN_STEPS or not out["preview_written"]:
            failures.append(f"train: launches {run} (expected {run_expected}), {len(steps)} "
                            f"steps, preview written {out['preview_written']}")
        times = sorted(st["seconds"] for st in steps[2:])
        out["step_seconds_median_3_5"] = times[len(times) // 2]
        out["tokens_per_step"] = TRAIN_BATCH * int(first["input_ids"].shape[1])
        out["real_tokens_first_batch"] = int(sum(lengths))
        out["tokens_per_s"] = out["tokens_per_step"] / out["step_seconds_median_3_5"]
        out["peak_gib"] = max(st["peak_gib"] for st in steps)
        for st in steps:
            log(f"train step {st['step']}: {st['seconds']:.3f} s, launches {st['launches']}, "
                + ", ".join(f"{k} {v:.5g}" for k, v in st["metrics"].items()))
        save = res["saves"][-1]
        log(f"train ({L} of {base.llama.num_layers} layers, {out['params'] / 1e9:.3f} B params, "
            f"bf16, remat dots, batch {TRAIN_BATCH} x {first['input_ids'].shape[1]}, rows "
            f"{lengths}): step median of 3-5 {out['step_seconds_median_3_5']:.3f} s, "
            f"{out['tokens_per_s']:.0f} tokens/s (padded), peak {out['peak_gib']:.2f} GiB; "
            f"launches over the run {run} (expected {run_expected}); checkpoint "
            f"{save['bytes'] / 2**30:.2f} GiB in {save['seconds']:.2f} s")

        # one more step, profiled by kernel class (lr is 0 past the schedule's end)
        _, train_step = make_train_step(cfg, train_cfg)
        state = res["state"]
        batch = {k: torch.from_numpy(v).cuda() for k, v in first.items()}
        out["step_profile"] = profile_window(lambda: train_step(state, batch), "train step", n=1)
        del state, batch, res, params
    torch.cuda.empty_cache()
    return out


def phase_tiny_train(failures):
    """The tiny config in fp32 with remat "dots", on the card against the
    same parameters and the same collated batch on the CPU: three
    `train_step`s (losses, grad_norm and parameters within the tolerances of
    tests/test_torch_train.py), then five steps at lr 5e-3 on the card, where
    the loss must fall, then `train.launch.train` on the card for 2 steps
    with a checkpoint and a resume that goes on to step 4."""
    import copy
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch import convert
    from instructany2pix_tpu_torch.llm import multimodal as mm
    from instructany2pix_tpu_torch.llm.tokenizer import initialize_vision_tokenizer, load_tokenizer
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.train import data as data_lib
    from instructany2pix_tpu_torch.train import launch
    from instructany2pix_tpu_torch.train import train_step as ts

    tok = load_tokenizer(None)
    ids = initialize_vision_tokenizer(tok)
    base = mm.Any2PixLMConfig.tiny(ids)
    cfg = dataclasses.replace(base, llama=dataclasses.replace(base.llama, remat=True,
                                                              remat_policy="dots"))
    out = {}
    with tempfile.TemporaryDirectory() as d:
        data, feats = _write_train_dataset(d, (40, 25), cfg.image_codec_dim, 22)
        dcfg = data_lib.DataConfig(max_length=512, audio_codec_dim=cfg.audio_codec_dim)
        ds = data_lib.InstructionDataset(data, data_lib.MediaMap(feats, d, cfg.image_codec_dim),
                                         tok, ids, dcfg)
        batch_np = data_lib.collate([ds[0], ds[1]], tok, ids, dcfg, codec_dim=cfg.image_codec_dim)
        params = mm.init(cfg, torch.Generator().manual_seed(0))
        tcfg = ts.TrainConfig(learning_rate=1e-3, total_steps=100)
        runs = {}
        for dev in ("cpu", "cuda"):
            init_state, step = ts.make_train_step(cfg, tcfg)
            state = init_state(copy.deepcopy(params).to(dev))
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
            before = _counts(fa, Q)
            hist = [{k: float(v) for k, v in step(state, batch)[1].items()} for _ in range(3)]
            runs[dev] = (hist, convert.to_tree(state["params"]),
                         [a - b for a, b in zip(_counts(fa, Q), before)])
        L = cfg.llama.num_layers
        launches = dict(zip(COUNT_KEYS, runs["cuda"][2]))
        expected = _launches(k1=3 * 2 * L, k4=3 * L, k4_fma=3 * L)
        worst = {}
        for i, (mc, mg) in enumerate(zip(runs["cpu"][0], runs["cuda"][0])):
            for k in mc:
                rel = abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30)
                worst[k] = max(worst.get(k, 0.0), rel)
        # the tolerances of tests/test_torch_train.py (float32 both sides)
        lr_sum = sum(ts.learning_rate(tcfg, i) for i in range(3))
        pmax = pmean = 0.0
        ok_params = True
        flat_c = _flatten(runs["cpu"][1])
        flat_g = _flatten(runs["cuda"][1])
        for key, a in flat_c.items():
            diff = np.abs(flat_g[key] - a)
            rounding = 1e-6 * float(np.abs(a).max())
            pmax = max(pmax, float(diff.max()) / lr_sum)
            pmean = max(pmean, float(diff.mean()) / lr_sum)
            ok_params &= bool(diff.max() <= 0.1 * lr_sum + rounding
                              and diff.mean() <= 1e-4 * lr_sum + rounding)
        out.update({"per_step_cpu": runs["cpu"][0], "per_step_card": runs["cuda"][0],
                    "worst_rel": worst, "param_max_diff_of_lr_sum": pmax,
                    "param_mean_diff_of_lr_sum": pmean, "launches": launches,
                    "launches_expected": expected})
        if max(worst.values()) > 1e-5 or not ok_params or launches != expected:
            failures.append(f"tiny train card vs CPU: worst relative metric difference {worst}, "
                            f"params max {pmax:.3g} / mean {pmean:.3g} of the summed lr, "
                            f"launches {launches} (expected {expected})")
        log(f"tiny train fp32, card vs CPU, 3 steps: worst relative difference "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
            + f" (tol 1e-05); params max diff {pmax:.3g}, mean {pmean:.3g} of the summed lr "
            f"(tol 0.1, 1e-4); card launches {launches} (expected {expected})")

        out["bf16_head_dim_128"] = _tiny_bf16_grads(failures, cfg, batch_np)

        # the loss falls on the card (as tests/test_serve_train.py asks of the JAX step)
        init_state, step = ts.make_train_step(cfg, ts.TrainConfig(learning_rate=5e-3,
                                                                  total_steps=100))
        state = init_state(copy.deepcopy(params).cuda())
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(5)]
        out["losses_lr5e-3"] = losses
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            failures.append(f"tiny train on the card: the loss did not fall: {losses}")
        log(f"tiny train on the card, lr 5e-3: losses {[round(x, 4) for x in losses]}")

        # the launcher on the card: 2 steps and a checkpoint, then a resume to step 4
        kw = dict(batch_size=2, ckpt_dir=os.path.join(d, "ck"), save_steps=2, log_steps=1,
                  preview_steps=2, preview_dir=os.path.join(d, "preview"), device="cuda")
        r1 = launch.train(cfg, ts.TrainConfig(total_steps=2), ds, **kw)
        r2 = launch.train(cfg, ts.TrainConfig(total_steps=4), ds, resume=True, **kw)
        out["resume"] = {"first": [r1["start_step"], r1["state"]["step"]],
                         "second": [r2["start_step"], r2["state"]["step"]]}
        if (r1["start_step"], r1["state"]["step"], r2["start_step"], r2["state"]["step"]) != (
                0, 2, 2, 4):
            failures.append(f"launcher save/resume on the card: {out['resume']}")
        log(f"launcher on the card: steps {out['resume']['first']} then resumed "
            f"{out['resume']['second']}")
    return out


def _tiny_bf16_grads(failures, cfg, batch_np):
    """The training loss's gradients in bf16 at head_dim 128, where K1 and
    K4 take their tensor-core paths inside `train_forward` with remat
    "dots" (2 heads of 128 on the tiny config's 2 layers, seeded weights).
    The card and the plain CPU versions round to bf16 at the same points,
    so each parameter's gradient on the card must lie as close to the
    float32 gradient of the same weights on the CPU as the CPU's bf16
    gradient does: |g_card - g_f32| <= 2 |g_cpu - g_f32| + 2^-8 |g_f32| in
    L2 norm (two independent draws of the same rounding noise, plus one
    bf16 rounding). A wiring fault (delta, the recompute, the scale) moves a
    gradient by its own size. Also: K1 twice (forward and recompute) and K4
    once per layer, on the fused wgmma path."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.llm import multimodal as mm
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q

    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, hidden_size=256, intermediate_size=512, num_heads=2, num_kv_heads=2))
    params = mm.init(cfg, torch.Generator().manual_seed(1), dtype=torch.bfloat16)
    L = cfg.llama.num_layers

    def grads(module, dev):
        module = copy.deepcopy(module).to(dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        before = _counts(fa, Q)
        with torch.enable_grad():
            loss, _ = mm.train_forward(module, cfg, batch)
            names, ps = zip(*module.named_parameters())
            gs = torch.autograd.grad(loss, ps, allow_unused=True)
        counts = [a - b for a, b in zip(_counts(fa, Q), before)]
        return float(loss.detach()), {n: (torch.zeros_like(p) if g is None else g).double().cpu()
                             for n, p, g in zip(names, ps, gs)}, counts

    loss32, g32, _ = grads(copy.deepcopy(params).float(), "cpu")
    loss_cpu, g_cpu, _ = grads(params, "cpu")
    # cuBLAS's bf16 GEMMs sum in float32, as the CPU's do
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        loss_card, g_card, counts = grads(params, "cuda")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    launches = dict(zip(COUNT_KEYS, counts))
    expected = _launches(k1=2 * L, k4=L, k4_wgmma=L)
    worst, bad = 0.0, []
    for n, ref in g32.items():
        e_card = float((g_card[n] - ref).norm())
        e_cpu = float((g_cpu[n] - ref).norm())
        limit = 2 * e_cpu + 2**-8 * float(ref.norm())
        if limit > 0:
            worst = max(worst, e_card / limit)
        if not (np.isfinite(e_card) and e_card <= limit):
            bad.append(f"{n}: {e_card:.3g} > {limit:.3g}")
    loss_limit = 2 * abs(loss_cpu - loss32) + 2**-8 * abs(loss32)
    row = {"loss_f32": loss32, "loss_cpu_bf16": loss_cpu, "loss_card_bf16": loss_card,
           "loss_of_limit": abs(loss_card - loss32) / loss_limit if loss_limit else 0.0,
           "grad_worst_of_limit": worst, "launches": launches, "launches_expected": expected,
           "params_outside": bad}
    if bad or abs(loss_card - loss32) > loss_limit or launches != expected:
        failures.append(f"tiny bf16 head_dim 128 grads: outside {bad[:4]}, loss {loss_card} vs "
                        f"{loss32} (limit {loss_limit:.3g}), launches {launches} "
                        f"(expected {expected})")
    log(f"tiny bf16 head_dim 128 grads, card vs CPU float32: worst {worst:.3f} of the limit "
        f"over {len(g32)} parameters, loss {loss_card:.6f} (cpu bf16 {loss_cpu:.6f}, f32 "
        f"{loss32:.6f}), launches {launches}" + (" FAIL" if bad else " ok"))
    return row


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _kernel_class(name):
    n = name.lower()
    if "relpos2d" in n:
        return "k3"
    if "flash_bwd_wgmma" in n:
        return "k4"
    if "bwd_dq" in n:
        return "k4a"
    if "bwd_dkv" in n:
        return "k4b"
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
            "top": [{"ms": ms, "count": c, "name": nm[:120]} for ms, c, nm in kernels[:12]],
            "k2_kernels": {nm[:120]: c for _, c, nm in kernels if _kernel_class(nm) == "k2"}}


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
        Q.reset_qmv_counts()
        tc = gen_lib.generate(cpu.models["llm"].llama, lcfg, emb_c, None, **kw).tokens[0]
        tg = gen_lib.generate(gpu.models["llm"].llama, lcfg, emb_c.cuda(), None, **kw).tokens[0].cpu()
        out["greedy_k2_launches"] = Q.qmv_cuda.launches
        out["greedy_k2_by_path"] = dict(Q.qmv_cuda.launches_by_path)
        if Q.qmv_cuda.launches == 0 or out["greedy_k2_by_path"]["fma"] != Q.qmv_cuda.launches:
            failures.append(f"tiny greedy decode: K2 launches {out['greedy_k2_by_path']} "
                            f"(expected some, all fma)")
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
        log(msg + f" (K2 launches on the card: {out['greedy_k2_launches']} "
            f"{out['greedy_k2_by_path']})")
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--planted-faults", action="store_true",
                    help="instead of the phases: build broken copies of K1 (FAULTS), K2 "
                         "(QMV_FAULTS), K3 (K3_FAULTS) and K4 (K4_FAULTS) and show that the "
                         "checks refuse each while the real kernels pass")
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
    k4 = phase_k4(failures)
    t_k4 = time.time() - t0
    t0 = time.time()
    full = phase_full_width(failures)
    t_full = time.time() - t0
    t0 = time.time()
    train = phase_train(failures)
    t_train = time.time() - t0
    t0 = time.time()
    tiny = phase_tiny_reference(failures)
    t_tiny = time.time() - t0
    t0 = time.time()
    tiny_train = phase_tiny_train(failures)
    seconds = {"k1_checks": t_k1, "k2_checks": t_k2, "k3_checks": t_k3, "k4_checks": t_k4,
               "full_width": t_full, "train": t_train, "tiny": t_tiny,
               "tiny_train": time.time() - t0, "total": time.time() - t_start}
    edit, subject = full["edit"], full["subject"]

    head = next(r for r in rows if r["dtype"] == "bfloat16")
    k1_paths = {"text2img": sum(r["k1_launches"] for r in full["requests"]),
                "forward_llm": edit["k1_launches"], "edit_call": edit["call_k1_launches"],
                "subject_call": subject["k1_launches"], "train": train["launches"]["k1"]}
    d80 = [r for r in rows if r["dtype"] == "bfloat16" and r["shape"][3] == 80]
    k1 = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "instructany2pix_tpu_torch/csrc/flash_fwd_sm90.cuh",
        "kernel": "sm90::flash_fwd_wgmma_kernel<D, kKvLen, NoBias> (bf16, D in {64, 80, 128}) "
                  "through ia2p_flash_fwd (csrc/flash_fwd.cu), whose flash_fwd_kernel takes "
                  "float32 and other head dims",
        "replaces": "instructany2pix_tpu/ops/flash_attention.py:44",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        # the same launches by the kernel path each took (wgmma, fma)
        "launches_by_kernel_path": {
            "text2img": {p: sum(r["k1_by_path"][p] for r in full["requests"])
                         for p in full["requests"][0]["k1_by_path"]},
            "forward_llm": edit["k1_by_path"], "edit_call": edit["call_k1_by_path"],
            "subject_call": subject["k1_by_path"], "train": train["k1_by_path"]},
        "max_abs_err": max(r["err_o"] for r in rows if r["dtype"] == "bfloat16"),
        "max_abs_err_fp32": max(r["err_o"] for r in rows if r["dtype"] == "float32"),
        "max_err_of_limit": max(r["of_limit"] for r in rows + k4["k1_kv_len"]),
        "ms": head["ms"],
        "ms_bshd": head["ms_bshd"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "headline_shape": f"{head['label']} {head['shape']} sk={head['sk']} bf16",
        "head_dim_80": [{k: r.get(k) for k in ("label", "shape", "sk", "path", "ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by", "of_limit")}
                        for r in d80],
        "shapes": rows,
        "kv_len_shapes": k4["k1_kv_len"],
        "training_shape": {k: k4["k1_kv_len"][0][k] for k in (
            "label", "shape", "kv_len", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
    }
    qhead = next(r for r in qrows if r["label"] == "7B qkv + norm" and r["m"] == 1)
    k2 = {
        "name": "qmv",
        "route": "cuda",
        "source": "instructany2pix_tpu_torch/csrc/qmv.cu",
        "kernel": "qmv_kernel<kMma, FMT, MT>: one launch per call, a cluster of K chunks per "
                  "128-column tile, weights by TMA; mma.sync on int4 with bf16 activations, "
                  "float32 fma otherwise",
        "replaces": "instructany2pix_tpu/ops/quant.py:294",
        "also_replaces": ["instructany2pix_tpu/ops/quant.py:417",
                          "benchmarks/qmv_dma_probe.py:32"],
        "launches": edit["k2_launches"],
        "launches_by_path": {"text2img": sum(r["k2_launches"] for r in full["requests"]),
                             "forward_llm": edit["k2_launches"],
                             "edit_call": edit["call_k2_launches"],
                             "subject_call": subject["k2_launches"],
                             "train": train["launches"]["k2"]},
        # the same launches by the kernel path each took (mma, fma), and the
        # tiny float32 greedy decode's, off the main paths
        "launches_by_kernel_path": {
            "text2img": {p: sum(r["k2_by_path"][p] for r in full["requests"])
                         for p in full["requests"][0]["k2_by_path"]},
            "forward_llm": edit["k2_by_path"], "edit_call": edit["call_k2_by_path"],
            "subject_call": subject["k2_by_path"], "tiny_greedy_decode": tiny["greedy_k2_by_path"]},
        "max_abs_err": max(r["err"] for r in qrows),
        "max_err_of_limit": max(r["of_limit"] for r in qrows),
        "ms": qhead["ms"],
        "ms_eager": qhead["ms_eager"],
        "ms_note": "device time from a CUDA graph of calls on weight copies larger than L2",
        "plain_ms": qhead["plain_ms"],
        "bound_ms": qhead["bound_ms"],
        "bound_by": qhead["bound_by"],
        "library_ms": qhead["library_ms"],
        "library_call": "F.linear on bf16 weights dequantized ahead of time",
        "headline_shape": "7B qkv + RMSNorm, M=1, K=4096, N=12288, int4 group 128, bf16",
        "decode_step_k2_share": edit.get("k2_share"),
        "shapes": [{k: r[k] for k in ("label", "m", "k", "n", "format", "fusion", "dtype", "path",
                                      "cluster", "chunk", "max_active_clusters", "ms", "ms_eager",
                                      "plain_ms", "library_ms", "bound_ms", "bound_by", "of_bound",
                                      "err", "of_limit")}
                   for r in qrows],
    }
    k3head = next(r for r in k3rows if r["label"] == "sam global block")
    k3win = next(r for r in k3rows if r["label"] == "sam window block")
    k3 = {
        "name": "flash_relpos2d",
        "route": "cuda",
        "source": "instructany2pix_tpu_torch/csrc/flash_fwd_sm90.cuh",
        "kernel": "sm90::flash_fwd_wgmma_kernel<D, false, RelPos2dBias> (bf16, D in {64, 80}) "
                  "through ia2p_flash_relpos2d (csrc/flash_fwd.cu)",
        "replaces": "instructany2pix_tpu/ops/flash_attention.py:174",
        "launches": subject["k3_launches"],
        "launches_by_kernel_path": {"subject_call": subject["k3_by_path"]},
        "launches_by_path": {"text2img": sum(r["k3_launches"] for r in full["requests"]),
                             "forward_llm": edit["k3_launches"], "edit_call": edit["call_k3_launches"],
                             "subject_call": subject["k3_launches"],
                             "train": train["launches"]["k3"]},
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
        "window_shape": {k: k3win[k] for k in ("label", "shape", "g", "ms", "plain_ms",
                                                "library_ms", "bound_ms", "bound_by")},
        "sam_encode_ms": subject["sam_encode_ms"],
        "sam_encode_split": subject["sam_encode_split"],
        "shapes": [{k: r[k] for k in ("label", "shape", "g", "path", "ms", "ms_bshd", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by", "err_o", "of_limit",
                                      "of_limit_qkv")}
                   for r in k3rows],
    }
    k4head = next(r for r in k4["k4"] if r["label"] == "llama train")
    k4rows = [{k: r.get(k) for k in (
        "label", "dtype", "path", "shape", "sk", "causal", "kv_len", "ms", "ms_bshd",
        "ms_with_delta", "ms_dq", "ms_dkv", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "bound_ms_dq", "bound_ms_dkv", "tflops", "err_dq", "err_dk", "err_dv", "of_limit_dq",
        "of_limit_dk", "of_limit_dv", "of_limit_fused", "of_limit_two_kernel")} for r in k4["k4"]]

    def per_path(key):
        return {"text2img": sum(r[key] for r in full["requests"]), "forward_llm": edit[key],
                "edit_call": edit["call_" + key], "subject_call": subject[key],
                "train": train["launches"][key.split("_")[0]]}

    k4_paths = per_path("k4_launches")

    def k4_entry(name, line, out_key):
        """K4a and K4b keep their entries: both name the fused kernel, which
        replaces both TPU kernels, with its launches and times."""
        bf16 = [r for r in k4["k4"] if r["dtype"] == "bfloat16"]
        return {
            "name": name, "route": "cuda",
            "source": "instructany2pix_tpu_torch/csrc/flash_bwd_sm90.cuh",
            "kernel": "sm90::bwd::flash_bwd_wgmma_kernel through ia2p_flash_bwd "
                      "(csrc/flash_bwd.cu), the wgmma path of flash_bwd_cuda",
            "replaces": f"instructany2pix_tpu/ops/flash_attention.py:{line}",
            "launches": sum(k4_paths.values()), "launches_by_path": k4_paths,
            "launches_by_kernel_path": {
                "train": {p: train["launches"][f"k4_{p}"] for p in ("wgmma", "mma", "fma")}},
            "two_kernel_launches": {"k4a": per_path("k4a_launches"),
                                    "k4b": per_path("k4b_launches")},
            "max_abs_err": max(max(r[f"err_{o}"] for o in out_key) for r in bf16),
            "max_abs_err_fp32": max(max(r[f"err_{o}"] for o in out_key) for r in k4["k4"]
                                    if r["dtype"] == "float32"),
            "max_err_of_limit": max(max(r[f"of_limit_{o}"] for o in out_key)
                                    for r in k4["k4"] + k4["function"]),
            "ms": k4head["ms"], "ms_bshd": k4head["ms_bshd"],
            "ms_with_delta": k4head["ms_with_delta"],
            "ms_note": "the whole backward (dq, dk and dv) in one launch, the dq accumulator's "
                       "zeroing and cast included; ms_with_delta also computes delta",
            "plain_ms": k4head["plain_ms"],
            "plain_call": "flash_bwd_reference: the whole plain backward (dq, dk and dv)",
            "bound_ms": k4head["bound_ms"], "bound_by": k4head["bound_by"],
            "bound_note": "5 products of 2 D flops per visible pair, or q, k, v, dO, lse and "
                          "delta read and dq, dk, dv written once",
            "library_ms": k4head["library_ms"],
            "library_call": "torch.autograd.grad through F.scaled_dot_product_attention("
                            "is_causal=True), backward only: dq, dk and dv in one call",
            "headline_shape": "Llama training (4, 32, 2048, 128), causal, bf16",
            "shapes": k4rows,
        }

    k4a = k4_entry("flash_bwd_dq", 321, ("dq",))
    k4b = k4_entry("flash_bwd_dkv", 367, ("dk", "dv"))
    kernels = [k1, k2, k3, k4a, k4b]
    result = {"card": card, "k2_shapes": qrows, "k4": k4, "full_width": full, "train": train,
              "tiny_reference": tiny, "tiny_train": tiny_train, "seconds": seconds}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "kernels": kernels}, f, indent=1, default=str)
    summary = {k: v for k, v in full.items() if k not in ("edit", "subject", "unet_step_profile")}
    log(json.dumps({"full_width": summary, "tiny_reference": tiny, "seconds": seconds}))
    log(json.dumps({"train": {k: v for k, v in train.items() if k != "step_profile"},
                    "tiny_train": tiny_train}, default=str))
    log(json.dumps({"edit": {k: v for k, v in edit.items() if k != "decode_profile"}}))
    log(json.dumps({"subject": subject}, default=str))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
