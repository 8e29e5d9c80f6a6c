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
edited image. Then the batched server (`serving.PipelineServer`, batch 4)
on that pipeline: its real LLM stage on 4 requests whose prompts fall in
four 64-token buckets (K2 launched exactly 128 times per decode step, all
on its mma path, every call at M = 4; the same requests served again give
the same tokens), the batched decode step timed and profiled; 4 image
requests and a caption-only one through `submit` with the LLM stage
stubbed by seeded outcomes, served twice (finite 1024x1024 images, the
caption-only one None, exact K1 count, seconds per stage, latency per
request, images per second, peak memory; the second serving identical);
one `__call__` with `diffusion_mode="ipa_lcm"` (4 LCM UNet calls after
the inversion) and one `serve.run` on the written media. Phase 5 also holds
the tiny server (batch 3, one caption-only row, the draws injected) on the
card against the CPU's and against `__call__` on the card.

Slice 11: before phase 4, `load_tokenizer` on a directory holding only a
SentencePiece `tokenizer.model` that the script encodes itself (a mixed
corpus round-trips; transformers, sentencepiece, tokenizers and protobuf
stay unloaded). After the server, on phase 4's pipeline (`phase_switches`):
`forward_llm` with `llm_speculative_layers=4` beside plain greedy decode
on the same prompt (tokens identical, or diverging only at a printed
rounding tie: the plain run's top-2 margin below the runs' largest logit
difference at that step; K2 exactly rounds x (3 x 4 x 4 + 128), split by
M), one verify and one draft step timed and the verify profiled;
`__call__(debug=True)` against the same call without it (bit-identical
images; attention maps (4, 1024, 1024), finite, summing to 1; K1 of the
call plus 2 per transformer block for the tap); the prior's DDPM path (25
steps); the CLIP ViT-H/14 image encoder at batch 2 in bf16 on random
weights (32 K1 launches, all wgmma; image_embeds within K1's limit carried
through the tower: the spread that moving every attention output by its
whole limit gives). Phase 5 adds speculative decode and the DDPM prior,
card against CPU (tokens identical; within 1e-5 relative).

Training (slice 4): after K3, K1 with a per-row key count (`kv_len`)
against the router's plain masked path, and K4 (the flash backward)
against the plain backward at the Llama training shape with and without
ragged rows, sq != sk, ragged D = 80, the UNet shape, the scalar path and
float32, on contiguous inputs and (B, S, H, D) views (K4_TOL): the whole
backward (`flash_bwd_cuda`: the fused TMA/wgmma kernel at bf16 head_dim 64,
80 and 128, which every such row must report, K4a then K4b otherwise) and,
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

Slice 12, on phase 4's pipeline after the switches (`phase_adapters`):
K1 on pnp's broadcast operands (q and k of row 0 with a zero batch stride)
against its plain version at (3,10,4096,64) and (3,20,1024,64), on the
wgmma path, bit-equal to K1 on a dense copy, timed beside the copy; plug-and-play
editing at 1024^2 (the edit's base image inverted, then `pnp_denoise`, 10
steps, injection 0.8: exactly 2 K1 per transformer block per UNet call,
8 x 36 of them broadcast), its UNet step at batch 3, three identical rows
bit-identical with sharing on and off (with cuDNN off; row 0 also with
cuDNN's convolutions); IP-Adapter Plus XL (random CLIP
ViT-H/14 and Resampler, bf16; 64 + 10 x 210 K1); FaceID and FaceID-Plus
written in the reference's layout, read through `faceid_keymap` and merged
into a copy of the base UNet (zero-init adapters leave ε bit-identical,
loaded ones change it; 10 x 210 K1, + 64 for Plus); the pipeline's UNet
unchanged afterwards. Then, while the tree exists (`phase_finetune_tree`):
rank-8 adapters over the tree's 32-layer LLM written in the reference's LoRA
layout, booted with `load_pretrained_model(load_lora=True)`, quantized and
fused (greedy tokens identical to the model merged in memory, K2 exactly
128 per decode step, all mma); the surgery round trip on its resized
embedding and lm_head; the data preparation over 2 PNGs and 2 WAVs with
ImageBind-huge from the tree (states bit-identical to the pipeline's
embeddings). After the train phase (`phase_finetune`): LoRA training at the
train phase's width and batch (3 steps; frozen weights bit-unchanged; K1 and
K4 exact), merged against unmerged logits, one decode step over an int4 base
with unmerged adapters (K2's unfused calls counted, each held against its
plain version), `MediaMap` over the prepared features into `train_forward`,
and 5 steps of the prior's training (GPT-2 medium). After the tiny trainer
(`phase_tiny_adapters`): one pnp step, one FaceID UNet call, one LoRA train
step and one prior train step in float32, card against CPU.

Slice 13: after phase 4's pipeline is freed, while the tree exists
(`phase_staged`): the tree booted into a `StagedParams` store under a
12.5e9-byte budget (`loaders.staged_models_from_root`, groups built on
first access, evicted least recently used to the host and restaged), the
same seeded `forward_llm` and `__call__` as phase 4 (tokens identical,
images bit-identical to the resident run's; evictions, swaps, swap_s,
swap_bytes and peak memory beside the budget), then phase 4's served
requests through `PipelineServer` over the staged pipeline (the UNet
resolved from the store per batch; images bit-identical to the resident
server's), then the same `forward_llm` on the int4 LLM restaged from the
host (tokens identical; K2 128 launches per step, all mma). After the fine-tuning phases: `phase_codecs`
(`build_vae("vq-npz")` and `VQVAE` over the prepared features;
`ClipVisionCodec` at ViT-H/14, 32 K1 launches, all wgmma, within K1's limit
carried through the tower; the VQ-GAN f16 at 256^2, batch 4: encode,
quantize, decode and one generator and one discriminator step with Adam
(0.5, 0.9), every weight moved; SpecVQGAN's 1D VQ model, the MelGAN vocoder
and LPAPS on an 80 x 848 mel), `phase_mpt` (MPT-7B bf16, random: prefill
512 tokens, 32 cached decode steps, held to one full forward within twice
the full forward's bf16 distance from float32), `phase_clip_score`
(ViT-H/14 towers, 2 images and 2 prompts, 32 K1 launches); and at the end
`phase_tiny_slice13` (float32, TF32 off: the tiny VQ-GAN, VQ1D and MPT on
the card against the CPU, indices identical, within TINY_REL; the tiny edit
through a store that evicts between stages, bit-identical to the edit
without one).

Slice 14 (`phase_parallel`, at the end of phase 4 with the tree on disk and
every pipeline freed; each rank a process of this script, `--rank`, joined
within PARALLEL_TIMEOUT_S and killed after it, so a rank that fails or
hangs fails the phase): two gloo ranks on the one card, mesh (1, 2), each
booting the full-width pipeline from the tree with `mesh=` (the LLM
unfused, o and down at int8); rank 0 first runs the LLM stage on its whole
model (the reference); `PipelineServer(mesh=)` shards the LLM and the
UNet over "model"; rank 0 serves the LLM stage for real on 2 prompts
(injected Gumbel draws: tokens identical to the reference or diverging
only at a bf16 rounding tie; K2 exactly 5 mma and 2 fma launches per layer
per decode step) and 2 edits through the diffusion stages at phase 4's
step counts (exact K1 count, all wgmma, the base UNet's attention on its
local heads; finite images; their largest uint8 difference from the
resident server printed), the other rank following; each rank's peak
memory and the collectives by op; one full-width decoder layer and one
SDXL transformer block by the two ranks' shards against the unsharded
copies within K2's and K1's limits carried through; one CFG UNet step's
collectives; ring attention at (1, 8192, 8, 64) against plain attention.
Then one NCCL rank: FSDP2 at world size 1 on the full-width trainer, the
first step's loss equal to the unsharded step's, its grad norm within
2^-8, the same K1 and K4 launches.

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
    ("unet self 64x64, served batch 4", (8, 10, 4096, 64), 4096, False),
    ("unet self 64x64, TP shard (5 of 10 heads)", (2, 5, 4096, 64), 4096, False),
    ("refiner self 64x64", (2, 12, 4096, 64), 4096, False),
    ("refiner self 32x32", (2, 24, 1024, 64), 1024, False),
    ("ragged d=64", (2, 10, 1000, 64), 999, False),
    ("imagebind vit-h", (1, 16, 257, 80), 257, False),
    ("clip vit-h/14 image encoder", (2, 16, 257, 80), 257, False),
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
    fa.flash_fwd_cuda.launches_broadcast = 0


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
    ("7B qkv + norm", 4096, 12288, "int4g", "norm", (1, 4, 16), "bfloat16"),
    ("7B o + residual", 4096, 4096, "int4g", "residual", (1, 4, 16), "bfloat16"),
    ("7B gate_up + norm", 4096, 22016, "int4g", "norm", (1, 4, 16), "bfloat16"),
    ("7B down + swiglu + residual", 11008, 4096, "int4g", "swiglu+residual", (1, 4, 16), "bfloat16"),
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
    # the tensor-parallel decode's shards at n_model = 2 (unfused; o and down
    # int8, row-split, their residual added after the all-reduce)
    ("7B TP q/k/v shard + norm", 4096, 2048, "int4g", "norm", (1, 2), "bfloat16"),
    ("7B TP gate/up shard + norm", 4096, 5504, "int4g", "norm", (1, 2), "bfloat16"),
    ("7B TP o shard, int8", 2048, 4096, "int8", "none", (1, 2), "bfloat16"),
    ("7B TP down shard, int8 + swiglu", 5504, 4096, "int8", "swiglu", (1, 2), "bfloat16"),
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
# patch the two-kernel fma path (csrc/flash_bwd.cu), which the whole backward
# takes at head_dim 72 and in float32 and the check also runs on its own
# there; the fused_* ones patch the fused wgmma kernel (flash_bwd_sm90.cuh),
# the fused_d80_* ones its head_dim 80 tail boxes.
K4_FAULTS = {
    "delta_dropped": (
        "K4a: ds = p * dp * scale, without delta",
        "ds_s[pi] = to_f(from_f<T>(p * (dp - del_s[r]) * a.scale));",
        "ds_s[pi] = to_f(from_f<T>(p * dp * a.scale));"),
    "causal_start_late": (
        "K4b: the causal query loop starts one tile late",
        "if (a.causal) qs0 = (max(key0 - offset, 0) / kSTile) * kSTile;",
        "if (a.causal) qs0 = (max(key0 - offset, 0) / kSTile + 1) * kSTile;"),
    "ds_scale_missing": (
        "K4b: ds = p * (dp - delta), without the scale",
        "ds_s[pi] = to_f(from_f<T>(p * (dp - del_s[j]) * a.scale));",
        "ds_s[pi] = to_f(from_f<T>(p * (dp - del_s[j])));"),
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
        "if (ct == 0) {  // one thread issues every reduce-add",
        "if (ct == 0 && q0 + kQRows <= p.Sq) {  // one thread issues every reduce-add",
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
    "fused_d80_tail_kstep_dropped": (
        "fused path, head_dim 80: S^T = K.Q^T skips its 5th k-step (columns 64-79)",
        "        Wgmma<64>::ss(s, desc(k_tail + cw * 64 * kTailRow, 16, 8 * kTailRow, 32),",
        "        if (cw < 0) Wgmma<64>::ss(s, desc(k_tail + cw * 64 * kTailRow, 16, 8 * kTailRow, 32),",
        "flash_bwd_sm90.cuh"),
    "fused_d80_dq_tail_never_added": (
        "fused path, head_dim 80: dQ's 16-column tail box is never reduce-added (dq's columns "
        "64-79 stay 0)",
        "tma_reduce_add(&maps.dq_tail, dq_buf + 2 * kQHalf, kMainCols, q0, h, b);",
        "if (q0 < 0) tma_reduce_add(&maps.dq_tail, dq_buf + 2 * kQHalf, kMainCols, q0, h, b);",
        "flash_bwd_sm90.cuh"),
    "fused_d80_dv_tail_dropped": (
        "fused path, head_dim 80: dV's n16 wgmma on dO's tail box never runs",
        "Wgmma<kTail>::rs(part<kMainCols / 2, kTail / 2>(dv), pa[kk],",
        "if (kk < 0) Wgmma<kTail>::rs(part<kMainCols / 2, kTail / 2>(dv), pa[kk],",
        "flash_bwd_sm90.cuh"),
    "fused_d80_dq_tail_unswizzled": (
        "fused path, head_dim 80: dQ's tail box is written to shared memory without the 64-byte "
        "swizzle",
        "const int chunk = (2 * (j - 8) + (t4 >> 1)) ^ ((row >> 1) & 3);",
        "const int chunk = 2 * (j - 8) + (t4 >> 1);", "flash_bwd_sm90.cuh"),
}


def k4_path_expected(dname, d):
    """The path of the whole backward (`flash_bwd_cuda`) for rows with
    16-byte aligned strides: the fused wgmma kernel for bf16 at head_dim 64,
    80 and 128, K4a and K4b on the scalar fma loop otherwise."""
    return "wgmma" if dname == "bfloat16" and d in (64, 80, 128) else "fma"


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


def phase_full_width(failures, feats_dir):
    """Phase 4: write the full-width tree, boot the pipeline from it, check
    the boot, then drive text2img, the edit and subject consistency, and
    the paths of the later slices that run on the booted pipeline or read
    the tree (the data preparation writes its features to `feats_dir`)."""
    import atexit
    import shutil

    cfg = _full_config()
    root = _tree_dir()
    if root is None:
        raise RuntimeError(f"the full-width checkpoint tree needs {TREE_FREE_BYTES / 2**30:.0f} GiB "
                           "free under the temporary directory or the checkout's build/")
    atexit.register(shutil.rmtree, root, True)
    try:
        return _full_width_from(root, cfg, failures, feats_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _full_width_from(root, cfg, failures, feats_dir):
    import gc

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
            # the step's closure holds the UNet: drop it with the pipeline below
            del step, eps_fn, lat, ctx_p, pooled_p, ctx_n, pooled_n, tid
        prof = out["unet_step_profile"]
        if prof is not None:
            log(f"UNet step device busy without the profiler: {prof['kernel_ms']:.2f} ms of kernels "
                f"in {out['unet_step_ms']:.2f} ms = {prof['kernel_ms'] / out['unet_step_ms']:.1%}")
        log(f"UNet step (CFG batch 2, 1024^2): median {out['unet_step_ms']:.2f} ms of 7 "
            f"(min {samples[0]:.2f}, max {samples[-1]:.2f}); VAE decode "
            f"{out['vae_decode_ms']:.2f} ms; prompt encode {out['prompt_encode_ms']:.2f} ms")
        out["edit"] = phase_edit(pipe, failures, finite)
        out["subject"] = phase_subject(pipe, failures, finite)
        out["serve"] = phase_serve(pipe, failures, finite, out["edit"])
        t0 = time.time()
        out["switches"] = phase_switches(pipe, failures, finite)
        out["switches_seconds"] = time.time() - t0
        t0 = time.time()
        out["adapters"] = phase_adapters(pipe, failures)
        out["adapters_seconds"] = time.time() - t0
        t0 = time.time()
        out["finetune_tree"] = phase_finetune_tree(pipe, root, feats_dir, failures)
        out["finetune_tree_seconds"] = time.time() - t0
    finally:
        vae_lib.decode = decode
    del pipe
    # the server's scheduler holds its pipeline in a reference cycle: collect
    # it now, so the phases after this one start without its weights
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    out["staged"] = phase_staged(root, cfg, failures)
    out["staged_seconds"] = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    out["parallel"] = phase_parallel(root, cfg, failures)
    out["parallel_seconds"] = time.time() - t0
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
        # on the host, for the staged edit after this pipeline is freed
        RESIDENT_EDIT.update(images=(non_refined, refined), tokens=out["tokens"],
                             decode_steps=steps, forward_llm_k1=k1_expected,
                             call_k1=expected, blocks={n: blocks(n) for n in ("unet", "refiner")})
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


SERVE_BATCH = 4  # requests per microbatch of the full-width server (K2 at M = 4)
# instructions whose Vicuna prompts (the byte tokenizer: a token per byte)
# fall in four different 64-token buckets, so every row has its own left pad
SERVE_INSTS = (
    "Put <video> in the picture.",
    "Draw the scene of <video>, with the light of a late afternoon falling on every surface "
    "of the room.",
    "Take the sound of <video> and paint it into the picture <video>, as an old oil painting "
    "of a small antique shop with clocks on the walls and a cat asleep on the counter.",
    "Describe what an antique shop full of ticking clocks, brass lamps, maps and old books "
    "would look like at dusk, then tell me which three objects a visitor would notice first "
    "and why they would stop to look at them for a long while.",
)


def _vicuna_prompt(inst):
    from instructany2pix_tpu_torch.llm.conversation import conv_templates

    conv = conv_templates["vicuna_v1"].copy()
    conv.append_message(conv.roles[0], inst)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def _served_edits(image, dd):
    """The served diffusion requests of `phase_serve` and `phase_staged`: 4
    edits of one image and a caption-only request, and a stub of the LLM
    stage that gives each edit seeded outcomes (a random 7B asks for no
    image)."""
    import numpy as np

    from instructany2pix_tpu_torch import serving

    def stub(batch):
        outs = []
        for r in batch:
            if not r.mm_data:
                outs.append((None, None, " a caption only", None, None))
                continue
            rk = np.random.RandomState(r.seed)
            outs.append((rk.randn(1, dd).astype(np.float32), rk.randn(dd).astype(np.float32),
                         f" a cat in an antique shop, take {r.seed}", r.mm_data[0]["fname"],
                         dict(all_objs=[], extra_embeds=np.zeros((0, dd)), extra_idx=[])))
        return outs

    edits = [serving.PipelineRequest("Put <video> in the picture.", [image],
                                     num_inference_steps=EDIT_STEPS, cfg=10.0, refinement=0.5,
                                     seed=s) for s in (1, 2, 3, 4)]
    caption_only = serving.PipelineRequest("Describe the shop.", [], num_inference_steps=EDIT_STEPS,
                                           cfg=10.0, refinement=0.5, seed=5)
    return edits, caption_only, stub


def phase_serve(pipe, failures, finite, edit):
    """The batched server at full width on the pipeline phase 4 booted:
    `PipelineServer._llm_stage` on 4 requests whose prompts fall in four
    64-token buckets (K2 at M = 4, 128 launches per decode step, all mma),
    then 4 image requests and a caption-only one through `submit` with the
    LLM stage stubbed by seeded outcomes (a random 7B asks for no image),
    served twice; one `__call__` with `diffusion_mode="ipa_lcm"`; one
    `serve.run` on the written media. Each with the launch counts set to 0
    just before and read just after."""
    import collections
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch import serve, serving
    from instructany2pix_tpu_torch.models import llama as llama_lib
    from instructany2pix_tpu_torch.models import unet as unet_lib
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q

    cfg = pipe.cfg
    out = {"batch": SERVE_BATCH}
    per_step = 4 * cfg.llm.llama.num_layers

    def reset():
        reset_k1(fa)
        reset_k3(fa)
        Q.reset_qmv_counts()
        reset_k4(fa)

    def blocks(name):
        return sum(isinstance(m, unet_lib.TBlock) for m in pipe.models[name].modules())

    def decode_steps(gen):
        return min(int(gen.done_at.max()), gen.tokens.shape[1] - 1)

    server = serving.PipelineServer(pipe, max_batch=SERVE_BATCH, max_wait_s=0.5)
    try:
        with tempfile.TemporaryDirectory() as d:
            png, wav = _write_media(d)
            image, audio = {"type": "image", "fname": png}, {"type": "audio", "fname": wav}
            media = ([image], [audio], [audio, image], [])
            reqs = [serving.PipelineRequest(inst, m, seed=40 + i)
                    for i, (inst, m) in enumerate(zip(SERVE_INSTS, media))]

            # ---- the real LLM stage: one batched decode at M = 4
            # the rows M of every quantized product (each such call on the
            # card is one K2 launch)
            rows = collections.Counter()
            orig = Q.qmatmul

            def recording(x, q, *a, **kw):
                rows[x.numel() // x.shape[-1]] += 1
                return orig(x, q, *a, **kw)

            lens = [len(pipe.tokenizer(_vicuna_prompt(r.inst)).input_ids) for r in reqs]
            tokens = []
            for rep in range(2):
                pipe.stage_times = {}
                reset()
                Q.qmatmul = recording
                rows.clear()
                try:
                    t0 = time.time()
                    llm_outs = server._llm_stage(reqs)
                    torch.cuda.synchronize()
                    dt = time.time() - t0
                finally:
                    Q.qmatmul = orig
                gen = server.last_generate
                tokens.append(gen.tokens.cpu())
                if rep == 0:
                    steps = decode_steps(gen)
                    k1, k2 = fa.flash_fwd_cuda.launches, Q.qmv_cuda.launches
                    out.update({
                        "llm_stage_seconds": dt, "llm_stage_stage_seconds": dict(pipe.stage_times),
                        "prompt_tokens": lens, "left_pads": [-(-max(lens) // 64) * 64 - n for n in lens],
                        "decode_steps": steps, "done_at": gen.done_at.tolist(),
                        "llm_k2_launches": k2, "llm_k2_by_path": dict(Q.qmv_cuda.launches_by_path),
                        "llm_k2_rows": dict(rows), "llm_k2_expected": per_step * steps,
                        "llm_k1_launches": k1, "llm_k1_by_path": dict(fa.flash_fwd_cuda.launches_by_path),
                        "llm_k1_expected": cfg.imagebind_vision.layers + cfg.imagebind_audio.layers,
                        "llm_k3_launches": fa.flash_relpos2d_cuda.launches,
                        "captions": [o[2][:60] for o in llm_outs]})
                    out.update({"llm_" + k: v for k, v in no_k4(fa, failures, "serve LLM stage").items()})
            out["llm_repeat_identical"] = bool(torch.equal(tokens[0], tokens[1]))
            buckets = {-(-n // 64) for n in lens}
            ok = (out["llm_k2_launches"] == per_step * steps and steps > 0
                  and out["llm_k2_by_path"]["mma"] == out["llm_k2_launches"]
                  and out["llm_k2_rows"] == {SERVE_BATCH: out["llm_k2_launches"]}
                  and out["llm_k1_launches"] == out["llm_k1_expected"]
                  and out["llm_k1_by_path"]["wgmma"] == out["llm_k1_launches"]
                  and out["llm_k3_launches"] == 0 and len(buckets) == len(reqs)
                  and out["llm_repeat_identical"])
            if not ok:
                failures.append(f"serve LLM stage: K2 {out['llm_k2_launches']} by path "
                                f"{out['llm_k2_by_path']} rows {out['llm_k2_rows']} (expected "
                                f"{per_step} x {steps} decode steps, all mma at M = {SERVE_BATCH}), "
                                f"K1 {out['llm_k1_launches']} {out['llm_k1_by_path']} (expected "
                                f"{out['llm_k1_expected']}, all wgmma), K3 {out['llm_k3_launches']}, "
                                f"prompt buckets {sorted(buckets)}, repeat identical "
                                f"{out['llm_repeat_identical']}")
            log(f"serve LLM stage (batch {SERVE_BATCH}, prompts of {lens} tokens, left pads "
                f"{out['left_pads']}): {out['llm_stage_seconds']:.3f} s ("
                + ", ".join(f"{k} {v:.3f} s" for k, v in out["llm_stage_stage_seconds"].items())
                + f"), {steps} decode steps, K2 launches {out['llm_k2_launches']} "
                f"{out['llm_k2_by_path']} at M {out['llm_k2_rows']} (expected {per_step * steps}, "
                f"all mma at M = {SERVE_BATCH}), K1 {out['llm_k1_launches']} "
                f"{out['llm_k1_by_path']} (expected {out['llm_k1_expected']}: the batch's ImageBind "
                f"calls), repeat identical {out['llm_repeat_identical']}")

            # the batched decode step, timed and profiled on the same prompts
            with torch.inference_mode():
                lm, lcfg = pipe.models["llm"].llama, cfg.llm.llama
                aux = server._batched_mm_embed(reqs)
                embs = [pipe._prepare_llm_inputs(r.inst, a)[1] for r, a in zip(reqs, aux)]
                tgt = -(-max(lens) // 64) * 64
                emb = torch.cat([torch.nn.functional.pad(e, (0, 0, tgt - e.shape[1], 0))
                                 for e in embs])
                pads = torch.tensor([tgt - n for n in lens], device="cuda")
                cache = llama_lib.KVCache.create(lcfg, SERVE_BATCH, max_len=tgt + 100,
                                                 dtype=emb.dtype, device="cuda")
                o = llama_lib.forward(lm, lcfg, inputs_embeds=emb, cache=cache, prefix_pad=pads)
                cache, tok = o["cache"], o["logits"][:, -1].argmax(-1)

                def decode_step():
                    nonlocal cache, tok
                    o = llama_lib.forward(lm, lcfg, inputs_embeds=llama_lib.embed(lm, tok[:, None]),
                                          cache=cache, prefix_pad=pads)
                    cache, tok = o["cache"], o["logits"][:, -1].argmax(-1)

                decode_step()
                td = sorted(time_ms(decode_step, 1, warmup=0) for _ in range(21))
                prof = profile_window(decode_step, f"batched decode step (M = {SERVE_BATCH})", n=3)
            out.update({"decode_ms_median": td[10], "decode_ms_range": [td[0], td[-1]],
                        "decode_profile": prof, "single_decode_ms_median": edit["decode_ms_median"],
                        "decode_busy": prof["kernel_ms"] / td[10] if prof else None})
            log(f"batched decode step (M = {SERVE_BATCH}): median {td[10]:.3f} ms of 21 (min "
                f"{td[0]:.3f}, max {td[-1]:.3f}); M = 1 in this run {edit['decode_ms_median']:.3f} ms"
                + (f"; {prof['kernel_ms']:.3f} ms of kernels, busy {out['decode_busy']:.1%}, K2 "
                   f"{prof['by_class'].get('k2', 0.0):.3f} ms" if prof else ""))

            # ---- the diffusion stages through submit, the LLM stage stubbed
            dd = cfg.llm.image_codec_dim
            edits, caption_only, server._llm_stage = _served_edits(image, dd)
            ref_steps = int(50 * 0.5)
            k1_expected = EDIT_STEPS * 5 * blocks("unet") + ref_steps * 2 * blocks("refiner")
            served = []
            for rep in range(2):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                pipe.stage_times = {}
                reset()
                n_decoded = len(finite)
                done_at = {}
                t0 = time.time()
                futs = [server.submit(r) for r in edits + [caption_only]]
                for i, f in enumerate(futs):
                    f.add_done_callback(lambda _f, i=i: done_at.__setitem__(i, time.time()))
                results = [f.result(timeout=900) for f in futs]
                torch.cuda.synchronize()
                wall = time.time() - t0
                served.append(results)
                if rep == 0:
                    k1 = fa.flash_fwd_cuda.launches
                    out.update({
                        "diffusion_wall_seconds": wall,
                        "latency_seconds": [done_at[i] - t0 for i in range(len(futs))],
                        "images_per_second": len(edits) / max(done_at[i] - t0
                                                              for i in range(len(edits))),
                        "stage_seconds": dict(pipe.stage_times), "k1_launches": k1,
                        "k1_by_path": dict(fa.flash_fwd_cuda.launches_by_path),
                        "k1_expected": k1_expected, "k2_launches": Q.qmv_cuda.launches,
                        "k3_launches": fa.flash_relpos2d_cuda.launches,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "single_call_seconds": edit["call_seconds"],
                        "single_call_peak_gib": edit["call_peak_gib"]})
                    out.update(no_k4(fa, failures, "serve diffusion"))
                    new_finite = finite[n_decoded:]
            size = cfg.image_size
            first, again = served
            images_ok = all(r.image is not None and r.image.shape == (size, size, 3)
                            and r.image.dtype == np.uint8 and r.image.std() > 0 for r in first[:4])
            repeat_ok = all(np.array_equal(a.image, b.image) for a, b in zip(first[:4], again[:4]))
            differ = all(not np.array_equal(first[i].image, first[j].image)
                         for i in range(4) for j in range(i + 1, 4))
            # on the host, for the staged serve after this pipeline is freed
            RESIDENT_EDIT["served"] = [r.image for r in first[:4]]
            out.update({"images_ok": images_ok, "repeat_identical": repeat_ok,
                        "seeds_differ": differ, "caption_only_none": first[4].image is None,
                        "decodes_finite": new_finite,
                        "mean_pixels": [float(r.image.mean()) for r in first[:4]]})
            # 2 VAE decodes per microbatch of edits (the denoise and the refiner)
            ok = (images_ok and repeat_ok and differ and first[4].image is None
                  and again[4].image is None and len(new_finite) == 2 and all(new_finite)
                  and out["k1_launches"] == k1_expected
                  and out["k1_by_path"]["wgmma"] == out["k1_launches"]
                  and out["k2_launches"] == 0 and out["k3_launches"] == 0)
            if not ok:
                failures.append(f"serve diffusion: images ok {images_ok}, repeat identical "
                                f"{repeat_ok}, seeds differ {differ}, caption-only None "
                                f"{first[4].image is None}/{again[4].image is None}, decodes finite "
                                f"{new_finite}, K1 {out['k1_launches']} {out['k1_by_path']} (expected "
                                f"{k1_expected}, all wgmma), K2 {out['k2_launches']}, K3 "
                                f"{out['k3_launches']} (expected 0)")
            log(f"serve diffusion (4 edits + 1 caption-only through submit, batch {SERVE_BATCH}, "
                f"{EDIT_STEPS} + {EDIT_STEPS} steps, cfg 10, refiner {ref_steps} of 50): "
                f"{out['images_per_second']:.4f} images/s, latency "
                + ", ".join(f"{x:.3f}" for x in out["latency_seconds"]) + " s; "
                + ", ".join(f"{k} {v:.3f} s" for k, v in out["stage_seconds"].items())
                + f"; K1 launches {out['k1_launches']} {out['k1_by_path']} (expected {k1_expected}, "
                f"all wgmma), K2 {out['k2_launches']}, K3 {out['k3_launches']}; peak "
                f"{out['peak_gib']:.2f} GiB; single __call__ in this run {edit['call_seconds']:.3f} s "
                f"(peak {edit['call_peak_gib']:.2f} GiB); repeat identical {repeat_ok}, seeds differ "
                f"{differ}, caption-only None {first[4].image is None}")

            # ---- one ipa_lcm edit through __call__ on a seeded cache
            unet_calls = collections.Counter()
            apply = unet_lib.apply

            def counting(params, *a, **kw):
                unet_calls[id(params)] += 1
                return apply(params, *a, **kw)

            rs = np.random.RandomState(12)
            pipe.cache = (rs.randn(1, dd).astype(np.float32), rs.randn(dd).astype(np.float32),
                          " a cat in an antique shop", png,
                          dict(all_objs=[], extra_embeds=np.zeros((0, dd), np.float32), extra_idx=[]))
            reset()
            n_decoded = len(finite)
            unet_lib.apply = counting
            try:
                t0 = time.time()
                non_refined, refined, msg = pipe("Put <video> in the picture.", [image],
                                                 num_inference_steps=EDIT_STEPS, refinement=0.0,
                                                 seed=6, use_cache=True, diffusion_mode="ipa_lcm")
                torch.cuda.synchronize()
                lcm_s = time.time() - t0
            finally:
                unet_lib.apply = apply
                pipe.cache = None
            base_calls = unet_calls[id(pipe.models["unet"])]
            k1 = fa.flash_fwd_cuda.launches
            lcm_k1 = EDIT_STEPS * 2 * blocks("unet") + 4 * 3 * blocks("unet")
            lcm_finite = finite[n_decoded:]
            out.update({"lcm_seconds": lcm_s, "lcm_unet_calls": base_calls,
                        "lcm_k1_launches": k1, "lcm_k1_expected": lcm_k1,
                        "lcm_k1_by_path": dict(fa.flash_fwd_cuda.launches_by_path),
                        "lcm_k2_launches": Q.qmv_cuda.launches, "lcm_finite": lcm_finite})
            out.update({"lcm_" + k: v for k, v in no_k4(fa, failures, "ipa_lcm __call__").items()})
            if not (msg == "SUCCESS!" and refined.shape == (size, size, 3) and lcm_finite == [True]
                    and base_calls == EDIT_STEPS + 4 and k1 == lcm_k1
                    and out["lcm_k2_launches"] == 0):
                failures.append(f"ipa_lcm __call__: msg {msg!r}, image {refined.shape}, finite "
                                f"{lcm_finite}, UNet calls {base_calls} (expected {EDIT_STEPS} "
                                f"inversion + 4 LCM), K1 {k1} (expected {lcm_k1}), K2 "
                                f"{out['lcm_k2_launches']}")
            log(f"__call__ with diffusion_mode='ipa_lcm' ({EDIT_STEPS} inversion steps, 4 LCM steps, "
                f"no refiner): {lcm_s:.3f} s; {base_calls} UNet calls, K1 launches {k1} "
                f"{out['lcm_k1_by_path']} (expected {lcm_k1}), finite {lcm_finite}")

            # ---- serve.run on the written media: the LLM answers, an image or a caption
            reset()
            n_decoded = len(finite)
            t0 = time.time()
            caption, result = serve.run(pipe, "add [audio1] to [image1]",
                                        {"image1": png, "audio1": wav}, steps=EDIT_STEPS,
                                        refinement=0.5, seed=7)
            torch.cuda.synchronize()
            run_s = time.time() - t0
            gen = pipe.last_generate
            steps = decode_steps(gen)
            out.update({"run_seconds": run_s, "run_caption": str(caption)[:120],
                        "run_image": None if result is None else list(result.shape),
                        "run_k2_launches": Q.qmv_cuda.launches,
                        "run_k2_by_path": dict(Q.qmv_cuda.launches_by_path),
                        "run_k2_expected": per_step * steps,
                        "run_k1_launches": fa.flash_fwd_cuda.launches,
                        "run_k1_by_path": dict(fa.flash_fwd_cuda.launches_by_path)})
            out.update({"run_" + k: v for k, v in no_k4(fa, failures, "serve.run").items()})
            result_ok = result is None or (result.shape == (size, size, 3) and result.dtype == np.uint8
                                          and all(finite[n_decoded:]))
            if not (isinstance(caption, str) and result_ok and steps > 0
                    and out["run_k2_launches"] == per_step * steps
                    and out["run_k2_by_path"]["mma"] == out["run_k2_launches"]):
                failures.append(f"serve.run: caption {type(caption)}, image {out['run_image']}, "
                                f"K2 {out['run_k2_launches']} {out['run_k2_by_path']} (expected "
                                f"{per_step} x {steps}, all mma)")
            log(f"serve.run('add [audio1] to [image1]'): {run_s:.3f} s, caption "
                f"{str(caption)[:60]!r}, image {out['run_image']}; K2 {out['run_k2_launches']} "
                f"{out['run_k2_by_path']} ({steps} decode steps), K1 {out['run_k1_launches']}")
    finally:
        server.stop()
        pipe.stage_times = None
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
    import os
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.llm import multimodal as mm
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.train import launch
    from instructany2pix_tpu_torch.train.train_step import TrainConfig, make_train_step

    base_layers = mm.Any2PixLMConfig().llama.num_layers
    L = TRAIN_LAYERS
    # per step with remat: K1 once in the forward and once more when the
    # backward recomputes each checkpointed layer; K4 once per layer
    per_step = _launches(k1=2 * L, k4=L, k4_wgmma=L)
    train_cfg = TrainConfig(total_steps=TRAIN_STEPS)
    out = {"layers": L, "of_layers": base_layers, "batch": TRAIN_BATCH,
           "max_length": TRAIN_LEN, "steps": TRAIN_STEPS, "per_step_expected": per_step}
    with tempfile.TemporaryDirectory() as d:
        cfg, make_ds, first, params = _train_setup(d)
        lengths = first["attention_mask"].sum(1).tolist()
        out["row_lengths"] = lengths
        if max(lengths) != TRAIN_LEN or len(set(lengths)) != TRAIN_BATCH:
            failures.append(f"train: row lengths {lengths}, expected ragged with a {TRAIN_LEN} row")
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
        log(f"train ({L} of {base_layers} layers, {out['params'] / 1e9:.3f} B params, "
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


# ------------------------------------------------- slice 11: the edit's last switches

SPEC_DRAFT_LAYERS = 4  # llm_speculative_layers of the full-width check
SPEC_K = 4  # the window generate_speculative takes by default, as forward_llm does
TOKENIZER_PACKAGES = ("transformers", "sentencepiece", "tokenizers", "google.protobuf")
# mixed text that a legacy Llama tokenizer must give back exactly
TOKENIZER_CORPUS = (
    "the cat sat in the picture", "", " ", "  lead  spaces", "trailing   ", "line\n\nx\ttab",
    "café crème brûlée ñandú", "日本語のテキスト", "emoji 😀🎨 and ✨", "mixed 日本 😀 ñ text",
    "A chat between a curious user and an artificial intelligence assistant. USER: put the "
    "sound of the sea into the picture ASSISTANT: [a beach at dusk]",
)


def _pb_varint(n):
    """A protobuf varint (a negative int32 as its 64-bit two's complement)."""
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_field(num, wire, payload):
    key = _pb_varint(num << 3 | wire)
    return key + (_pb_varint(len(payload)) + payload if wire == 2 else payload)


def write_sentencepiece_model(path):
    """A small byte-fallback BPE `tokenizer.model` (SentencePiece's
    ModelProto) encoded here field by field: <unk> <s> </s>, the 256 byte
    pieces, a USER_DEFINED <sep>, then letters and a few merges scored by
    rank; BPE model type, byte fallback, Llama's special ids."""
    import struct

    learnt = list("▁etaoinshrdlcumwfgypbvkjxqz.,!?:[]") + [
        "▁t", "he", "▁the", "in", "▁a", "an", "er", "on", "▁c", "at", "▁cat", "▁s", "▁in", "re",
        "nd", "▁and", "ic", "▁p", "▁pic", "tu", "ture", "▁picture", "ea", "▁se", "▁sea"]
    pieces = ([("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
              + [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)] + [("<sep>", 0.0, 4)]
              + [(p, -float(i), 1) for i, p in enumerate(learnt)])
    body = b"".join(_pb_field(1, 2, _pb_field(1, 2, p.encode()) + _pb_field(2, 5, struct.pack("<f", sc))
                                 + _pb_field(3, 0, _pb_varint(t))) for p, sc, t in pieces)
    trainer = b"".join(_pb_field(n, 0, _pb_varint(v))
                       for n, v in ((3, 2), (35, 1), (40, 0), (41, 1), (42, 2), (43, -1)))
    normalizer = (_pb_field(1, 2, b"identity") + _pb_field(3, 0, _pb_varint(1))
                  + _pb_field(4, 0, _pb_varint(0)))
    with open(path, "wb") as f:
        f.write(body + _pb_field(2, 2, trainer) + _pb_field(3, 2, normalizer))
    return len(pieces)


def phase_tokenizer_model(failures):
    """`load_tokenizer` on a directory that holds SentencePiece's
    `tokenizer.model` and no `tokenizer.json`: the mixed corpus must come
    back from encode and decode, each generation token must be one id, and
    none of transformers, sentencepiece, tokenizers or protobuf may be
    loaded afterwards."""
    import json as _json
    import os
    import tempfile

    from instructany2pix_tpu_torch.llm import tokenizer as tok_lib

    before = [m for m in TOKENIZER_PACKAGES if m in sys.modules]
    with tempfile.TemporaryDirectory() as d:
        n_pieces = write_sentencepiece_model(os.path.join(d, "tokenizer.model"))
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            _json.dump({"tokenizer_class": "LlamaTokenizer", "add_bos_token": True}, f)
        t0 = time.perf_counter()
        tok = tok_lib.load_tokenizer(d)
        load_s = time.perf_counter() - t0
    gen_ids = tok_lib.initialize_vision_tokenizer(tok)
    bad = [text for text in TOKENIZER_CORPUS
           if tok.decode(tok.encode(text, add_special_tokens=False)) != text]
    single = all(tok.encode(t, add_special_tokens=False) == [i] and tok.decode([i]) == t
                 for t, i in gen_ids.items())
    bos = tok.encode("the cat")[0] == tok.bos_token_id == 1
    after = [m for m in TOKENIZER_PACKAGES if m in sys.modules]
    out = {"pieces": n_pieces, "load_seconds": load_s, "merges": len(tok._merges),
           "not_round_tripped": bad, "generation_tokens_single": single, "bos_first": bos,
           "packages_before": before, "packages_after": after,
           "kind": type(tok).__name__}
    if bad or not single or not bos or after or out["kind"] != "JsonTokenizer":
        failures.append(f"tokenizer.model boot: {out}")
    log(f"tokenizer.model boot ({n_pieces} pieces, {out['merges']} merges, no tokenizer.json): "
        f"{out['kind']} in {load_s * 1e3:.1f} ms; {len(TOKENIZER_CORPUS) - len(bad)} of "
        f"{len(TOKENIZER_CORPUS)} texts round-trip, generation tokens single ids {single}, BOS "
        f"first {bos}; loaded afterwards of {list(TOKENIZER_PACKAGES)}: {after or 'none'}")
    return out


def _full_logits(llama_lib, s, run):
    """{output index: logits row (CPU float32)} of every full-model forward
    over a cache that `run` makes: the prefill's last row predicts token 0;
    a forward at cache length c predicts tokens c - s + 1 onwards. A later
    forward over an index replaces an earlier one (the round that emitted
    it)."""
    got = {}
    orig = llama_lib.forward

    def rec(*a, **kw):
        o = orig(*a, **kw)
        c = kw.get("cache")
        if kw.get("layers") is None and c is not None:
            lg = o["logits"][0].float().cpu()
            if c.length == 0:
                got[0] = lg[-1]
            else:
                for r in range(lg.shape[0]):
                    got[c.length - s + r + 1] = lg[r]
        return o

    llama_lib.forward = rec
    try:
        run()
    finally:
        llama_lib.forward = orig
    return got


def phase_switches(pipe, failures, finite):
    """The edit's last switches at full width, on phase 4's pipeline, each
    with the launch counts set to 0 just before and read just after:
    `forward_llm` with `llm_speculative_layers` beside plain greedy decode on
    the same spliced prompt (tokens identical, or diverging only where the
    plain run's top-2 logit margin is below the two runs' largest logit
    difference at that step; K2 exactly rounds x ((k - 1) 4 L + 4 x 32),
    split by M); one verify forward profiled; `__call__(debug=True)` on the
    seeded LLM cache against the same `__call__` without debug (bit-identical
    images; attention maps finite, (n_ip, 1024, 1024), summing to 1); the
    prior's DDPM path (25 steps); the CLIP ViT-H/14 image encoder (batch 2,
    bf16, random weights: 32 K1 launches, all wgmma, image_embeds within
    K1's limit of the same tower on plain attention)."""
    import collections
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.diffusion import ip_adapter as ipa
    from instructany2pix_tpu_torch.llm import generate as gen_lib
    from instructany2pix_tpu_torch.llm import speculative as spec_lib
    from instructany2pix_tpu_torch.models import clip as clip_lib
    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.models import llama as llama_lib
    from instructany2pix_tpu_torch.models import unet as unet_lib
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.prior import model as prior_lib

    cfg = pipe.cfg
    lm, lcfg = pipe.models["llm"].llama, cfg.llm.llama
    per_step = 4 * lcfg.num_layers
    out = {"card": card_line()}

    def reset():
        reset_k1(fa)
        reset_k3(fa)
        Q.reset_qmv_counts()
        reset_k4(fa)

    def counts(prefix):
        c = {f"{prefix}k1_launches": fa.flash_fwd_cuda.launches,
             f"{prefix}k1_by_path": dict(fa.flash_fwd_cuda.launches_by_path),
             f"{prefix}k2_launches": Q.qmv_cuda.launches,
             f"{prefix}k2_by_path": dict(Q.qmv_cuda.launches_by_path),
             f"{prefix}k3_launches": fa.flash_relpos2d_cuda.launches}
        c.update({prefix + k: v for k, v in no_k4(fa, failures, prefix.strip("_")).items()})
        return c

    def blocks(name):
        return sum(isinstance(m, unet_lib.TBlock) for m in pipe.models[name].modules())

    rows = collections.Counter()
    orig_qmatmul = Q.qmatmul

    def recording(x, q, *a, **kw):
        rows[x.numel() // x.shape[-1]] += 1
        return orig_qmatmul(x, q, *a, **kw)

    with tempfile.TemporaryDirectory() as d:
        png, wav = _write_media(d)
        media = [{"type": "image", "fname": png}, {"type": "audio", "fname": wav}]
        inst = "Put the sound of <video> into the picture <video> and draw it."

        # ---- speculative forward_llm
        pipe.cfg = dataclasses.replace(cfg, llm_speculative_layers=SPEC_DRAFT_LAYERS)
        pipe.cache, pipe.stage_times = None, {}
        reset()
        rows.clear()
        Q.qmatmul = recording
        try:
            t0 = time.time()
            res = pipe.forward_llm(inst, media)
            torch.cuda.synchronize()
            out["spec_forward_llm_seconds"] = time.time() - t0
        finally:
            Q.qmatmul = orig_qmatmul
            pipe.cfg, pipe.cache = cfg, None
        out.update(counts("spec_"))
        spec, rounds = pipe.last_generate, list(pipe.last_rounds)
        out["spec_stage_seconds"], pipe.stage_times = dict(pipe.stage_times), None
        n_spec = min(int(spec.done_at[0]) + 1, spec.tokens.shape[1])
        m1 = len(rounds) * (SPEC_K - 1) * 4 * SPEC_DRAFT_LAYERS
        mk = len(rounds) * per_step
        out.update({"spec_rounds": len(rounds), "spec_tokens_per_round": rounds,
                    "spec_mean_accepted_drafts": (sum(rounds) / len(rounds) - 1) if rounds else None,
                    "spec_tokens": n_spec, "spec_k2_rows": dict(rows),
                    "spec_k2_expected": m1 + mk, "spec_k2_rows_expected": {1: m1, SPEC_K: mk},
                    "spec_k1_expected": cfg.imagebind_vision.layers + cfg.imagebind_audio.layers})
        ok = (out["spec_k2_launches"] == m1 + mk and out["spec_k2_by_path"]["mma"] == m1 + mk
              and out["spec_k2_rows"] == {k: v for k, v in {1: m1, SPEC_K: mk}.items() if v}
              and out["spec_k1_launches"] == out["spec_k1_expected"]
              and out["spec_k1_by_path"]["wgmma"] == out["spec_k1_launches"]
              and out["spec_k3_launches"] == 0 and sum(rounds) == n_spec - 1 and len(rounds) > 0
              and isinstance(res, tuple) and len(res) == 5)
        if not ok:
            failures.append(
                f"speculative forward_llm: K2 {out['spec_k2_launches']} {out['spec_k2_by_path']} "
                f"at M {out['spec_k2_rows']} (expected {len(rounds)} rounds x "
                f"({SPEC_K - 1} x 4 x {SPEC_DRAFT_LAYERS} + {per_step}) = {m1 + mk}, all mma, "
                f"{{1: {m1}, {SPEC_K}: {mk}}}), K1 {out['spec_k1_launches']} (expected "
                f"{out['spec_k1_expected']}, all wgmma), K3 {out['spec_k3_launches']}, rounds "
                f"emitted {sum(rounds)} of {n_spec - 1}")

        # ---- plain greedy decode on the same spliced prompt
        with torch.inference_mode():
            aux = pipe.embed_mm_data(media)
            _, emb = pipe._prepare_llm_inputs(inst, aux)
        eos = pipe.tokenizer.eos_token_id
        s = emb.shape[1]

        def greedy():
            return gen_lib.generate(lm, lcfg, emb, None, max_new_tokens=100, temperature=0.0,
                                    eos_id=eos, dynamic_stop=True)

        reset()
        torch.cuda.synchronize()
        t0 = time.time()
        plain = greedy()
        torch.cuda.synchronize()
        out["greedy_seconds"] = time.time() - t0
        out.update(counts("greedy_"))
        n_plain = min(int(plain.done_at[0]) + 1, plain.tokens.shape[1])
        steps = min(int(plain.done_at[0]), plain.tokens.shape[1] - 1)
        out["greedy_k2_expected"] = per_step * steps
        if (out["greedy_k2_launches"] != per_step * steps or out["greedy_k1_launches"] != 0
                or out["greedy_k2_by_path"]["mma"] != out["greedy_k2_launches"]):
            failures.append(f"plain greedy decode: K2 {out['greedy_k2_launches']} "
                            f"{out['greedy_k2_by_path']} (expected {per_step} x {steps}, all mma), "
                            f"K1 {out['greedy_k1_launches']} (expected 0)")
        a, b = spec.tokens[0, :n_spec].tolist(), plain.tokens[0, :n_plain].tolist()
        identical = a == b
        out.update({"spec_tokens_identical": identical,
                    "spec_tokens_per_s": n_spec / out["spec_stage_seconds"]["llm_generate"],
                    "greedy_tokens_per_s": n_plain / out["greedy_seconds"]})
        msg = (f"speculative forward_llm (draft {SPEC_DRAFT_LAYERS} of {lcfg.num_layers} layers, "
               f"k {SPEC_K}): {out['spec_forward_llm_seconds']:.3f} s, {len(rounds)} rounds for "
               f"{n_spec} tokens, mean accepted drafts {out['spec_mean_accepted_drafts']:.3f}, "
               f"{out['spec_tokens_per_s']:.1f} tokens/s against plain greedy "
               f"{out['greedy_tokens_per_s']:.1f} tokens/s ({n_plain} tokens, "
               f"{out['greedy_seconds']:.3f} s); K2 {out['spec_k2_launches']} at M "
               f"{out['spec_k2_rows']} (expected {{1: {m1}, {SPEC_K}: {mk}}}), greedy K2 "
               f"{out['greedy_k2_launches']} (expected {per_step * steps}); tokens identical "
               f"{identical}")
        if not identical:
            i = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]), min(len(a), len(b)))
            sl = _full_logits(llama_lib, s, lambda: spec_lib.generate_speculative(
                lm, lcfg, emb, max_new_tokens=100, eos_id=eos, draft_layers=SPEC_DRAFT_LAYERS,
                k_draft=SPEC_K))
            pl = _full_logits(llama_lib, s, greedy)
            top2 = pl[i].topk(2).values
            margin = (top2[0] - top2[1]).item()
            diff = (pl[i] - sl[i]).abs().max().item()
            out["spec_divergence"] = {"index": i, "plain_top2_margin": margin,
                                      "max_logit_difference": diff, "rounding_tie": margin < diff}
            msg += (f"; first divergence at token {i}: plain top-2 margin {margin:.6g}, largest "
                    f"logit difference between the runs {diff:.6g}")
            if not margin < diff:
                failures.append(f"speculative tokens diverge from plain greedy at {i}, not at a "
                                f"rounding tie: margin {margin:.6g} >= difference {diff:.6g}")
        log(msg)

        # ---- one verify (M = k) and one draft step, timed and profiled
        with torch.inference_mode():
            cache = llama_lib.KVCache.create(lcfg, 1, max_len=s + 100 + SPEC_K, dtype=emb.dtype,
                                             device="cuda")
            cache = llama_lib.forward(lm, lcfg, inputs_embeds=emb, cache=cache)["cache"]
            win = llama_lib.embed(lm, plain.tokens[:, :SPEC_K])
            dcache = llama_lib.KVCache(cache.k[:SPEC_DRAFT_LAYERS], cache.v[:SPEC_DRAFT_LAYERS],
                                       cache.length)

            def verify():
                llama_lib.forward(lm, lcfg, inputs_embeds=win, cache=cache)

            def draft():
                llama_lib.forward(lm, lcfg, inputs_embeds=win[:, :1], cache=dcache,
                                  layers=SPEC_DRAFT_LAYERS)

            verify()
            vt = sorted(time_ms(verify, 1, warmup=0) for _ in range(11))
            dt = sorted(time_ms(draft, 1, warmup=1) for _ in range(11))
            prof = profile_window(verify, f"speculative verify (M = {SPEC_K})", n=3)
        out.update({"verify_ms_median": vt[5], "draft_step_ms_median": dt[5],
                    "verify_profile": prof})
        if prof is not None:
            out["verify_k2_ms"] = prof["by_class"].get("k2", 0.0)
        log(f"speculative verify at M = {SPEC_K}: median {vt[5]:.3f} ms of 11 (draft step over "
            f"{SPEC_DRAFT_LAYERS} layers {dt[5]:.3f} ms)"
            + (f"; K2 kernels {out['verify_k2_ms']:.3f} ms" if prof is not None else ""))

        # ---- __call__(debug=True) against the same call without debug
        rs = np.random.RandomState(7)
        d_img = cfg.llm.image_codec_dim
        seeded = (rs.randn(1, d_img).astype(np.float32), rs.randn(d_img).astype(np.float32),
                  " a cat in an antique shop", png,
                  dict(all_objs=[], extra_embeds=np.zeros((0, d_img), np.float32), extra_idx=[]))
        ref_steps = int(50 * 0.5)
        call_k1 = (EDIT_STEPS * 2 * blocks("unet") + EDIT_STEPS * 3 * blocks("unet")
                   + ref_steps * 2 * blocks("refiner"))
        tap_k1 = 2 * blocks("unet")  # the tap's forward: self and text cross; IP is plain
        images = {}
        n_decoded = len(finite)
        for debug in (True, False):
            pipe.cache, pipe.stage_times = seeded, {}
            reset()
            torch.cuda.synchronize()
            t0 = time.time()
            images[debug] = pipe(inst, media, num_inference_steps=EDIT_STEPS, refinement=0.5,
                                 seed=1, use_cache=True, debug=debug)
            torch.cuda.synchronize()
            key = "debug_" if debug else "nodebug_"
            out[key + "call_seconds"] = time.time() - t0
            out[key + "stage_seconds"] = dict(pipe.stage_times)
            out.update(counts(key))
        pipe.cache, pipe.stage_times = None, None
        msg_d = images[True][2]
        same = all(np.array_equal(images[True][j], images[False][j]) for j in (0, 1))
        maps = msg_d.get("attn_maps") if isinstance(msg_d, dict) else None
        n_ip = cfg.image_proj.num_tokens
        want_keys = {"attn_maps", "output_caption", "latent_inv", "img_base", "latent_la",
                     "base_embed", "annotations", "subjec_data", "y"}
        maps_ok = (maps is not None and tuple(maps.shape) == (n_ip, cfg.image_size, cfg.image_size)
                   and bool(torch.isfinite(maps).all()))
        sum_err = (maps.sum(0) - 1).abs().max().item() if maps_ok else float("inf")
        out.update({"debug_images_identical": same, "debug_keys": sorted(msg_d) if isinstance(msg_d, dict) else None,
                    "attn_maps_shape": list(maps.shape) if maps is not None else None,
                    "attn_maps_sum_err": sum_err, "debug_tap_seconds":
                    out["debug_stage_seconds"].get("debug_tap"),
                    "debug_k1_expected": call_k1 + tap_k1, "nodebug_k1_expected": call_k1})
        all_finite = len(finite) - n_decoded == 4 and all(finite[n_decoded:])
        if not (same and maps_ok and sum_err <= 1e-5 and set(msg_d) == want_keys and all_finite
                and out["debug_k1_launches"] == call_k1 + tap_k1
                and out["nodebug_k1_launches"] == call_k1
                and out["debug_k1_by_path"]["wgmma"] == out["debug_k1_launches"]
                and out["debug_k2_launches"] == out["debug_k3_launches"] == 0):
            failures.append(f"__call__(debug=True): images identical to debug=False {same}, maps "
                            f"{out['attn_maps_shape']} finite {maps_ok} sum error {sum_err:.3g}, "
                            f"keys {out['debug_keys']}, finite images {all_finite}, K1 "
                            f"{out['debug_k1_launches']} / {out['nodebug_k1_launches']} (expected "
                            f"{call_k1 + tap_k1} / {call_k1}), K2 {out['debug_k2_launches']}, K3 "
                            f"{out['debug_k3_launches']}")
        log(f"__call__(debug=True) ({EDIT_STEPS} + {EDIT_STEPS} steps, refiner {ref_steps}): "
            f"{out['debug_call_seconds']:.3f} s against {out['nodebug_call_seconds']:.3f} s "
            f"without; the tap's forward and maps {out['debug_tap_seconds']:.3f} s; images "
            f"bit-identical {same}; attn_maps {out['attn_maps_shape']}, finite {maps_ok}, sum over "
            f"the IP tokens within {sum_err:.3g} of 1; K1 {out['debug_k1_launches']} (expected "
            f"{call_k1} + {tap_k1} for the tap) [{out['card']}]")

    # ---- the prior's DDPM path at full width
    with torch.inference_mode():
        th, tm = pipe._encode_prior_text("")
        src = torch.randn((1, cfg.prior.imagebind_dim), generator=torch.Generator("cuda").manual_seed(5),
                          device="cuda")
        src = src / src.norm() * 100.0
        reset()
        torch.cuda.synchronize()
        t0 = time.time()
        y = prior_lib.generate_diffusion(
            pipe.models["prior"], cfg.prior, prior_lib.MODALITY.VIDEO, prior_lib.MODALITY.IMAGE, src,
            th, tm, num_inference_steps=25, guidance_scale=10.0, score=6.5,
            generator=torch.Generator("cuda").manual_seed(6))
        torch.cuda.synchronize()
        out["prior_ddpm_seconds"] = time.time() - t0
        out.update(counts("prior_ddpm_"))
    want = (1, cfg.prior.sequence_gen_length, cfg.prior.output_dim)
    ok = (tuple(y.shape) == want and bool(torch.isfinite(y).all())
          and out["prior_ddpm_k1_launches"] == out["prior_ddpm_k2_launches"] == 0)
    out["prior_ddpm_shape"] = list(y.shape)
    if not ok:
        failures.append(f"prior DDPM path: shape {list(y.shape)} (expected {list(want)}), finite "
                        f"{bool(torch.isfinite(y).all())}, K1 {out['prior_ddpm_k1_launches']}, K2 "
                        f"{out['prior_ddpm_k2_launches']} (both expected 0)")
    log(f"prior DDPM path (25 steps, GPT-2 medium, CFG batch 2): {out['prior_ddpm_seconds']:.3f} s, "
        f"shape {list(y.shape)}, finite {bool(torch.isfinite(y).all())}")

    # ---- the CLIP ViT-H/14 image encoder, random bf16 weights
    vcfg = clip_lib.CLIPVisionConfig.vit_h()
    with torch.device("meta"):
        vision = clip_lib.CLIPVision(vcfg)
    vision = L.init_(L.materialize(vision, torch.device("cuda"), torch.bfloat16),
                     torch.Generator("cuda").manual_seed(11)).eval().requires_grad_(False)
    rs = np.random.RandomState(12)
    imgs = [rs.randint(0, 256, (300, 400, 3)).astype(np.uint8),
            rs.randint(0, 256, (512, 384, 3)).astype(np.uint8)]
    with torch.inference_mode():
        t0 = time.perf_counter()
        pixels = ipa.preprocess_clip_image(imgs, vcfg.image_size)
        out["clip_preprocess_ms"] = (time.perf_counter() - t0) * 1e3
        ipa.encode_clip_image(vision, vcfg, imgs)  # warm
        reset()
        emb_k1 = ipa.encode_clip_image(vision, vcfg, imgs)
        torch.cuda.synchronize()
        out.update(counts("clip_"))
        plain_e = clip_lib.vision_apply(vision, pixels, vcfg, impl="xla")["image_embeds"].float()
        # K1's limit carried through the tower: the plain attention again,
        # each call's output moved by its whole per-element limit (TOL, as
        # k1_reference) in a seeded random sign pattern; K1's deviation from
        # the plain tower must stay within the deviation this gives
        moved_e = _with_limit_moves(clip_lib, lambda: clip_lib.vision_apply(
            vision, pixels, vcfg, impl="xla")["image_embeds"].float())
        got = emb_k1.float()
        allowed = (moved_e - plain_e).abs().max().item()
        of_limit = (got - plain_e).abs().max().item() / allowed
        # the same ratio in root mean square, less bound to bf16 steps of the output
        of_limit_rms = ((got - plain_e).square().mean() / (moved_e - plain_e).square().mean()).sqrt().item()
        out["clip_encode_ms"] = time_ms(lambda: clip_lib.vision_apply(vision, pixels, vcfg), 5)
        out["clip_encode_plain_ms"] = time_ms(
            lambda: clip_lib.vision_apply(vision, pixels, vcfg, impl="xla"), 5)
    out.update({"clip_weights_gib": _weight_bytes(vision) / 2**30, "clip_embeds_shape": list(got.shape),
                "clip_max_abs_err": (got - plain_e).abs().max().item(), "clip_of_limit": of_limit,
                "clip_limit_carried": allowed, "clip_of_limit_rms": of_limit_rms,
                "clip_k1_expected": vcfg.num_layers})
    del vision
    torch.cuda.empty_cache()
    ok = (out["clip_k1_launches"] == vcfg.num_layers
          and out["clip_k1_by_path"]["wgmma"] == vcfg.num_layers and of_limit <= 1.0
          and bool(torch.isfinite(got).all()) and list(got.shape) == [2, vcfg.projection_dim]
          and out["clip_k2_launches"] == out["clip_k3_launches"] == 0)
    if not ok:
        failures.append(f"CLIP ViT-H/14 encoder: K1 {out['clip_k1_launches']} "
                        f"{out['clip_k1_by_path']} (expected {vcfg.num_layers}, all wgmma), "
                        f"image_embeds {list(got.shape)} at {of_limit:.3g} of K1's limit against "
                        f"the plain attention")
    log(f"CLIP ViT-H/14 image encoder (batch 2 at 224, bf16, {out['clip_weights_gib']:.2f} GiB): "
        f"{out['clip_encode_ms']:.2f} ms per encode ({out['clip_encode_plain_ms']:.2f} ms on the "
        f"plain attention; preprocessing {out['clip_preprocess_ms']:.1f} ms on the host), K1 "
        f"{out['clip_k1_launches']} {out['clip_k1_by_path']} (expected {vcfg.num_layers}, all "
        f"wgmma), image_embeds max |diff| {out['clip_max_abs_err']:.3g} against the plain "
        f"attention = {of_limit:.3f} of K1's limit carried through the tower "
        f"({allowed:.3g}: each attention moved by 2^-7 |o| + 2^-5 sigma; in RMS "
        f"{of_limit_rms:.3f}) [{out['card']}]")
    return out


def _with_limit_moves(module, run, seed=13):
    """`run()` with `module.dot_product_attention` on the plain path and
    each output element moved by K1's whole limit for that call (TOL's
    bf16 rtol |o| + stol sigma, sigma as `k1_reference` computes it), the
    signs drawn from a seeded generator."""
    import torch

    orig = module.dot_product_attention
    gen = torch.Generator("cuda").manual_seed(seed)
    tol = TOL["bfloat16"]

    def moved(q, k, v, *, causal=False, mask=None, impl="auto", **kw):
        o = orig(q, k, v, causal=causal, mask=mask, impl="xla", **kw)
        qt, kt, vt = (x.transpose(1, 2).float() for x in (q, k, v))
        p = torch.softmax(torch.matmul(qt, kt.transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1)
        sigma = torch.matmul(p.square(), vt.square()).sqrt().transpose(1, 2)
        lim = tol["rtol"] * o.float().abs() + tol["stol"] * sigma
        sign = torch.randint(0, 2, o.shape, generator=gen, device=o.device) * 2 - 1
        return (o.float() + sign * lim).to(o.dtype)

    module.dot_product_attention = moved
    try:
        return run()
    finally:
        module.dot_product_attention = orig



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


def _tiny_server(cpu, gpu, png, h, failures, levels):
    """The tiny batched server on the card against the CPU port's, the same
    injected numpy draws on both: the real LLM stage on two prompts of
    different lengths (Gumbel draws injected) with identical tokens, then a
    batch of 3 with one caption-only row (the LLM stage stubbed, the VAE,
    polar and refiner draws injected) within 1 uint8 level, and a row of it
    within 1 level of the single-request `__call__` on the card."""
    import numpy as np
    import torch

    from instructany2pix_tpu_torch import serving
    from instructany2pix_tpu_torch.ops import quant as Q

    cfg = cpu.cfg
    out = {}
    servers = [serving.PipelineServer(p, max_batch=3, max_new_tokens=16) for p in (cpu, gpu)]
    try:
        insts = ["describe a cat", "describe a small antique shop full of ticking clocks, brass "
                                   "lamps and old maps, at dusk, in a few words"]
        g = np.random.RandomState(40).gumbel(size=(2, 16, cfg.llm.llama.vocab_size)).astype(np.float32)
        lreqs = [serving.PipelineRequest(x, [], seed=i, llm_gumbel=g[i]) for i, x in enumerate(insts)]
        Q.reset_qmv_counts()
        captions = [[o[2] for o in srv._llm_stage(lreqs)] for srv in servers]
        gc, gg = servers[0].last_generate, servers[1].last_generate
        same = bool(torch.equal(gc.tokens, gg.tokens.cpu()) and torch.equal(gc.done_at, gg.done_at.cpu()))
        out.update({"llm_tokens_identical": same, "llm_captions_identical": captions[0] == captions[1],
                    "llm_k2_by_path": dict(Q.qmv_cuda.launches_by_path)})
        if not (same and captions[0] == captions[1] and Q.qmv_cuda.launches > 0):
            failures.append(f"tiny server LLM stage: tokens identical {same}, captions "
                            f"{captions[0]} vs {captions[1]}, K2 {out['llm_k2_by_path']}")

        dd = cfg.llm.image_codec_dim

        def stub(batch):
            outs = []
            for r in batch:
                if not r.mm_data:
                    outs.append((None, None, " a caption only", None, None))
                    continue
                rk = np.random.RandomState(r.seed)
                outs.append((rk.randn(1, dd).astype(np.float32), rk.randn(dd).astype(np.float32),
                             f" a tiny scene {r.seed}", r.mm_data[0]["fname"],
                             dict(all_objs=[], extra_embeds=np.zeros((0, dd)), extra_idx=[])))
            return outs

        names = ("vae_noise", "polar_noise", "refiner_vae_noise", "refiner_noise")
        draws = {s: {k: np.random.RandomState(60 + 4 * s + i).randn(h, h, 4).astype(np.float32)
                     for i, k in enumerate(names)} for s in (1, 2)}
        reqs = [serving.PipelineRequest("edit <video>", [{"type": "image", "fname": png}],
                                        num_inference_steps=3, refinement=0.5, seed=s, **draws[s])
                for s in (1, 2)]
        reqs.insert(1, serving.PipelineRequest("describe", [], num_inference_steps=3,
                                               refinement=0.5, seed=3))
        results = []
        for srv in servers:
            srv._llm_stage = stub
            results.append(srv._run_batch(reqs))
        out["caption_only_none"] = results[0][1].image is None and results[1][1].image is None
        if not out["caption_only_none"]:
            failures.append("tiny server: the caption-only row returned an image")
        out["max_levels"] = [levels(results[0][i].image, results[1][i].image, f"server row {i}")
                             for i in (0, 2)]
        gpu.cache = stub([reqs[0]])[0]
        _, single, _ = gpu("edit <video>", reqs[0].mm_data, num_inference_steps=3, refinement=0.5,
                           seed=0, use_cache=True, **{k: v[None] for k, v in draws[1].items()})
        gpu.cache = None
        out["vs_call_max_levels"] = levels(results[1][0].image, single,
                                           "server row 0 vs __call__ on the card")
    finally:
        for srv in servers:
            srv.stop()
    return out


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
    from instructany2pix_tpu_torch.llm import speculative as spec_lib
    from instructany2pix_tpu_torch.models import llama as llama_lib
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.pipeline import InstructAny2PixPipeline
    from instructany2pix_tpu_torch.prior import model as prior_lib

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
        out["server"] = _tiny_server(cpu, gpu, png, h, failures, levels)

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

        # speculative greedy decode (draft 1 of 2 layers, window 4) on both devices
        sk = dict(max_new_tokens=16, eos_id=-1, draft_layers=1, k_draft=SPEC_K)
        sc = spec_lib.generate_speculative(cpu.models["llm"].llama, lcfg, emb_c, **sk).tokens[0]
        sg = spec_lib.generate_speculative(gpu.models["llm"].llama, lcfg, emb_c.cuda(),
                                           **sk).tokens[0].cpu()
        out["speculative_tokens_identical"] = bool(torch.equal(sc, sg))
        if not out["speculative_tokens_identical"]:
            failures.append(f"tiny speculative decode: card tokens {sg.tolist()} != CPU "
                            f"{sc.tolist()}")

        # the prior's DDPM path, the same injected draws on both devices
        pc = cfg.prior
        rs = np.random.RandomState(40)
        shape = (1, pc.sequence_gen_length, pc.embed_dim)
        src, th = rs.randn(1, pc.imagebind_dim), rs.randn(1, pc.text_len, pc.text_dim)
        tm = (np.arange(pc.text_len) < 4).astype(np.float32)[None]
        lat0 = rs.randn(*shape)
        noise = [rs.randn(*shape) for _ in range(25)]
        ys = []
        for p, dev in ((cpu, "cpu"), (gpu, "cuda")):
            def f32(x):
                return torch.as_tensor(np.asarray(x, np.float32), device=dev)

            ys.append(prior_lib.generate_diffusion(
                p.models["prior"], pc, prior_lib.MODALITY.VIDEO, prior_lib.MODALITY.IMAGE, f32(src),
                f32(th), f32(tm), num_inference_steps=25, latents=f32(lat0),
                noise=[f32(n) for n in noise]).cpu())
        rel_p = ((ys[1] - ys[0]).abs().max() / ys[0].abs().max()).item()
        out["prior_ddpm_rel"] = rel_p
        if not rel_p <= 1e-5:
            failures.append(f"tiny prior DDPM path: card vs CPU {rel_p:.3g} of the largest (limit 1e-5)")
        log(f"tiny fp32 speculative decode (draft 1 of 2 layers, k {SPEC_K}, 16 tokens): card "
            f"tokens identical to the CPU's {out['speculative_tokens_identical']}; tiny prior DDPM "
            f"path (25 steps, injected draws): card vs CPU max rel diff {rel_p:.3g}")
    return out


# ------------------------------------------------------------------ slice 12

PNP_STEPS, PNP_INJECTION = 10, 0.8  # plug-and-play at full width
ADAPTER_STEPS = 10  # CFG denoise steps of the Plus and FaceID paths
FACEID_RANK = 128  # the reference's LoRA rank on every attention
LORA_RANK, LORA_ALPHA, LORA_LR, LORA_TRAIN_STEPS = 8, 16.0, 2e-4, 3
LORA_DECODE_TOKENS = 32  # greedy tokens of the LoRA-booted 7B
PRIOR_TRAIN_STEPS, PRIOR_TRAIN_BATCH = 5, 8
TINY_REL = 1e-5  # card against CPU in float32, relative to the largest element
PNP_K1_SHAPES = [(3, 10, 4096, 64), (3, 20, 1024, 64)]  # the shared-Q/K self-attentions at 1024^2


def reset_all(fa, Q):
    reset_k1(fa)
    reset_k3(fa)
    Q.reset_qmv_counts()
    reset_k4(fa)


def path_counts(fa, Q):
    """Every launch counter, read after a path that followed `reset_all`."""
    return {"k1": fa.flash_fwd_cuda.launches,
            "k1_by_path": dict(fa.flash_fwd_cuda.launches_by_path),
            "k1_broadcast": fa.flash_fwd_cuda.launches_broadcast,
            "k2": Q.qmv_cuda.launches, "k2_by_path": dict(Q.qmv_cuda.launches_by_path),
            "k2_unfused": Q.qmv_cuda.launches_unfused,
            "k3": fa.flash_relpos2d_cuda.launches,
            "k4": fa.flash_bwd_cuda.launches, "k4_by_path": dict(fa.flash_bwd_cuda.launches_by_path),
            "k4a": fa.flash_bwd_dq_cuda.launches, "k4b": fa.flash_bwd_dkv_cuda.launches}


def counted(name, fn, expect, failures):
    """fn() with every launch counter set to 0 just before and read just
    after; each must equal `expect` (a count or a by-path dict; 0 where not
    given). Returns (fn's result, the counts, host seconds with a sync)."""
    import torch

    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q

    torch.cuda.synchronize()
    reset_all(fa, Q)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = path_counts(fa, Q)
    want = {k: ({**dict.fromkeys(v, 0), **expect.get(k, {})} if isinstance(v, dict)
                else expect.get(k, 0)) for k, v in got.items()}
    if got != want:
        failures.append(f"{name}: launches {got} (expected {want})")
    nz = {k: v for k, v in got.items() if (any(v.values()) if isinstance(v, dict) else v)}
    log(f"{name}: {dt:.3f} s, launches {nz} (each as expected: {got == want})")
    return res, got, dt


def _rel(a, b):
    """max |a - b| / max |b| over float32 copies on the CPU."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _k1_broadcast_rows(failures, timed=True):
    """K1 on pnp's operands (q and k broadcast from batch row 0 with a zero
    stride, v dense) against its plain version on the same views, at the
    shared self-attentions' shapes, on the wgmma path; timed beside K1 on a
    dense copy of the same values and SDPA."""
    import torch
    import torch.nn.functional as F

    from instructany2pix_tpu_torch.ops import flash_attention as fa

    rows = []
    for i, (b, h, s, d) in enumerate(PNP_K1_SHAPES):
        g = torch.Generator("cuda").manual_seed(600 + i)
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=g, dtype=torch.bfloat16)
                   for _ in range(3))
        qb, kb = q[:1].expand_as(q).transpose(1, 2), k[:1].expand_as(k).transpose(1, 2)
        vt = v.transpose(1, 2)
        scale = d ** -0.5
        ref = k1_reference(fa, qb, kb, vt, False, scale)
        (o, lse), paths = k1_paths_of(fa, lambda: fa.flash_fwd_cuda(qb, kb, vt, False, scale,
                                                                     return_lse=True))
        r = k1_reading(o, lse, ref)
        qd, kd = qb.contiguous(), kb.contiguous()
        same = bool(torch.equal(o, fa.flash_fwd_cuda(qd, kd, vt, False, scale)))
        row = {"shape": [b, h, s, d], "paths": paths, "dense_output": o.is_contiguous()
               or o.transpose(1, 2).is_contiguous(), "equal_to_dense_copy": same, **r}
        bound_ms, bound_by, _ = k1_bound((b, h, s, d), s, False, "bfloat16")
        row.update(bound_ms=bound_ms, bound_by=bound_by)
        if timed:
            row["ms"] = time_ms(lambda: fa.flash_fwd_cuda(qb, kb, vt, False, scale), 20)
            row["ms_dense_copy"] = time_ms(lambda: fa.flash_fwd_cuda(
                qb.contiguous(), kb.contiguous(), vt, False, scale), 20)
            row["copy_ms"] = time_ms(lambda: (qb.contiguous(), kb.contiguous()), 20)
            row["plain_ms"] = time_ms(lambda: fa._reference_attention(qb, kb, vt, False, scale), 3)
            row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                qb, kb, vt, scale=scale), 20)
        ok = r["ok"] and paths == {"wgmma": 1} and same and row["dense_output"]
        if not ok:
            failures.append(f"K1 on broadcast Q/K {row['shape']}: {row}")
        rows.append(row)
        log(f"K1 broadcast Q/K {row['shape']}: path {paths}, max err {r['err_o']:.3g} "
            f"({r['of_limit']:.3f} of the limit), equal to K1 on a dense copy {same}"
            + (f"; {row['ms']:.4f} ms (dense copy {row['ms_dense_copy']:.4f} + the copy "
               f"{row['copy_ms']:.4f}), plain {row['plain_ms']:.4f}, SDPA "
               f"{row['library_ms']:.4f}, bound {bound_ms:.4f} ({bound_by})" if timed else ""))
    return rows


def _faceid_state(unet, ucfg, pcfg, rank, seed):
    """A random FaceID checkpoint in the reference's nested layout
    ({"image_proj": ..., "ip_adapter": ...}), written through
    `faceid_keymap` read backward: a projector drawn with the port's
    initializers, rank-`rank` adapters on to_q/to_k/to_v/to_out of every
    attention (A N(0, 1)/sqrt(in), B N(0, 0.02^2)) and the face K/V of every
    cross-attention, all float16 as published."""
    import torch

    from instructany2pix_tpu_torch.diffusion import ip_adapter_faceid as face
    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.models import unet_convert

    g = torch.Generator("cuda").manual_seed(seed)
    with torch.device("meta"):
        proj = face.FaceProj(pcfg)
    proj = L.init_(L.materialize(proj, torch.device("cuda"), torch.float32), g)
    named = {f"image_proj.{n}": p.detach() for n, p in proj.named_parameters()}

    def rnd(shape, std):
        return torch.randn(shape, generator=g, device="cuda") * std

    for path in unet_convert.all_attn_paths(ucfg):
        attn = unet.get_submodule(path)
        for name in face.LORA_PROJ:
            lin = getattr(attn, name)
            named[f"{path}.{name}.lora_a"] = rnd((rank, lin.in_features), lin.in_features ** -0.5)
            named[f"{path}.{name}.lora_b"] = rnd((lin.out_features, rank), 0.02)
        if path.endswith("attn2"):
            for name in ("to_k_ip", "to_v_ip"):
                w = getattr(attn, name).weight
                named[f"{path}.{name}.weight"] = rnd(tuple(w.shape), w.shape[1] ** -0.5)
    flat = face.faceid_keymap(ucfg, pcfg).to_ref(named)
    nested = {"image_proj": {}, "ip_adapter": {}}
    for k, v in flat.items():
        top, _, rest = k.partition(".")
        nested[top][rest] = v.to(torch.float16).cpu()
    return nested


def phase_adapters(pipe, failures):
    """Slice 12 on phase 4's pipeline at 1024^2, each path with every launch
    counter set to 0 just before and read just after: plug-and-play editing
    (the edit's base image VAE-encoded and DDIM-inverted, then
    `pnp_denoise`, PNP_STEPS steps, injection PNP_INJECTION: the up blocks'
    self-attentions of the 3-row batch attend with row 0's Q/K, passed to K1
    as zero-stride views); IP-Adapter Plus XL (the CLIP ViT-H/14
    penultimate states of an image and of a zero image through
    `ResamplerConfig.plus_xl()`, 16 tokens x 2048, into a CFG denoise);
    FaceID and FaceID-Plus (shortcut): each checkpoint written in the
    reference's layout (rank 128 on every attention), read back through
    `faceid_keymap`, merged into a copy of the base UNet and run for a CFG
    denoise from a seeded 512-d id embedding. Checks: K1 launches exact on
    each path, all wgmma, the broadcast ones apart; K1 on the broadcast
    operands against its plain version and bit-equal to K1 on a dense copy;
    on three identical rows, sharing on bit-identical to sharing off with
    PyTorch's own convolutions (row 0 also with cuDNN's, which round some
    up-block convolutions by batch position); FaceID's
    zero-init adapters leave ε
    bit-identical, the loaded ones change it; finite latents and images;
    the pipeline's UNet unchanged afterwards."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.codecs import image_io
    from instructany2pix_tpu_torch.diffusion import ip_adapter_faceid as face
    from instructany2pix_tpu_torch.diffusion import pnp as pnp_lib
    from instructany2pix_tpu_torch.diffusion import resampler as rs_lib
    from instructany2pix_tpu_torch.diffusion import sampler as sampler_lib
    from instructany2pix_tpu_torch.models import clip as clip_lib
    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.models import unet as unet_lib
    from instructany2pix_tpu_torch.models import vae as vae_lib

    cfg, ucfg = pipe.cfg, pipe.cfg.unet
    unet = pipe.models["unet"]
    out = {"card": card_line(), "paths": {}, "seconds": {}}
    blocks = sum(isinstance(m, unet_lib.TBlock) for m in unet.modules())
    up_blocks = sum(isinstance(m, unet_lib.TBlock) for n, m in unet.named_modules()
                    if n.startswith("up_"))
    attn_names = [n for n, m in unet.named_modules() if isinstance(m, unet_lib.Attention)]
    before = {n: checksum(t) for n, t in unet.state_dict().items()
              if any(n.startswith(a + ".") for a in attn_names)}
    keys_before = set(unet.state_dict())

    out["k1_broadcast_rows"] = _k1_broadcast_rows(failures)

    hl = cfg.image_size // 8
    g = torch.Generator("cuda").manual_seed(31)
    with tempfile.TemporaryDirectory() as d:
        png, _ = _write_media(d)
        base_img = pipe.load_base_img(png)
    with torch.inference_mode():
        x = torch.as_tensor(image_io.to_model_range(base_img)[None], device=pipe.device)
        vae_noise = torch.randn((1, hl, hl, 4), generator=g, device="cuda")
        lat0 = torch.randn((1, hl, hl, 4), generator=g, device="cuda")
        ctx_null, pooled_null = pipe._encode_sdxl_prompt("")
        ctx_e, pooled_e = pipe._encode_sdxl_prompt("a watercolor painting of a fox in a forest")
        tid = sampler_lib.default_time_ids(cfg.image_size, cfg.image_size, 1, pipe.device)

        # ---- plug-and-play
        n_inject = int(PNP_INJECTION * PNP_STEPS)
        secs = {}

        def pnp_path():
            lat = vae_lib.encode(pipe.models["vae"], x, vae_noise, cfg.vae).float()
            inv = sampler_lib.ddim_invert(unet, ucfg, pipe.schedule, lat, ctx_null, pooled_null,
                                          tid, num_inference_steps=PNP_STEPS)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            edited = pnp_lib.pnp_denoise(unet, ucfg, pipe.schedule, inv, ctx_e, ctx_null, ctx_null,
                                         pooled_e, pooled_null, pooled_null, tid, PNP_STEPS, 7.5,
                                         PNP_INJECTION)
            torch.cuda.synchronize()
            secs["pnp_denoise"] = time.perf_counter() - t1
            return edited, vae_lib.decode(pipe.models["vae"], edited, cfg.vae)

        k1 = 2 * PNP_STEPS * 2 * blocks  # inversion at batch 1, pnp at batch 3: self + text each
        (edited, img), c, dt = counted(
            "pnp (inversion + pnp_denoise)", pnp_path,
            {"k1": k1, "k1_by_path": {"wgmma": k1}, "k1_broadcast": n_inject * up_blocks}, failures)
        out["paths"]["pnp"] = c
        ok = bool(torch.isfinite(edited).all() and torch.isfinite(img).all())
        out["pnp"] = {"seconds": dt, "pnp_denoise_seconds": secs["pnp_denoise"], "finite": ok,
                      "shape": list(img.shape), "steps": PNP_STEPS, "injected_steps": n_inject,
                      "shared_qk_blocks_per_forward": up_blocks}
        if not ok or tuple(img.shape) != (1, cfg.image_size, cfg.image_size, 3):
            failures.append(f"pnp: finite {ok}, image {list(img.shape)}")

        # its UNet step at batch 3 (sharing on), and sharing on identical rows
        ctx3 = torch.cat([ctx_null, ctx_null, ctx_e])
        pooled3 = torch.cat([pooled_null, pooled_null, pooled_e])
        kv3 = unet_lib.precompute_cross_kv(unet, ucfg, ctx3)
        lat3 = torch.randn((3, hl, hl, 4), generator=g, device="cuda")

        def step3():
            return unet_lib.apply(unet, lat3, torch.full((3,), 500), ctx3, ucfg,
                                  pooled_text=pooled3, time_ids=tid.repeat(3, 1), cross_kv=kv3,
                                  pnp_share_qk=True)

        time_ms(step3, 1, warmup=1)
        samples = sorted(time_ms(step3, 1, warmup=0) for _ in range(5))
        out["pnp"]["unet_step_batch3_ms"] = samples[2]
        same_rows = lat3[:1].expand(3, -1, -1, -1).contiguous()
        ctx_same = ctx_e.expand(3, -1, -1).contiguous()
        args = (unet, same_rows, torch.full((3,), 500), ctx_same, ucfg)
        kw = dict(pooled_text=pooled_e.expand(3, -1).contiguous(), time_ids=tid.repeat(3, 1))

        def spread(e):
            return max((e[i].float() - e[0].float()).abs().max().item() for i in (1, 2))

        ident = {}
        # cuDNN's convolutions round by batch position at some of the up blocks'
        # shapes (its deterministic algorithms too), so with them the UNet already
        # gives three identical rows different outputs without sharing; PyTorch's
        # own convolutions treat the rows alike, which is where sharing is held to
        # bit-identity. With cuDNN, row 0 (its own Q/K either way) must still match.
        cudnn = torch.backends.cudnn
        for name, enabled in (("cudnn", True), ("no_cudnn", False)):
            with cudnn.flags(enabled=enabled, benchmark=cudnn.benchmark,
                             deterministic=cudnn.deterministic, allow_tf32=cudnn.allow_tf32):
                on = unet_lib.apply(*args, pnp_share_qk=True, **kw)
                off = unet_lib.apply(*args, pnp_share_qk=False, **kw)
            ident[name] = {"bit_identical": bool(torch.equal(on, off)),
                           "row0_bit_identical": bool(torch.equal(on[0], off[0])),
                           "off_rows_spread": spread(off), "on_rows_spread": spread(on),
                           "on_minus_off": (on.float() - off.float()).abs().max().item()}
        out["pnp"]["identical_rows"] = ident
        if not (ident["no_cudnn"]["bit_identical"] and ident["cudnn"]["row0_bit_identical"]):
            failures.append(f"pnp: three identical rows with sharing on against off: {ident}")
        log(f"pnp at {cfg.image_size}^2 ({PNP_STEPS} inversion + {PNP_STEPS} pnp steps, "
            f"{n_inject} shared): {dt:.3f} s (pnp_denoise {secs['pnp_denoise']:.3f} s), UNet step "
            f"at batch 3 median {samples[2]:.2f} ms of 5; identical rows {ident}; finite {ok} "
            f"[{out['card']}]")

        # ---- IP-Adapter Plus XL: the CLIP ViT-H/14 tower and the Resampler, random bf16
        vcfg = clip_lib.CLIPVisionConfig.vit_h()
        with torch.device("meta"):
            vision = clip_lib.CLIPVision(vcfg)
        vision = L.init_(L.materialize(vision, torch.device("cuda"), torch.bfloat16),
                         torch.Generator("cuda").manual_seed(11)).eval().requires_grad_(False)
        rcfg = rs_lib.ResamplerConfig.plus_xl()
        resampler = rs_lib.init(rcfg, torch.Generator().manual_seed(41), "cuda", torch.bfloat16)
        rs = np.random.RandomState(42)
        image = rs.randint(0, 256, (512, 384, 3)).astype(np.uint8)

        def denoise(model, cond, uncond):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lat = sampler_lib.denoise(model, ucfg, pipe.schedule, lat0, ctx_e, ctx_null, pooled_e,
                                      pooled_null, tid, ADAPTER_STEPS, 5.0, ip_tokens=cond,
                                      ip_tokens_uncond=uncond)
            torch.cuda.synchronize()
            return lat, time.perf_counter() - t1

        def plus_path():
            cond, uncond = rs_lib.get_image_embeds_plus(resampler, rcfg, image=image,
                                                        image_encoder=(vision, vcfg))
            return cond, uncond, denoise(unet, cond, uncond)

        k1 = 2 * vcfg.num_layers + ADAPTER_STEPS * 3 * blocks
        (cond, uncond, (lat, den_s)), c, dt = counted(
            "IP-Adapter Plus XL (CLIP states, Resampler, CFG denoise)", plus_path,
            {"k1": k1, "k1_by_path": {"wgmma": k1}}, failures)
        out["paths"]["ip_plus_xl"] = c
        ok = bool(torch.isfinite(lat).all() and torch.isfinite(cond).all())
        out["ip_plus_xl"] = {"seconds": dt, "denoise_seconds": den_s,
                             "denoise_step_ms": den_s / ADAPTER_STEPS * 1e3,
                             "tokens": list(cond.shape), "finite": ok}
        if not ok or tuple(cond.shape) != (1, rcfg.num_queries, rcfg.output_dim):
            failures.append(f"IP-Adapter Plus XL: tokens {list(cond.shape)}, finite {ok}")

        # ---- FaceID and FaceID-Plus on a copy of the base UNet
        fu = copy.deepcopy(unet)
        pcfg = face.FaceProjConfig()
        id_embed = torch.randn((1, pcfg.id_embeddings_dim), generator=g, device="cuda")
        tok_probe = torch.randn((2, pcfg.num_tokens, ucfg.cross_attention_dim), generator=g,
                                device="cuda", dtype=torch.bfloat16)
        probe_args = (torch.cat([lat0, lat0]), torch.full((2,), 500), torch.cat([ctx_null, ctx_e]),
                      ucfg)
        probe_kw = dict(pooled_text=torch.cat([pooled_null, pooled_e]), time_ids=tid.repeat(2, 1),
                        ip_tokens=tok_probe)
        eps0 = unet_lib.apply(fu, *probe_args, **probe_kw)
        face.attach_faceid_lora(fu, torch.Generator("cuda").manual_seed(43), rank=FACEID_RANK)
        eps1 = unet_lib.apply(fu, *probe_args, **probe_kw)
        out["faceid_zero_init_bit_identical"] = bool(torch.equal(eps0, eps1))
        if not out["faceid_zero_init_bit_identical"]:
            failures.append(f"FaceID: zero-init adapters move ε by "
                            f"{(eps1.float() - eps0.float()).abs().max().item():.3g}")
        face_img = rs.randint(0, 256, (256, 256, 3)).astype(np.uint8)
        for plus in (False, True):
            name = "faceid_plus" if plus else "faceid"
            pc = face.FaceProjConfig(plus=plus)
            with tempfile.TemporaryDirectory() as d:
                t1 = time.perf_counter()
                path = f"{d}/ip-adapter-{name}_sdxl.bin"
                torch.save(_faceid_state(fu, ucfg, pc, FACEID_RANK, 44 + int(plus)), path)
                write_s = time.perf_counter() - t1
                t1 = time.perf_counter()
                sd = torch.load(path, map_location="cpu", weights_only=True)
                proj_t, attn_t = face.convert_faceid(sd, ucfg, pc)
                face.merge_faceid_weights(fu, attn_t)
                proj = face.build_proj(proj_t, pc, "cuda", torch.bfloat16)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t1
                del sd, attn_t
            eps2 = unet_lib.apply(fu, *probe_args, **probe_kw)
            moved = (eps2.float() - eps0.float()).abs().max().item()
            if not moved > 0:
                failures.append(f"{name}: the loaded adapters leave ε unchanged")

            def face_path(pc=pc, proj=proj, plus=plus):
                clip_c = clip_u = None
                if plus:
                    from instructany2pix_tpu_torch.diffusion import ip_adapter as ipa

                    px = ipa.preprocess_clip_image(face_img, vcfg.image_size)
                    clip_c = rs_lib.clip_penultimate(vision, vcfg, px)
                    clip_u = rs_lib.clip_penultimate(vision, vcfg, torch.zeros_like(px))
                cond, uncond = face.get_image_embeds(proj, pc, id_embed, clip_c, clip_u,
                                                     shortcut=plus)
                return cond, denoise(fu, cond, uncond)

            k1 = (2 * vcfg.num_layers if plus else 0) + ADAPTER_STEPS * 3 * blocks
            (cond, (lat, den_s)), c, dt = counted(f"{name} (projector, CFG denoise, rank-128 LoRA)",
                                                  face_path, {"k1": k1, "k1_by_path": {"wgmma": k1}},
                                                  failures)
            out["paths"][name] = c
            ok = bool(torch.isfinite(lat).all() and torch.isfinite(cond).all())
            out[name] = {"seconds": dt, "denoise_seconds": den_s,
                         "denoise_step_ms": den_s / ADAPTER_STEPS * 1e3, "write_seconds": write_s,
                         "load_and_merge_seconds": load_s, "eps_moved_by_loaded": moved,
                         "tokens": list(cond.shape), "finite": ok}
            if not ok or tuple(cond.shape) != (1, pc.num_tokens, ucfg.cross_attention_dim):
                failures.append(f"{name}: tokens {list(cond.shape)}, finite {ok}")
            log(f"{name}: written {write_s:.2f} s, read, mapped and merged {load_s:.2f} s; "
                f"loaded adapters move ε by {moved:.3g}; CFG denoise {ADAPTER_STEPS} steps "
                f"{den_s:.3f} s ({den_s / ADAPTER_STEPS * 1e3:.2f} ms per step); finite {ok}")
            del proj
        del fu, vision, resampler
    torch.cuda.empty_cache()
    after = {n: checksum(t) for n, t in unet.state_dict().items() if n in before}
    out["pipeline_unet_unchanged"] = after == before and set(unet.state_dict()) == keys_before
    if not out["pipeline_unet_unchanged"]:
        failures.append("adapters phase: the pipeline's UNet changed")
    log(f"IP-Adapter Plus XL: {out['ip_plus_xl']['seconds']:.3f} s, denoise step "
        f"{out['ip_plus_xl']['denoise_step_ms']:.2f} ms; FaceID zero-init ε bit-identical "
        f"{out['faceid_zero_init_bit_identical']}; pipeline UNet unchanged "
        f"{out['pipeline_unet_unchanged']} [{out['card']}]")
    return out


def _greedy(lm, cfg, ids, n):
    """Greedy tokens of a Llama on a prompt of byte ids (prefill M > 16)."""
    import torch

    from instructany2pix_tpu_torch.llm import generate as gen_lib
    from instructany2pix_tpu_torch.models import llama as llama_lib

    emb = llama_lib.embed(lm, torch.as_tensor(ids, device="cuda")[None])
    return gen_lib.generate(lm, cfg, emb, None, max_new_tokens=n, temperature=0.0,
                            eos_id=-1).tokens[0].cpu()


def _prep_media(d):
    """Two PNGs and two 3 s 16 kHz WAVs for the data preparation."""
    import os
    import wave

    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(51)
    for i, hw in enumerate(((384, 512), (600, 480))):
        Image.fromarray(rs.randint(0, 255, hw + (3,), np.uint8)).save(os.path.join(d, f"img{i}.png"))
    for i, f in enumerate((440.0, 659.0)):
        sig = np.sin(2 * np.pi * f * np.arange(48000) / 16000) * 0.5 + rs.randn(48000) * 0.05
        with wave.open(os.path.join(d, f"snd{i}.wav"), "w") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(sig, -1, 1) * 32767).astype(np.int16).tobytes())


def phase_finetune_tree(pipe, root, feats_dir, failures):
    """Slice 12's tools that read the written tree, on phase 4's pipeline:
    the LoRA boot (rank-8 adapters over all 32 layers of the tree's LLM and
    its predictor heads written in the reference's LoRA layout, booted with
    `load_pretrained_model(load_lora=True)`, quantized to int4 and fused,
    then greedy decode of LORA_DECODE_TOKENS tokens: identical to the model
    merged in memory from the same factors, K2 exactly 128 per decode step,
    all mma); the surgery round trip on its resized embedding and lm_head;
    the data preparation over 2 PNGs and 2 WAVs with ImageBind-huge from the
    tree (states bit-identical to the pipeline's own embeddings of the
    files, K1 exactly once per encoder layer per file)."""
    import gc
    import os
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch import loaders
    from instructany2pix_tpu_torch.models import llama as llama_lib
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.train import data_preparation as prep
    from instructany2pix_tpu_torch.train import lora
    from instructany2pix_tpu_torch.utils import surgery

    cfg = pipe.cfg
    lcfg = cfg.llm.llama
    out = {"card": card_line(), "paths": {}}
    base_dir = os.path.join(root, "llm-retrained")
    prompt = list("Describe, in a few words, a red cat sleeping in an antique shop.".encode())
    g = torch.Generator("cuda").manual_seed(61)
    with tempfile.TemporaryDirectory() as lora_dir:
        # ---- the finetune: adapters on the float base, merged in memory
        m = loaders.load_llm(base_dir, cfg.llm, "cuda", torch.bfloat16)
        lora.apply_lora(m, g, rank=LORA_RANK, alpha=LORA_ALPHA)
        with torch.no_grad():
            for n, p in m.named_parameters():
                if n.endswith("lora_b"):
                    p.copy_(torch.randn(p.shape, generator=g, device="cuda") * 0.02)
                elif n.startswith("vae_predictor"):
                    p.add_(torch.randn(p.shape, generator=g, device="cuda") * 0.01)
        t0 = time.perf_counter()
        counts = lora.save_lora_checkpoint(m, lora_dir)
        out["lora_write_seconds"] = time.perf_counter() - t0
        out["lora_files"] = counts
        lora.merge_lora(m)
        Q.quantize_llama(m.llama, bits=4)
        llama_lib.fuse_projections(m.llama)
        tokens_mem = _greedy(m.llama, lcfg, prompt, LORA_DECODE_TOKENS)
        del m
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the boot
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booted, _, _ = loaders.load_pretrained_model(lora_dir, base_dir, load_lora=True,
                                                     cfg=cfg.llm, device="cuda",
                                                     dtype=torch.bfloat16)
        torch.cuda.synchronize()
        out["lora_load_merge_seconds"] = time.perf_counter() - t0

        # ---- surgery on the merged model's resized embedding and lm_head (float32)
        t1 = time.perf_counter()
        fine = {"embed_tokens.weight": booted.llama.embed_tokens.weight.float(),
                "lm_head.weight": booted.llama.lm_head.weight.float()}
        n_base = lcfg.vocab_size - 9
        base = {k: (v[:n_base] + torch.randn(v[:n_base].shape, generator=g, device="cuda") * 0.01)
                .bfloat16().float() for k, v in fine.items()}
        delta = surgery.make_delta(fine, base)
        back = surgery.apply_delta(delta, base)
        torch.cuda.synchronize()
        out["surgery"] = {
            "seconds": time.perf_counter() - t1, "rows": [lcfg.vocab_size, n_base],
            "round_trip_bit_identical": all(torch.equal(back[k], fine[k]) for k in fine),
            "added_rows_verbatim": all(torch.equal(delta[k][n_base:], fine[k][n_base:])
                                       for k in fine)}
        if not (out["surgery"]["round_trip_bit_identical"] and out["surgery"]["added_rows_verbatim"]):
            failures.append(f"surgery: {out['surgery']}")
        del fine, base, delta, back

        t1 = time.perf_counter()
        Q.quantize_llama(booted.llama, bits=4)
        llama_lib.fuse_projections(booted.llama)
        torch.cuda.synchronize()
        out["lora_quantize_seconds"] = time.perf_counter() - t1
        out["lora_boot_seconds"] = out["lora_load_merge_seconds"] + out["lora_quantize_seconds"]
        k2 = 128 * (LORA_DECODE_TOKENS - 1)
        tokens_boot, c, dt = counted(
            f"LoRA-booted 7B greedy decode ({LORA_DECODE_TOKENS} tokens)",
            lambda: _greedy(booted.llama, lcfg, prompt, LORA_DECODE_TOKENS),
            {"k2": k2, "k2_by_path": {"mma": k2}}, failures)
        out["paths"]["lora_boot_decode"] = c
        same = bool(torch.equal(tokens_boot, tokens_mem))
        out.update({"lora_decode_seconds": dt, "lora_tokens_identical": same,
                    "lora_tokens": tokens_boot.tolist()})
        if not same:
            failures.append(f"LoRA boot: tokens {tokens_boot.tolist()} != merged in memory "
                            f"{tokens_mem.tolist()}")
        log(f"LoRA boot (rank {LORA_RANK} on 7 x 32 projections, heads): written "
            f"{out['lora_write_seconds']:.2f} s ({counts}); load + merge "
            f"{out['lora_load_merge_seconds']:.2f} s, quantize + fuse "
            f"{out['lora_quantize_seconds']:.2f} s; greedy tokens identical to the model merged "
            f"in memory {same}; surgery round trip {out['surgery']} [{out['card']}]")
        del booted
        gc.collect()
        torch.cuda.empty_cache()

    # ---- data preparation with ImageBind-huge from the tree
    vcfg, acfg = cfg.imagebind_vision, cfg.imagebind_audio
    with tempfile.TemporaryDirectory() as media:
        _prep_media(media)
        times = []
        argv = ["--input", media, "--output", feats_dir, "--ckpt",
                os.path.join(root, "imagebind_huge.pth"), "--dtype", "bfloat16"]
        k1 = 2 * vcfg.layers + 2 * acfg.layers
        written, c, dt = counted("data preparation (2 PNGs, 2 WAVs, ImageBind-huge bf16)",
                                 lambda: prep.main(argv, times=times),
                                 {"k1": k1, "k1_by_path": {"wgmma": k1}}, failures)
        out["paths"]["data_preparation"] = c
        same = []
        with torch.inference_mode():
            for p in written:
                stem = os.path.splitext(os.path.basename(p))[0]
                kind = "image" if stem.startswith("img") else "audio"
                src = os.path.join(media, stem + (".png" if kind == "image" else ".wav"))
                want = pipe._embed_media({"type": kind, "fname": src}).cpu().numpy()[0]
                same.append(bool(np.array_equal(np.load(p)["state"], want)))
        out["data_preparation"] = {"seconds": dt, "files": len(written),
                                   "ms_per_file": [t * 1e3 for t in times],
                                   "bit_identical_to_pipeline": same}
        if len(written) != 4 or not all(same):
            failures.append(f"data preparation: {len(written)} files, bit-identical {same}")
        log(f"data preparation: {dt:.3f} s with the boot; per file "
            + ", ".join(f"{t * 1e3:.1f}" for t in times)
            + f" ms; states bit-identical to the pipeline's embeddings {same}")
    return out


def _train_setup(d):
    """The full-width trainer's config (Any2PixLMConfig() at every Vicuna-7B
    width, TRAIN_LAYERS layers, remat "dots"), a dataset factory over a
    synthetic dataset written to `d`, its first batch as `train.launch.train`
    collates it (same order, same rewrite stream; numpy) and bf16
    parameters from seed 0 on the card."""
    import dataclasses

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.llm import multimodal as mm
    from instructany2pix_tpu_torch.llm.tokenizer import initialize_vision_tokenizer, load_tokenizer
    from instructany2pix_tpu_torch.train import data as data_lib

    tok = load_tokenizer(None)
    ids = initialize_vision_tokenizer(tok)
    base = mm.Any2PixLMConfig().with_token_ids(ids)
    cfg = dataclasses.replace(base, llama=dataclasses.replace(
        base.llama, num_layers=TRAIN_LAYERS, remat=True, remat_policy="dots"))
    data, feats = _write_train_dataset(d, TRAIN_ROW_CHARS, cfg.image_codec_dim, 21)
    dcfg = data_lib.DataConfig(max_length=TRAIN_LEN, audio_codec_dim=cfg.audio_codec_dim)

    def make_ds():
        return data_lib.InstructionDataset(
            data, data_lib.MediaMap(feats, d, cfg.image_codec_dim), tok, ids, dcfg)

    ds0 = make_ds()
    order = data_lib.length_grouped_indices(ds0.modality_lengths, TRAIN_BATCH,
                                            np.random.RandomState(0))
    first = data_lib.collate([ds0[int(i)] for i in order[:TRAIN_BATCH]], tok, ids, dcfg,
                             codec_dim=cfg.image_codec_dim)
    params = mm.init(cfg, torch.Generator("cuda").manual_seed(0), device="cuda",
                     dtype=torch.bfloat16)
    return cfg, make_ds, first, params


def phase_finetune(feats_dir, failures):
    """Slice 12's training paths at full width, each counted: LoRA on
    Any2PixLMConfig() (Vicuna-7B widths, 4 of 32 layers, bf16, remat
    "dots", batch 4 x 2048): `apply_lora` (r 8, alpha 16), `trainable_mask`,
    3 steps of the port's optimizer over the trainable parameters (finite
    losses; frozen weights bit-unchanged; every lora_b moved; K1 2L and K4 L
    per step, wgmma); the adapted model's logits merged against unmerged
    (within twice the bf16 model's own distance from float32); one decode
    step over an int4 base with the adapters unmerged (K2's unfused call:
    exactly 7 per layer, each held against its plain version within K2's
    limit); `MediaMap` over the data preparation's features into one
    `train_forward`; the prior's training (PRIOR_TRAIN_STEPS steps at
    `PriorConfig.default()`, float32, finite losses)."""
    import copy
    import json
    import os
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.llm import multimodal as mm
    from instructany2pix_tpu_torch.llm.tokenizer import initialize_vision_tokenizer, load_tokenizer
    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.models import llama as llama_lib
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.prior import model as prior_lib
    from instructany2pix_tpu_torch.train import data as data_lib
    from instructany2pix_tpu_torch.train import lora
    from instructany2pix_tpu_torch.train.train_step import TrainConfig, make_train_step

    out = {"card": card_line(), "paths": {}}
    tok = load_tokenizer(None)
    ids = initialize_vision_tokenizer(tok)
    with tempfile.TemporaryDirectory() as d:
        cfg, make_ds, first, params = _train_setup(d)
        dcfg = make_ds().cfg
    batch = {k: torch.from_numpy(v).cuda() for k, v in first.items()}
    Lr = cfg.llama.num_layers
    lora.apply_lora(params, torch.Generator("cuda").manual_seed(1), rank=LORA_RANK, alpha=LORA_ALPHA)
    mask = lora.trainable_mask(params)
    n_train = sum(p.numel() for n, p in params.named_parameters() if mask[n])
    frozen = {n: checksum(p) for n, p in params.named_parameters() if not mask[n]}
    start = {n: checksum(p) for n, p in params.named_parameters() if mask[n]}
    init_state, train_step = make_train_step(cfg, TrainConfig(learning_rate=LORA_LR,
                                                              total_steps=100))
    state = init_state(params)
    steps = []

    def run():
        for _ in range(LORA_TRAIN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, metrics = train_step(state, batch)
            vals = {k: float(v) for k, v in metrics.items()}
            torch.cuda.synchronize()
            steps.append({"seconds": time.perf_counter() - t1, "metrics": vals})

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    _, c, dt = counted(f"LoRA train ({LORA_TRAIN_STEPS} steps)", run,
                       {"k1": LORA_TRAIN_STEPS * 2 * Lr, "k1_by_path": {"wgmma": LORA_TRAIN_STEPS * 2 * Lr},
                        "k4": LORA_TRAIN_STEPS * Lr, "k4_by_path": {"wgmma": LORA_TRAIN_STEPS * Lr}},
                       failures)
    out["paths"]["lora_train"] = c
    finite = all(np.isfinite(v) for st in steps for v in st["metrics"].values())
    unchanged = all(checksum(p) == frozen[n] for n, p in params.named_parameters() if n in frozen)
    moved_b = all(checksum(p) != start[n] for n, p in params.named_parameters()
                  if n.endswith("lora_b"))
    moved_a = np.mean([checksum(p) != start[n] for n, p in params.named_parameters()
                       if n.endswith("lora_a")])
    tokens = TRAIN_BATCH * int(batch["input_ids"].shape[1])
    med = min(st["seconds"] for st in steps[1:])
    out["lora_train"] = {
        "steps": steps, "trainable_params": n_train,
        "params": sum(p.numel() for p in params.parameters()), "frozen_unchanged": unchanged,
        "every_lora_b_moved": moved_b, "lora_a_moved_share": float(moved_a),
        "step_seconds_best_2_3": med, "tokens_per_s": tokens / med,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "resident_before_gib": resident / 2**30}
    if not (finite and unchanged and moved_b):
        failures.append(f"LoRA train: finite {finite}, frozen unchanged {unchanged}, every lora_b "
                        f"moved {moved_b}: {steps}")
    log(f"LoRA train ({Lr} of 32 layers, r {LORA_RANK}, {n_train / 1e6:.2f} M trainable of "
        f"{out['lora_train']['params'] / 1e9:.3f} B, batch {TRAIN_BATCH} x "
        f"{batch['input_ids'].shape[1]}): steps " + ", ".join(
            f"{st['seconds']:.3f} s loss {st['metrics']['loss']:.4f}" for st in steps)
        + f"; best of steps 2-{LORA_TRAIN_STEPS} {med:.3f} s, {tokens / med:.0f} tokens/s; peak "
        f"{out['lora_train']['peak_gib']:.2f} GiB; frozen bit-unchanged {unchanged}; lora_b moved "
        f"{moved_b}, lora_a moved {moved_a:.2f} [{out['card']}]")

    # ---- merged against unmerged logits (bf16), beside the bf16 model's own distance from float32
    x = batch["input_ids"][:1, :256]
    with torch.no_grad():
        unmerged = llama_lib.forward(params.llama, cfg.llama, input_ids=x)["logits"].float()
        f32 = copy.deepcopy(params.llama).float()
        ref32 = llama_lib.forward(f32, cfg.llama, input_ids=x)["logits"]
        del f32
        merged_m = lora.merge_lora(copy.deepcopy(params.llama))
        merged = llama_lib.forward(merged_m, cfg.llama, input_ids=x)["logits"].float()
        del merged_m
    own = (unmerged - ref32).abs().max().item()
    diff = (merged - unmerged).abs().max().item()
    out["merge_logits"] = {"max_diff": diff, "bf16_own_max_diff": own, "limit": 2 * own,
                           "of_limit": diff / max(2 * own, 1e-30)}
    if not diff <= 2 * own:
        failures.append(f"LoRA merge: logits move by {diff:.4g} > twice the bf16 model's own "
                        f"distance from float32 ({own:.4g})")
    log(f"LoRA merged against unmerged logits (bf16, 256 tokens): max diff {diff:.4g}, limit "
        f"{2 * own:.4g} (twice the unmerged bf16 logits' distance from float32)")

    # ---- one decode step over an int4 base with the adapters unmerged
    with torch.no_grad():
        qm = copy.deepcopy(params.llama).requires_grad_(False)
        Q.quantize_llama(qm, bits=4)
    calls = []
    qmatmul = Q.qmatmul

    def recording(x_, q, *a, **kw):
        y = qmatmul(x_, q, *a, **kw)
        calls.append((x_.detach().reshape(-1, x_.shape[-1]).clone(), q, kw, y.detach().clone()))
        return y

    with torch.inference_mode():
        cache = llama_lib.KVCache.create(cfg.llama, 1, 64, torch.bfloat16, "cuda")
        pre = llama_lib.forward(qm, cfg.llama, input_ids=x[:, :32], cache=cache)
        nxt = pre["logits"][:, -1:].argmax(-1)
        Q.qmatmul = recording
        try:
            step, c, _ = counted("one decode step, int4 base with unmerged adapters",
                                 lambda: llama_lib.forward(qm, cfg.llama, input_ids=nxt,
                                                           cache=pre["cache"]),
                                 {"k2": 7 * Lr, "k2_by_path": {"mma": 7 * Lr}, "k2_unfused": 7 * Lr},
                                 failures)
        finally:
            Q.qmatmul = qmatmul
        out["paths"]["lora_unmerged_decode_step"] = c
        worst = 0.0
        ok = bool(torch.isfinite(step["logits"]).all())
        for xk, q, kw, y in calls:
            ref = Q._qmv_reference(xk, q, **kw)
            r = qmv_reading(y.reshape(ref.shape), ref, q, xk, kw.get("norm_g"), kw.get("swiglu", False),
                            kw.get("residual"))
            worst = max(worst, r["of_limit"])
            ok &= r["ok"]
    out["lora_unmerged_step"] = {"k2_calls": len(calls), "worst_of_k2_limit": worst, "ok": ok,
                                 "adapters_on_int4": sum(L.has_lora(m) for m in qm.modules())}
    if not ok or len(calls) != 7 * Lr:
        failures.append(f"LoRA over int4, unmerged: {out['lora_unmerged_step']}")
    log(f"decode step over int4 with unmerged adapters: {len(calls)} K2 calls without a fused "
        f"prologue, the worst {worst:.3f} of K2's limit against its plain version; finite {ok}")
    del qm, cache, pre

    # ---- MediaMap over the data preparation's features, into one train_forward
    files = sorted(f for f in os.listdir(feats_dir) if f.endswith(".npz"))
    mmap = data_lib.MediaMap({f"caption {f}": f for f in files}, feats_dir, cfg.image_codec_dim)
    rec = [{"conversations": [{"from": "human", "value": f"change [caption {files[1]}] please"},
                              {"from": "gpt", "value": f"[caption {files[0]}] done"}],
            "base": f"caption {files[1]}", "target": f"caption {files[0]}", "modality": "image"}]
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "data.json"), "w") as f:
            json.dump(rec, f)
        ds = data_lib.InstructionDataset(os.path.join(d, "data.json"), mmap, tok, ids, dcfg)
        b1 = data_lib.collate([ds[0]], tok, ids, dcfg, codec_dim=cfg.image_codec_dim)
    got = mmap.get(f"caption {files[0]}")
    with torch.no_grad():
        loss, _ = mm.train_forward(params, cfg, {k: torch.from_numpy(v).cuda() for k, v in b1.items()})
    out["media_map_train_forward"] = {"loss": float(loss), "norm": float(np.linalg.norm(got))}
    if not (np.isfinite(float(loss)) and abs(np.linalg.norm(got) - 20.0) < 1e-3):
        failures.append(f"MediaMap into train_forward: {out['media_map_train_forward']}")
    log(f"MediaMap over the prepared features into train_forward: loss {float(loss):.4f}")
    del params, state, batch, frozen, start
    torch.cuda.empty_cache()

    # ---- the prior's training, GPT-2 medium, float32
    pcfg = prior_lib.PriorConfig.default()
    with torch.device("meta"):
        prior = prior_lib.Prior(pcfg)
    prior = L.init_(L.materialize(prior, torch.device("cuda"), torch.float32),
                    torch.Generator("cuda").manual_seed(71)).train()
    g = torch.Generator("cuda").manual_seed(72)
    b = PRIOR_TRAIN_BATCH
    lens = torch.randint(5, pcfg.text_len, (b,), generator=g, device="cuda")
    cond = {"src_type": torch.randint(0, 4, (b, 1), generator=g, device="cuda"),
            "imagebind": torch.randn((b, 1, pcfg.imagebind_dim), generator=g, device="cuda"),
            "crossattn_clip": (torch.randn((b, pcfg.text_len, pcfg.text_dim), generator=g,
                                           device="cuda"),
                               (torch.arange(pcfg.text_len, device="cuda")[None] < lens[:, None]).float()),
            "score": prior_lib.score_embedding(6.5, pcfg.score_dim, "cuda").expand(b, 1, -1)}
    target = torch.randn((b, pcfg.sequence_gen_length, pcfg.embed_dim), generator=g, device="cuda")
    tx = prior_lib.make_optimizer(1e-4, weight_decay=0.01, warmup_steps=1)
    pstate = tx.init(prior)
    losses, times = [], []

    def prior_run():
        for _ in range(PRIOR_TRAIN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(prior_lib.train_step(prior, pcfg, tx, pstate, cond, target,
                                                     generator=g)))
            times.append(time.perf_counter() - t1)

    _, c, dt = counted(f"prior training ({PRIOR_TRAIN_STEPS} steps, GPT-2 medium, float32)",
                       prior_run, {}, failures)
    out["paths"]["prior_train"] = c
    ms = sorted(times[1:])[len(times[1:]) // 2] * 1e3
    out["prior_train"] = {"losses": losses, "step_ms_median_2_5": ms,
                          "params": prior_lib.param_count(prior), "batch": b}
    if not all(np.isfinite(losses)):
        failures.append(f"prior training: losses {losses}")
    log(f"prior training ({out['prior_train']['params'] / 1e6:.1f} M params, batch {b}): losses "
        f"{[round(x_, 4) for x_ in losses]}, step median of 2-{PRIOR_TRAIN_STEPS} {ms:.2f} ms "
        f"[{out['card']}]")
    del prior, pstate
    torch.cuda.empty_cache()
    return out


def phase_tiny_adapters(failures):
    """Slice 12's paths in float32 on tiny models, the card against the CPU
    from the same weights and draws, each within TINY_REL of the largest
    element (K1 on its fma path): one pnp step (sharing on), one FaceID
    UNet call (random rank-4 adapters on every attention, face K/V), one
    LoRA train step (the loss and the trainable parameters; frozen ones
    bit-unchanged on both) and one prior train step (loss and parameters)."""
    import copy

    import torch

    from instructany2pix_tpu_torch.diffusion import ip_adapter_faceid as face
    from instructany2pix_tpu_torch.diffusion import pnp as pnp_lib
    from instructany2pix_tpu_torch.diffusion.schedulers import Schedule
    from instructany2pix_tpu_torch.llm import multimodal as mm
    from instructany2pix_tpu_torch.llm.tokenizer import initialize_vision_tokenizer, load_tokenizer
    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.models import unet as unet_lib
    from instructany2pix_tpu_torch.prior import model as prior_lib
    from instructany2pix_tpu_torch.train import data as data_lib
    from instructany2pix_tpu_torch.train import lora
    from instructany2pix_tpu_torch.train import train_step as ts

    out = {}
    g = torch.Generator().manual_seed(81)
    ucfg = unet_lib.UNetConfig.tiny(with_ip=True)
    with torch.device("meta"):
        unet = unet_lib.UNet(ucfg)
    unet = L.init_(L.materialize(unet, torch.device("cpu"), torch.float32), g).eval()
    ctx = [torch.randn(1, 7, ucfg.cross_attention_dim, generator=g) for _ in range(3)]
    pooled = [torch.randn(1, ucfg.pooled_dim, generator=g) for _ in range(3)]
    tid = torch.tensor([[64.0, 64, 0, 0, 64, 64]])
    lat = torch.randn(1, 8, 8, 4, generator=g)
    res = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(unet).to(dev)
        with torch.inference_mode():
            res[dev] = pnp_lib.pnp_denoise(m, ucfg, Schedule.create(device=dev), lat.to(dev),
                                           *[c.to(dev) for c in ctx], *[p.to(dev) for p in pooled],
                                           tid.to(dev), num_inference_steps=1, injection_ratio=1.0)
    out["pnp_step_rel"] = _rel(res["cuda"], res["cpu"])

    face.attach_faceid_lora(unet, g, rank=4)
    with torch.no_grad():
        for n, p in unet.named_parameters():
            if n.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    x = torch.randn(2, 8, 8, 4, generator=g)
    ip = torch.randn(2, 2, ucfg.cross_attention_dim, generator=g)
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(unet).to(dev)
        with torch.inference_mode():
            kv = unet_lib.precompute_cross_kv(m, ucfg, torch.cat(ctx[:2]).to(dev), ip.to(dev))
            res[dev] = unet_lib.apply(m, x.to(dev), torch.tensor([700, 300], device=dev),
                                      torch.cat(ctx[:2]).to(dev), ucfg,
                                      pooled_text=torch.cat(pooled[:2]).to(dev),
                                      time_ids=tid.repeat(2, 1).to(dev), cross_kv=kv, ip_scale=0.7)
    out["faceid_unet_rel"] = _rel(res["cuda"], res["cpu"])

    tok = load_tokenizer(None)
    ids = initialize_vision_tokenizer(tok)
    cfg = mm.Any2PixLMConfig.tiny(ids)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        data, feats = _write_train_dataset(d, (40, 25), cfg.image_codec_dim, 22)
        dcfg = data_lib.DataConfig(max_length=512, audio_codec_dim=cfg.audio_codec_dim)
        ds = data_lib.InstructionDataset(data, data_lib.MediaMap(feats, d, cfg.image_codec_dim),
                                         tok, ids, dcfg)
        batch_np = data_lib.collate([ds[0], ds[1]], tok, ids, dcfg, codec_dim=cfg.image_codec_dim)
    params = mm.init(cfg, torch.Generator().manual_seed(0))
    lora.apply_lora(params, torch.Generator().manual_seed(1), rank=4)
    with torch.no_grad():
        for n, p in params.named_parameters():
            if n.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    tcfg = ts.TrainConfig(learning_rate=1e-3, total_steps=100, warmup_ratio=0.0)
    runs = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(params).to(dev)
        mask = lora.trainable_mask(m)
        init_state, step = ts.make_train_step(cfg, tcfg)
        state = init_state(m)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        frozen = {n: p.detach().clone() for n, p in m.named_parameters() if not mask[n]}
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
        runs[dev] = (losses, m, all(torch.equal(p, frozen[n])
                                    for n, p in m.named_parameters() if n in frozen), mask)
    lc, mc, uc, mask = runs["cpu"]
    lg, mg, ug, _ = runs["cuda"]
    pg = dict(mg.named_parameters())
    out["lora_step_loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    # the trainable parameters after the second step (the first runs at lr 0): Adam moves each
    # element by about lr, so elements are held to 0.1 of it and to 1e-4 of it on average,
    # the tolerances of the existing tiny train check
    dmax = max((pg[n].detach().cpu() - p.detach()).abs().max().item()
               for n, p in mc.named_parameters() if mask[n])
    dmean = max((pg[n].detach().cpu() - p.detach()).abs().mean().item()
                for n, p in mc.named_parameters() if mask[n])
    out.update(lora_step_param_max_of_lr=dmax / 1e-3, lora_step_param_mean_of_lr=dmean / 1e-3,
               lora_step_frozen_unchanged=bool(uc and ug))

    pcfg = prior_lib.PriorConfig.tiny()
    with torch.device("meta"):
        prior = prior_lib.Prior(pcfg)
    prior = L.init_(L.materialize(prior, torch.device("cpu"), torch.float32), g).train()
    cond = {"src_type": torch.tensor([[3], [0]]), "imagebind": torch.randn(2, 1, 16, generator=g),
            "crossattn_clip": (torch.randn(2, pcfg.text_len, pcfg.text_dim, generator=g),
                               torch.ones(2, pcfg.text_len)),
            "score": torch.randn(2, 1, pcfg.score_dim, generator=g)}
    target = torch.randn(2, 3, pcfg.embed_dim, generator=g)
    draws = dict(t=torch.tensor([10, 900]), noise=torch.randn(target.shape, generator=g))
    pres = {}
    with torch.enable_grad():
        loss0 = prior_lib.train_forward(prior, pcfg, cond, target, **draws)
        grads0 = dict(zip([n for n, _ in prior.named_parameters()],
                          torch.autograd.grad(loss0, list(prior.parameters()))))
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(prior).to(dev)
        tx = prior_lib.make_optimizer(1e-3, warmup_steps=1)
        st = tx.init(m)
        mv = lambda v: v.to(dev) if torch.is_tensor(v) else tuple(x.to(dev) for x in v)  # noqa: E731
        losses = [float(prior_lib.train_step(m, pcfg, tx, st, {k: mv(v) for k, v in cond.items()},
                                             target.to(dev), **{k: v.to(dev) for k, v in draws.items()}))
                  for _ in range(2)]
        pres[dev] = (losses, m)
    out["prior_step_loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(pres["cuda"][0],
                                                                         pres["cpu"][0]))
    # Adam moves each element by about lr whatever its gradient's size: where the
    # gradient is float32 noise (the attention keys' bias, to which softmax is
    # blind) the two devices may step either way, so such elements are held
    # within lr, the rest within float32 rounding (tests/test_torch_prior_train.py)
    pgp = dict(pres["cuda"][1].named_parameters())
    strong_max = all_max = 0.0
    for n, p in pres["cpu"][1].named_parameters():
        d = (pgp[n].detach().cpu() - p.detach()).abs()
        gn = grads0[n].abs()
        strong = gn > 1e-4 * gn.max().clamp_min(1e-30)
        lim = 1e-6 + 1e-6 * p.detach().abs().max().item()
        strong_max = max(strong_max, (d[strong].max().item() if strong.any() else 0.0) / lim)
        all_max = max(all_max, d.max().item() / (1e-3 + lim))
    out["prior_step_param_strong_of_limit"] = strong_max
    out["prior_step_param_max_of_lr"] = all_max
    bad = [k for k in ("pnp_step_rel", "faceid_unet_rel", "lora_step_loss_rel", "prior_step_loss_rel")
           if not out[k] <= TINY_REL]
    if (bad or out["lora_step_param_max_of_lr"] > 0.1 or out["lora_step_param_mean_of_lr"] > 1e-4
            or not out["lora_step_frozen_unchanged"] or out["prior_step_param_max_of_lr"] > 1.0
            or out["prior_step_param_strong_of_limit"] > 1.0):
        failures.append(f"tiny slice-12 checks, card vs CPU: {out}")
    log("tiny fp32, card vs CPU: " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                                              for k, v in out.items()) + f" (limit {TINY_REL})")
    return out


# ------------------------------------------------------------------ slice 13

STAGED_BUDGET = 12.5e9  # bytes: the JAX staged boot's default, below the 17.61 GiB of weights
MPT_PREFILL = 512  # MPT-7B prompt tokens
MPT_DECODE = 32  # cached decode steps after it
VQ_BATCH = 4  # VQ-GAN f16 images of 256^2 per step
MEL_FRAMES = 848  # the SpecVQGAN mel: 80 bins x 848 frames (10 s at 22.05 kHz, hop 256, trimmed)
RESIDENT_EDIT: dict = {}  # phase_edit's and phase_serve's images, tokens and counts, on the host


def _same_images(a, b):
    """(bit-identical, max |a - b| in uint8 levels)."""
    import numpy as np

    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return bool(d.max() == 0), int(d.max())


def phase_staged(root, cfg, failures):
    """After the resident pipeline is freed: the same tree booted into a
    `StagedParams` store under STAGED_BUDGET (`loaders.staged_models_from_root`),
    the same seeded `forward_llm` and `__call__` as phase_edit (tokens
    identical, images bit-identical to the resident run's), the store's
    evictions and swaps; then phase_serve's requests through `PipelineServer`
    over the staged pipeline (the UNet resolved from the store per batch;
    images bit-identical to the resident server's); then the same
    `forward_llm` once more on the int4 LLM restaged from the host (tokens
    identical, K2 128 launches per step, all mma)."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch import loaders, serving
    from instructany2pix_tpu_torch.core.dtypes import DEFAULT
    from instructany2pix_tpu_torch.core.staging import tree_device_bytes
    from instructany2pix_tpu_torch.pipeline import InstructAny2PixPipeline

    card = card_line()
    ref = RESIDENT_EDIT
    out = {"budget_bytes": STAGED_BUDGET, "card": card, "paths": {}}
    if "images" not in ref or "served" not in ref:
        failures.append("staged edit: the resident edit or server left no outputs to compare with")
        return out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    store = loaders.staged_models_from_root(cfg, root, quant_bits=4, dtype=DEFAULT.param_dtype,
                                            budget_bytes=STAGED_BUDGET)
    pipe = InstructAny2PixPipeline(cfg, ckpt=root, llm_quant_bits=4, models=store)
    torch.cuda.synchronize()
    out["boot_seconds"] = time.time() - t0  # tokenizers, SAM, GroundingDINO; groups load lazily
    per_step = 4 * cfg.llm.llama.num_layers
    steps = ref["decode_steps"]
    try:
        with tempfile.TemporaryDirectory() as d:
            png, wav = _write_media(d)
            media = [{"type": "image", "fname": png}, {"type": "audio", "fname": wav}]
            inst = "Put the sound of <video> into the picture <video> and draw it."
            k1_llm, k2 = ref["forward_llm_k1"], per_step * steps
            _, c, dt = counted("staged forward_llm", lambda: pipe.forward_llm(
                inst, media, generator=torch.Generator("cuda").manual_seed(0)),
                {"k1": k1_llm, "k1_by_path": {"wgmma": k1_llm}, "k2": k2, "k2_by_path": {"mma": k2}},
                failures)
            out["paths"]["staged_forward_llm"] = c
            tokens = pipe.last_generate.tokens[0, :steps + 1].tolist()
            out.update({"forward_llm_seconds": dt, "tokens_identical": tokens == ref["tokens"],
                        "after_llm": {k: store.stats[k] for k in ("swaps", "swap_bytes")}})
            rs = np.random.RandomState(7)
            d_img = cfg.llm.image_codec_dim
            pipe.cache = (rs.randn(1, d_img).astype(np.float32), rs.randn(d_img).astype(np.float32),
                          " a cat in an antique shop", png,
                          dict(all_objs=[], extra_embeds=np.zeros((0, d_img), np.float32),
                               extra_idx=[]))
            pipe.stage_times = {}
            (non_refined, refined, msg), c, dt = counted(
                "staged __call__", lambda: pipe(inst, media, num_inference_steps=EDIT_STEPS,
                                                refinement=0.5, seed=1, use_cache=True),
                {"k1": ref["call_k1"], "k1_by_path": {"wgmma": ref["call_k1"]}}, failures)
            out["paths"]["staged_edit_call"] = c
            pipe.cache = None
            same = [_same_images(a, b) for a, b in zip((non_refined, refined), ref["images"])]
            out.update({"call_seconds": dt, "call_stage_seconds": dict(pipe.stage_times),
                        "images_identical": [x[0] for x in same],
                        "images_max_levels": [x[1] for x in same], "msg": msg})
            pipe.stage_times = None
            st = store.stats
            out.update({"evictions": list(st["evictions"]), "swaps": st["swaps"],
                        "swap_s": st["swap_s"], "swap_bytes": st["swap_bytes"],
                        "evict_s": st["evict_s"], "load_s": dict(st["load_s"]),
                        "live_groups_gib": {k: v / 2**30 for k, v in store.live_groups().items()},
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "budget_gib": STAGED_BUDGET / 2**30,
                        # every group's bytes, live or on the host: the first build of the
                        # largest runs on top of a full budget
                        "group_gib": {n: tree_device_bytes(m) / 2**30 for n, m in
                                      {**{n: m for n, (m, _) in store._host.items()},
                                       **store._live}.items()}})
            ok = (out["tokens_identical"] and all(out["images_identical"]) and msg == "SUCCESS!"
                  and len(st["evictions"]) > 0)
            if not ok:
                failures.append(f"staged edit: tokens identical {out['tokens_identical']}, images "
                                f"identical {out['images_identical']} (max levels "
                                f"{out['images_max_levels']}), msg {msg!r}, evictions "
                                f"{st['evictions']}, swaps {st['swaps']}")
            log(f"staged edit (budget {STAGED_BUDGET:.3g} B = {out['budget_gib']:.2f} GiB): "
                f"forward_llm {out['forward_llm_seconds']:.3f} s, tokens identical to the resident "
                f"run {out['tokens_identical']}; __call__ {dt:.3f} s ("
                + ", ".join(f"{k} {v:.3f}" for k, v in out["call_stage_seconds"].items())
                + f"), images bit-identical {out['images_identical']}; evictions "
                f"{len(st['evictions'])} {st['evictions']}, swaps {st['swaps']}, swap_s "
                f"{st['swap_s']:.3f}, swap_bytes {st['swap_bytes'] / 1e9:.3f} GB, evict_s "
                f"{st['evict_s']:.3f}; first loads " + ", ".join(
                    f"{k} {v:.2f}" for k, v in st["load_s"].items())
                + f" s; peak {out['peak_gib']:.2f} GiB allocated against the "
                f"{out['budget_gib']:.2f} GiB budget (SAM and GroundingDINO resident outside "
                f"it); groups " + ", ".join(f"{k} {v:.2f}" for k, v in out["group_gib"].items())
                + f" GiB [{card}]")

            # ---- phase_serve's 4 edits and caption-only request over the staged pipeline
            server = serving.PipelineServer(pipe, max_batch=SERVE_BATCH, max_wait_s=0.5)
            edits, caption_only, server._llm_stage = _served_edits(
                {"type": "image", "fname": png}, d_img)
            blocks = ref["blocks"]
            k1 = EDIT_STEPS * 5 * blocks["unet"] + int(50 * 0.5) * 2 * blocks["refiner"]
            ev0 = len(store.stats["evictions"])
            sw0 = {k: store.stats[k] for k in ("swaps", "swap_s", "swap_bytes")}
            try:
                results, c, dt = counted(
                    "staged serve", lambda: [f.result(timeout=900) for f in
                                             [server.submit(r) for r in edits + [caption_only]]],
                    {"k1": k1, "k1_by_path": {"wgmma": k1}}, failures)
            finally:
                server.stop()
            out["paths"]["staged_serve"] = c
            same = [_same_images(r.image, a) for r, a in zip(results, ref["served"])]
            out["serve"] = {"seconds": dt, "images_identical": [x[0] for x in same],
                            "images_max_levels": [x[1] for x in same],
                            "caption_only_none": results[4].image is None,
                            "evictions": store.stats["evictions"][ev0:],
                            **{k: store.stats[k] - v for k, v in sw0.items()},
                            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            if not (all(out["serve"]["images_identical"]) and results[4].image is None):
                failures.append(f"staged serve: images bit-identical to the resident server's "
                                f"{out['serve']['images_identical']} (max levels "
                                f"{out['serve']['images_max_levels']}), caption-only None "
                                f"{results[4].image is None}")
            log(f"staged serve (phase_serve's 4 edits + 1 caption-only, batch {SERVE_BATCH}, "
                f"{EDIT_STEPS} + {EDIT_STEPS} steps, refiner 25 of 50): {dt:.3f} s, images "
                f"bit-identical to the resident server's {out['serve']['images_identical']}, "
                f"evictions while serving {out['serve']['evictions']}, swaps "
                f"{out['serve']['swaps']} ({out['serve']['swap_bytes'] / 1e9:.3f} GB in "
                f"{out['serve']['swap_s']:.3f} s), peak {out['serve']['peak_gib']:.2f} GiB [{card}]")

            # ---- forward_llm again on the int4 LLM restaged from the host
            if "llm" in store.live_groups():
                store.evict("llm")
            sw0 = {k: store.stats[k] for k in ("swaps", "swap_s", "swap_bytes")}
            _, c, dt = counted("staged forward_llm, LLM restaged", lambda: pipe.forward_llm(
                inst, media, generator=torch.Generator("cuda").manual_seed(0)),
                {"k1": k1_llm, "k1_by_path": {"wgmma": k1_llm}, "k2": k2, "k2_by_path": {"mma": k2}},
                failures)
            out["paths"]["staged_forward_llm_restaged"] = c
            again = pipe.last_generate.tokens[0, :steps + 1].tolist()
            out["restaged_llm"] = {"seconds": dt, "tokens_identical": again == ref["tokens"],
                                   "llm_live": "llm" in store.live_groups(),
                                   **{k: store.stats[k] - v for k, v in sw0.items()}}
            r = out["restaged_llm"]
            if not (r["tokens_identical"] and r["llm_live"] and r["swaps"] > 0):
                failures.append(f"staged forward_llm on the restaged LLM: {r}")
            log(f"staged forward_llm on the LLM restaged from the host: {dt:.3f} s, tokens "
                f"identical to the resident run {r['tokens_identical']}, swaps {r['swaps']} "
                f"({r['swap_bytes'] / 1e9:.3f} GB in {r['swap_s']:.3f} s) [{card}]")
    finally:
        del pipe, store
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_codecs(feats_dir, failures):
    """The codec layer at full width: `build_vae("vq-npz")` and `VQVAE` over
    the features `phase_finetune_tree` wrote; `ClipVisionCodec` at ViT-H/14
    (random bf16, batch 2: 32 K1 launches, all wgmma, within K1's limit
    carried through the tower); the VQ-GAN f16 at 256^2 (encode, quantize,
    decode, then one generator and one discriminator step with Adam (0.5,
    0.9): finite losses, every trainable weight moved); SpecVQGAN's 1D VQ
    model on an 80 x 848 mel, the MelGAN vocoder and LPAPS. Float32 for the
    conv codecs (TF32 off, as the whole script)."""
    import os

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.codecs import audio as audio_lib
    from instructany2pix_tpu_torch.codecs import builder
    from instructany2pix_tpu_torch.codecs import vqgan as vq_lib
    from instructany2pix_tpu_torch.codecs import vqgan_train as gan_lib
    from instructany2pix_tpu_torch.diffusion import ip_adapter as ipa
    from instructany2pix_tpu_torch.models import clip as clip_lib
    from instructany2pix_tpu_torch.models import layers as L

    card = card_line()
    out = {"card": card, "paths": {}}

    def build(make, dtype, seed):
        with torch.device("meta"):
            m = make()
        return L.init_(L.materialize(m, torch.device("cuda"), dtype),
                       torch.Generator("cuda").manual_seed(seed)).eval().requires_grad_(False)

    # ---- vq-npz over the prepared features
    files = sorted(f for f in os.listdir(feats_dir) if f.endswith(".npz"))
    vae = builder.VQVAE("vq-npz", "vq-npz")
    states = np.stack([vae.processor(os.path.join(feats_dir, f), "image") for f in files])
    enc = vae({"image": states, "audio": states})
    npz_ok = (len(files) > 0 and vae.embed_dim_image == vae.embed_dim_audio == 1024
              and states.shape[-1] == 1024 and np.isfinite(states).all()
              and all(enc[k][0] is states and enc[k][1] is None for k in ("image", "audio")))
    out["vq_npz"] = {"files": len(files), "shape": list(states.shape), "ok": npz_ok}
    if not npz_ok:
        failures.append(f"vq-npz: {len(files)} feature files, states {states.shape}, passthrough "
                        f"{npz_ok}")
    log(f"vq-npz: {len(files)} prepared feature files read by NpzLoader, states "
        f"{list(states.shape)}, TensorLoader passthrough for both modalities: {npz_ok}")

    # ---- ClipVisionCodec at ViT-H/14
    vcfg = clip_lib.CLIPVisionConfig.vit_h()
    vision = build(lambda: clip_lib.CLIPVision(vcfg), torch.bfloat16, 11)
    codec = builder.ClipVisionCodec(params=vision, cfg=vcfg)
    rs = np.random.RandomState(12)
    imgs = [rs.randint(0, 256, (300, 400, 3)).astype(np.uint8),
            rs.randint(0, 256, (512, 384, 3)).astype(np.uint8)]
    with torch.inference_mode():
        pixels = ipa.preprocess_clip_image(imgs, vcfg.image_size)
        codec.encode_seq(pixels)  # warm
        (emb, _, _), c, _ = counted("ClipVisionCodec encode", lambda: codec.encode_seq(pixels),
                                    {"k1": vcfg.num_layers,
                                     "k1_by_path": {"wgmma": vcfg.num_layers}}, failures)
        out["paths"]["codec_clip_encode"] = c
        plain = clip_lib.vision_apply(vision, pixels, vcfg, impl="xla")["image_embeds"].float()
        moved = _with_limit_moves(clip_lib, lambda: clip_lib.vision_apply(
            vision, pixels, vcfg, impl="xla")["image_embeds"].float())
        got = emb[..., 0, 0].float()
        allowed = (moved - plain).abs().max().item()
        of_limit = (got - plain).abs().max().item() / allowed
        ms = time_ms(lambda: codec.encode_seq(pixels), 5)
    out["clip_codec"] = {"shape": list(emb.shape), "of_limit": of_limit, "ms": ms,
                         "max_abs_err": (got - plain).abs().max().item()}
    if not (list(emb.shape) == [2, vcfg.projection_dim, 1, 1] and of_limit <= 1.0
            and bool(torch.isfinite(got).all())):
        failures.append(f"ClipVisionCodec: embeds {list(emb.shape)}, {of_limit:.3g} of K1's limit "
                        f"carried through the tower")
    log(f"ClipVisionCodec (ViT-H/14, bf16, batch 2): {ms:.2f} ms per encode_seq, embeds "
        f"{list(emb.shape)}, {of_limit:.3f} of K1's limit carried through the tower [{card}]")
    del vision, codec
    torch.cuda.empty_cache()

    # ---- the VQ-GAN f16 at 256^2: encode, quantize, decode, then a GAN step
    cfg = vq_lib.VQConfig.image_f16()
    dcfg = gan_lib.DiscConfig()
    vq = build(lambda: vq_lib.VQModel(cfg), torch.float32, 21)
    disc = build(lambda: gan_lib.Discriminator(dcfg), torch.float32, 22)
    gen = torch.Generator("cuda").manual_seed(23)
    x = torch.rand((VQ_BATCH, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
    res = {}

    def code():
        with torch.no_grad():
            z = vq_lib.encode_z(vq, x, cfg)
            zq, idx, _ = vq_lib.quantize(vq, z)
            return z, idx, vq_lib.decode_z(vq, zq, cfg)

    code()
    (z, idx, recon), c, res["code_s"] = counted("VQ-GAN f16 encode, quantize, decode", code, {},
                                                failures)
    out["paths"]["vqgan_code"] = c
    vq.requires_grad_(True)
    disc.requires_grad_(True)
    before = {n: p.detach().clone() for n, p in [*vq.named_parameters(prefix="vq"),
                                                 *disc.named_parameters(prefix="disc")]}
    opt_g = torch.optim.Adam(vq.parameters(), lr=1e-4, betas=(0.5, 0.9))
    opt_d = torch.optim.Adam(disc.parameters(), lr=1e-4, betas=(0.5, 0.9))

    def step():
        loss_g, aux = gan_lib.vqgan_generator_loss(vq, disc, x, 0, cfg, dcfg, disc_start=0)
        opt_g.zero_grad(set_to_none=True)
        loss_g.backward()
        opt_g.step()
        loss_d, _ = gan_lib.vqgan_discriminator_loss(disc, vq, x, 0, cfg, dcfg, disc_start=0)
        opt_d.zero_grad(set_to_none=True)
        loss_d.backward()
        opt_d.step()
        return loss_g.item(), loss_d.item(), aux["g_loss"].item()

    torch.cuda.reset_peak_memory_stats()
    (loss_g, loss_d, g_loss), c, res["step_s"] = counted("VQ-GAN f16 generator + discriminator "
                                                         "step", step, {}, failures)
    out["paths"]["vqgan_train"] = c
    still = [n for n, p in [*vq.named_parameters(prefix="vq"), *disc.named_parameters(prefix="disc")]
             if torch.equal(p.detach(), before[n])]
    res.update({"z": list(z.shape), "indices": list(idx.shape), "recon": list(recon.shape),
                "codes_used": int(idx.unique().numel()), "loss_g": loss_g, "loss_d": loss_d,
                "g_loss": g_loss, "unmoved": still, "weights": len(before),
                "params_m": sum(p.numel() for p in vq.parameters()) / 1e6,
                "disc_params_m": sum(p.numel() for p in disc.parameters()) / 1e6,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    out["vqgan"] = res
    ok = (res["z"] == [VQ_BATCH, 16, 16, cfg.embed_dim] and res["recon"] == [VQ_BATCH, 256, 256, 3]
          and bool(torch.isfinite(recon).all()) and all(np.isfinite([loss_g, loss_d]))
          and not still)
    if not ok:
        failures.append(f"VQ-GAN f16: z {res['z']}, recon {res['recon']}, losses "
                        f"{loss_g}/{loss_d}, weights that did not move {still}")
    log(f"VQ-GAN f16 at 256^2, batch {VQ_BATCH}, float32 ({res['params_m']:.1f} M + disc "
        f"{res['disc_params_m']:.1f} M parameters): encode, quantize, decode {res['code_s']:.3f} s "
        f"(z {res['z']}, {res['codes_used']} codes used); one generator + one discriminator step "
        f"{res['step_s']:.3f} s, losses {loss_g:.4f} / {loss_d:.4f} (adversarial "
        f"{g_loss:.4f}), {len(before) - len(still)} of {len(before)} weights moved, peak "
        f"{res['peak_gib']:.2f} GiB [{card}]")
    del vq, disc, opt_g, opt_d, before, x, z, idx, recon
    torch.cuda.empty_cache()

    # ---- SpecVQGAN's 1D VQ model, the MelGAN vocoder and LPAPS on an 80 x 848 mel
    acfg, voc_cfg, lp_cfg = audio_lib.VQ1DConfig(), audio_lib.VocoderConfig(), audio_lib.LPAPSConfig()
    vq1 = build(lambda: audio_lib.VQ1D(acfg), torch.float32, 24)
    voc = build(lambda: audio_lib.Vocoder(voc_cfg), torch.float32, 25)
    with torch.device("meta"):
        lp = audio_lib.LPAPS(lp_cfg)
    lp = audio_lib.lpaps_init_(L.materialize(lp, torch.device("cuda"), torch.float32),
                               torch.Generator("cuda").manual_seed(26)).eval()
    mel = torch.rand((1, MEL_FRAMES, acfg.in_channels), generator=gen, device="cuda") * 2 - 1
    codec1 = audio_lib.VQ1DCodec(vq1, acfg)

    def audio():
        with torch.no_grad():
            zq, idx1, n = codec1.encode_seq(mel)
            rec = codec1.decode_seq(idx1)
            wav = audio_lib.vocoder_apply(voc, rec, voc_cfg)
            dist = audio_lib.lpaps_loss(lp, mel.transpose(1, 2), rec.transpose(1, 2))
            return zq, idx1, rec, wav, dist

    audio()
    (zq, idx1, rec, wav, dist), c, a_s = counted("VQ1D + MelGAN + LPAPS", audio, {}, failures)
    out["paths"]["audio_codecs"] = c
    out["audio"] = {"seconds": a_s, "codes": list(idx1.shape), "mel": list(rec.shape),
                    "wav": list(wav.shape), "lpaps": dist.tolist()}
    ok = (list(idx1.shape) == [1, MEL_FRAMES // 4] and list(rec.shape) == list(mel.shape)
          and list(wav.shape) == [1, MEL_FRAMES * voc_cfg.hop_length]
          and all(bool(torch.isfinite(t).all()) for t in (rec, wav, dist))
          and float(dist.min()) >= 0)
    if not ok:
        failures.append(f"audio codecs: codes {list(idx1.shape)}, mel {list(rec.shape)}, wav "
                        f"{list(wav.shape)}, LPAPS {dist.tolist()}")
    log(f"VQ1D (80 x {MEL_FRAMES} mel -> {idx1.shape[1]} codes -> mel), MelGAN vocoder -> "
        f"{wav.shape[1]} samples, LPAPS {dist.tolist()}: {a_s:.3f} s, float32 [{card}]")
    del vq1, voc, lp
    torch.cuda.empty_cache()
    return out


def phase_mpt(failures):
    """MPT-7B (`MPTConfig.mpt_7b()`, bf16, random from a seed): a prefill of
    MPT_PREFILL tokens and MPT_DECODE cached decode steps against one full
    forward over all the tokens. The limit is twice the bf16 full forward's
    largest distance from the same forward in float32 (the model cast after
    the bf16 runs): two bf16 computations of the same logits, each that far
    from float32 at most, differ by at most twice it."""
    import numpy as np
    import torch

    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.models import mpt as mpt_lib

    card = card_line()
    cfg = mpt_lib.MPTConfig.mpt_7b()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.device("meta"):
        m = mpt_lib.MPT(cfg)
    t0 = time.time()
    m = mpt_lib.init_(L.materialize(m, torch.device("cuda"), torch.bfloat16),
                      torch.Generator("cuda").manual_seed(31)).eval().requires_grad_(False)
    torch.cuda.synchronize()
    out = {"card": card, "init_seconds": time.time() - t0, "paths": {},
           "weights_gib": _weight_bytes(m) / 2**30}
    n = MPT_PREFILL + MPT_DECODE
    ids = torch.as_tensor(np.random.RandomState(32).randint(0, cfg.vocab_size, (1, n)),
                          device="cuda")

    def cached():
        cache = mpt_lib.init_cache(cfg, 1, n, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = mpt_lib.forward(m, cfg, input_ids=ids[:, :MPT_PREFILL], cache=cache)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        logits, step_ms = [o["logits"].float()], []
        for t in range(MPT_PREFILL, n):
            t0 = time.perf_counter()
            o = mpt_lib.forward(m, cfg, input_ids=ids[:, t:t + 1], cache=o["cache"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(o["logits"].float())
        return torch.cat(logits, dim=1), prefill_ms, step_ms, o["cache"].length

    with torch.inference_mode():
        cached()  # warm
        (inc, prefill_ms, step_ms, length), c, cached_s = counted("MPT-7B prefill + cached decode",
                                                                  cached, {}, failures)
        out["paths"]["mpt_decode"] = c
        full = mpt_lib.forward(m, cfg, input_ids=ids)["logits"].float()
        t0 = time.perf_counter()
        mpt_lib.forward(m, cfg, input_ids=ids)
        torch.cuda.synchronize()
        full_ms = (time.perf_counter() - t0) * 1e3
        out["peak_bf16_gib"] = torch.cuda.max_memory_allocated() / 2**30
        m.float()  # the float32 reference: the same weights, cast
        full32 = mpt_lib.forward(m, cfg, input_ids=ids)["logits"]
    limit = 2 * (full - full32).abs().max().item()
    err = (inc - full).abs().max().item()
    err_decode = (inc[:, MPT_PREFILL:] - full[:, MPT_PREFILL:]).abs().max().item()
    argmax_same = float((inc.argmax(-1) == full.argmax(-1)).float().mean())
    step_ms = sorted(step_ms)
    out.update({"prefill_ms": prefill_ms, "decode_step_ms_median": step_ms[len(step_ms) // 2],
                "decode_step_ms_range": [step_ms[0], step_ms[-1]], "full_forward_ms": full_ms,
                "cached_seconds": cached_s, "max_abs_err": err, "max_abs_err_decode": err_decode,
                "limit": limit, "of_limit": err / limit, "argmax_agree": argmax_same,
                "logit_scale": full.abs().max().item(), "cache_length": length})
    del m, full, full32, inc
    torch.cuda.empty_cache()
    ok = (length == n and err <= limit and np.isfinite(err) and np.isfinite(limit))
    if not ok:
        failures.append(f"MPT-7B: cached logits off the full forward by {err:.4g} against a limit "
                        f"of {limit:.4g}, cache length {length} (expected {n})")
    log(f"MPT-7B (bf16, {out['weights_gib']:.2f} GiB, random): prefill {MPT_PREFILL} tokens "
        f"{prefill_ms:.2f} ms, decode step median {out['decode_step_ms_median']:.2f} ms of "
        f"{MPT_DECODE} (min {step_ms[0]:.2f}, max {step_ms[-1]:.2f}), full forward over {n} "
        f"{full_ms:.2f} ms; cached against full logits max |diff| {err:.4g} (decode steps "
        f"{err_decode:.4g}) = {err / limit:.3f} of the limit {limit:.4g} (twice the bf16 full "
        f"forward's distance from float32); argmax agree {argmax_same:.4f} [{card}]")
    return out


def phase_clip_score(failures):
    """`clip_score` at ViT-H/14 (text and vision towers random, bf16) on two
    images and two prompts with the crc32 word tokenizer: finite scores in
    [0, 100]; the vision tower's 32 attentions on K1 (wgmma), the text
    tower's plain."""
    import numpy as np
    import torch

    from instructany2pix_tpu_torch.models import clip as clip_lib
    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.utils import clip_score as cs

    card = card_line()
    tcfg, vcfg = clip_lib.CLIPTextConfig.vit_h(), clip_lib.CLIPVisionConfig.vit_h()
    towers = []
    for make, seed in ((lambda: clip_lib.CLIPText(tcfg), 41), (lambda: clip_lib.CLIPVision(vcfg), 42)):
        with torch.device("meta"):
            m = make()
        towers.append(L.init_(L.materialize(m, torch.device("cuda"), torch.bfloat16),
                              torch.Generator("cuda").manual_seed(seed)).eval()
                      .requires_grad_(False))
    tok = cs._HashWordTokenizer(tcfg.vocab_size, tcfg.eos_token_id)
    rs = np.random.RandomState(43)
    imgs = [rs.randint(0, 256, (480, 640, 3)).astype(np.uint8),
            rs.randint(0, 256, (512, 512, 3)).astype(np.uint8)]
    prompts = ["a photo of a cat in an antique shop", "a red clock on a wooden shelf"]

    def score():
        return cs.clip_score(towers[0], tcfg, tok, towers[1], vcfg, imgs, prompts)

    score()  # warm
    scores, c, dt = counted("clip_score", score, {"k1": vcfg.num_layers,
                                                  "k1_by_path": {"wgmma": vcfg.num_layers}},
                            failures)
    ms = time_ms(score, 3, warmup=0)
    out = {"card": card, "scores": scores.tolist(), "seconds": dt, "ms": ms,
           "paths": {"clip_score": c}}
    if not (scores.shape == (2,) and np.isfinite(scores).all()
            and ((scores >= 0) & (scores <= 100)).all()):
        failures.append(f"clip_score: {scores}")
    log(f"clip_score (ViT-H/14 text and vision, bf16, random; 2 images, 2 prompts): {ms:.2f} ms, "
        f"scores {scores.tolist()}, K1 {c['k1']} {c['k1_by_path']} [{card}]")
    del towers
    torch.cuda.empty_cache()
    return out


class _NoTF32:
    """TF32 off for matmuls and cuDNN while the block runs, restored after."""

    def __enter__(self):
        import torch

        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev


def phase_tiny_slice13(failures):
    """The tiny slice-13 modules in float32 (TF32 off), card against CPU on
    the same weights: the VQ-GAN and the 1D VQ model (code indices
    identical, outputs within TINY_REL), MPT (prefill and cached decode
    logits within TINY_REL); and the tiny edit through a `StagedParams`
    store whose budget evicts between stages, bit-identical on the card to
    the edit without one."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from instructany2pix_tpu_torch.codecs import audio as audio_lib
    from instructany2pix_tpu_torch.codecs import vqgan as vq_lib
    from instructany2pix_tpu_torch.core.dtypes import FP32
    from instructany2pix_tpu_torch.core.staging import StagedParams
    from instructany2pix_tpu_torch.models import layers as L
    from instructany2pix_tpu_torch.models import mpt as mpt_lib
    from instructany2pix_tpu_torch.pipeline import InstructAny2PixPipeline, PipelineConfig

    out = {"paths": {}}

    def pair(make, seed, init=L.init_):
        with torch.device("meta"):
            m = make()
        cpu = init(L.materialize(m, torch.device("cpu"), torch.float32),
                   torch.Generator().manual_seed(seed)).eval().requires_grad_(False)
        return cpu, copy.deepcopy(cpu).cuda()

    with _NoTF32(), torch.no_grad():
        rs = np.random.RandomState(61)
        cfg = vq_lib.VQConfig.tiny()
        cpu, gpu = pair(lambda: vq_lib.VQModel(cfg), 62)
        x = torch.as_tensor(rs.randn(2, 16, 16, 3).astype(np.float32))
        (lc, ac), (lg, ag) = (vq_lib.vq_losses(m, x.to(d), cfg) for m, d in ((cpu, "cpu"), (gpu, "cuda")))
        out["vqgan"] = {"indices_identical": bool(torch.equal(ac["indices"], ag["indices"].cpu())),
                        "recon_rel": _rel(ag["recon"], ac["recon"]), "loss_rel": _rel(lg, lc)}
        acfg = audio_lib.VQ1DConfig.tiny()
        cpu, gpu = pair(lambda: audio_lib.VQ1D(acfg), 63)
        mel = torch.as_tensor(rs.randn(2, 12, acfg.in_channels).astype(np.float32))
        (lc, ac), (lg, ag) = (audio_lib.vq1d_losses(m, mel.to(d), acfg)
                              for m, d in ((cpu, "cpu"), (gpu, "cuda")))
        out["vq1d"] = {"indices_identical": bool(torch.equal(ac["indices"], ag["indices"].cpu())),
                       "recon_rel": _rel(ag["recon"], ac["recon"]), "loss_rel": _rel(lg, lc)}
        mcfg = mpt_lib.MPTConfig.tiny()
        cpu, gpu = pair(lambda: mpt_lib.MPT(mcfg), 64, init=mpt_lib.init_)
        ids = torch.as_tensor(rs.randint(0, mcfg.vocab_size, (2, 12)))
        logits = []
        for m, d in ((cpu, "cpu"), (gpu, "cuda")):
            cache = mpt_lib.init_cache(mcfg, 2, 16, device=d)
            o = mpt_lib.forward(m, mcfg, input_ids=ids[:, :8], cache=cache)
            steps = [o["logits"]]
            for t in range(8, 12):
                o = mpt_lib.forward(m, mcfg, input_ids=ids[:, t:t + 1], cache=o["cache"])
                steps.append(o["logits"])
            logits.append(torch.cat(steps, 1))
        out["mpt"] = {"logits_rel": _rel(logits[1], logits[0])}
    checks = [out["vqgan"]["indices_identical"], out["vq1d"]["indices_identical"]] + [
        v <= TINY_REL for k in ("vqgan", "vq1d", "mpt") for n, v in out[k].items()
        if n.endswith("_rel")]
    if not all(checks):
        failures.append(f"tiny slice 13, card against CPU: {out}")
    log(f"tiny slice 13, card against CPU (float32, TF32 off): VQ-GAN {out['vqgan']}, VQ1D "
        f"{out['vq1d']}, MPT {out['mpt']} (limit {TINY_REL} relative)")

    # ---- the tiny staged edit on the card, against the same edit unstaged
    with _NoTF32(), tempfile.TemporaryDirectory() as d:
        from PIL import Image

        png = f"{d}/img.png"
        Image.fromarray(np.random.RandomState(65).randint(0, 255, (80, 96, 3), np.uint8)).save(png)
        media = [{"type": "image", "fname": png}]
        resident = InstructAny2PixPipeline(PipelineConfig.tiny(), policy=FP32, seed=0)
        store = StagedParams({k: (lambda v=v: copy.deepcopy(v))
                              for k, v in resident.models.items()}, budget_bytes=2048)
        staged = InstructAny2PixPipeline(resident.cfg, policy=FP32, models=store)
        dim = resident.cfg.llm.image_codec_dim
        outs = []
        for pipe in (resident, staged):
            rk = np.random.RandomState(66)
            pipe.cache = (rk.randn(1, dim).astype(np.float32), rk.randn(dim).astype(np.float32),
                          " a caption", png, dict(all_objs=["cat"], extra_embeds=rk.randn(
                              1, dim).astype(np.float32), extra_idx=np.array([0])))
            outs.append(pipe("edit <video>", media, num_inference_steps=2, refinement=0.3,
                             seed=5, use_cache=True, subject_strength=0.3))
            pipe.cache = None
        same = [np.array_equal(a, b) for a, b in zip(outs[0][:2], outs[1][:2])]
        out["staged_edit"] = {"identical": same, "evictions": len(store.stats["evictions"]),
                              "swaps": store.stats["swaps"]}
        del resident, staged, store
    if not (all(same) and out["staged_edit"]["swaps"] > 0):
        failures.append(f"tiny staged edit on the card: {out['staged_edit']}")
    log(f"tiny staged edit on the card (budget 2048 B): images bit-identical to the unstaged edit "
        f"{same}, {out['staged_edit']['evictions']} evictions, {out['staged_edit']['swaps']} swaps")
    return out


# ------------------------------------------------------------------ the mesh (slice 14)

PARALLEL_TIMEOUT_S = 600  # a rank group's whole run, boot included; then it is killed
TP_LLM_ROWS = 2  # the tensor-parallel LLM stage's prompts: phase_serve's first two
TP_EDIT_SEEDS = (1, 2)  # the tensor-parallel diffusion microbatch: phase_serve's first two edits
TP_TEMPERATURE = 0.3  # the server's sampling temperature
RING_SHAPE = (1, 8192, 8, 64)  # (B, S, H, D) of the ring attention check, S over two ranks
RING_TOL = 2e-5  # float32, the sum order of the online softmax (tests/test_ring_attention.py)
TP_GUMBEL_SEED = 77
# decode steps of the TP LLM stage: every step of the two ranks sharing one
# card waits on a gloo round trip between their time-sliced contexts
TP_NEW_TOKENS = 48


def _tp_llm_requests(png, wav, vocab, max_new_tokens):
    """phase_serve's first TP_LLM_ROWS LLM requests with injected Gumbel
    draws, so the resident and the tensor-parallel runs sample from the same
    noise and each step's sampling scores are known."""
    import numpy as np

    from instructany2pix_tpu_torch import serving

    media = ([{"type": "image", "fname": png}], [{"type": "audio", "fname": wav}])
    g = np.random.RandomState(TP_GUMBEL_SEED).gumbel(
        size=(TP_LLM_ROWS, max_new_tokens, vocab)).astype(np.float32)
    return [serving.PipelineRequest(SERVE_INSTS[i], media[i], seed=40 + i, llm_gumbel=g[i])
            for i in range(TP_LLM_ROWS)], g


def _record_logits(run):
    """`run()` with every cached `llama.forward`'s last-position logits
    recorded (CPU float32, one (B, V) per call: the prefill's predicts token
    0, each decode step's the next)."""
    from instructany2pix_tpu_torch.models import llama as llama_lib

    got = []
    orig = llama_lib.forward

    def rec(*a, **kw):
        o = orig(*a, **kw)
        if kw.get("cache") is not None:
            got.append(o["logits"][:, -1].float().cpu())
        return o

    llama_lib.forward = rec
    try:
        result = run()
    finally:
        llama_lib.forward = orig
    return result, got


def _first_divergence(tokens, ref_tokens, done_at, ref_done):
    """[(row, index)] of each row's first differing token within its answer."""
    out = []
    for r in range(ref_tokens.shape[0]):
        n = min(int(max(done_at[r], ref_done[r])) + 1, ref_tokens.shape[1])
        diff = [i for i in range(n) if tokens[r, i] != ref_tokens[r, i]]
        if diff:
            out.append((r, diff[0]))
    return out


def _tie_reading(ref, got_logits, got_tokens, got_done):
    """Tokens against the resident reference: identical, or each row's
    first divergence at a bf16 rounding tie. A flip of the sampled token is
    possible only where the resident's top-2 margin of the sampling scores
    (logits / T + the injected Gumbel draw) is below twice the runs'
    largest score difference at that step."""
    import torch

    div = _first_divergence(got_tokens, ref["tokens"], got_done, ref["done_at"])
    readings = []
    for r, i in div:
        if i >= len(ref["logits"]) or i >= len(got_logits):
            readings.append({"row": r, "index": i, "tie": False, "note": "no logits at the step"})
            continue
        g = torch.from_numpy(ref["gumbel"][r, i])
        s_ref = ref["logits"][i][r] / TP_TEMPERATURE + g
        s_got = got_logits[i][r] / TP_TEMPERATURE + g
        top2 = s_ref.topk(2).values
        margin = float(top2[0] - top2[1])
        diff = float((s_ref - s_got).abs().max())
        readings.append({"row": r, "index": i, "resident_top2_margin": margin,
                         "max_score_difference": diff, "tie": margin < 2 * diff})
    return {"identical": not div, "divergences": readings,
            "ok": all(x["tie"] for x in readings)}


def _tp_server_class():
    """A `PipelineServer` whose LLM stage gives phase_serve's seeded outcomes
    (`_served_edits`) to requests whose instruction starts with "stub:" (a
    random 7B asks for no image), and runs for real otherwise."""
    from instructany2pix_tpu_torch import serving

    class TPServer(serving.PipelineServer):
        def _llm_stage(self, reqs):
            if reqs[0].inst.startswith("stub:"):
                _, _, stub = _served_edits(None, self.pipe.cfg.llm.image_codec_dim)
                return stub(reqs)
            return super()._llm_stage(reqs)

    return TPServer


def _moved_qmatmul(Q, seed=17):
    """A `qmatmul` whose output moves each element by K2's whole limit
    (QMV_TOL, as `qmv_reading` computes it), the signs from a seeded
    generator: running a layer through it carries K2's limit through."""
    import torch

    orig = Q.qmatmul
    gen = torch.Generator("cuda").manual_seed(seed)

    def moved(x, q, norm_g=None, norm_eps=1e-6, swiglu=False, residual=None):
        y = orig(x, q, norm_g, norm_eps, swiglu, residual)
        x2 = x.reshape(-1, x.shape[-1])
        h = Q._prologue(x2, norm_g, norm_eps, swiglu).float()
        wd = _dequant(q)
        sigma = torch.sqrt((h * h) @ (wd * wd))
        a = h.abs() @ wd.abs()
        y2 = y.reshape(sigma.shape).float()
        lim = QMV_TOL["ulp"] * y2.abs() + QMV_TOL["stol"] * sigma + QMV_TOL["atol"] * a
        sign = torch.randint(0, 2, lim.shape, generator=gen, device=lim.device) * 2 - 1
        return (y2 + sign * lim).to(y.dtype).reshape(y.shape)

    return orig, moved


def _carried_reading(y_tp, y_1, y_moved):
    """The sharded output against the unsharded one, each element within
    the carried limit (the largest move that shifting every kernel output
    by its whole limit gives the unsharded output) plus one bf16 rounding
    of that element (2^-8 |y|: both runs round their last sum apart)."""
    import torch

    a, b = y_tp.float(), y_1.float()
    spread = (y_moved.float() - b).abs().max().item()
    limit = spread + 2.0**-8 * b.abs()
    d = (a - b).abs()
    return {"max_abs_diff": d.max().item(), "carried_limit": spread,
            "of_limit": (d / limit).max().item(), "finite": bool(torch.isfinite(a).all()),
            "ok": bool((d <= limit).all())}


def _tp_layer_checks(pipe, layer_ref, block_ref, mesh):
    """One full-width decoder layer and one SDXL transformer block computed
    by this rank's shards (both ranks in lock-step) against the unsharded
    copies on the same card: each difference as a share of the spread that
    moving every K2 (the layer) or K1 (the block) output by its whole limit
    gives the unsharded copy (`_with_limit_moves`)."""
    import collections

    import torch

    from instructany2pix_tpu_torch.models import llama as llama_lib
    from instructany2pix_tpu_torch.models import unet as unet_lib
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.parallel import sharding as sh

    out = {}
    lcfg = pipe.cfg.llm.llama
    g = torch.Generator("cuda").manual_seed(5)
    x = (torch.randn((2, 1, lcfg.hidden_size), generator=g, device="cuda")).bfloat16()
    rope = llama_lib._rope_tables(torch.zeros((2, 1), device="cuda"), lcfg.head_dim // 2,
                                  lcfg.rope_theta)
    layer_tp = pipe.models["llm"].llama.layer_0
    with torch.inference_mode():
        Q.reset_qmv_counts()
        with sh.tp_activation_constraints(mesh):
            y_tp = llama_lib._block(layer_tp, x, lcfg, None, rope)
        out["layer_k2_by_path"] = dict(Q.qmv_cuda.launches_by_path)
        y_1 = llama_lib._block(layer_ref, x, lcfg, None, rope)
        orig, moved = _moved_qmatmul(Q)
        Q.qmatmul = moved
        try:
            y_mv = llama_lib._block(layer_ref, x, lcfg, None, rope)
        finally:
            Q.qmatmul = orig
    out["layer"] = _carried_reading(y_tp, y_1, y_mv)

    ucfg = pipe.cfg.unet
    block_tp = pipe.models["unet"].down_1["attn_0"].block_0
    dim, heads = ucfg.block_out_channels[1], ucfg.num_attention_heads[1]
    xb = torch.randn((2, 4096, dim), generator=g, device="cuda").bfloat16()
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=g, device="cuda").bfloat16()
    seen = collections.Counter()
    attn = unet_lib.dot_product_attention

    def recording(q, k, v, **kw):
        seen[(tuple(q.shape), k.shape[1])] += 1
        return attn(q, k, v, **kw)

    with torch.inference_mode():
        reset_k1(fa)
        unet_lib.dot_product_attention = recording
        try:
            with sh.tp_activation_constraints(mesh):
                b_tp = unet_lib._tblock(block_tp, xb, ctx, heads, None, 1.0)
        finally:
            unet_lib.dot_product_attention = attn
        out["block_k1_launches"] = fa.flash_fwd_cuda.launches
        out["block_k1_by_path"] = dict(fa.flash_fwd_cuda.launches_by_path)
        out["block_attention_shapes"] = [[list(s), sk, n] for (s, sk), n in seen.items()]
        b_1 = unet_lib._tblock(block_ref, xb, ctx, heads, None, 1.0)
        b_mv = _with_limit_moves(unet_lib, lambda: unet_lib._tblock(block_ref, xb, ctx, heads,
                                                                      None, 1.0))
    out["block"] = _carried_reading(b_tp, b_1, b_mv)
    return out


def _rank_serve(job, mesh):
    """Rank body of phase_parallel's (a) and (c): the full-width pipeline
    booted from the tree, sharded by `PipelineServer` over the (1, 2) mesh;
    the LLM stage on TP_LLM_ROWS prompts and a microbatch of edits served
    through rank 0's scheduler; the layer checks; one CFG UNet step's
    collectives; ring attention over the two ranks."""
    import collections
    import copy
    import gc

    import torch

    from instructany2pix_tpu_torch.diffusion import sampler as sampler_lib
    from instructany2pix_tpu_torch.models import unet as unet_lib
    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.parallel import collectives as C
    from instructany2pix_tpu_torch.parallel import ring_attention as ring_lib
    from instructany2pix_tpu_torch.parallel import sharding as sh
    from instructany2pix_tpu_torch import serving
    from instructany2pix_tpu_torch.pipeline import InstructAny2PixPipeline

    out = {"rank": mesh.rank, "mesh": [mesh.n_data, mesh.n_model], "backend": mesh.backend}

    def reset():
        reset_k1(fa)
        reset_k3(fa)
        Q.reset_qmv_counts()
        reset_k4(fa)
        C.reset_counts()

    def counts():
        return {"k1": fa.flash_fwd_cuda.launches, "k1_by_path": dict(fa.flash_fwd_cuda.launches_by_path),
                "k2": Q.qmv_cuda.launches, "k2_by_path": dict(Q.qmv_cuda.launches_by_path),
                "k3": fa.flash_relpos2d_cuda.launches, "k4": fa.flash_bwd_cuda.launches,
                "k4a": fa.flash_bwd_dq_cuda.launches, "k4b": fa.flash_bwd_dkv_cuda.launches,
                "collectives": C.counts()}

    cfg = _full_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pipe = InstructAny2PixPipeline(cfg, ckpt=job["root"], llm_quant_bits=4, mesh=mesh)
    torch.cuda.synchronize()
    out["boot_seconds"] = time.time() - t0
    out["boot_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    layer_ref = copy.deepcopy(pipe.models["llm"].llama.layer_0)
    block_ref = copy.deepcopy(pipe.models["unet"].down_1["attn_0"].block_0)
    vocab = cfg.llm.llama.vocab_size
    if mesh.rank == 0:
        # the reference: the same LLM stage on this rank's whole, unsharded
        # model (the TP layout's weights: o and down at int8, unfused)
        ref_server = serving.PipelineServer(pipe, max_batch=TP_LLM_ROWS, max_new_tokens=TP_NEW_TOKENS)
        try:
            reqs, g = _tp_llm_requests(job["png"], job["wav"], vocab, ref_server.max_new_tokens)
            reset()
            _, logits = _record_logits(lambda: ref_server._llm_stage(reqs))
            gen = ref_server.last_generate
            out["ref"] = {"tokens": gen.tokens.cpu().numpy(), "done_at": gen.done_at.cpu().numpy(),
                          "logits": logits, "gumbel": g, "counts": counts()}
        finally:
            ref_server.stop()
        del ref_server
    server = _tp_server_class()(pipe, mesh=mesh, max_batch=TP_LLM_ROWS, max_wait_s=1.0,
                                max_new_tokens=TP_NEW_TOKENS)
    gc.collect()
    torch.cuda.empty_cache()
    out["weights_gib"] = sum(_weight_bytes(m) for m in pipe.models.values()) / 2**30
    out["resident_gib"] = torch.cuda.memory_allocated() / 2**30
    out["formats"] = {n: str(getattr(pipe.models["llm"].llama.layer_0, n))
                      for n in ("q", "o", "gate", "down")}
    out["kinds"] = collections.Counter(getattr(m, "tp", None) for m in pipe.models["unet"].modules()
                                       if getattr(m, "tp", None))
    out["tblocks"] = {n: sum(isinstance(m, unet_lib.TBlock) for m in pipe.models[n].modules())
                      for n in ("unet", "refiner")}
    out["llm_kinds"] = collections.Counter(getattr(m, "tp", None)
                                           for m in pipe.models["llm"].llama.modules()
                                           if getattr(m, "tp", None))

    heads = collections.Counter()
    attn = unet_lib.dot_product_attention

    def recording(q, k, v, **kw):
        heads[(q.shape[2], q.shape[1])] += 1
        return attn(q, k, v, **kw)

    if mesh.rank != 0:
        unet_lib.dot_product_attention = recording
        try:
            reset()
            server.wait(timeout=PARALLEL_TIMEOUT_S)
            out["serve_counts"] = counts()
        finally:
            unet_lib.dot_product_attention = attn
    else:
        image = {"type": "image", "fname": job["png"]}
        edits, _, _ = _served_edits(image, cfg.llm.image_codec_dim)
        edits = [e for e in edits if e.seed in TP_EDIT_SEEDS]
        for e in edits:
            e.inst = "stub: " + e.inst
        try:
            # ---- the LLM stage for real on TP_LLM_ROWS prompts
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            pipe.stage_times = {}
            t0 = time.time()
            results, logits = _record_logits(
                lambda: [f.result(timeout=PARALLEL_TIMEOUT_S) for f in [server.submit(r) for r in reqs]])
            torch.cuda.synchronize()
            out["llm_seconds"] = time.time() - t0
            out["llm_stage_seconds"] = dict(pipe.stage_times)
            out["llm_counts"] = counts()
            gen = server.last_generate
            out["llm_tokens"] = gen.tokens.cpu().numpy()
            out["llm_done_at"] = gen.done_at.cpu().numpy()
            out["llm_logits"] = logits
            out["llm_captions"] = [r.caption[:60] for r in results]
            out["llm_decode_steps"] = min(int(gen.done_at.max()), gen.tokens.shape[1] - 1)
            # ---- the diffusion stages: a microbatch of edits, the LLM stage stubbed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            pipe.stage_times = {}
            unet_lib.dot_product_attention = recording
            t0 = time.time()
            try:
                served = [f.result(timeout=PARALLEL_TIMEOUT_S) for f in [server.submit(r) for r in edits]]
                torch.cuda.synchronize()
            finally:
                unet_lib.dot_product_attention = attn
            out["serve_seconds"] = time.time() - t0
            out["serve_stage_seconds"] = dict(pipe.stage_times)
            out["serve_counts"] = counts()
            out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            out["images"] = [r.image for r in served]
            out["serve_captions"] = [r.caption for r in served]
        finally:
            pipe.stage_times = None
            server.stop()
    out["unet_attention_heads"] = [[h, s, n] for (h, s), n in sorted(heads.items())]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # ---- after the server released every rank: the layer checks in lock-step
    out.update(_tp_layer_checks(pipe, layer_ref, block_ref, mesh))
    del layer_ref, block_ref

    # ---- one CFG UNet step of the microbatch's shape: collectives and time
    with torch.inference_mode(), sh.tp_activation_constraints(mesh):
        b = 2 * len(TP_EDIT_SEEDS)
        ctx_p, pooled_p = pipe._encode_sdxl_prompt("a photo of a cat in an antique shop")
        ctx_n, pooled_n = pipe._encode_sdxl_prompt("")
        tid = sampler_lib.default_time_ids(1024, 1024, b // 2, pipe.device)
        eps_fn = sampler_lib.make_cfg_eps_fn(
            pipe.models["unet"], cfg.unet, ctx_p.expand(b // 2, -1, -1), ctx_n.expand(b // 2, -1, -1),
            pooled_p.expand(b // 2, -1), pooled_n.expand(b // 2, -1), tid, 5.0)
        lat = torch.randn((b // 2, 128, 128, 4), generator=torch.Generator("cuda").manual_seed(3),
                          device="cuda")
        torch.cuda.synchronize()  # the served microbatch warmed this step's shapes
        C.reset_counts()
        t0 = time.time()
        eps_fn(lat, 500, 0)
        torch.cuda.synchronize()
        out["cfg_step_seconds"] = time.time() - t0
        out["cfg_step_collectives"] = C.counts()

    # ---- (c) ring attention over the two ranks against plain attention
    del server, pipe
    gc.collect()
    torch.cuda.empty_cache()
    bq, s, h, d = RING_SHAPE
    g = torch.Generator("cuda").manual_seed(23)
    q, k, v = (torch.randn(RING_SHAPE, generator=g, device="cuda") for _ in range(3))
    n, idx = mesh.n_model, mesh.axis_index("model")
    blk = slice(idx * s // n, (idx + 1) * s // n)
    ring = {}
    for causal in (False, True):
        C.reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        o = ring_lib.ring_attention(q[:, blk], k[:, blk], v[:, blk], mesh, axis="model",
                                    causal=causal)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        counts_ring = C.counts()
        full = C.all_gather(o, 1, mesh.group("model"))
        if mesh.rank != 0:  # rank 0 holds the plain reference
            continue
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t0 = time.time()
        ref = torch.softmax((qt @ kt.transpose(-1, -2)) * d**-0.5
                            + (torch.full((s, s), float("-inf"), device="cuda").triu(1)
                               if causal else 0.0), dim=-1) @ vt
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        ref = ref.transpose(1, 2)
        err = (full - ref).abs().max().item()
        ring[f"causal={causal}"] = {"max_abs_err": err, "ok": err <= RING_TOL, "ms": ms,
                                    "plain_ms": plain_ms, "collectives": counts_ring}
        del full, ref, o
    out["ring"] = ring
    return out


def _rank_train(job, mesh):
    """Rank body of phase_parallel's (b): FSDP2 at world size 1 over NCCL on
    the full-width trainer (phase_train's config and first batch): the first
    step's loss and grad norm against the unsharded step on the same
    weights and batch, and each step's K1 and K4 launches."""
    import copy
    import tempfile

    import torch

    from instructany2pix_tpu_torch.ops import flash_attention as fa
    from instructany2pix_tpu_torch.ops import quant as Q
    from instructany2pix_tpu_torch.train.train_step import TrainConfig, make_train_step

    out = {"rank": mesh.rank, "backend": mesh.backend, "world": mesh.size()}
    with tempfile.TemporaryDirectory() as d:
        cfg, _, first, params = _train_setup(d)
        batch = {k: torch.from_numpy(v).cuda() for k, v in first.items()}
        twin = copy.deepcopy(params)
        tcfg = TrainConfig(total_steps=TRAIN_STEPS)
        for name, mesh_arg, model in (("plain", None, params), ("fsdp", mesh, twin)):
            init_state, step = make_train_step(cfg, tcfg, mesh=mesh_arg)
            state = init_state(model)
            reset_k1(fa)
            reset_k3(fa)
            Q.reset_qmv_counts()
            reset_k4(fa)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            out[name] = {"seconds": time.time() - t0,
                         "metrics": {k: float(v) for k, v in m.items()},
                         "launches": dict(zip(COUNT_KEYS, _counts(fa, Q))),
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            t0 = time.time()  # a second step, warm, for the time
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            out[name]["second_step_seconds"] = time.time() - t0
            if name == "fsdp":
                out["fsdp"]["sharded_params"] = sum(1 for p in model.parameters()
                                                    if hasattr(p, "placements"))
                out["fsdp"]["replicated_params"] = len(model.fsdp_replicated)
            del state
            torch.cuda.empty_cache()
    return out


def _rank_main(kind, rank, world, d):
    """A rank of phase_parallel, started as `chip_smoke.py --rank KIND R W
    DIR`: joins the group through file://DIR/rdv, runs its body, pickles the
    result to DIR/rank<R>.pkl."""
    import pickle

    import torch

    from instructany2pix_tpu_torch.core import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(f"{d}/job.json") as f:
        job = json.load(f)
    backend = "gloo" if kind == "serve" else "nccl"
    mesh_lib.init_distributed(backend, f"file://{d}/rdv", rank, world,
                              timeout_s=PARALLEL_TIMEOUT_S)
    import torch.distributed as dist

    mesh = mesh_lib.make_mesh(1, world)
    out = (_rank_serve if kind == "serve" else _rank_train)(job, mesh)
    with open(f"{d}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _spawn_ranks(kind, world, d, job):
    """`world` ranks of `kind` (one process each, this script with --rank),
    joined within PARALLEL_TIMEOUT_S and killed after it: a rank that fails
    or hangs fails the phase. Returns (results by rank or None, seconds,
    the failure or None)."""
    import os
    import pickle

    with open(os.path.join(d, "job.json"), "w") as f:
        json.dump(job, f)
    here = os.path.abspath(__file__)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, here, "--rank", kind, str(r), str(world), d],
                              stdout=open(os.path.join(d, f"rank{r}.log"), "w"),
                              stderr=subprocess.STDOUT, cwd=os.path.dirname(here))
             for r in range(world)]
    failed = None
    deadline = t0 + PARALLEL_TIMEOUT_S
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(deadline - time.time(), 1))
            except subprocess.TimeoutExpired:
                failed = f"rank {r} of {kind} ran past {PARALLEL_TIMEOUT_S} s"
                break
            if rc != 0:
                failed = f"rank {r} of {kind} exited with {rc}"
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.time() - t0
    if failed:
        tails = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.log")) as f:
                lines = f.read().splitlines()
            log(f"--- {kind} rank {r} log (last lines)\n" + "\n".join(lines[-40:]))
            tails.append(f"rank {r}: " + " | ".join(lines[-8:]))
        return None, seconds, failed + "; " + " || ".join(tails)
    res = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res, seconds, None


def phase_parallel(root, cfg, failures):
    """Slice 14, after phase 4's pipelines are freed, with the tree on disk:
    (a) two ranks on the one card over gloo, mesh (1, 2): each boots the
    full-width pipeline from the tree and `PipelineServer` shards the LLM
    (unfused, o and down int8) and the UNet over "model"; rank 0 serves the
    LLM stage for real on phase_serve's first TP_LLM_ROWS prompts (injected
    Gumbel draws; tokens identical to the resident server's, or diverging
    only at a bf16 rounding tie) and a microbatch of TP_EDIT_SEEDS edits at
    1024^2 on phase 4's step counts (finite images; their largest uint8
    difference from the resident server's printed); K2 by path (mma for
    q/k/v/gate/up, fma for the int8 o/down: exact counts per decode step),
    K1 on the UNet's local heads, collectives by op; each rank's peak
    memory; then one decoder layer and one SDXL transformer block by the
    two ranks' shards against the unsharded copy, within K2's and K1's
    limits carried through; one CFG step's collectives.
    (c) in the same ranks: ring attention at RING_SHAPE against plain
    attention on the card. (b) one rank over NCCL: FSDP2 at world size 1 on
    the full-width trainer, the first step's loss equal to the unsharded
    step's, its grad norm within a bf16 ulp, the same K1 and K4 launches."""
    import tempfile

    import numpy as np

    card = card_line()
    out = {"card": card}
    if "served" not in RESIDENT_EDIT:
        failures.append("parallel: the resident server left no images to compare with")
        return out
    import torch

    L = cfg.llm.llama.num_layers
    free, total = torch.cuda.mem_get_info()
    out["parent_device_gib"] = {"allocated": torch.cuda.memory_allocated() / 2**30,
                                "reserved": torch.cuda.memory_reserved() / 2**30,
                                "free": free / 2**30, "total": total / 2**30}
    log(f"parallel: this process holds {out['parent_device_gib']['allocated']:.2f} GiB "
        f"({out['parent_device_gib']['reserved']:.2f} reserved); the card has "
        f"{out['parent_device_gib']['free']:.2f} of {out['parent_device_gib']['total']:.2f} GiB free")
    with tempfile.TemporaryDirectory(prefix="ia2p-mesh-") as d:
        png, wav = _write_media(d)
        res, secs, failed = _spawn_ranks("serve", 2, d, {"root": root, "png": png, "wav": wav})
    out["serve_ranks_seconds"] = secs
    if failed:
        failures.append(f"parallel serve: {failed}")
        return out
    lead, follow = res
    steps = lead["llm_decode_steps"]
    tie = _tie_reading(lead["ref"], lead["llm_logits"], lead["llm_tokens"], lead["llm_done_at"])
    ref_k2 = lead["ref"]["counts"]["k2_by_path"]
    k2 = lead["llm_counts"]["k2_by_path"]
    k2_expected = {"mma": 5 * L * steps, "fma": 2 * L * steps}
    k1_llm_expected = cfg.imagebind_vision.layers + cfg.imagebind_audio.layers
    tb = lead["tblocks"]
    # per edit microbatch: inversion 1 + denoise 2 (CFG) calls with self, text
    # and IP attention, as phase_serve counts it; the refiner's CFG steps
    k1_serve_expected = EDIT_STEPS * 5 * tb["unet"] + int(50 * 0.5) * 2 * tb["refiner"]
    sc = lead["serve_counts"]
    heads = {h for h, _, _ in lead["unet_attention_heads"]}
    imgs = lead["images"]
    size = cfg.image_size
    images_ok = all(im is not None and im.shape == (size, size, 3) and im.dtype == np.uint8
                    and im.std() > 0 for im in imgs)
    resident = [RESIDENT_EDIT["served"][s - 1] for s in TP_EDIT_SEEDS]
    levels = [int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) for a, b in zip(imgs, resident)]
    out.update({
        "boot_seconds": [lead["boot_seconds"], follow["boot_seconds"]],
        "boot_peak_gib": [lead["boot_peak_gib"], follow["boot_peak_gib"]],
        "weights_gib": [lead["weights_gib"], follow["weights_gib"]],
        "resident_gib": [lead["resident_gib"], follow["resident_gib"]],
        "peak_gib": [lead["peak_gib"], follow["peak_gib"]],
        "formats": lead["formats"], "unet_kinds": dict(lead["kinds"]),
        "llm_kinds": dict(lead["llm_kinds"]),
        "llm_seconds": lead["llm_seconds"], "llm_stage_seconds": lead["llm_stage_seconds"],
        "llm_decode_steps": steps, "llm_captions": lead["llm_captions"], "tokens": tie,
        "llm_k2_by_path": k2, "llm_k2_expected": k2_expected, "unsharded_k2_by_path": ref_k2,
        "llm_k1_launches": lead["llm_counts"]["k1"], "llm_k1_expected": k1_llm_expected,
        "llm_collectives": lead["llm_counts"]["collectives"],
        # the stage's generate over its decode steps (the prefill's share included)
        "llm_ms_per_step": lead["llm_stage_seconds"].get("serve_llm", 0.0) * 1e3 / max(steps, 1),
        "serve_seconds": lead["serve_seconds"], "serve_stage_seconds": lead["serve_stage_seconds"],
        "serve_k1_launches": sc["k1"], "serve_k1_by_path": sc["k1_by_path"],
        "serve_k1_expected": k1_serve_expected,
        "serve_k2_launches": sc["k2"], "serve_collectives": sc["collectives"],
        "follower_collectives": follow["serve_counts"]["collectives"],
        "unet_attention_heads": lead["unet_attention_heads"], "serve_peak_gib": lead["serve_peak_gib"],
        "images_ok": images_ok, "levels_from_resident": levels,
        "layer": [lead["layer"], follow["layer"]], "block": [lead["block"], follow["block"]],
        "layer_k2_by_path": lead["layer_k2_by_path"],
        "block_attention_shapes": lead["block_attention_shapes"],
        "cfg_step_seconds": lead["cfg_step_seconds"],
        "cfg_step_collectives": lead["cfg_step_collectives"], "ring": lead["ring"],
    })
    if not tie["ok"]:
        failures.append(f"parallel LLM stage: tokens diverge from the resident server's, not at a "
                        f"rounding tie: {tie['divergences']}")
    if k2 != k2_expected or ref_k2 != k2_expected or steps <= 0:
        failures.append(f"parallel LLM stage: K2 by path {k2}, unsharded {ref_k2} (expected "
                        f"{k2_expected}: 5 mma and 2 fma launches per layer per decode step, "
                        f"{steps} steps)")
    if lead["llm_counts"]["k1"] != k1_llm_expected or lead["llm_counts"]["k4"]:
        failures.append(f"parallel LLM stage: K1 {lead['llm_counts']['k1']} (expected "
                        f"{k1_llm_expected}), K4 {lead['llm_counts']['k4']}")
    if not images_ok or sc["k2"] or sc["k4"] or sc["k3"] or sc["k1"] != k1_serve_expected \
            or sc["k1_by_path"].get("wgmma") != sc["k1"] or 20 in heads or 5 not in heads:
        failures.append(f"parallel diffusion: images ok {images_ok}, K1 {sc['k1']} "
                        f"{sc['k1_by_path']} (expected {k1_serve_expected}, all wgmma), UNet "
                        f"attention heads {sorted(heads)} "
                        f"(local: 5 and 10, never 20), K2 {sc['k2']}, K3 {sc['k3']}, K4 {sc['k4']}")
    for name in ("layer", "block"):
        for r, x in enumerate(out[name]):
            if not (x["ok"] and x["finite"]):
                failures.append(f"parallel {name} on rank {r}: max diff {x['max_abs_diff']:.4g} = "
                                f"{x['of_limit']:.3f} of the carried limit {x['carried_limit']:.4g}")
    for k, x in lead["ring"].items():
        if not x["ok"]:
            failures.append(f"parallel ring attention {k}: max err {x['max_abs_err']:.3g} > "
                            f"{RING_TOL}")
    log(f"parallel serve (2 gloo ranks on one card, mesh (1, 2)): boot "
        f"{out['boot_seconds'][0]:.1f}/{out['boot_seconds'][1]:.1f} s, boot peak "
        f"{out['boot_peak_gib'][0]:.2f}/{out['boot_peak_gib'][1]:.2f} GiB, weights after sharding "
        f"{out['weights_gib'][0]:.2f}/{out['weights_gib'][1]:.2f} GiB (resident single-device: "
        f"phase 4's weights), serving peak {out['peak_gib'][0]:.2f}/{out['peak_gib'][1]:.2f} GiB; "
        f"LLM formats {out['formats']}, TP kinds UNet {out['unet_kinds']} LLM {out['llm_kinds']} [{card}]")
    log(f"parallel LLM stage ({TP_LLM_ROWS} prompts, {steps} decode steps): {out['llm_seconds']:.3f} s "
        f"(generate {out['llm_ms_per_step']:.2f} ms per decode step, prefill included), K2 {k2} (expected {k2_expected}), "
        f"K1 {out['llm_k1_launches']} (expected {k1_llm_expected}), collectives "
        f"{out['llm_collectives']}; against the same stage on rank 0's unsharded model (K2 "
        f"{ref_k2}): tokens identical {tie['identical']}, divergences {tie['divergences']}; "
        f"captions {out['llm_captions']}")
    log(f"parallel diffusion ({len(TP_EDIT_SEEDS)} edits, {EDIT_STEPS} + {EDIT_STEPS} steps, refiner "
        f"{int(50 * 0.5)} of 50, 1024^2): {out['serve_seconds']:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in out["serve_stage_seconds"].items())
        + f"), K1 {sc['k1']} {sc['k1_by_path']} (expected {k1_serve_expected}), UNet attention (heads, tokens, calls) "
        f"{out['unet_attention_heads']}, collectives {sc['collectives']}; images ok {images_ok}, "
        f"largest uint8 difference from the resident server {levels}; one CFG UNet step (batch "
        f"{2 * len(TP_EDIT_SEEDS)}): {out['cfg_step_seconds']:.3f} s, collectives "
        f"{out['cfg_step_collectives']}")
    for name in ("layer", "block"):
        x = out[name][0]
        log(f"parallel {name} by two ranks' shards vs unsharded: max diff {x['max_abs_diff']:.4g}, "
            f"carried limit {x['carried_limit']:.4g} + 2^-8 |y| ({x['of_limit']:.3f} of it; rank 1 "
            f"{out[name][1]['of_limit']:.3f})")
    log(f"parallel block attention shapes {out['block_attention_shapes']}; layer K2 by path "
        f"{out['layer_k2_by_path']}")
    for k, x in out["ring"].items():
        log(f"ring attention {RING_SHAPE} {k} over 2 gloo ranks: max err {x['max_abs_err']:.3g} "
            f"(limit {RING_TOL}), {x['ms']:.1f} ms (plain on one rank {x['plain_ms']:.1f} ms), "
            f"collectives {x['collectives']}")

    with tempfile.TemporaryDirectory(prefix="ia2p-fsdp-") as d:
        res, secs, failed = _spawn_ranks("train", 1, d, {})
    out["train_ranks_seconds"] = secs
    if failed:
        failures.append(f"parallel FSDP train: {failed}")
        return out
    t = res[0]
    per_step = _launches(k1=2 * TRAIN_LAYERS, k4=TRAIN_LAYERS, k4_wgmma=TRAIN_LAYERS)
    plain, fsdp = t["plain"], t["fsdp"]
    gn = (plain["metrics"]["grad_norm"], fsdp["metrics"]["grad_norm"])
    out["fsdp"] = t
    ok = (plain["metrics"]["loss"] == fsdp["metrics"]["loss"]
          and abs(gn[0] - gn[1]) <= 2.0**-8 * abs(gn[0])
          and plain["launches"] == per_step and fsdp["launches"] == per_step
          and t["backend"] == "nccl")
    if not ok:
        failures.append(f"parallel FSDP train: loss {fsdp['metrics']['loss']!r} vs unsharded "
                        f"{plain['metrics']['loss']!r}, grad norm {gn} (within 2^-8), launches "
                        f"{fsdp['launches']} / {plain['launches']} (expected {per_step}), backend "
                        f"{t['backend']}")
    log(f"parallel FSDP2 train (NCCL, world {t['world']}, {TRAIN_LAYERS} of 32 layers, batch "
        f"{TRAIN_BATCH} x {TRAIN_LEN}): first step loss {fsdp['metrics']['loss']!r} (unsharded "
        f"{plain['metrics']['loss']!r}), grad norm {gn[1]!r} (unsharded {gn[0]!r}), first step "
        f"{fsdp['seconds']:.3f} s (unsharded, the process's first: {plain['seconds']:.3f} s), "
        f"second step {fsdp['second_step_seconds']:.3f} s (unsharded "
        f"{plain['second_step_seconds']:.3f} s), peak {fsdp['peak_gib']:.2f} "
        f"GiB (unsharded {plain['peak_gib']:.2f}), launches {fsdp['launches']}; "
        f"{fsdp['sharded_params']} parameters sharded, {fsdp['replicated_params']} replicated "
        f"[{card}]")
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
    ap.add_argument("--rank", nargs=4, metavar=("KIND", "RANK", "WORLD", "DIR"),
                    help=argparse.SUPPRESS)  # a rank of phase_parallel (_rank_main)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from instructany2pix_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    if args.rank:
        kind, rank, world, d = args.rank
        return _rank_main(kind, int(rank), int(world), d)
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
    tok_model = phase_tokenizer_model(failures)
    t_tok = time.time() - t0
    import atexit
    import shutil
    import tempfile

    feats_dir = tempfile.mkdtemp(prefix="ia2p-feats-")
    atexit.register(shutil.rmtree, feats_dir, True)
    t0 = time.time()
    full = phase_full_width(failures, feats_dir)
    t_full = time.time() - t0
    t0 = time.time()
    train = phase_train(failures)
    t_train = time.time() - t0
    t0 = time.time()
    finetune = phase_finetune(feats_dir, failures)
    t_finetune = time.time() - t0
    t0 = time.time()
    codecs = phase_codecs(feats_dir, failures)
    t_codecs = time.time() - t0
    t0 = time.time()
    mpt = phase_mpt(failures)
    t_mpt = time.time() - t0
    t0 = time.time()
    score = phase_clip_score(failures)
    t_score = time.time() - t0
    t0 = time.time()
    tiny = phase_tiny_reference(failures)
    t_tiny = time.time() - t0
    t0 = time.time()
    tiny_train = phase_tiny_train(failures)
    t_tiny_train = time.time() - t0
    t0 = time.time()
    tiny_s12 = phase_tiny_adapters(failures)
    t_tiny_s12 = time.time() - t0
    t0 = time.time()
    tiny_s13 = phase_tiny_slice13(failures)
    seconds = {"k1_checks": t_k1, "k2_checks": t_k2, "k3_checks": t_k3, "k4_checks": t_k4,
               "tokenizer_model": t_tok, "full_width": t_full, "train": t_train,
               "adapters": full["adapters_seconds"], "finetune_tree": full["finetune_tree_seconds"],
               "staged": full["staged_seconds"], "finetune": t_finetune, "codecs": t_codecs,
               "mpt": t_mpt, "clip_score": t_score, "tiny": t_tiny, "tiny_train": t_tiny_train,
               "tiny_adapters": t_tiny_s12, "tiny_slice13": time.time() - t0,
               "parallel": full.get("parallel_seconds"), "total": time.time() - t_start}
    edit, subject, serve = full["edit"], full["subject"], full["serve"]
    sw = full["switches"]
    par = full.get("parallel", {})
    par_fsdp = par.get("fsdp", {}).get("fsdp", {}).get("launches", {})
    # slice 12's and slice 13's paths, each with every counter read (phase_adapters,
    # phase_finetune*, phase_staged, phase_codecs, phase_mpt, phase_clip_score)
    s12 = {**full["adapters"]["paths"], **full["finetune_tree"]["paths"], **finetune["paths"],
           **full["staged"]["paths"], **codecs["paths"], **mpt["paths"], **score["paths"]}

    head = next(r for r in rows if r["dtype"] == "bfloat16")
    k1_paths = {"text2img": sum(r["k1_launches"] for r in full["requests"]),
                "forward_llm": edit["k1_launches"], "edit_call": edit["call_k1_launches"],
                "subject_call": subject["k1_launches"], "train": train["launches"]["k1"],
                "serve_llm": serve["llm_k1_launches"], "serve_diffusion": serve["k1_launches"],
                "serve_lcm_call": serve["lcm_k1_launches"], "serve_run": serve["run_k1_launches"],
                "speculative_forward_llm": sw["spec_k1_launches"],
                "greedy_decode": sw["greedy_k1_launches"], "debug_call": sw["debug_k1_launches"],
                "nodebug_call": sw["nodebug_k1_launches"], "prior_ddpm": sw["prior_ddpm_k1_launches"],
                "clip_encode": sw["clip_k1_launches"], **{p: c["k1"] for p, c in s12.items()},
                # slice 14: rank 0 of the tensor-parallel server, the FSDP step
                "parallel_serve_llm": par.get("llm_k1_launches", 0),
                "parallel_serve_diffusion": par.get("serve_k1_launches", 0),
                "parallel_fsdp_train": par_fsdp.get("k1", 0)}
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
            "subject_call": subject["k1_by_path"], "train": train["k1_by_path"],
            "serve_llm": serve["llm_k1_by_path"], "serve_diffusion": serve["k1_by_path"],
            "serve_lcm_call": serve["lcm_k1_by_path"], "serve_run": serve["run_k1_by_path"],
            **{p: sw[f"{k}_k1_by_path"] for p, k in (
                ("speculative_forward_llm", "spec"), ("greedy_decode", "greedy"),
                ("debug_call", "debug"), ("nodebug_call", "nodebug"),
                ("prior_ddpm", "prior_ddpm"), ("clip_encode", "clip"))},
            **{p: c["k1_by_path"] for p, c in s12.items()},
            "parallel_serve_diffusion": par.get("serve_k1_by_path", {})},
        # UNet attention calls of the tensor-parallel server by (local heads, tokens)
        "parallel_attention_heads": par.get("unet_attention_heads"),
        # K1 launches with a zero-stride (broadcast) operand: pnp's shared Q/K
        "launches_broadcast_by_path": {p: c["k1_broadcast"] for p, c in s12.items()},
        "broadcast_shapes": full["adapters"]["k1_broadcast_rows"],
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
        "tp_shard_shape": {k: v for k, v in next(
            r for r in rows if r["dtype"] == "bfloat16" and "TP shard" in r["label"]).items()
            if k in ("label", "shape", "path", "ms", "ms_bshd", "plain_ms", "library_ms",
                     "bound_ms", "bound_by", "of_limit")},
        "served_batch_shape": {k: v for k, v in next(
            r for r in rows if r["dtype"] == "bfloat16" and r["shape"][0] == 8).items()
            if k in ("label", "shape", "path", "ms", "ms_bshd", "plain_ms", "library_ms",
                     "bound_ms", "bound_by", "of_limit")},
        "clip_encoder_shape": {k: v for k, v in next(
            r for r in rows if r["dtype"] == "bfloat16" and r["label"].startswith("clip")).items()
            if k in ("label", "shape", "path", "ms", "ms_bshd", "plain_ms", "library_ms",
                     "bound_ms", "bound_by", "of_limit")},
        "clip_encoder": {k: sw[k] for k in ("clip_encode_ms", "clip_encode_plain_ms",
                                            "clip_max_abs_err", "clip_of_limit",
                                            "clip_of_limit_rms")},
        "clip_vision_codec": codecs["clip_codec"],
        "clip_score_ms": score["ms"],
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
        "launches": None,  # the sum over the main paths, below
        "launches_by_path": {"text2img": sum(r["k2_launches"] for r in full["requests"]),
                             "forward_llm": edit["k2_launches"],
                             "edit_call": edit["call_k2_launches"],
                             "subject_call": subject["k2_launches"],
                             "train": train["launches"]["k2"],
                             "serve_llm": serve["llm_k2_launches"],
                             "serve_diffusion": serve["k2_launches"],
                             "serve_lcm_call": serve["lcm_k2_launches"],
                             "serve_run": serve["run_k2_launches"],
                             "speculative_forward_llm": sw["spec_k2_launches"],
                             "greedy_decode": sw["greedy_k2_launches"],
                             "debug_call": sw["debug_k2_launches"],
                             "nodebug_call": sw["nodebug_k2_launches"],
                             "prior_ddpm": sw["prior_ddpm_k2_launches"],
                             "clip_encode": sw["clip_k2_launches"],
                             **{p: c["k2"] for p, c in s12.items()},
                             "parallel_serve_llm": sum(par.get("llm_k2_by_path", {}).values()),
                             "parallel_fsdp_train": par_fsdp.get("k2", 0)},
        # K2 launches with no fused prologue or epilogue: linears carrying adapters
        "launches_unfused_by_path": {p: c["k2_unfused"] for p, c in s12.items()},
        "lora_unmerged_step": finetune["lora_unmerged_step"],
        # the same launches by the kernel path each took (mma, fma), and the
        # tiny float32 greedy decode's, off the main paths
        "launches_by_kernel_path": {
            "text2img": {p: sum(r["k2_by_path"][p] for r in full["requests"])
                         for p in full["requests"][0]["k2_by_path"]},
            "forward_llm": edit["k2_by_path"], "edit_call": edit["call_k2_by_path"],
            "subject_call": subject["k2_by_path"], "serve_llm": serve["llm_k2_by_path"],
            "serve_run": serve["run_k2_by_path"], "tiny_greedy_decode": tiny["greedy_k2_by_path"],
            "tiny_server_llm": tiny["server"]["llm_k2_by_path"],
            "speculative_forward_llm": sw["spec_k2_by_path"], "greedy_decode": sw["greedy_k2_by_path"],
            **{p: c["k2_by_path"] for p, c in s12.items()},
            "parallel_serve_llm": par.get("llm_k2_by_path", {})},
        "serve_llm_rows": serve["llm_k2_rows"],
        "speculative_rows": sw["spec_k2_rows"],
        "speculative_verify": {k: sw.get(k) for k in ("verify_ms_median", "verify_k2_ms",
                                                      "draft_step_ms_median")},
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
        "served_decode_step": {k: serve[k] for k in ("decode_ms_median", "decode_ms_range",
                                                     "decode_busy", "single_decode_ms_median")},
        "shapes": [{k: r[k] for k in ("label", "m", "k", "n", "format", "fusion", "dtype", "path",
                                      "cluster", "chunk", "max_active_clusters", "ms", "ms_eager",
                                      "plain_ms", "library_ms", "bound_ms", "bound_by", "of_bound",
                                      "err", "of_limit")}
                   for r in qrows],
    }
    k2["launches"] = sum(k2["launches_by_path"].values())
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
                             "train": train["launches"]["k3"],
                             "serve_llm": serve["llm_k3_launches"],
                             "serve_diffusion": serve["k3_launches"],
                             **{p: sw[f"{k}_k3_launches"] for p, k in (
                                 ("speculative_forward_llm", "spec"), ("greedy_decode", "greedy"),
                                 ("debug_call", "debug"), ("nodebug_call", "nodebug"),
                                 ("prior_ddpm", "prior_ddpm"), ("clip_encode", "clip"))},
                             **{p: c["k3"] for p, c in s12.items()}},
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
        short = key.split("_")[0]
        return {"text2img": sum(r[key] for r in full["requests"]), "forward_llm": edit[key],
                "edit_call": edit["call_" + key], "subject_call": subject[key],
                "train": train["launches"][short],
                "serve": sum(serve[p + key] for p in ("llm_", "", "lcm_", "run_")),
                "switches": sum(sw[p + key] for p in ("spec_", "greedy_", "debug_", "nodebug_",
                                                       "prior_ddpm_", "clip_")),
                **{p: c[short] for p, c in s12.items()},
                "parallel_fsdp_train": par_fsdp.get(short, 0)}

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
                "train": {p: train["launches"][f"k4_{p}"] for p in ("wgmma", "mma", "fma")},
                **{p: c["k4_by_path"] for p, c in s12.items()}},
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
              "finetune": finetune, "tiny_reference": tiny, "tiny_train": tiny_train,
              "tiny_adapters": tiny_s12, "tokenizer_model": tok_model, "codecs": codecs,
              "mpt": mpt, "clip_score": score, "tiny_slice13": tiny_s13, "seconds": seconds}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "kernels": kernels}, f, indent=1, default=str)
    summary = {k: v for k, v in full.items()
               if k not in ("edit", "subject", "serve", "switches", "unet_step_profile", "adapters",
                            "finetune_tree", "staged", "parallel")}
    log(json.dumps({"full_width": summary, "tiny_reference": tiny, "seconds": seconds}))
    log(json.dumps({"train": {k: v for k, v in train.items() if k != "step_profile"},
                    "tiny_train": tiny_train}, default=str))
    log(json.dumps({"edit": {k: v for k, v in edit.items() if k != "decode_profile"}}))
    log(json.dumps({"subject": subject}, default=str))
    log(json.dumps({"serve": {k: v for k, v in serve.items() if k != "decode_profile"}},
                   default=str))
    log(json.dumps({"switches": {k: v for k, v in sw.items() if k != "verify_profile"},
                    "tokenizer_model": tok_model}, default=str))
    log(json.dumps({"adapters": full["adapters"], "finetune_tree": full["finetune_tree"],
                    "finetune": {k: v for k, v in finetune.items() if k != "paths"},
                    "tiny_adapters": tiny_s12}, default=str))
    log(json.dumps({"parallel": {k: v for k, v in par.items()
                                 if k not in ("fsdp", "llm_stage_seconds")}}, default=str))
    log(json.dumps({"staged": {k: v for k, v in full["staged"].items() if k != "paths"},
                    "codecs": {k: v for k, v in codecs.items() if k != "paths"},
                    "mpt": {k: v for k, v in mpt.items() if k != "paths"},
                    "clip_score": {k: v for k, v in score.items() if k != "paths"},
                    "tiny_slice13": tiny_s13}, default=str))
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
