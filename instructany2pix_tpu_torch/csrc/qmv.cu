// K2: the weight-only quantized decode matvec on Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels
//   instructany2pix_tpu/ops/quant.py::_qmv_kernel          (K2a, grid pipeline)
//   instructany2pix_tpu/ops/quant.py::_qmv_stream_kernel   (K2b, manual multi-buffer DMA)
//   benchmarks/qmv_dma_probe.py::_manual_kernel            (P, the int4-grouped probe)
// which compute one function; their grid-versus-DMA split is a TPU pipelining
// detail, so they become this one kernel.
//
// What it computes, for x (M, K') with M <= 16 and W (K, N), N % 128 == 0:
//   y = cast_out(x' @ dequant(W)) (+ residual, added in the output dtype)
// with W in one of three formats, input-major as in the JAX package:
//   fmt 0  int8 (K, N) with a per-channel scale (N,)
//   fmt 1  int4 packed (K/2, N) with a per-channel scale (N,)
//   fmt 2  int4 packed (K/2, N) with group scales (K/group, N), any even
//          group that divides K
// Byte row i holds original row 2i in its low nibble and row 2i+1 in its
// high nibble, both signed. x' is x after the optional prologue:
//   RMSNorm   x * rsqrt(mean(x^2) + eps) * g in float32 over the whole row
//             of x (width K'), rounded to x's dtype;
//   SwiGLU    x is (M, 2K): silu(gate) in float32 (fast exp and divide)
//             rounded to x's dtype, times up in x's dtype.
// Sums are float32; in the grouped format each group's partial dot is
// scaled by its group scale and added to the accumulator; a per-channel
// scale multiplies the whole sum.
//
// What bounds it: bytes. At M = 1 every packed weight byte is read once and
// used for one (int8) or two (int4) multiply-adds per row of x, far below the
// card's ~295 operations per byte. The bound is (packed W + scales + x + g +
// residual + out) / 3.35 TB/s: 8.0 us for the 7B qkv (4096 -> 12288, int4
// group 128), 2.7 us for o, 14.3 us for gate_up, 7.2 us for down.
//
// What the design does about it (one launch per call):
//   * A block owns 128 output columns (the tile) and one chunk of K, a whole
//     number of stages of 64 byte rows (8 KB; 128 k for int4, inside one
//     scale group when the group is a multiple of 128). One producer thread streams the chunk's stages by TMA into a
//     ring of 4 or 8 stages (or the whole chunk) in shared memory, 128-byte
//     swizzled, each with its 512 bytes of group scales, under full/empty
//     mbarriers: up to 64 KB in flight per block with no registers spent on
//     loads. The weights are read once and go through L2 evict-first. Stage s
//     goes to consumer warp s % kConsumers.
//   * The K chunks of one tile are the blocks of a thread block cluster
//     (size <= 8, along gridDim.x). Each block pushes its float32 sums of the
//     tile's columns into the shared memory of the rank that finishes them,
//     which adds them in rank (chunk) order after one cluster barrier: the
//     result is deterministic and nothing but the output is written to
//     device memory. The RMSNorm statistics go the same way: each block sums
//     the squares of its own chunk of the row (gate and up with SwiGLU) and
//     pushes them to every rank.
//   * The prologue comes first: the consumers request the chunk of x (and
//     the gains) before the weights, stage it raw in shared memory, and form
//     x' in place. A chunk whose x' does not fit is staged in windows of
//     stages (statistics first, over every window), so K is unbounded. A request made behind a full ring waits for the ring's
//     bytes to reach the SM, the prologue's instructions and cluster barrier
//     included, so with a prologue to run only one stage goes out before it.
//   * bf16 activations with int4 weights (the decode path, "mma"): the
//     product runs on the tensor cores as y^T = dequant(W)^T x'^T with
//     mma.sync.m16n8k16 (bf16 in, float32 out): output columns are the MMA's
//     rows and rows of x its n (one n8 tile for M <= 8, two for M <= 16).
//     The A fragment's register (k pair 2t, 2t+1 at one row) is exactly one
//     packed byte, so a thread reads 8 consecutive columns of a byte row with
//     one 8-byte shared load and feeds byte j to MMA instance j, whose row
//     rho stands for column 8 * slot_of(rho) + j; slot_of spreads a warp's
//     reads over all 32 banks under the swizzle. A byte becomes two exact
//     bf16 values in three instructions: prmt of its two nibbles into the
//     two halves, lop3 of each with XOR 8 (offset binary, u = n + 8) into
//     the mantissa of bf16 128.0, and subtract 136 (all integers below 256,
//     exact in bf16). bf16 x int4 products are exact, and each MMA
//     accumulator covers one group (128 k) before it is scaled and added to
//     a float32 running sum in group order.
//   * float32 activations, int8 weights, and int4 groups that are not a
//     multiple of 128 ("fma"): the same frame, with float32 FMAs on the CUDA
//     cores; each lane owns 4 columns of the tile.
// mma.sync rather than wgmma: the bound is bytes, and m16n8k16 gives ~30x
// more tensor-core rate than they allow while each warp keeps its own
// stages, barriers and accumulators (wgmma would tie four warps to one
// 64-row tile and take B from shared memory).
// The path taken is reported by ia2p_qmv_last_path (0 fma, 1 mma).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <mutex>
#include <unordered_map>

#include "sm90_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kConsumers = 4;                  // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);  // + one producer warp
constexpr int kRing = 8;                       // most stages in shared memory
// Stage s sits in slot s % ring and goes to warp s % kConsumers. With the ring
// a multiple of kConsumers (or no larger than the chunk, so no slot is used
// twice) every slot belongs to one warp, which takes its stages in order:
// no warp can wait on a slot's barrier two phases ahead, where a parity wait
// would pass on the earlier phase.
static_assert(kRing % kConsumers == 0, "each ring slot must belong to one consumer warp");
constexpr int kTileN = 128;                    // output columns per block: one 128-byte TMA box
constexpr int kStageRows = 64;                 // byte rows per stage
constexpr int kStageBytes = kStageRows * kTileN;
constexpr int kGroup = 128;                    // the grouped format's group
constexpr int kMaxM = 16;
constexpr int kMaxCluster = 8;                 // the portable cluster size
constexpr int kXPad = 8;                       // bf16 pad per staged row of x' (mma path)
constexpr int kMaxSmem = 227 * 1024;

enum Fmt { kInt8 = 0, kInt4 = 1, kInt4G = 2 };
enum Path { kPathFma = 0, kPathMma = 1 };

struct Params {
  const void* x;
  const float* scale;  // (N,), per-channel formats; group scales come by TMA
  const void* g;       // RMSNorm gain (K',), float32 or bf16 (g_bf16), or null
  const void* residual;
  void* out;
  int M, K, N, xk, chunk_stages, nstages, ring, swiglu, has_norm, g_bf16, act;
  int group;  // fmt 2: k per scale group
  int win;    // stages of x' staged at once (a window of the chunk)
  float eps;
};

__host__ __device__ constexpr int stage_k(int fmt) { return fmt == kInt8 ? kStageRows : 2 * kStageRows; }

__device__ __forceinline__ float load_act(const void* p, int64_t i, int act) {
  return act ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
             : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float round_act(float v, int act) {
  return act ? __bfloat162float(__float2bfloat16(v)) : v;
}

// cast the float32 sum to the output dtype, then add the residual in it
__device__ __forceinline__ void finish(const Params& p, int64_t o, float s) {
  float y = round_act(s, p.act);
  if (p.residual) y = round_act(y + load_act(p.residual, o, p.act), p.act);
  if (p.act)
    reinterpret_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16(y);
  else
    reinterpret_cast<float*>(p.out)[o] = y;
}

// 8 consecutive activations from element i (i % 8 == 0) as raw bits,
// through the read-only path: bf16 in .a, float32 in .a and .b
struct Raw8 {
  uint4 a, b;
};

__device__ __forceinline__ Raw8 raw8(const void* x, int64_t i, bool bf) {
  Raw8 r;
  if (bf) {
    r.a = __ldg(reinterpret_cast<const uint4*>(reinterpret_cast<const __nv_bfloat16*>(x) + i));
    r.b = make_uint4(0u, 0u, 0u, 0u);
  } else {
    const uint4* f = reinterpret_cast<const uint4*>(reinterpret_cast<const float*>(x) + i);
    r.a = __ldg(f);
    r.b = __ldg(f + 1);
  }
  return r;
}

// the first n (<= 8) activations from element i, at any alignment, zeros
// after them
__device__ __forceinline__ Raw8 raw8_n(const void* x, int64_t i, bool bf, int n) {
  uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  if (bf) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(x) + i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) w[j >> 1] |= uint32_t(__ldg(h + j)) << (16 * (j & 1));
  } else {
    const uint32_t* f = reinterpret_cast<const uint32_t*>(x) + i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) w[j] = __ldg(f + j);
  }
  Raw8 r;
  r.a = make_uint4(w[0], w[1], w[2], w[3]);
  r.b = make_uint4(w[4], w[5], w[6], w[7]);
  return r;
}

__device__ __forceinline__ void unpack8(const Raw8& r, bool bf, float (&v)[8]) {
  if (bf) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    const uint32_t w[8] = {r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __uint_as_float(w[j]);
  }
}

// 8 staged activations at element idx of xs: bf16 on the mma path, float32
// on the fma path (16-byte aligned either way)
template <bool kMma>
__device__ __forceinline__ void store8(uint8_t* xs, int idx, const float (&v)[8]) {
  if (kMma) {
    uint32_t h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 t2 = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      h[j] = *reinterpret_cast<const uint32_t*>(&t2);
    }
    *reinterpret_cast<uint4*>(xs + 2 * idx) = make_uint4(h[0], h[1], h[2], h[3]);
  } else {
    float4* d = reinterpret_cast<float4*>(xs + 4 * idx);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <bool kMma>
__device__ __forceinline__ void load8s(const uint8_t* xs, int idx, float (&v)[8]) {
  Raw8 r;
  if (kMma) {
    r.a = *reinterpret_cast<const uint4*>(xs + 2 * idx);
  } else {
    r.a = reinterpret_cast<const uint4*>(xs + 4 * idx)[0];
    r.b = reinterpret_cast<const uint4*>(xs + 4 * idx)[1];
  }
  unpack8(r, kMma, v);
}

// x'[m, k..k+7] from the raw gate (and up) values and their RMSNorm gains,
// in x's dtype
__device__ __forceinline__ void prologue8(const Params& p, float rstd, float (&v)[8],
                                          const float (&up)[8], const float (&gn)[8],
                                          const float (&gu)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (p.has_norm) v[j] = round_act(v[j] * rstd * gn[j], p.act);
    if (p.swiglu) {
      const float u = p.has_norm ? round_act(up[j] * rstd * gu[j], p.act) : up[j];
      // silu in float32 from the fast exp and divide (a few ulp), rounded
      const float sl = round_act(__fdividef(v[j], 1.0f + __expf(-v[j])), p.act);
      v[j] = round_act(sl * u, p.act);
    }
  }
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the two halves of a cluster barrier, for a warp that arrives early and
// waits late
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// an arrival that publishes nothing (no fence)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------ mma path

// The 8-byte slot (of the 16 in a 128-byte row) whose 8 columns MMA row rho
// (0..15) stands for: bits 0, 1, 2, 3 of rho go to bits 0, 3, 2, 1. Under
// the 128-byte swizzle the 16 lanes of a half-warp (rows t and slots of 4
// consecutive g) then hit 16 different 8-byte bank pairs.
__device__ __forceinline__ int slot_of(int rho) {
  return (rho & 1) | ((rho & 2) << 2) | (rho & 4) | ((rho & 8) >> 2);
}

// byte offset of 8-byte slot c in a 128-byte row r of a 128-byte-swizzled box
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * 128 + ((((c >> 1) ^ (r & 7)) << 4) | ((c & 1) << 3));
}

// byte b of (v, v >> 4) as two bf16: the low nibble in the low half, the
// high nibble in the high half
template <int B>
__device__ __forceinline__ uint32_t dequant_pair(uint32_t v, uint32_t v4) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(v4), "r"(uint32_t(B | ((B + 4) << 8))));
  // (r & 0x000F000F) ^ 0x43084308: the nibble XOR 8 (offset binary, u = n + 8)
  // in the mantissa of 128.0, so 128 + u in each half
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(r) : "r"(r), "r"(0x000F000Fu), "r"(0x43084308u));
  // (128 + u) * 1 - 136 = u - 8 = n, exact
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage (64 byte rows = 8 k16 steps, 128 k) of warp `lane`'s MMAs into
// pt; NT n8 tiles of x' rows. off[q]: the thread's four byte offsets in a
// step's 8 rows (rows t and t + 4, MMA rows g and g + 8).
template <int NT>
__device__ __forceinline__ void mma_stage(float (&pt)[NT][8][4], const uint8_t* tile,
                                          const __nv_bfloat16* xs, int xs_ld, int kbase, int M,
                                          const int (&off)[4], int g, int t) {
#pragma unroll 2
  for (int step = 0; step < 8; ++step) {
    uint2 wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wv[q] = *reinterpret_cast<const uint2*>(tile + step * 8 * 128 + off[q]);
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int m = g + 8 * nt;
      const __nv_bfloat16* xr = xs + (int64_t)m * xs_ld + kbase + step * 16 + 2 * t;
      b[nt][0] = m < M ? *reinterpret_cast<const uint32_t*>(xr) : 0u;
      b[nt][1] = m < M ? *reinterpret_cast<const uint32_t*>(xr + 8) : 0u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v[4], v4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = h ? wv[q].y : wv[q].x;
        v4[q] = v[q] >> 4;
      }
      uint32_t a[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[0][q] = dequant_pair<0>(v[q], v4[q]);
        a[1][q] = dequant_pair<1>(v[q], v4[q]);
        a[2][q] = dequant_pair<2>(v[q], v4[q]);
        a[3][q] = dequant_pair<3>(v[q], v4[q]);
      }
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(pt[nt][4 * h + bb], a[bb], b[nt][0], b[nt][1]);
    }
  }
}

// ------------------------------------------------------------ fma path

// The weights become float32 exactly without a conversion instruction (a
// quarter-rate I2F): the value in offset binary, u = n + 128 (int8) or
// n + 8 (int4), goes into the low mantissa bits of 2^23, and one subtract
// of 2^23 + 128 (or + 8) leaves n.
constexpr float kMagic8 = 8388736.0f;  // 2^23 + 128
constexpr float kMagic4 = 8388616.0f;  // 2^23 + 8

// one byte row's 4 columns into part[m][c]; xr points at the row of x' that
// multiplies it (int8) or at the pair of rows 2i, 2i+1 (int4). kGuard: rows
// M..MT-1 are not staged and read as 0.
template <int MT, int FMT, bool kGuard>
__device__ __forceinline__ void mac_row(float (&part)[MT][4], uint32_t wd, const float* xr,
                                        int ld, int M) {
  const uint32_t u = wd ^ (FMT == kInt8 ? 0x80808080u : 0x88888888u);  // offset binary
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (FMT == kInt8) {
      const float wv = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | c)) - kMagic8;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        part[m][c] = fmaf(kGuard && m >= M ? 0.f : xr[m * ld], wv, part[m][c]);
    } else {
      const float lo = __uint_as_float(((u >> (8 * c)) & 0xFu) | 0x4B000000u) - kMagic4;
      const float hi = __uint_as_float(((u >> (8 * c + 4)) & 0xFu) | 0x4B000000u) - kMagic4;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        part[m][c] = fmaf(kGuard && m >= M ? 0.f : xr[m * ld], lo, part[m][c]);
        part[m][c] = fmaf(kGuard && m >= M ? 0.f : xr[m * ld + 1], hi, part[m][c]);
      }
    }
  }
}

// ------------------------------------------------------------ the kernel

// Shared memory, from a 1024-byte aligned base: the ring of weight stages
// (ring x 8 KB), the ring of group scales (int4g), x' of one window of the
// chunk (win stages; xs_rows rows of xs_ld elements: M in bf16 on the mma
// path, which loads no row past M, and the fma path's MT in float32; with
// SwiGLU as many rows again hold up until x' is formed), the window's
// RMSNorm gains (gate and up) and its squares per 8-k vector, the table of
// the cluster's sums of this block's columns, the mbarriers, the cluster's
// RMSNorm sums and rstd. After the main loop the ring holds the warps' sums
// (red).
__host__ __device__ inline int xs_ld_of(bool mma, int fmt, int win) {
  return win * stage_k(fmt) + (mma ? kXPad : 0);
}

__host__ __device__ inline int xs_rows_of(bool mma, int M) {
  return mma ? M : M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
}

// the ring's bytes: its stages, or the warps' sums after the loop
__host__ __device__ inline int ring_bytes(int ring, int M) {
  const int sums = kConsumers * M * kTileN * 4;
  return ring * kStageBytes > sums ? ring * kStageBytes : sums;
}

struct Layout {
  int ring, scales, xs, gains, squares, recv, wacc, bars, total;  // byte offsets from the aligned base
};

// `windowed`: x' is staged in more than one window, and each warp keeps its
// sums in shared memory between them
__host__ __device__ inline Layout layout_of(bool mma, int fmt, int M, int win, int ring,
                                            int swiglu, int has_norm, bool windowed) {
  const int wk = win * stage_k(fmt);
  Layout l;
  l.ring = 0;
  l.scales = ring_bytes(ring, M);
  l.xs = l.scales + (fmt == kInt4G ? ring * kTileN * 4 : 0);
  l.gains = l.xs + ((swiglu ? 2 : 1) * xs_rows_of(mma, M) * xs_ld_of(mma, fmt, win) *
                        (mma ? 2 : 4) + 15) / 16 * 16;
  l.squares = l.gains + (has_norm ? (swiglu ? 2 : 1) * wk * 4 : 0);
  l.recv = l.squares + (has_norm ? (M * wk / 8 * 4 + 15) / 16 * 16 : 0);
  l.wacc = l.recv + M * (kTileN + kMaxCluster) * 4;  // [rank][m][column of my share]
  l.bars = l.wacc + (windowed ? kConsumers * M * kTileN * 4 : 0);  // [warp][m][col]
  l.total = l.bars + 16 * kRing + (kMaxCluster + 1) * kMaxM * 4;
  return l;
}

__host__ __device__ inline int smem_bytes(bool mma, int fmt, int M, int win, int ring, int swiglu,
                                          int has_norm, bool windowed) {
  return 1024 + layout_of(mma, fmt, M, win, ring, swiglu, has_norm, windowed).total;
}

// window w of a chunk: its stages [ws, we), its first k, its staged and
// real 8-k vectors (the last one partial when K % 8 != 0) and its real k
struct Win {
  int ws, we, kw, nvs, nv, kc;
};

// Blocks are held to the registers that keep 3 (M <= 8) or 2 (M <= 16) of
// them on an SM. kAny: the instance for any shape (x' in windows, K % 8 !=
// 0, groups that end inside a stage), with every register a thread may
// have; without it these are constants and fold away, and the main path's
// instance keeps its registers.
template <bool kMma, int FMT, int MT, bool kAny>
__global__ void __launch_bounds__(kThreads, kAny ? 1 : MT > 8 ? 2 : 3)
    qmv_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap smap,
               const Params p) {
  constexpr int kK = stage_k(FMT);
  constexpr int NT = MT / 8;  // n8 tiles of the mma path
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  const int nring = p.ring;
  const Layout lay = layout_of(kMma, FMT, p.M, p.win, nring, p.swiglu, p.has_norm,
                               kAny && p.win < p.chunk_stages);
  float* sring = reinterpret_cast<float*>(ring + lay.scales);
  uint8_t* xs = ring + lay.xs;
  float* gs = reinterpret_cast<float*>(ring + lay.gains);     // RMSNorm gains of the window
  float* sqi = reinterpret_cast<float*>(ring + lay.squares);  // squares per 8-k vector
  const int xs_ld = xs_ld_of(kMma, FMT, p.win);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + lay.bars);
  float* ss = reinterpret_cast<float*>(bars + 2 * kRing);  // [rank][m] the cluster's sums of squares
  float* rsd = ss + kMaxCluster * kMaxM;                    // rstd per row of x
  float* red = reinterpret_cast<float*>(ring);               // [warp][m][col], after the loop
  float* recv = reinterpret_cast<float*>(ring + lay.recv);  // the other chunks' sums of my share
  float* wacc = reinterpret_cast<float*>(ring + lay.wacc);  // [warp][m][col], between windows

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the cluster spans gridDim.x
  const int csize = gridDim.x;
  const int n0 = blockIdx.y * kTileN;
  const int s0 = rank * p.chunk_stages;  // the chunk's first stage
  const int nst = max(0, min(p.chunk_stages, p.nstages - s0));
  const int k0 = s0 * kK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool producer = warp == kConsumers;
  const uint32_t full = sm90::smem_addr(bars), empty = full + 8 * kRing;
  // int4 grouped: with a group of 128 or a multiple of it a stage (128 k)
  // lies in one group, whose scales come with the stage by TMA; other groups
  // are read from global memory at each group's end (the fma path)
  const bool tma_scales = FMT == kInt4G && (!kAny || p.group % kGroup == 0);
  const uint32_t tx = kStageBytes + (tma_scales ? kTileN * 4 : 0);

  // the weights are read once: they go through L2 first in line for
  // eviction, so that x, the gains and the code stay there between calls
  const uint64_t stream_policy = sm90::evict_first_policy();
  auto issue = [&](int s) {
    const int slot = s % nring;
    sm90::mbar_expect_tx(full + 8 * slot, tx);
    sm90::tma_load_2d_hint(sm90::smem_addr(ring + slot * kStageBytes), &wmap, full + 8 * slot, n0,
                           (s0 + s) * kStageRows, stream_policy);
    if (tma_scales)
      sm90::tma_load_2d(sm90::smem_addr(sring + slot * kTileN), &smap, full + 8 * slot, n0,
                        (s0 + s) * kK / p.group);
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < nring; ++i) {
      sm90::mbar_init(full + 8 * i, 1);
      sm90::mbar_init(empty + 8 * i, 1);  // lane 0 of the consuming warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // A block may touch another's shared memory only once that block has
  // started: every thread arrives here and waits before its first remote
  // access (the RMSNorm sums, or the epilogue's sums)
  cluster_arrive_relaxed();
  // 1. x is staged one window of the chunk at a time (the whole chunk when
  // it fits). The window's x (and its RMSNorm gains) is requested before the
  // weights: a load issued behind a full ring waits for the ring's bytes to
  // reach this SM. The consumers issue their first batch of loads, then let
  // the producer fill the ring; they store x raw in xs, with the squares of
  // each 8-k vector for the statistics. Items: (row, vector) pairs of x,
  // row-major, then with RMSNorm the window's gain vectors (gate and up);
  // kU of them per thread have their loads in flight at once.
  const int nwin = kAny ? max(1, (nst + p.win - 1) / p.win) : 1;
  const int wk = p.win * kK;                // staged k of a window
  const bool vec = !kAny || p.K % 8 == 0;   // x's rows and the gains in aligned 8-vectors
  const bool bf = kMma || p.act;   // x in bf16
  const int xrows = xs_rows_of(kMma, p.M);  // up's rows follow x's with SwiGLU
  auto window = [&](int w) {
    Win r;
    r.ws = w * p.win;
    r.we = min(nst, r.ws + p.win);
    r.kw = k0 + r.ws * kK;
    r.nvs = (r.we - r.ws) * kK / 8;
    r.kc = max(0, min((r.we - r.ws) * kK, p.K - r.kw));
    r.nv = (r.kc + 7) / 8;
    return r;
  };
  auto count = [&](const Win& W) { return p.M * W.nvs + (p.has_norm ? W.nvs : 0); };
  constexpr int kU = 4;
  constexpr int kC = kConsumers * 32;  // consumer threads
  constexpr int kBatch = kU * kC;
  auto load8 = [&](const void* src, int64_t at, bool bits16, int n) {
    return vec ? raw8(src, at, bits16) : raw8_n(src, at, bits16, n);
  };
  auto load_batch = [&](const Win& W, int i0, Raw8 (&ra)[kU], Raw8 (&rb)[kU]) {
    const int items = p.M * W.nvs, all = count(W);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kC;
      if (i < items) {
        const int m = i / W.nvs, v = i - m * W.nvs;
        if (v < W.nv) {
          const int64_t at = (int64_t)m * p.xk + W.kw + 8 * v;
          const int n = min(8, W.kc - 8 * v);
          ra[u] = load8(p.x, at, bf, n);
          if (p.swiglu) rb[u] = load8(p.x, at + p.K, bf, n);
        }
      } else if (i < all && i - items < W.nv) {
        const int v = i - items, n = min(8, W.kc - 8 * v);
        ra[u] = load8(p.g, W.kw + 8 * v, p.g_bf16, n);
        if (p.swiglu) rb[u] = load8(p.g, p.K + W.kw + 8 * v, p.g_bf16, n);
      }
    }
  };
  auto store_batch = [&](const Win& W, int i0, const Raw8 (&ra)[kU], const Raw8 (&rb)[kU]) {
    const int items = p.M * W.nvs, all = count(W);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kC;
      if (i >= all) continue;
      const bool gain = i >= items;
      const int m = gain ? 0 : i / W.nvs, v = gain ? i - items : i - m * W.nvs;
      const bool real = v < W.nv;
      float a[8], b[8];
      const bool bits16 = gain ? p.g_bf16 != 0 : bf;
      if (real) unpack8(ra[u], bits16, a);
      if (real && p.swiglu) unpack8(rb[u], bits16, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!real) a[j] = b[j] = 0.f;
        if (!p.swiglu) b[j] = 0.f;
      }
      if (gain) {
        store8<false>(reinterpret_cast<uint8_t*>(gs), 8 * v, a);
        if (p.swiglu) store8<false>(reinterpret_cast<uint8_t*>(gs), wk + 8 * v, b);
        continue;
      }
      store8<kMma>(xs, m * xs_ld + 8 * v, a);
      if (p.swiglu) store8<kMma>(xs, (xrows + m) * xs_ld + 8 * v, b);
      if (p.has_norm) {
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) sq += a[j] * a[j] + b[j] * b[j];
        sqi[i] = sq;
      }
    }
  };
  // a later window of x, raw, once every consumer is done with the last one
  constexpr int kBar = 2;  // the consumers' named barrier
  auto stage_window = [&](const Win& W) {
    named_sync(kBar, kC);
    Raw8 ra[kU], rb[kU];
    for (int i0 = tid; i0 < count(W); i0 += kBatch) {
      load_batch(W, i0, ra, rb);
      store_batch(W, i0, ra, rb);
    }
    named_sync(kBar, kC);
  };
  // From here the producer warp takes part in no block barrier until the
  // main loop is over, and in the prologue's cluster barrier only by arriving
  // early: TMA issue can stall it, and the consumers must not wait for that.
  // With a prologue to run (RMSNorm, SwiGLU), only stage 0 goes out before
  // it and the rest of the ring after x' is formed: with the ring in flight
  // everything the prologue fetches, its instructions and the cluster
  // barrier's messages included, queues behind the ring's bytes (3-5 us of
  // a 7B qkv call on an H100). Without one, the ring follows x's requests.
  const bool late = p.has_norm || p.swiglu;
  const int g = lane >> 2, t = lane & 3;
  if (producer) {
    if (late && lane == 0 && nst > 0) issue(0);
    __syncwarp();
    if (p.has_norm) {
      cluster_wait();
      cluster_arrive();
    }
    named_sync(1, kThreads);  // the consumers' loads of x are out (one batch), or x' is formed
    // 4. stream the chunk: the producer fills the ring, then refills each
    // slot as its warp frees it
    if (lane == 0) {
      for (int s = late ? 1 : 0; s < min(nst, nring); ++s) issue(s);
      for (int s = nring; s < nst; ++s) {
        sm90::mbar_wait(empty + 8 * (s % nring), ((s / nring) & 1) ^ 1);
        issue(s);
      }
    }
    __syncwarp();
    cluster_wait();
  } else {
    {
      const Win W = window(0);
      const int all = count(W);
      const bool one_batch = all <= kBatch;
      Raw8 ra[kU], rb[kU];
      load_batch(W, tid, ra, rb);
      __syncwarp();
      if (one_batch && !late) named_arrive(1, kThreads);
      store_batch(W, tid, ra, rb);
      for (int i0 = tid + kBatch; i0 < all; i0 += kBatch) {
        load_batch(W, i0, ra, rb);
        store_batch(W, i0, ra, rb);
      }
      __syncwarp();
      if (!one_batch && !late) named_arrive(1, kThreads);
      named_sync(kBar, kC);
    }

    // 2. RMSNorm statistics: each row's squares over the chunk, window by
    // window (warp w owns rows w, w + 4, ...); each row's sum goes to slot
    // [rank][m] of every block's table, then every block adds its table in
    // rank order
    if (p.has_norm) {
      float sqs[kMaxM / kConsumers];
#pragma unroll
      for (int r = 0; r < kMaxM / kConsumers; ++r) sqs[r] = 0.f;
      for (int w = 0; w < nwin; ++w) {
        const Win W = window(w);
        if (w > 0) stage_window(W);
#pragma unroll
        for (int r = 0; r < kMaxM / kConsumers; ++r) {
          const int m = warp + kConsumers * r;
          if (m < p.M)
            for (int v = lane; v < W.nvs; v += 32) sqs[r] += sqi[m * W.nvs + v];
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxM / kConsumers; ++r)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sqs[r] += __shfl_xor_sync(0xffffffffu, sqs[r], o);
      cluster_wait();
#pragma unroll
      for (int r = 0; r < kMaxM / kConsumers; ++r) {
        const int m = warp + kConsumers * r;
        if (m < p.M && lane < csize) cluster.map_shared_rank(ss, lane)[rank * kMaxM + m] = sqs[r];
      }
      cluster_arrive();
      cluster_wait();
      if (tid < p.M) {
        float t = 0.f;
        for (int q = 0; q < csize; ++q) t += ss[q * kMaxM + tid];
        rsd[tid] = 1.0f / sqrtf(t / (float)p.xk + p.eps);
      }
      if (nwin > 1)
        stage_window(window(0));  // x of the first window again
      else
        named_sync(kBar, kC);
    }

    int off[4];
    off[0] = swizzled(t, slot_of(g));
    off[1] = swizzled(t, slot_of(g + 8));
    off[2] = swizzled(t + 4, slot_of(g));
    off[3] = swizzled(t + 4, slot_of(g + 8));
    for (int w = 0; w < nwin; ++w) {
      const Win W = window(w);
      if (w > 0) stage_window(W);
      // 3. x' in place: the prologue on the staged gate (and up) values
      if (p.has_norm || p.swiglu) {
        for (int i = tid; i < p.M * W.nvs; i += kC) {
          const int m = i / W.nvs, v = i - m * W.nvs;
          if (v >= W.nv) continue;
          float a[8], b[8], gn[8], gu[8];
          load8s<kMma>(xs, m * xs_ld + 8 * v, a);
          if (p.swiglu) load8s<kMma>(xs, (xrows + m) * xs_ld + 8 * v, b);
          if (p.has_norm) load8s<false>(reinterpret_cast<const uint8_t*>(gs), 8 * v, gn);
          if (p.has_norm && p.swiglu)
            load8s<false>(reinterpret_cast<const uint8_t*>(gs), wk + 8 * v, gu);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (!p.swiglu) b[j] = 0.f;
            if (!p.has_norm) gn[j] = gu[j] = 1.f;
            if (p.has_norm && !p.swiglu) gu[j] = 1.f;
          }
          prologue8(p, p.has_norm ? rsd[m] : 1.f, a, b, gn, gu);
          store8<kMma>(xs, m * xs_ld + 8 * v, a);
        }
        named_sync(kBar, kC);
      }
      if (w == 0 && late) named_arrive(1, kThreads);

      // 4. consumer warp w takes the window's stages s with s % 4 == w. Its
      // sums live only here, where no x is being staged: a window before the
      // last adds them to the warp's accumulator in shared memory (wacc);
      // after the last, once every warp has consumed its stages, the ring
      // is free and they go into it (red), to be added in warp order
      const int first = W.ws + (warp - W.ws % kConsumers + kConsumers) % kConsumers;
      const bool last = w + 1 == nwin;
      const float* wa = wacc + warp * p.M * kTileN;
      if constexpr (kMma) {
        float run[NT][8][4];  // [n8 tile][instance][C fragment]
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) run[nt][j][e] = 0.f;
        for (int s = first; s < W.we; s += kConsumers) {
          const int slot = s % nring;
          sm90::mbar_wait(full + 8 * slot, (s / nring) & 1);
          float pt[NT][8][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) pt[nt][j][e] = 0.f;
          mma_stage<NT>(pt, ring + slot * kStageBytes, reinterpret_cast<const __nv_bfloat16*>(xs),
                        xs_ld, (s - W.ws) * kK, p.M, off, g, t);
          if constexpr (FMT == kInt4G) {
            // the stage's group scales at the thread's columns 8 slot_of(rho) + j
            const float4* sc = reinterpret_cast<const float4*>(sring + slot * kTileN);
            const float4 l0 = sc[2 * slot_of(g)], l1 = sc[2 * slot_of(g) + 1];
            const float4 h0 = sc[2 * slot_of(g + 8)], h1 = sc[2 * slot_of(g + 8) + 1];
            const float s_lo[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
            const float s_hi[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                run[nt][j][0] = fmaf(pt[nt][j][0], s_lo[j], run[nt][j][0]);
                run[nt][j][1] = fmaf(pt[nt][j][1], s_lo[j], run[nt][j][1]);
                run[nt][j][2] = fmaf(pt[nt][j][2], s_hi[j], run[nt][j][2]);
                run[nt][j][3] = fmaf(pt[nt][j][3], s_hi[j], run[nt][j][3]);
              }
          } else {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) run[nt][j][e] += pt[nt][j][e];
          }
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(empty + 8 * slot);
        }
        if (last) named_sync(kBar, kC);
        float* dst = (last ? red : wacc) + warp * p.M * kTileN;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int m = 8 * nt + 2 * t + (e & 1);
              const int col = 8 * slot_of(e < 2 ? g : g + 8) + j;
              if (m < p.M) dst[m * kTileN + col] = (w ? wa[m * kTileN + col] : 0.f) + run[nt][j][e];
            }
      } else {
        constexpr int kRowsPerByte = FMT == kInt8 ? 1 : 2;
        const float* xf = reinterpret_cast<const float*>(xs);
        float acc[MT][4];  // [row of x][column]
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
        for (int s = first; s < W.we; s += kConsumers) {
          const int slot = s % nring;
          sm90::mbar_wait(full + 8 * slot, (s / nring) & 1);
          const uint8_t* tile = ring + slot * kStageBytes;
          const float* xr = xf + (s - W.ws) * kK;
          float pt[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int c = 0; c < 4; ++c) pt[m][c] = 0.f;
          if (FMT == kInt4G && !tma_scales) {
            // groups that end inside a stage: each group's partial dot is
            // scaled at its end (or at the stage's) by its scales, read
            // from global memory
            const int half = p.group / 2;  // byte rows per group
            const int row0 = (s0 + s) * kStageRows;
            int grp = row0 / half, left = half - row0 % half;
            for (int r = 0; r < kStageRows; ++r) {
              const uint32_t wd = *reinterpret_cast<const uint32_t*>(
                  tile + r * 128 + ((((lane >> 2) ^ (r & 7)) << 4) | ((lane & 3) << 2)));
              mac_row<MT, FMT, kAny>(pt, wd, xr + r * kRowsPerByte, xs_ld, p.M);
              if (--left == 0 || r == kStageRows - 1) {
                const float4 s4 =
                    grp < p.K / p.group
                        ? __ldg(reinterpret_cast<const float4*>(p.scale + (int64_t)grp * p.N +
                                                                n0 + lane * 4))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
                const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
                for (int m = 0; m < MT; ++m)
#pragma unroll
                  for (int c = 0; c < 4; ++c) {
                    acc[m][c] = fmaf(pt[m][c], sc[c], acc[m][c]);
                    pt[m][c] = 0.f;
                  }
                if (left == 0) {
                  ++grp;
                  left = half;
                }
              }
            }
          } else {
#pragma unroll 4
            for (int r = 0; r < kStageRows; ++r) {
              const uint32_t wd = *reinterpret_cast<const uint32_t*>(
                  tile + r * 128 + ((((lane >> 2) ^ (r & 7)) << 4) | ((lane & 3) << 2)));
              mac_row<MT, FMT, kAny>(pt, wd, xr + r * kRowsPerByte, xs_ld, p.M);
            }
            if (FMT == kInt4G) {
              const float4 s4 = *reinterpret_cast<const float4*>(sring + slot * kTileN + lane * 4);
              const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
              for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(pt[m][c], sc[c], acc[m][c]);
            } else {
#pragma unroll
              for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[m][c] += pt[m][c];
            }
          }
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(empty + 8 * slot);
        }
        if (last) named_sync(kBar, kC);
        float* dst = (last ? red : wacc) + warp * p.M * kTileN;
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (m < p.M) {
            const float4 b = w ? *reinterpret_cast<const float4*>(wa + m * kTileN + lane * 4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(dst + m * kTileN + lane * 4) =
                make_float4(b.x + acc[m][0], b.y + acc[m][1], b.z + acc[m][2], b.w + acc[m][3]);
          }
      }
    }
    // 5. every warp's sums are in the ring
    named_sync(kBar, kC);
  }

  // 6. rank r finishes columns [r cols, (r + 1) cols) of the tile. Each block
  // pushes its chunk's sums of every column to the column's rank (into
  // shared memory the ring does not use: the rank may still be streaming),
  // one cluster barrier later every rank adds its table in rank order.
  const int cols = (kTileN + csize - 1) / csize;
  if (!producer) {
    if (!p.has_norm) cluster_wait();
    for (int i = tid; i < p.M * kTileN; i += kC) {
      const int m = i / kTileN, c = i - m * kTileN;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumers; ++w) s += red[w * p.M * kTileN + i];
      cluster.map_shared_rank(recv, c / cols)[(rank * p.M + m) * cols + c % cols] = s;
    }
  }
  cluster.sync();
  for (int i = tid; i < p.M * cols; i += kThreads) {
    const int m = i / cols, cl = i - m * cols, c = rank * cols + cl;
    if (c >= kTileN) continue;
    float s = 0.f;
    for (int q = 0; q < csize; ++q) s += recv[(q * p.M + m) * cols + cl];
    if (FMT != kInt4G) s *= p.scale[n0 + c];
    finish(p, (int64_t)m * p.N + n0 + c, s);
  }
}

// ------------------------------------------------------------ host side

// Tensor maps depend only on (pointer, shape, type), so each is encoded once.
struct MapKey {
  const void* p;
  int64_t cols, rows;
  int kind;
  bool operator==(const MapKey& o) const {
    return p == o.p && cols == o.cols && rows == o.rows && kind == o.kind;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<const void*>()(k.p) ^ (size_t(k.cols) * 0x9E3779B97F4A7C15ull) ^
           (size_t(k.rows) << 20) ^ size_t(k.kind);
  }
};

std::mutex g_maps_mu;
std::unordered_map<MapKey, CUtensorMap, MapKeyHash> g_maps;
int g_last_path = -1;

// kind 0: packed weights (rows x N bytes), boxes of 128 bytes x 64 rows in
// the 128-byte swizzle; kind 1: group scales (rows x N float32), 128 x 1
cudaError_t cached_map(CUtensorMap* out, int kind, const void* p, int64_t cols, int64_t rows) {
  const MapKey key{p, cols, rows, kind};
  std::lock_guard<std::mutex> lock(g_maps_mu);
  auto it = g_maps.find(key);
  if (it != g_maps.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  CUtensorMap map;
  const cudaError_t e =
      kind == 0 ? sm90::encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, p, cols, rows, cols, kTileN,
                                  kStageRows, CU_TENSOR_MAP_SWIZZLE_128B)
                : sm90::encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p, cols, rows, 4 * cols,
                                  kTileN, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  if (g_maps.size() > 4096) g_maps.clear();  // weights freed long ago
  g_maps.emplace(key, map);
  *out = map;
  return cudaSuccess;
}

struct Launch {
  CUtensorMap wmap, smap;
  Params p;
  int cluster, tiles, smem;
  bool any;  // the shape needs the kAny instance
  cudaStream_t stream;
  int* max_clusters;  // set: report the occupancy instead of launching
};

template <bool kMma, int FMT, int MT, bool kAny>
cudaError_t run_one(const Launch& l) {
  auto kernel = qmv_kernel<kMma, FMT, MT, kAny>;
  static int smem_set = 48 * 1024;  // per instance
  if (l.smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    smem_set = kMaxSmem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.cluster, l.tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = l.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (l.max_clusters) return cudaOccupancyMaxActiveClusters(l.max_clusters, kernel, &cfg);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, l.wmap, l.smap, l.p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the kAny instance is built at MT = 1 (fma) and 16 only: it reads no row
// past M
template <bool kMma, int FMT, int MT>
cudaError_t run(const Launch& l) {
  if (!l.any) return run_one<kMma, FMT, MT, false>(l);
  if constexpr (!kMma)
    if (l.p.M == 1) return run_one<false, FMT, 1, true>(l);
  return run_one<kMma, FMT, kMaxM, true>(l);
}

template <int FMT>
cudaError_t run_fma(const Launch& l) {
  const int M = l.p.M;
  if (M <= 1) return run<false, FMT, 1>(l);
  if (M <= 2) return run<false, FMT, 2>(l);
  if (M <= 4) return run<false, FMT, 4>(l);
  if (M <= 8) return run<false, FMT, 8>(l);
  return run<false, FMT, 16>(l);
}

cudaError_t dispatch(int fmt, bool mma, const Launch& l) {
  if (mma) {
    if (fmt == kInt4G) return l.p.M <= 8 ? run<true, kInt4G, 8>(l) : run<true, kInt4G, 16>(l);
    return l.p.M <= 8 ? run<true, kInt4, 8>(l) : run<true, kInt4, 16>(l);
  }
  switch (fmt) {
    case kInt8: return run_fma<kInt8>(l);
    case kInt4: return run_fma<kInt4>(l);
    default: return run_fma<kInt4G>(l);
  }
}

// Validates a call and fills `l` (maps, params, launch shape); x, out and
// the pointers the kernel reads through a map may be null when only the
// occupancy is asked for.
cudaError_t prepare(Launch* l, int fmt, int act, const void* x, const void* w, const void* scale,
                    const void* g, const void* residual, void* out, int M, int K, int N, int xk,
                    int group, int chunk_stages, int cluster, int ring, int swiglu, int has_norm,
                    int g_bf16, float eps, void* stream, bool* mma) {
  if (fmt < 0 || fmt > 2 || (act != 0 && act != 1) || M < 1 || M > kMaxM || N < kTileN ||
      N % kTileN || N / kTileN > 65535 || K < 1 || (fmt != kInt8 && K % 2) ||
      xk != (swiglu ? 2 * K : K) || (fmt == kInt4G && (group < 2 || group % 2 || K % group)) ||
      cluster < 1 || cluster > kMaxCluster || chunk_stages < 1 || (has_norm && !g) || !w || !scale)
    return cudaErrorInvalidValue;
  const int rows = fmt == kInt8 ? K : K / 2;
  const int nstages = (rows + kStageRows - 1) / kStageRows;
  if ((int64_t)chunk_stages * cluster < nstages) return cudaErrorInvalidValue;
  // the tensor cores take bf16 x int4 when each stage lies in one scale group
  *mma = act == 1 && fmt != kInt8 && (fmt != kInt4G || group % kGroup == 0);
  if (ring < 1 || ring > kRing || (ring % kConsumers && ring < chunk_stages) || ring > chunk_stages)
    return cudaErrorInvalidValue;
  // x' is staged for the whole chunk when it fits, else in even windows of
  // the most stages that fit
  int win = chunk_stages;
  const bool windowed = smem_bytes(*mma, fmt, M, win, ring, swiglu, has_norm, false) > kMaxSmem;
  l->any = windowed || K % 8 || (fmt == kInt4G && group % kGroup);
  if (windowed) {
    while (win > 1 && smem_bytes(*mma, fmt, M, win, ring, swiglu, has_norm, true) > kMaxSmem) --win;
    const int nwin = (chunk_stages + win - 1) / win;
    win = (chunk_stages + nwin - 1) / nwin;
  }
  const int smem = smem_bytes(*mma, fmt, M, win, ring, swiglu, has_norm, windowed);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  std::memset(&l->smap, 0, sizeof(l->smap));
  cudaError_t e = cached_map(&l->wmap, 0, w, N, rows);
  if (e != cudaSuccess) return e;
  if (fmt == kInt4G && group % kGroup == 0) {
    e = cached_map(&l->smap, 1, scale, N, K / group);
    if (e != cudaSuccess) return e;
  }
  l->p = Params{x, reinterpret_cast<const float*>(scale), g, residual, out, M, K, N, xk,
                chunk_stages, nstages, ring, swiglu, has_norm, g_bf16 ? 1 : 0, act,
                fmt == kInt4G ? group : 0, win, eps};
  l->cluster = cluster;
  l->tiles = N / kTileN;
  l->smem = smem;
  l->stream = reinterpret_cast<cudaStream_t>(stream);
  l->max_clusters = nullptr;
  return cudaSuccess;
}

}  // namespace

// Returns 0 or a CUDA error code. One launch on `stream`: grid (cluster,
// N / 128) in clusters of `cluster` blocks along x, each block a chunk of
// `chunk_stages` stages of K through a ring of `ring` stages (a multiple of 4,
// or the whole chunk). `group`: k per scale group of fmt 2 (ignored
// otherwise). Does not synchronise and allocates nothing.
extern "C" int ia2p_qmv(int fmt, int act, const void* x, const void* w, const void* scale,
                        const void* g, const void* residual, void* out, int M, int K, int N, int xk,
                        int group, int chunk_stages, int cluster, int ring, int swiglu,
                        int has_norm, int g_bf16, float eps, void* stream) {
  Launch l;
  bool mma = false;
  if (!x || !out) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare(&l, fmt, act, x, w, scale, g, residual, out, M, K, N, xk, group,
                          chunk_stages, cluster, ring, swiglu, has_norm, g_bf16, eps, stream, &mma);
  if (e != cudaSuccess) return (int)e;
  e = dispatch(fmt, mma, l);
  if (e == cudaSuccess) g_last_path = mma ? kPathMma : kPathFma;
  return (int)e;
}

// The path of the last launch that ia2p_qmv made: 0 fma, 1 mma.
extern "C" int ia2p_qmv_last_path() { return g_last_path; }

// How many clusters of the call's launch can be resident on the card at
// once (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
extern "C" int ia2p_qmv_max_active_clusters(int fmt, int act, const void* w, const void* scale,
                                            int M, int K, int N, int group, int chunk_stages,
                                            int cluster, int ring, int swiglu, int has_norm) {
  Launch l;
  bool mma = false;
  static const float dummy_g = 1.f;
  cudaError_t e = prepare(&l, fmt, act, nullptr, w, scale, has_norm ? &dummy_g : nullptr, nullptr,
                          nullptr, M, K, N, swiglu ? 2 * K : K, group, chunk_stages, cluster, ring,
                          swiglu, has_norm, 0, 1e-6f, nullptr, &mma);
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  l.max_clusters = &n;
  e = dispatch(fmt, mma, l);
  return e == cudaSuccess ? n : -(int)e;
}
