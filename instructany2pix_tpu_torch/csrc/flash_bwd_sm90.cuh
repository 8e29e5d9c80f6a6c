// K4's fused backward for Hopper (sm_90a) at head_dim 64, 80 and 128: dq,
// dk and dv from one kernel on TMA and wgmma. Included by flash_bwd.cu,
// whose `ia2p_flash_bwd` routes every bf16 call with D in {64, 80, 128},
// 16-byte aligned rows and a float32 dq accumulator here. It replaces both
// TPU kernels of instructany2pix_tpu/ops/flash_attention.py,
// `_flash_bwd_dq_kernel` (K4a) and `_flash_bwd_dkv_kernel` (K4b), and
// computes what they compute, from the forward's float32 lse and
// delta = rowsum(dO * O):
//   * s = q . k * scale in float32; p = exp(s - lse), set to 0 where masked
//     (the end-aligned causal rule key <= row + Sk - Sq, the kv_len[b]
//     tail, keys past Sk and query rows past Sq); exponentials in base 2,
//     with log2 e folded into the scale and lse, as in K1;
//   * dp = dO . v^T and ds = p (dp - delta) scale in float32;
//   * dq = ds . k, dk = ds^T . q and dv = p^T . dO with ds and p rounded to
//     bf16 before each product, float32 accumulators, dk and dv written in
//     bf16; dq is added into a zeroed float32 (B, H, Sq, D) accumulator that
//     the caller rounds to bf16 once, after the kernel.
// p is computed once per (query tile, key block): the two TPU kernels (and
// flash_bwd.cu's K4a and K4b) each compute it, 7 products where a fused
// backward needs 5.
//
// What bounds it: at the Llama training shape ((4,32,2048,128) causal) the
// 5 products are 344 GFLOP against ~0.2 GB of traffic, 0.35 ms of the
// tensor cores against 0.06 ms of HBM: the tensor cores. The design, FA2's
// and FA3's key-major backward on K1's machinery:
//   * one block per (128 keys, b*h); the grid walks groups of 8 heads, each
//     group's first key blocks before its second ones: under the causal
//     rule the heaviest blocks start first, and the blocks in flight share
//     few heads, so the dq accumulator's rows stay in L2 for the
//     reduce-adds;
//   * a producer warpgroup (24 registers), of which one thread issues every
//     TMA load and one warp copies each tile's 64 lse and delta values, and
//     two consumer warpgroups of 64 keys each (240): k and v are loaded
//     once per block and stay in shared memory; 64-row tiles of q and dO
//     with their lse and delta come through a ring of kStages stages with
//     full and empty barriers. The query loop starts at the first tile that
//     sees the block's keys, and a block wholly past kv_len[b] loads
//     nothing and writes zeros;
//   * per tile each consumer warpgroup runs m64 wgmma only:
//     S^T = K.Q^T and dP^T = V.dO^T (both operands K-major from shared
//     memory, as K1's Q.K^T), p and ds in registers (the m16n8 C layout,
//     which is also the register A layout), dV += P^T.dO and dK += dS^T.Q
//     (A from registers, dO and q MN-major through the transpose bit, as
//     K1 reads v); dk and dv stay float32 in registers (64 + 64 a thread
//     at D = 128);
//   * dS^T goes to shared memory in bf16 (128-byte swizzled rows, one per
//     key, double-buffered) and dQ = dS.K is one more wgmma with both
//     operands MN-major: at D = 128 each warpgroup takes 64 of the 128
//     columns over all 128 keys (the two warpgroups meet at a named
//     barrier once per tile), at D = 64 and 80 each takes its own 64 keys
//     over all D columns. S's and dP's registers are free by then;
//   * dQ's tile goes through shared memory into the accumulator by TMA
//     reduce-adds (float32 adds in L2, issued by one thread per warpgroup)
//     in boxes of 32 columns, so the order of its float32 sums changes from
//     run to run: a few ulps of float32, far inside the bf16 terms of the
//     check's limit (K4_TOL in chip_smoke.py), which come from rounding ds
//     and p;
//   * at D = 80 a 160-byte row is no whole number of 128-byte boxes: as in
//     K1 (flash_fwd_sm90.cuh), q, k, v and dO come as a 64-column box in
//     the 128-byte swizzle plus a 16-column tail box in the 32-byte one.
//     S^T and dP^T take their 5th k-step from the tail boxes; dV, dK and dQ,
//     whose N is D, are an n64 wgmma on the main box plus an n16 on the
//     tail (dk and dv: 40 + 40 float32 registers a thread); dQ's tile goes
//     out as two 32-column boxes plus a 16-column (64-byte) one in the
//     64-byte swizzle. Shared memory: k and v 2 x 20 KB, two q/dO stages
//     40 KB, dS^T 32 KB, two dQ tiles 40 KB, 155 KB in all.
// Left for later: overlap inside a warpgroup (FA3's schedule), clusters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "sm90_common.cuh"

namespace {
namespace sm90 {
namespace bwd {

constexpr int kKeys = 128;     // keys per block: two consumer warpgroups of 64
constexpr int kQRows = 64;     // query rows per tile of the ring
constexpr int kThreads = 384;  // the producer warpgroup, then the two consumers
constexpr int kStages = 2;
constexpr int kHeadGroup = 8;  // heads whose key blocks run together (see the grid below)
constexpr uint32_t kKHalf = kKeys * kRowBytes;   // a 64-column half of the k or v tile
constexpr uint32_t kQHalf = kQRows * kRowBytes;  // of a q or dO tile; also a 32-column dQ box
constexpr uint32_t kDsBytes = kKeys * kRowBytes;  // dS^T: 128 keys x 64 queries in bf16
constexpr uint32_t kStatBytes = 2 * kQRows * 4;   // a stage's lse, then its delta
constexpr int kDqBoxCols = 32;  // float32 columns per TMA box of dQ: one 128-byte swizzle row

// Widths and offsets in shared memory from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows); every box starts 1024-byte
// aligned.
template <int D>
struct Layout {
  static constexpr int kHalves = D / kBoxCols;  // 64-column boxes in the 128-byte swizzle
  static constexpr int kTail = D % kBoxCols;    // columns in the 32-byte swizzled tail box
  static_assert(kTail == 0 || kTail == 16, "head_dim 64, 80 or 128");
  static constexpr int kMainCols = kHalves * kBoxCols;
  static constexpr uint32_t kTailRow = kTail * 2;  // bytes of a tail-box row
  static constexpr int kDqCols = D == 128 ? 64 : D;  // columns of a warpgroup's dQ tile
  static constexpr uint32_t kKvTile = kHalves * kKHalf + kKeys * kTailRow;
  static constexpr uint32_t kQTile = kHalves * kQHalf + kQRows * kTailRow;
  static constexpr uint32_t kStageBytes = 2 * kQTile;  // q, then dO
  static constexpr uint32_t kDqTile = kQRows * kDqCols * 4;  // float32
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kKvTile;
  static constexpr uint32_t kRing = kV + kKvTile;
  static constexpr uint32_t kDs = kRing + kStages * kStageBytes;  // two buffers
  static constexpr uint32_t kDq = kDs + 2 * kDsBytes;  // one tile per warpgroup
  static constexpr uint32_t kStats = kDq + 2 * kDqTile;
  static constexpr uint32_t kBars = kStats + kStages * kStatBytes;
  static constexpr size_t kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kKvTile % 1024 == 0 && kQTile % 1024 == 0 && kDqTile % 1024 == 0,
                "boxes 1024-byte aligned");
  static_assert(kSmem <= kMaxSmem, "shared memory");
};

// The tensor maps: q, k, v and dO in 64-column boxes in the 128-byte
// swizzle, the dq accumulator in 32-column float32 boxes in the same, and
// at D = 80 the tail boxes of columns 64..79 (bf16 in the 32-byte swizzle,
// dq's float32 in the 64-byte one; unused, zero, at D = 64 and 128).
struct Maps {
  CUtensorMap q, k, v, g, dq;
  CUtensorMap q_tail, k_tail, v_tail, g_tail, dq_tail;
};

struct Params {
  const float *lse, *delta;  // float32 (B*H, Sq), contiguous
  __nv_bfloat16* dk;
  int64_t kb, kh, ks;
  __nv_bfloat16* dv;
  int64_t vb, vh, vs;
  const int* kv_len;  // (B,) or null
  int B, H, Sq, Sk;
  float scale;
  int causal;
};

// p = 2^(s scale log2 e - lse log2 e) in place of s, for the thread's two
// keys and the tile's queries 8 j + 2 t4 (+1); with kMask, 0 where the pair
// is masked (the tile holds a row past Sq, a key past kv_len or Sk, or a
// pair across the causal diagonal).
template <bool kMask>
__device__ __forceinline__ void probs(float (&s)[32], const float* lse, int t4,
                                      const int (&keys)[2], int q0, int Sq, int skb, int causal,
                                      int offset, float scale2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t4 + (e & 1);
      float x = ex2(s[4 * j + e] * scale2 - ((e & 1) ? l.y : l.x) * kLog2e);
      if (kMask) {
        const int row = q0 + col;
        const int key = keys[e >> 1];
        const bool valid = row < Sq && key < skb && (!causal || key <= row + offset);
        x = valid ? x : 0.f;
      }
      s[4 * j + e] = x;
    }
  }
}

// p (or ds) rounded to bf16 as the A operand of a wgmma: a[kk] covers
// queries 16 kk .. 16 kk + 15 of the tile
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[kk][e] = MmaOps<__nv_bfloat16>::pack(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = Layout<D>;
  constexpr int kHalves = L::kHalves;
  constexpr int kTail = L::kTail;
  constexpr int kMainCols = L::kMainCols;
  constexpr uint32_t kTailRow = L::kTailRow;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sk = base + L::kK;
  const uint32_t sv = base + L::kV;
  const uint32_t ring = base + L::kRing;
  const uint32_t sds = base + L::kDs;
  const uint32_t stats = base + L::kStats;
  const uint32_t kv_full = base + L::kBars;
  const uint32_t full = kv_full + 8;           // + 8 stage
  const uint32_t empty = full + 8 * kStages;   // + 8 stage

  // The grid walks groups of kHeadGroup heads, and in a group every head's
  // first key block, then every head's second, ...: the heaviest blocks
  // under the causal rule start first, while the blocks in flight share
  // few heads, whose dq accumulator rows (and q and dO) stay in L2.
  const int tid = threadIdx.x;
  const int n_kb = (p.Sk + kKeys - 1) / kKeys;
  const int group = blockIdx.x / (kHeadGroup * n_kb);
  const int in_group = blockIdx.x - group * kHeadGroup * n_kb;
  const int heads = min(kHeadGroup, p.B * p.H - group * kHeadGroup);
  const int bh = group * kHeadGroup + in_group % heads;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int key0 = (in_group / heads) * kKeys;
  const int offset = p.Sk - p.Sq;  // causal alignment at the end
  const int skb = visible_keys(p.kv_len, b, p.Sk);
  // the first query tile whose rows can see key0 under the causal rule
  // (row >= key0 - offset); a block wholly past kv_len sees none
  const int qt0 = p.causal ? max(key0 - offset, 0) / kQRows : 0;
  const int n_tiles = key0 < skb ? max((p.Sq + kQRows - 1) / kQRows - qt0, 0) : 0;

  if (tid == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1 + 32);  // the TMA thread and the warp copying lse and delta
      mbar_init(empty + 8 * st, 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer: one thread loads k and v once, then keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid >= 32 && tid < 64) {
      // warp 1: each tile's lse and delta into the stage, 0 past Sq
      const float* lse_bh = p.lse + int64_t(bh) * p.Sq;
      const float* delta_bh = p.delta + int64_t(bh) * p.Sq;
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(empty + 8 * stage, ((it / kStages) & 1) ^ 1);
        const int row0 = (qt0 + it) * kQRows;
        float* stat = reinterpret_cast<float*>(smem_raw + (stats - raw) + stage * kStatBytes);
        for (int c = tid - 32; c < kQRows; c += 32) {
          const bool ok = row0 + c < p.Sq;
          stat[c] = ok ? lse_bh[row0 + c] : 0.f;
          stat[kQRows + c] = ok ? delta_bh[row0 + c] : 0.f;
        }
        mbar_arrive(full + 8 * stage);  // releases the stores to the consumers
      }
    } else if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(kv_full, 2 * L::kKvTile);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        tma_load(sk + hf * kKHalf, &maps.k, kv_full, hf * kBoxCols, key0, h, b);
        tma_load(sv + hf * kKHalf, &maps.v, kv_full, hf * kBoxCols, key0, h, b);
      }
      if constexpr (kTail > 0) {
        tma_load(sk + kHalves * kKHalf, &maps.k_tail, kv_full, kMainCols, key0, h, b);
        tma_load(sv + kHalves * kKHalf, &maps.v_tail, kv_full, kMainCols, key0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(empty + 8 * stage, ((it / kStages) & 1) ^ 1);  // passes at once on the first round
        const int row0 = (qt0 + it) * kQRows;
        const uint32_t bar = full + 8 * stage;
        const uint32_t dst = ring + stage * L::kStageBytes;
        mbar_expect_tx(bar, L::kStageBytes);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load(dst + hf * kQHalf, &maps.q, bar, hf * kBoxCols, row0, h, b);
          tma_load(dst + L::kQTile + hf * kQHalf, &maps.g, bar, hf * kBoxCols, row0, h, b);
        }
        if constexpr (kTail > 0) {
          tma_load(dst + kHalves * kQHalf, &maps.q_tail, bar, kMainCols, row0, h, b);
          tma_load(dst + L::kQTile + kHalves * kQHalf, &maps.g_tail, bar, kMainCols, row0, h, b);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns keys key0 + 64 cw .. key0 + 64 cw + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = tid / 128 - 1;
    const int ct = tid % 128;
    const int warp = ct / 32;
    const int lane = ct % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const int kw0 = key0 + 64 * cw;
    const int keys[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};
    const uint32_t k_rows = sk + cw * 64 * kRowBytes;  // this warpgroup's rows of half 0
    const uint32_t v_rows = sv + cw * 64 * kRowBytes;
    const uint32_t k_tail = sk + kHalves * kKHalf;  // the tail boxes, at D = 80
    const uint32_t v_tail = sv + kHalves * kKHalf;
    // dQ = dS.K: at D = 128 this warpgroup's 64 columns (its half of the k
    // tile) over all 128 keys; at D = 64 and 80 all columns over its own keys
    constexpr int kDqSteps = D == 128 ? kKeys / 16 : 64 / 16;
    const int dq_key0 = D == 128 ? 0 : 64 * cw;
    const uint32_t dq_k = sk + (D == 128 ? cw * kKHalf : 0) + dq_key0 * kRowBytes;
    const int dq_col0 = D == 128 ? 64 * cw : 0;
    const uint32_t dq_buf = base + L::kDq + cw * L::kDqTile;  // this warpgroup's dQ tile
    uint8_t* dq_tile = smem_raw + (dq_buf - raw);
    const float scale2 = p.scale * kLog2e;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    if (n_tiles > 0) mbar_wait(kv_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % kStages;
      const int q0 = (qt0 + it) * kQRows;
      const uint32_t q_tile = ring + stage * L::kStageBytes;
      const uint32_t g_tile = q_tile + L::kQTile;
      const uint32_t q_tail = q_tile + kHalves * kQHalf;  // at D = 80
      const uint32_t g_tail = g_tile + kHalves * kQHalf;
      const float* lse = reinterpret_cast<const float*>(smem_raw + (stats - raw) +
                                                        stage * kStatBytes);
      const float* delta = lse + kQRows;
      mbar_wait(full + 8 * stage, (it / kStages) & 1);

      // S^T = K.Q^T and dP^T = V.dO^T: 64 keys x 64 queries, k-steps of 16
      // along D; within a 128-byte swizzled row a step is 32 bytes on, a
      // half is a new box; at D = 80 the last step is the 32-byte rows of
      // the tail boxes
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * kHalves; ++kk) {
        Wgmma<64>::ss(s, desc(k_rows + (kk / 4) * kKHalf + (kk % 4) * 32, 16, 8 * kRowBytes),
                      desc(q_tile + (kk / 4) * kQHalf + (kk % 4) * 32, 16, 8 * kRowBytes), kk > 0);
      }
      if constexpr (kTail > 0) {
        Wgmma<64>::ss(s, desc(k_tail + cw * 64 * kTailRow, 16, 8 * kTailRow, 32),
                      desc(q_tail, 16, 8 * kTailRow, 32), 1);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4 * kHalves; ++kk) {
        Wgmma<64>::ss(dp, desc(v_rows + (kk / 4) * kKHalf + (kk % 4) * 32, 16, 8 * kRowBytes),
                      desc(g_tile + (kk / 4) * kQHalf + (kk % 4) * 32, 16, 8 * kRowBytes), kk > 0);
      }
      if constexpr (kTail > 0) {
        Wgmma<64>::ss(dp, desc(v_tail + cw * 64 * kTailRow, 16, 8 * kTailRow, 32),
                      desc(g_tail, 16, 8 * kTailRow, 32), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      keep(s);

      const bool edge = q0 + kQRows > p.Sq || kw0 + 64 > skb ||
                        (p.causal && kw0 + 63 > q0 + offset);
      if (edge) {
        probs<true>(s, lse, t4, keys, q0, p.Sq, skb, p.causal, offset, scale2);
      } else {
        probs<false>(s, lse, t4, keys, q0, p.Sq, skb, p.causal, offset, scale2);
      }
      wgmma_wait<0>();
      keep(dp);
      // ds = p (dp - delta) scale in place of dp, from the unrounded p
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dlt = (e & 1) ? dl.y : dl.x;
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dlt) * p.scale;
        }
      }
      uint32_t pa[4][4], da[4][4];
      pack_a(pa, s);
      pack_a(da, dp);

      // dV += P^T.dO and dK += dS^T.Q over the tile's 64 queries: k-steps of
      // 16 queries (two 8-row swizzle groups); dO and q are MN-major, their
      // two 64-column halves kQHalf bytes apart; at D = 80 an n64 wgmma on
      // the main box and an n16 on the tail box
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {
        if constexpr (kTail == 0) {
          Wgmma<D>::rs(dv, pa[kk], desc(g_tile + kk * 16 * kRowBytes, kQHalf, 8 * kRowBytes));
        } else {
          Wgmma<kMainCols>::rs(part<0, kMainCols / 2>(dv), pa[kk],
                               desc(g_tile + kk * 16 * kRowBytes, kQHalf, 8 * kRowBytes));
          Wgmma<kTail>::rs(part<kMainCols / 2, kTail / 2>(dv), pa[kk],
                           desc(g_tail + kk * 16 * kTailRow, kQRows * kTailRow, 8 * kTailRow, 32));
        }
      }
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {
        if constexpr (kTail == 0) {
          Wgmma<D>::rs(dk, da[kk], desc(q_tile + kk * 16 * kRowBytes, kQHalf, 8 * kRowBytes));
        } else {
          Wgmma<kMainCols>::rs(part<0, kMainCols / 2>(dk), da[kk],
                               desc(q_tile + kk * 16 * kRowBytes, kQHalf, 8 * kRowBytes));
          Wgmma<kTail>::rs(part<kMainCols / 2, kTail / 2>(dk), da[kk],
                           desc(q_tail + kk * 16 * kTailRow, kQRows * kTailRow, 8 * kTailRow, 32));
        }
      }
      wgmma_commit();

      // dS^T in bf16 to shared memory: one 128-byte row of the tile's 64
      // queries per key, 16-byte chunks swizzled as the 128-byte mode reads
      // them; the buffers alternate between tiles
      const uint32_t ds_buf = sds + (it & 1) * kDsBytes;
      uint8_t* ds_rows = smem_raw + (ds_buf - raw);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lrow = 64 * cw + warp * 16 + g + 8 * r;  // the key's row in the block
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int chunk = j ^ (lrow % 8);
          *reinterpret_cast<uint32_t*>(ds_rows + lrow * kRowBytes + chunk * 16 + t4 * 4) =
              da[j >> 1][((j & 1) << 1) | r];
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      if (D == 128) {
        asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both warpgroups' rows are written
      } else {
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
      }

      // dQ = dS.K for the tile's 64 queries: A is dS^T read transposed, B
      // the k tile MN-major, k-steps of 16 keys; at D = 80 the tail box's
      // 16 columns are one more n16 wgmma per step
      float dq[L::kDqCols / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqSteps; ++kk) {
        const uint64_t ds_desc =
            desc(ds_buf + (dq_key0 + 16 * kk) * kRowBytes, kDsBytes, 8 * kRowBytes);
        Wgmma<64>::tt(part<0, 32>(dq), ds_desc,
                      desc(dq_k + 16 * kk * kRowBytes, kKHalf, 8 * kRowBytes), kk > 0);
        if constexpr (kTail > 0) {
          Wgmma<kTail>::tt(part<32, kTail / 2>(dq), ds_desc,
                           desc(k_tail + (dq_key0 + 16 * kk) * kTailRow, kKeys * kTailRow,
                                8 * kTailRow, 32),
                           kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // dV and dK are done: the stage may be refilled
      keep(dv);
      keep(dk);
      keep(pa);
      keep(da);
      mbar_arrive(empty + 8 * stage);
      wgmma_wait<0>();
      keep(dq);

      // the accumulator += dQ: the tile goes to shared memory as two boxes
      // of 32 float32 columns (128-byte swizzled rows) and, at D = 80, a
      // box of the last 16 (64-byte rows in the 64-byte swizzle), which one
      // thread adds into the accumulator with TMA reduce-adds; rows past Sq
      // fall outside the map and are dropped. The buffer is rewritten only
      // once the previous tile's reduce-adds have read it.
      if (ct == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(4 + cw) : "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int chunk = (2 * (j % 4) + (t4 >> 1)) ^ (row % 8);
          *reinterpret_cast<float2*>(dq_tile + (j / 4) * kQHalf + row * kRowBytes + chunk * 16 +
                                     (t4 & 1) * 8) =
              make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        }
#pragma unroll
        for (int j = 8; j < L::kDqCols / 8; ++j) {
          // the 64-byte swizzle: a row's four 16-byte chunks XOR (row / 2) % 4
          const int chunk = (2 * (j - 8) + (t4 >> 1)) ^ ((row >> 1) & 3);
          *reinterpret_cast<float2*>(dq_tile + 2 * kQHalf + row * (kTail * 4) + chunk * 16 +
                                     (t4 & 1) * 8) =
              make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA unit
      asm volatile("bar.sync %0, 128;\n" ::"r"(4 + cw) : "memory");
      if (ct == 0) {  // one thread issues every reduce-add
#pragma unroll
        for (int box = 0; box < 2; ++box) {
          tma_reduce_add(&maps.dq, dq_buf + box * kQHalf, dq_col0 + box * kDqBoxCols, q0, h, b);
        }
        if constexpr (kTail > 0) {
          tma_reduce_add(&maps.dq_tail, dq_buf + 2 * kQHalf, kMainCols, q0, h, b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    // shared memory must outlive the last reduce-adds' reads
    if (ct == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

    // dk and dv in bf16 (zeros for a block that saw no query), rows past Sk
    // dropped
    __nv_bfloat16* kout = p.dk + b * p.kb + h * p.kh + 2 * t4;
    __nv_bfloat16* vout = p.dv + b * p.vb + h * p.vh + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (keys[r] >= p.Sk) continue;
      __nv_bfloat16* krow = kout + (int64_t)keys[r] * p.ks;
      __nv_bfloat16* vrow = vout + (int64_t)keys[r] * p.vs;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(krow + 8 * j) =
            MmaOps<__nv_bfloat16>::pack(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(vrow + 8 * j) =
            MmaOps<__nv_bfloat16>::pack(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// The 4-D map (D, Sq, H, B) of the float32 dq accumulator `acc` (element
// strides sb, sh, ss, each a multiple of 4) with boxes of `cols` columns x
// 64 rows in `swizzle`: 32 columns in the 128-byte swizzle, or 16 (D = 80's
// tail) in the 64-byte one; extents of 1 get packed strides as in encode().
cudaError_t encode_acc(CUtensorMap* map, float* acc, int64_t sb, int64_t sh, int64_t ss, int D,
                       int S, int H, int B, int cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H), cuuint64_t(B)};
  ss = S == 1 ? D : ss;
  sh = H == 1 ? int64_t(D) * S : sh;
  sb = B == 1 ? int64_t(D) * S * H : sb;
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 4, cuuint64_t(sh) * 4, cuuint64_t(sb) * 4};
  const cuuint32_t box[4] = {cuuint32_t(cols), kQRows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, acc, dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const View& q, const View& k, const View& v, const View& g, float* acc,
                   const int64_t* acc_st, const Params& p, int B, cudaStream_t stream) {
  constexpr int kTail = Layout<D>::kTail;
  Maps maps{};
  cudaError_t err = encode(&maps.q, q, D, p.Sq, p.H, B, kQRows);
  if (err == cudaSuccess) err = encode(&maps.k, k, D, p.Sk, p.H, B, kKeys);
  if (err == cudaSuccess) err = encode(&maps.v, v, D, p.Sk, p.H, B, kKeys);
  if (err == cudaSuccess) err = encode(&maps.g, g, D, p.Sq, p.H, B, kQRows);
  if (err == cudaSuccess) {
    err = encode_acc(&maps.dq, acc, acc_st[0], acc_st[1], acc_st[2], D, p.Sq, p.H, B, kDqBoxCols,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (kTail > 0) {
    constexpr CUtensorMapSwizzle kSw32 = CU_TENSOR_MAP_SWIZZLE_32B;
    if (err == cudaSuccess) err = encode(&maps.q_tail, q, D, p.Sq, p.H, B, kQRows, kTail, kSw32);
    if (err == cudaSuccess) err = encode(&maps.k_tail, k, D, p.Sk, p.H, B, kKeys, kTail, kSw32);
    if (err == cudaSuccess) err = encode(&maps.v_tail, v, D, p.Sk, p.H, B, kKeys, kTail, kSw32);
    if (err == cudaSuccess) err = encode(&maps.g_tail, g, D, p.Sq, p.H, B, kQRows, kTail, kSw32);
    if (err == cudaSuccess) {
      err = encode_acc(&maps.dq_tail, acc, acc_st[0], acc_st[1], acc_st[2], D, p.Sq, p.H, B, kTail,
                       CU_TENSOR_MAP_SWIZZLE_64B);
    }
  }
  if (err != cudaSuccess) return err;
  constexpr size_t smem = Layout<D>::kSmem;
  err = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int blocks = B * p.H * ((p.Sk + kKeys - 1) / kKeys);
  flash_bwd_wgmma_kernel<D><<<blocks, kThreads, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

// bf16, D in {64, 80, 128}, Sq and Sk >= 1, 16-byte aligned rows, a 16-byte
// aligned float32 accumulator (B, H, Sq, D) with strides (acc_st: b, h, s)
// that are multiples of 4 (the caller checks).
cudaError_t dispatch(const View& q, const View& k, const View& v, const View& g, float* acc,
                     const int64_t* acc_st, const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<64>(q, k, v, g, acc, acc_st, p, B, stream);
    case 80: return launch<80>(q, k, v, g, acc, acc_st, p, B, stream);
    case 128: return launch<128>(q, k, v, g, acc, acc_st, p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd
}  // namespace sm90
}  // namespace
