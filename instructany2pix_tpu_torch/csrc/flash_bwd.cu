// K4: the flash-attention backward for NVIDIA Hopper (sm_90a).
//
// K4 replaces instructany2pix_tpu/ops/flash_attention.py
// `_flash_bwd_dq_kernel` (K4a, dq) and `_flash_bwd_dkv_kernel` (K4b, dk and
// dv), both launched by `_flash_bwd`. Same function, from the forward's
// saved float32 logsumexp (lse) and delta = rowsum(dO * O) (float32,
// computed by the caller as the JAX wrapper does outside Pallas):
//   * logits recomputed as (q . k) * scale in float32 from input-dtype
//     operands;
//   * p = exp(s - lse), zero where masked: the key tail (col < kv_len[b]
//     when kv_len is given, else col < Sk), padded query rows, and the
//     end-aligned causal rule col <= row + Sk - Sq;
//   * dp = dO . v^T in float32; ds = p * (dp - delta) * scale;
//   * dq = ds . k, dk = ds^T . q, dv = p^T . dO, with ds and p rounded to
//     the input dtype before each product and float32 accumulators; the
//     outputs are written in the input dtype;
//   * the query loop of a key block starts at the first query tile that
//     can see its keys under the causal rule, and a key block wholly past
//     kv_len[b] writes zeros.
//
// What bounds it here: at the Llama training shape ((4,32,2048,128) bf16,
// causal) one backward is 5 products of S^2 D per (b, h), halved by
// causality: 0.35 ms of the tensor cores at 989 TFLOP/s against ~0.06 ms
// of HBM traffic, so the bound is arithmetic.
//
// `ia2p_flash_bwd` computes dq, dk and dv in one call and reports the path
// it took through `ia2p_flash_bwd_last_path`:
//   * bf16 with head_dim 64 or 128, 16-byte aligned rows and a float32 dq
//     accumulator: `sm90::bwd::flash_bwd_wgmma_kernel` in
//     flash_bwd_sm90.cuh, one fused kernel on TMA and wgmma that computes p
//     once per (query tile, key block) and adds dq into the accumulator by
//     TMA reduce-adds (sm_90a only);
//   * otherwise two kernels, K4a (dq) then K4b (dk, dv), also reachable on
//     their own through `ia2p_flash_bwd_dq` and `ia2p_flash_bwd_dkv`. The TPU
//     kernels keep a whole (b, h)'s K/V (K4a) or Q/dO (K4b) resident in VMEM
//     and walk a sequential grid; here blocks run in parallel in no order: a
//     block owns 64 query rows (K4a) or 64 key rows (K4b), keeps what it
//     owns in registers or shared memory, and streams the other side
//     through shared memory in tiles of 32 rows; lse and delta are read per
//     row. Any strides with a unit last dim are taken, so the router's
//     (B, S, H, D) views need no copy. Each recomputes p: 7 products where
//     the fused kernel does 5. Two paths per kernel:
//       - bf16 with head_dim 80 (a 160-byte row is not one 128-byte TMA
//         box) and 16-byte aligned rows: warp-level mma.sync m16n8k16 with
//         float32 accumulators (flash_mma.cuh). Each of a block's 4 warps
//         owns 16 of its rows. K4a keeps its q and dO fragments in registers
//         (the A operands of q.k^T and dO.v^T); K4b keeps its keys and
//         values in shared memory, since its two D-wide float32 accumulators
//         (dk and dv: 80 registers a thread) leave no room for them in
//         registers. The second product of each kernel takes ds (or p) from
//         registers as its A operand and reads its B operand (k, q or dO)
//         from the row-major tile with two 16-bit loads per register; rows
//         are padded by 8 elements so those loads hit distinct banks;
//       - everything else (float32, other head dims up to 256, unaligned
//         strides, and K4a or K4b called on its own at bf16 head_dim 64 or
//         128): float32 fma on the CUDA cores. A block owns 16 rows,
//         streams 16-row tiles through shared memory, computes the 16 x 16
//         p and ds tiles (two pairs a thread) into shared memory, then each
//         thread accumulates D/8 elements of its row of the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_sm90.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;   // rows a tensor-core block owns
constexpr int kTile = 32;   // rows per streamed tile, tensor-core path
constexpr int kSRows = 16;  // rows a scalar block owns
constexpr int kSTile = 16;  // rows per streamed tile, scalar path
constexpr int kSMaxDT = 32;  // output elements a scalar thread holds: D / 8, D <= 256

struct BwdArgs {
  const void *q, *k, *v, *g;  // (B, H, S, D) with a unit last stride
  const float *lse, *delta;   // (B*H, Sq), contiguous
  const int* kv_len;          // (B,) or null
  void *dq, *dk, *dv;         // K4a writes dq, K4b dk and dv
  int H, Sq, Sk, D;
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, gb, gh, gs;  // in elements
  int64_t ob, oh, os, o2b, o2h, o2s;  // dq (K4a), or dk then dv (K4b)
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage `n` rows of a (rows, D) bf16 slab starting at row r0 into shared
// memory with row stride RS, zero past `limit`; neighbouring threads take
// neighbouring 16-byte chunks of a row.
template <int D, int RS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t stride, int r0, int n, int limit, int tid) {
  for (int c = tid; c < n * (D / 8); c += kThreads) {
    const int r = c / (D / 8);
    const int d8 = (c % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit) x = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * stride + d8);
    *reinterpret_cast<uint4*>(dst + r * RS + d8) = x;
  }
}

// ------------------------------------------------------------------------
// K4a, tensor-core path: a block owns 64 query rows, 16 per warp, and walks
// 32-key tiles of K and V.

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_mma_kernel(BwdArgs a) {
  using T = __nv_bfloat16;
  using Ops = MmaOps<T>;
  constexpr int RS = D + 8;     // padded shared row (elements)
  constexpr int KQ = D / 16;    // k-steps over the head dim
  constexpr int NT = kTile / 8;  // n-tiles of S per key tile
  constexpr int DT = D / 8;     // n-tiles of dq
  __shared__ __align__(16) T ks[kTile * RS];
  __shared__ __align__(16) T vs[kTile * RS];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int row0 = blockIdx.x * kRows + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  const int offset = a.Sk - a.Sq;
  const int skb = visible_keys(a.kv_len, b, a.Sk);

  const T* qp = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* gp = static_cast<const T*>(a.g) + b * a.gb + h * a.gh;
  const T* kp = static_cast<const T*>(a.k) + b * a.kb + h * a.kh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vb + h * a.vh;

  // q and dO fragments (A operands), zero for rows past Sq
  uint32_t qa[KQ][4], ga[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rows[r & 1];
      const int col = kk * 16 + 2 * t4 + (r >> 1) * 8;
      const bool ok = row < a.Sq;
      qa[kk][r] = ok ? ld32(qp + (int64_t)row * a.qs + col) : 0u;
      ga[kk][r] = ok ? ld32(gp + (int64_t)row * a.gs + col) : 0u;
    }
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < a.Sq;
    lse_r[r] = ok ? a.lse[(int64_t)bh * a.Sq + rows[r]] : 0.f;
    delta_r[r] = ok ? a.delta[(int64_t)bh * a.Sq + rows[r]] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  int kend = skb;
  if (a.causal) {
    const int last = min((int)(blockIdx.x + 1) * kRows, a.Sq) - 1;
    kend = max(0, min(skb, last + offset + 1));
  }

  for (int kt = 0; kt < kend; kt += kTile) {
    __syncthreads();  // the previous tile is no longer read
    stage_rows<D, RS>(ks, kp, a.ks, kt, kTile, a.Sk, tid);
    stage_rows<D, RS>(vs, vp, a.vs, kt, kTile, a.Sk, tid);
    __syncthreads();

    // S = q.k^T and dP = dO.v^T for this warp's 16 rows x 32 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const T* kr = ks + (j * 8 + g) * RS + kk * 16 + 2 * t4;
        Ops::mma(s[j], qa[kk], ld32(kr), ld32(kr + 8));
        const T* vr = vs + (j * 8 + g) * RS + kk * 16 + 2 * t4;
        Ops::mma(dp[j], ga[kk], ld32(vr), ld32(vr + 8));
      }
    }

    // ds in place of s
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = kt + j * 8 + 2 * t4 + (e & 1);
        const bool valid = rows[r] < a.Sq && col < skb && (!a.causal || col <= rows[r] + offset);
        const float p = valid ? expf(s[j][e] * a.scale - lse_r[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[r]) * a.scale;
      }
    }

    // dq += ds . k: ds (rounded to bf16) is the A operand straight from
    // registers; k's columns are read from the row-major tile
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t da[4] = {Ops::pack(s[2 * kk][0], s[2 * kk][1]),
                              Ops::pack(s[2 * kk][2], s[2 * kk][3]),
                              Ops::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              Ops::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const T* kc = ks + (kk * 16 + 2 * t4) * RS + n * 8 + g;
        Ops::mma(acc[n], da, Ops::join(kc[0], kc[RS]), Ops::join(kc[8 * RS], kc[9 * RS]));
      }
    }
  }

  T* op = static_cast<T*>(a.dq) + b * a.ob + h * a.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= a.Sq) continue;
    T* orow = op + (int64_t)rows[r] * a.os;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t4) =
          Ops::pack(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------------
// K4b, tensor-core path: a block owns 64 key rows, 16 per warp, and walks
// 32-query tiles of q, dO, lse and delta. Its keys and values sit in
// dynamic shared memory (33 KB at D = 80 with the tiles).

template <int D>
size_t dkv_mma_smem() {
  return sizeof(__nv_bfloat16) * (2 * kRows + 2 * kTile) * (D + 8) + sizeof(float) * 2 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dkv_mma_kernel(BwdArgs a) {
  using T = __nv_bfloat16;
  using Ops = MmaOps<T>;
  constexpr int RS = D + 8;
  constexpr int KQ = D / 16;
  constexpr int NT = kTile / 8;  // n-tiles of S^T (queries) per tile
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* kb_s = reinterpret_cast<T*>(smem);  // this block's keys, kRows x RS
  T* vb_s = kb_s + kRows * RS;
  T* q_s = vb_s + kRows * RS;            // the query tile, kTile x RS
  T* g_s = q_s + kTile * RS;
  float* lse_s = reinterpret_cast<float*>(g_s + kTile * RS);
  float* del_s = lse_s + kTile;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int key0 = blockIdx.x * kRows;
  const int wrow = warp * 16;  // this warp's first key row within the block
  const int keys[2] = {key0 + wrow + g, key0 + wrow + g + 8};
  const int offset = a.Sk - a.Sq;
  const int skb = visible_keys(a.kv_len, b, a.Sk);

  const T* qp = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* gp = static_cast<const T*>(a.g) + b * a.gb + h * a.gh;
  stage_rows<D, RS>(kb_s, static_cast<const T*>(a.k) + b * a.kb + h * a.kh, a.ks, key0, kRows,
                    a.Sk, tid);
  stage_rows<D, RS>(vb_s, static_cast<const T*>(a.v) + b * a.vb + h * a.vh, a.vs, key0, kRows,
                    a.Sk, tid);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }
  }

  // the first query tile whose rows can see key0 under the causal rule
  // (row >= key0 - offset); a block wholly past kv_len sees no query
  int qt0 = 0;
  if (a.causal) qt0 = (max(key0 - offset, 0) / kTile) * kTile;
  const int qend = key0 < skb ? a.Sq : 0;

  for (int qt = qt0; qt < qend; qt += kTile) {
    __syncthreads();  // the previous tile is no longer read (and the block's keys are staged)
    stage_rows<D, RS>(q_s, qp, a.qs, qt, kTile, a.Sq, tid);
    stage_rows<D, RS>(g_s, gp, a.gs, qt, kTile, a.Sq, tid);
    if (tid < kTile) {
      const bool ok = qt + tid < a.Sq;
      lse_s[tid] = ok ? a.lse[(int64_t)bh * a.Sq + qt + tid] : 0.f;
      del_s[tid] = ok ? a.delta[(int64_t)bh * a.Sq + qt + tid] : 0.f;
    }
    __syncthreads();

    // S^T = k.q^T and dP^T = v.dO^T for this warp's 16 keys x 32 queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t ka[4], va[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int off = (wrow + g + (r & 1) * 8) * RS + kk * 16 + 2 * t4 + (r >> 1) * 8;
        ka[r] = ld32(kb_s + off);
        va[r] = ld32(vb_s + off);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* qr = q_s + (j * 8 + g) * RS + kk * 16 + 2 * t4;
        Ops::mma(s[j], ka, ld32(qr), ld32(qr + 8));
        const T* gr = g_s + (j * 8 + g) * RS + kk * 16 + 2 * t4;
        Ops::mma(dp[j], va, ld32(gr), ld32(gr + 8));
      }
    }

    // p in place of s, ds in place of dp
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = keys[e >> 1];
        const int ql = j * 8 + 2 * t4 + (e & 1);
        const int row = qt + ql;
        const bool valid = row < a.Sq && key < skb && (!a.causal || key <= row + offset);
        const float p = valid ? expf(s[j][e] * a.scale - lse_s[ql]) : 0.f;
        const float dl = del_s[ql];
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl) * a.scale;
      }
    }

    // dv += p^T . dO and dk += ds^T . q over the tile's queries: p and ds
    // (rounded to bf16) are A operands from registers; dO and q columns
    // are read from the row-major tiles
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {Ops::pack(s[2 * kk][0], s[2 * kk][1]),
                              Ops::pack(s[2 * kk][2], s[2 * kk][3]),
                              Ops::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              Ops::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {Ops::pack(dp[2 * kk][0], dp[2 * kk][1]),
                              Ops::pack(dp[2 * kk][2], dp[2 * kk][3]),
                              Ops::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              Ops::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const T* gc = g_s + (kk * 16 + 2 * t4) * RS + n * 8 + g;
        Ops::mma(dv[n], pa, Ops::join(gc[0], gc[RS]), Ops::join(gc[8 * RS], gc[9 * RS]));
        const T* qc = q_s + (kk * 16 + 2 * t4) * RS + n * 8 + g;
        Ops::mma(dk[n], da, Ops::join(qc[0], qc[RS]), Ops::join(qc[8 * RS], qc[9 * RS]));
      }
    }
  }

  T* kout = static_cast<T*>(a.dk) + b * a.ob + h * a.oh;
  T* vout = static_cast<T*>(a.dv) + b * a.o2b + h * a.o2h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= a.Sk) continue;
    T* krow = kout + (int64_t)keys[r] * a.os;
    T* vrow = vout + (int64_t)keys[r] * a.o2s;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8 + 2 * t4) =
          Ops::pack(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vrow + n * 8 + 2 * t4) =
          Ops::pack(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------------
// Scalar path (float32, or bf16 at other head dims or unaligned strides).
// Rows in shared memory are float32 with a stride of D + 1 floats.

template <typename T>
__device__ __forceinline__ void stage_rows_f(float* dst, const T* src, int64_t stride, int r0,
                                             int n, int limit, int D, int tid) {
  for (int i = tid; i < n * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    dst[r * (D + 1) + d] = r0 + r < limit ? to_f(src[(int64_t)(r0 + r) * stride + d]) : 0.f;
  }
}

__device__ __forceinline__ float dot_f(const float* x, const float* y, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(x[d], y[d], acc);
  return acc;
}

size_t dq_fma_smem(int D) {
  return sizeof(float) * ((2 * kSRows + 2 * kSTile) * (D + 1) + kSRows * kSTile + 2 * kSRows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dq_fma_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float fsm[];
  const int D = a.D;
  const int DP = D + 1;
  float* q_s = fsm;                 // kSRows x DP
  float* g_s = q_s + kSRows * DP;
  float* k_s = g_s + kSRows * DP;   // kSTile x DP
  float* v_s = k_s + kSTile * DP;
  float* ds_s = v_s + kSTile * DP;  // kSRows x kSTile, in the operand dtype
  float* lse_s = ds_s + kSRows * kSTile;
  float* del_s = lse_s + kSRows;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int row0 = blockIdx.x * kSRows;
  const int offset = a.Sk - a.Sq;
  const int skb = visible_keys(a.kv_len, b, a.Sk);
  const T* kp = static_cast<const T*>(a.k) + b * a.kb + h * a.kh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vb + h * a.vh;

  stage_rows_f(q_s, static_cast<const T*>(a.q) + b * a.qb + h * a.qh, a.qs, row0, kSRows, a.Sq,
               D, tid);
  stage_rows_f(g_s, static_cast<const T*>(a.g) + b * a.gb + h * a.gh, a.gs, row0, kSRows, a.Sq,
               D, tid);
  if (tid < kSRows) {
    const bool ok = row0 + tid < a.Sq;
    lse_s[tid] = ok ? a.lse[(int64_t)bh * a.Sq + row0 + tid] : 0.f;
    del_s[tid] = ok ? a.delta[(int64_t)bh * a.Sq + row0 + tid] : 0.f;
  }
  const int orow = tid / 8;  // this thread's output row and dims od + 8 i
  const int od = tid % 8;
  float acc[kSMaxDT];
#pragma unroll
  for (int i = 0; i < kSMaxDT; ++i) acc[i] = 0.f;

  int kend = skb;
  if (a.causal) {
    const int last = min(row0 + kSRows, a.Sq) - 1;
    kend = max(0, min(skb, last + offset + 1));
  }
  for (int kt = 0; kt < kend; kt += kSTile) {
    __syncthreads();
    stage_rows_f(k_s, kp, a.ks, kt, kSTile, a.Sk, D, tid);
    stage_rows_f(v_s, vp, a.vs, kt, kSTile, a.Sk, D, tid);
    __syncthreads();
    for (int pi = tid; pi < kSRows * kSTile; pi += kThreads) {
      const int r = pi / kSTile;
      const int j = pi % kSTile;
      const int row = row0 + r;
      const int col = kt + j;
      const float s = dot_f(q_s + r * DP, k_s + j * DP, D);
      const float dp = dot_f(g_s + r * DP, v_s + j * DP, D);
      const bool valid = row < a.Sq && col < skb && (!a.causal || col <= row + offset);
      const float p = valid ? expf(s * a.scale - lse_s[r]) : 0.f;
      ds_s[pi] = to_f(from_f<T>(p * (dp - del_s[r]) * a.scale));
    }
    __syncthreads();
    for (int j = 0; j < kSTile; ++j) {
      const float dsv = ds_s[orow * kSTile + j];
#pragma unroll
      for (int i = 0; i < kSMaxDT; ++i) {
        const int d = od + 8 * i;
        if (d < D) acc[i] = fmaf(dsv, k_s[j * DP + d], acc[i]);
      }
    }
  }
  const int row = row0 + orow;
  if (row < a.Sq) {
    T* out = static_cast<T*>(a.dq) + b * a.ob + h * a.oh + (int64_t)row * a.os;
#pragma unroll
    for (int i = 0; i < kSMaxDT; ++i) {
      const int d = od + 8 * i;
      if (d < D) out[d] = from_f<T>(acc[i]);
    }
  }
}

size_t dkv_fma_smem(int D) {
  return sizeof(float) * ((2 * kSRows + 2 * kSTile) * (D + 1) + 2 * kSRows * kSTile + 2 * kSTile);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dkv_fma_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float fsm[];
  const int D = a.D;
  const int DP = D + 1;
  float* k_s = fsm;                 // this block's keys, kSRows x DP
  float* v_s = k_s + kSRows * DP;
  float* q_s = v_s + kSRows * DP;   // the query tile, kSTile x DP
  float* g_s = q_s + kSTile * DP;
  float* p_s = g_s + kSTile * DP;   // kSRows x kSTile, in the operand dtype
  float* ds_s = p_s + kSRows * kSTile;
  float* lse_s = ds_s + kSRows * kSTile;
  float* del_s = lse_s + kSTile;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int key0 = blockIdx.x * kSRows;
  const int offset = a.Sk - a.Sq;
  const int skb = visible_keys(a.kv_len, b, a.Sk);
  const T* qp = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* gp = static_cast<const T*>(a.g) + b * a.gb + h * a.gh;

  stage_rows_f(k_s, static_cast<const T*>(a.k) + b * a.kb + h * a.kh, a.ks, key0, kSRows, a.Sk,
               D, tid);
  stage_rows_f(v_s, static_cast<const T*>(a.v) + b * a.vb + h * a.vh, a.vs, key0, kSRows, a.Sk,
               D, tid);
  const int orow = tid / 8;
  const int od = tid % 8;
  float dk[kSMaxDT], dv[kSMaxDT];
#pragma unroll
  for (int i = 0; i < kSMaxDT; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  int qs0 = 0;  // the first visible query tile under the causal rule
  if (a.causal) qs0 = (max(key0 - offset, 0) / kSTile) * kSTile;
  const int qend = key0 < skb ? a.Sq : 0;
  for (int qt = qs0; qt < qend; qt += kSTile) {
    __syncthreads();
    stage_rows_f(q_s, qp, a.qs, qt, kSTile, a.Sq, D, tid);
    stage_rows_f(g_s, gp, a.gs, qt, kSTile, a.Sq, D, tid);
    if (tid < kSTile) {
      const bool ok = qt + tid < a.Sq;
      lse_s[tid] = ok ? a.lse[(int64_t)bh * a.Sq + qt + tid] : 0.f;
      del_s[tid] = ok ? a.delta[(int64_t)bh * a.Sq + qt + tid] : 0.f;
    }
    __syncthreads();
    for (int pi = tid; pi < kSRows * kSTile; pi += kThreads) {
      const int r = pi / kSTile;  // key
      const int j = pi % kSTile;  // query
      const int key = key0 + r;
      const int row = qt + j;
      const float s = dot_f(k_s + r * DP, q_s + j * DP, D);
      const float dp = dot_f(v_s + r * DP, g_s + j * DP, D);
      const bool valid = row < a.Sq && key < skb && (!a.causal || key <= row + offset);
      const float p = valid ? expf(s * a.scale - lse_s[j]) : 0.f;
      p_s[pi] = to_f(from_f<T>(p));
      ds_s[pi] = to_f(from_f<T>(p * (dp - del_s[j]) * a.scale));
    }
    __syncthreads();
    for (int j = 0; j < kSTile; ++j) {
      const float pv = p_s[orow * kSTile + j];
      const float dsv = ds_s[orow * kSTile + j];
#pragma unroll
      for (int i = 0; i < kSMaxDT; ++i) {
        const int d = od + 8 * i;
        if (d < D) {
          dv[i] = fmaf(pv, g_s[j * DP + d], dv[i]);
          dk[i] = fmaf(dsv, q_s[j * DP + d], dk[i]);
        }
      }
    }
  }
  const int key = key0 + orow;
  if (key < a.Sk) {
    T* kout = static_cast<T*>(a.dk) + b * a.ob + h * a.oh + (int64_t)key * a.os;
    T* vout = static_cast<T*>(a.dv) + b * a.o2b + h * a.o2h + (int64_t)key * a.o2s;
#pragma unroll
    for (int i = 0; i < kSMaxDT; ++i) {
      const int d = od + 8 * i;
      if (d < D) {
        kout[d] = from_f<T>(dk[i]);
        vout[d] = from_f<T>(dv[i]);
      }
    }
  }
}

// ------------------------------------------------------------------------
// Launch helpers

// The tensor-core path needs 16-byte aligned rows: base pointers and every
// stride a multiple of 8 elements.
bool mma_aligned(const BwdArgs& a, bool dkv) {
  uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                   reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.g);
  ptrs |= dkv ? (reinterpret_cast<uintptr_t>(a.dk) | reinterpret_cast<uintptr_t>(a.dv))
              : reinterpret_cast<uintptr_t>(a.dq);
  const int64_t strides = a.qb | a.qh | a.qs | a.kb | a.kh | a.ks | a.vb | a.vh | a.vs | a.gb |
                          a.gh | a.gs | a.ob | a.oh | a.os | a.o2b | a.o2h | a.o2s;
  return (ptrs % 16) == 0 && (strides % 8) == 0;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const BwdArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int blocks(int n, int per) { return (n + per - 1) / per; }

BwdArgs make_args(const void* q, const void* k, const void* v, const void* g, const float* lse,
                  const float* delta, const int* kv_len, int H, int Sq, int Sk, int D,
                  const int64_t* st, float scale, int causal) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.lse = lse;
  a.delta = delta;
  a.kv_len = kv_len;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.qb = st[0], a.qh = st[1], a.qs = st[2];
  a.kb = st[3], a.kh = st[4], a.ks = st[5];
  a.vb = st[6], a.vh = st[7], a.vs = st[8];
  a.gb = st[9], a.gh = st[10], a.gs = st[11];
  a.ob = st[12], a.oh = st[13], a.os = st[14];
  a.scale = scale;
  a.causal = causal;
  return a;
}

// Which path a call of `ia2p_flash_bwd` took, per calling thread.
enum Path { kPathFma = 0, kPathMma = 1, kPathWgmma = 2 };
thread_local int last_path = kPathFma;

// K4a on `a` (dq in a.dq with strides a.ob/oh/os); *path: the one taken.
cudaError_t run_dq(int dtype, BwdArgs a, int B, cudaStream_t s, int* path) {
  const dim3 mma_grid(blocks(a.Sq, kRows), B * a.H);
  *path = kPathMma;
  if (dtype == 1 && mma_aligned(a, false)) {
    switch (a.D) {
      case 80: return launch(bwd_dq_mma_kernel<80>, mma_grid, 0, s, a);
      default: break;
    }
  }
  *path = kPathFma;
  const dim3 grid(blocks(a.Sq, kSRows), B * a.H);
  switch (dtype) {
    case 0: return launch(bwd_dq_fma_kernel<float>, grid, dq_fma_smem(a.D), s, a);
    case 1: return launch(bwd_dq_fma_kernel<__nv_bfloat16>, grid, dq_fma_smem(a.D), s, a);
    default: return cudaErrorInvalidValue;
  }
}

// K4b on `a` (dk in a.dk with strides a.ob/oh/os, dv in a.dv with a.o2*).
cudaError_t run_dkv(int dtype, BwdArgs a, int B, cudaStream_t s, int* path) {
  const dim3 mma_grid(blocks(a.Sk, kRows), B * a.H);
  *path = kPathMma;
  if (dtype == 1 && mma_aligned(a, true)) {
    switch (a.D) {
      case 80: return launch(bwd_dkv_mma_kernel<80>, mma_grid, dkv_mma_smem<80>(), s, a);
      default: break;
    }
  }
  *path = kPathFma;
  const dim3 grid(blocks(a.Sk, kSRows), B * a.H);
  switch (dtype) {
    case 0: return launch(bwd_dkv_fma_kernel<float>, grid, dkv_fma_smem(a.D), s, a);
    case 1: return launch(bwd_dkv_fma_kernel<__nv_bfloat16>, grid, dkv_fma_smem(a.D), s, a);
    default: return cudaErrorInvalidValue;
  }
}

// The fused kernel takes bf16 at head_dim 64 and 128 with the mma.sync
// kernels' alignment and a dq accumulator its TMA map can address (16-byte
// aligned, strides a multiple of 16 bytes).
bool wgmma_ready(const BwdArgs& dq, const BwdArgs& dkv, const float* dq_acc,
                 const int64_t* acc_st) {
  return dq_acc != nullptr && (dq.D == 64 || dq.D == 128) && mma_aligned(dq, false) &&
         mma_aligned(dkv, true) && reinterpret_cast<uintptr_t>(dq_acc) % 16 == 0 &&
         ((acc_st[0] | acc_st[1] | acc_st[2]) % 4) == 0;
}

}  // namespace

// K4a. dtype: 0 float32, 1 bfloat16; q, k, v, g (dO) and dq share it.
// strides: 15 int64 in elements, (b, h, s) of q, k, v, g, dq. lse and delta
// float32 contiguous (B*H, Sq); kv_len int32 (B,) or null. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ia2p_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                 const void* g, const float* lse, const float* delta,
                                 const int* kv_len, void* dq, int B, int H, int Sq, int Sk, int D,
                                 const int64_t* strides, float scale, int causal, void* stream) {
  if (D < 1 || D > 8 * kSMaxDT || B * H < 1) return cudaErrorInvalidValue;
  BwdArgs a = make_args(q, k, v, g, lse, delta, kv_len, H, Sq, Sk, D, strides, scale, causal);
  a.dq = dq;
  int path;
  return run_dq(dtype, a, B, static_cast<cudaStream_t>(stream), &path);
}

// K4b. As K4a; strides: 18 int64, (b, h, s) of q, k, v, g, dk, dv.
extern "C" int ia2p_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                  const void* g, const float* lse, const float* delta,
                                  const int* kv_len, void* dk, void* dv, int B, int H, int Sq,
                                  int Sk, int D, const int64_t* strides, float scale, int causal,
                                  void* stream) {
  if (D < 1 || D > 8 * kSMaxDT || B * H < 1) return cudaErrorInvalidValue;
  BwdArgs a = make_args(q, k, v, g, lse, delta, kv_len, H, Sq, Sk, D, strides, scale, causal);
  a.dk = dk;
  a.dv = dv;
  a.o2b = strides[15], a.o2h = strides[16], a.o2s = strides[17];
  int path;
  return run_dkv(dtype, a, B, static_cast<cudaStream_t>(stream), &path);
}

// The whole backward: dq, dk and dv. As K4a otherwise; strides: 24 int64,
// (b, h, s) of q, k, v, g, dq, dk, dv and dq_acc. dq_acc is a zeroed float32
// (B, H, Sq, D) accumulator or null: the fused wgmma kernel (bf16, head_dim
// 64 or 128, aligned rows, dq_acc given) adds dq into it and leaves dq to
// the caller, who rounds dq_acc once; the other paths write dq and do not
// touch dq_acc. Returns the launch's cudaGetLastError() (0 on success), or
// the error that refused it; `ia2p_flash_bwd_last_path` tells the path.
extern "C" int ia2p_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                              const void* g, const float* lse, const float* delta,
                              const int* kv_len, float* dq_acc, void* dq, void* dk, void* dv,
                              int B, int H, int Sq, int Sk, int D, const int64_t* strides,
                              float scale, int causal, void* stream) {
  last_path = kPathFma;
  if (D < 1 || D > 8 * kSMaxDT || B * H < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a = make_args(q, k, v, g, lse, delta, kv_len, H, Sq, Sk, D, strides, scale, causal);
  BwdArgs b = a;
  a.dq = dq;
  b.dk = dk;
  b.dv = dv;
  b.ob = strides[15], b.oh = strides[16], b.os = strides[17];
  b.o2b = strides[18], b.o2h = strides[19], b.o2s = strides[20];
  if (dtype == 1 && wgmma_ready(a, b, dq_acc, strides + 21)) {
    last_path = kPathWgmma;
    sm90::bwd::Params p{};
    p.lse = lse;
    p.delta = delta;
    p.dk = static_cast<__nv_bfloat16*>(dk);
    p.kb = b.ob, p.kh = b.oh, p.ks = b.os;
    p.dv = static_cast<__nv_bfloat16*>(dv);
    p.vb = b.o2b, p.vh = b.o2h, p.vs = b.o2s;
    p.kv_len = kv_len;
    p.B = B, p.H = H, p.Sq = Sq, p.Sk = Sk;
    p.scale = scale;
    p.causal = causal;
    return sm90::bwd::dispatch({q, a.qb, a.qh, a.qs}, {k, a.kb, a.kh, a.ks}, {v, a.vb, a.vh, a.vs},
                               {g, a.gb, a.gh, a.gs}, dq_acc, strides + 21, p, B, D, s);
  }
  // K4a's and K4b's alignment checks see different outputs: the call
  // reports the lower of their two paths (fma if either took fma).
  int dq_path = kPathFma, dkv_path = kPathFma;
  cudaError_t err = run_dq(dtype, a, B, s, &dq_path);
  last_path = dq_path;
  if (err != cudaSuccess) return err;
  err = run_dkv(dtype, b, B, s, &dkv_path);
  last_path = dq_path < dkv_path ? dq_path : dkv_path;
  return err;
}

// 0 fma, 1 mma.sync, 2 wgmma: the path of this thread's last `ia2p_flash_bwd`.
extern "C" int ia2p_flash_bwd_last_path() { return last_path; }
