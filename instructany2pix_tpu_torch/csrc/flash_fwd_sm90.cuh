// K1's and K3's tensor-core path for Hopper (sm_90a): a warp-specialised
// flash-attention forward on TMA and wgmma, templated on a bias policy.
// Included by flash_fwd.cu: `ia2p_flash_fwd` routes every bf16 call with
// D in {64, 80, 128} and 16-byte aligned rows here (K1, `NoBias`), and
// `ia2p_flash_relpos2d` every K3 call (bf16, D in {64, 80}, `RelPos2dBias`).
// It computes what the TPU kernels `_flash_fwd_kernel` and
// `_flash_relpos2d_kernel` of instructany2pix_tpu/ops/flash_attention.py
// compute: float32 logits with the scale applied (log2 e folded into it,
// so the exponentials are base 2) plus K3's bias, online softmax, the
// unnormalized p rounded to bf16 for P.V while l sums the unrounded p,
// o = acc / max(l, 1e-30) and float32 lse = m + log(max(l, 1e-30)),
// end-aligned causal masking with key tiles past a block's last visible key
// never loaded, ragged Sq/Sk tails and the optional per-row kv_len
// (compiled in only where it is passed). K3 has no causal mask, no kv_len
// and no lse: its instances compile them out.
//
// What bounds it: at the UNet's (2,10,4096,64) and at SAM's global blocks
// (1,16,4096,80) the work is 86 GFLOP against 21 (75) MB, far above the
// H100's ~295 FLOP/byte ridge, so the tensor cores; the 77- and 4-key cross
// attentions and SAM's window blocks (25,16,196,80) are bound by their
// bytes. The mma.sync loop this replaced reached ~10 % of the bf16 peak:
// warp-level products, synchronous staging, 64 queries per key tile. Here:
//   * one block per (b*h, 128 query rows): a producer warpgroup, of which
//     one thread issues every TMA load, and two consumer warpgroups of 64
//     rows each (wgmma's M). The producer drops to 24 registers
//     (setmaxnreg.dec), the consumers rise to 240;
//   * q, k, v and o are 4-D TMA tensor maps (D, S, H, B) built on the host
//     from the tensors' own strides, so (B, S, H, D) views and fused-qkv
//     chunks need no copy. Boxes are 64 elements (128 bytes) along D with
//     the 128-byte swizzle: one box at D = 64, two at D = 128. A 160-byte
//     row at D = 80 is no whole number of such boxes: its last 16 columns
//     come through a second map of 16-column boxes in the 32-byte swizzle,
//     so Q.K^T takes its 5th k-step from those boxes and P.V is an n64
//     wgmma on the first box plus an n16 on the tail (shared memory: q 20
//     KB, a 2-stage k/v ring of 80 KB). TMA zero-fills rows past S; the
//     softmax masks them as before;
//   * q is loaded once; k and v tiles of kKeys rows sit in a ring of
//     kStages stages, each with a full barrier for k, one for v and an
//     empty barrier that both consumer warpgroups arrive on once their
//     P.V wgmma on the stage has completed;
//   * S = Q.K^T is one wgmma m64nKk16 chain per 16 of D, both operands
//     K-major from shared memory, float32 accumulators in registers (the
//     m16n8k16 C layout per warp, so the quad reductions carry over);
//   * the bias policy's hook sits where the scaled logit is formed
//     (`softmax_tile`). K3's bh and bw rows are staged once per block by
//     the consumer warps themselves, each its own 16 rows, while the first
//     TMA loads are in flight: with log2 e folded in, so they add in the
//     logits' base-2 units, and each row padded to an odd stride so the 8
//     rows a warp reads at once fall in 8 banks (66 KB at g = 64, 16 KB at
//     g = 14). A key column's grid row and column are found once per tile
//     for the thread's two rows, by a float reciprocal that is exact for
//     g <= 120, not by an integer division per logit;
//   * P.V takes p, rounded to bf16, straight from registers as wgmma's A
//     operand, and v from its TMA tile as an MN-major B operand (the
//     transpose bit), so v is never transposed by hand;
//   * o / l goes in bf16 through shared memory (each warpgroup's own rows
//     of the q tile, swizzled as the maps expect) and out by TMA stores,
//     which clip the rows past Sq; lse is written per row.
// Left for later: ping-pong between the consumer warpgroups, the softmax
// of one tile overlapped with the next tile's Q.K^T, persistent blocks and
// clusters.
//
// The TMA, mbarrier and wgmma helpers and the host-side tensor maps are in
// sm90_common.cuh, shared with K4's fused backward.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "sm90_common.cuh"

namespace {
namespace sm90 {

constexpr int kRows = 128;     // query rows per block: two consumer warpgroups of 64
constexpr int kThreads = 384;  // the producer warpgroup, then the two consumers
constexpr int kWarpRows = 16;  // rows of a consumer warp, each staging its own bias rows
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may have on the H100

// Keys per k/v tile and stages of the ring, per head dim. On the H100, 128
// keys beat 64 at both head dims and matched or beat 176 (PERF.md, from
// benchmarks_torch/k1_ab.py --keys).
template <int D>
struct Tile;
template <> struct Tile<64> { static constexpr int kKeys = 128, kStages = 2; };
template <> struct Tile<80> { static constexpr int kKeys = 128, kStages = 2; };
template <> struct Tile<128> { static constexpr int kKeys = 128, kStages = 2; };

template <int D>
constexpr size_t smem_bytes() {
  // q (then o), kStages k and v tiles, the barriers, and slack to align the
  // base to 1024 bytes (the 128-byte swizzle repeats every 8 rows)
  return size_t(kRows) * D * 2 + 2 * size_t(Tile<D>::kStages) * Tile<D>::kKeys * D * 2 +
         8 * (1 + 3 * Tile<D>::kStages) + 1024;
}

// The tensor maps of q, k, v and o: 64-column boxes in the 128-byte
// swizzle and, at D = 80, 16-column boxes of columns 64..79 in the 32-byte
// swizzle (unused, zero, at D = 64 and 128).
struct Maps {
  CUtensorMap q, k, v, o;
  CUtensorMap q_tail, k_tail, v_tail, o_tail;
};

// What the kernel adds to a scaled logit, in its base-2 units. `stage`
// fills a consumer warp's own rows of the block's dynamic shared memory
// before the key loop; `column` is the part of the bias that depends on
// the key only, taken once per key column of a tile for the thread's two
// rows; `add` takes the row's staged table.
struct NoBias {  // K1
  static constexpr bool kActive = false;
  struct Col {};
  size_t smem_bytes() const { return 0; }
  __device__ __forceinline__ int row_stride() const { return 0; }
  __device__ __forceinline__ void stage(float*, int, int, int) const {}
  __device__ __forceinline__ Col column(int) const { return {}; }
  __device__ __forceinline__ float add(float x, const float*, Col) const { return x; }
};

struct RelPos2dBias {  // K3: logit + bh[t, key / G] + bw[t, key % G]
  static constexpr bool kActive = true;
  struct Col {
    int u, w;  // the key's row and column in the grid
  };
  const float* bh;  // (B, H, N, G) float32, contiguous
  const float* bw;
  int N, G;
  int gp;       // staged row stride: G + 1 or G + 2, odd, so 8 rows fall in 8 banks
  float inv_g;  // 1 / G

  static RelPos2dBias make(const float* bh, const float* bw, int N, int G) {
    return {bh, bw, N, G, (G + 1) | 1, 1.f / float(G)};
  }
  // bh then bw rows for each of the block's 8 consumer warps
  size_t smem_bytes() const { return sizeof(float) * 2 * kRows * gp + 16; }
  __device__ __forceinline__ int row_stride() const { return gp; }

  // x / G for 0 <= x < 2^16 and G <= 120: (x + 0.5) / G lies at least
  // 0.5 / G from an integer, far above the rounding of the product
  __device__ __forceinline__ int div_g(int x) const {
    return __float2int_rz((float(x) + 0.5f) * inv_g);
  }

  // four floats of a table at flat index f of the warp's rows, zero at and
  // past `valid`
  static __device__ __forceinline__ float4 load4(const float* p, int f, int valid, bool vec) {
    if (vec && f + 4 <= valid) return __ldg(reinterpret_cast<const float4*>(p + f));
    return make_float4(f < valid ? __ldg(p + f) : 0.f, f + 1 < valid ? __ldg(p + f + 1) : 0.f,
                       f + 2 < valid ? __ldg(p + f + 2) : 0.f, f + 3 < valid ? __ldg(p + f + 3) : 0.f);
  }
  __device__ __forceinline__ void put4(float* dst, int f, float4 x) const {
    const float e4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = div_g(f + e);
      const int c = f + e - r * G;
      dst[r * gp + c] = e4[e] * kLog2e;
    }
  }

  // The warp's bh and bw rows row0 .. row0 + 15 of head bhi, scaled by
  // log2 e, into rows 0..15 and 16..31 of `dst`; rows past N are zero.
  // Each lane keeps 2 x kBatch loads in flight.
  __device__ __forceinline__ void stage(float* dst, int bhi, int row0, int lane) const {
    constexpr int kBatch = 8;
    const int valid = max(0, min(kWarpRows, N - row0)) * G;
    const int64_t base = ((int64_t)bhi * N + row0) * G;
    const float* ph = bh + base;
    const float* pw = bw + base;
    const bool vec = ((reinterpret_cast<uintptr_t>(ph) | reinterpret_cast<uintptr_t>(pw)) & 15) == 0;
    for (int q0 = lane; q0 < kWarpRows * G / 4; q0 += kBatch * 32) {
      float4 xh[kBatch], xw[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int f = 4 * (q0 + 32 * j);
        xh[j] = load4(ph, f, valid, vec);
        xw[j] = load4(pw, f, valid, vec);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int f = 4 * (q0 + 32 * j);
        if (f < kWarpRows * G) {
          put4(dst, f, xh[j]);
          put4(dst + kWarpRows * gp, f, xw[j]);
        }
      }
    }
  }

  __device__ __forceinline__ Col column(int col) const {
    const int key = min(col, N - 1);  // a masked tail column reads the last key's bias
    const int u = div_g(key);
    return {u, key - u * G};
  }

  __device__ __forceinline__ float add(float x, const float* row, Col c) const {
    return x + row[c.u] + row[kWarpRows * gp + c.w];
  }
};

// N floats of an accumulator array from Off on, as an array of its own:
// the wgmma of D = 80's first 64 columns and that of its last 16 share `o`.
template <int Off, int N, int M>
__device__ __forceinline__ float (&part(float (&a)[M]))[N] {
  static_assert(Off + N <= M, "part out of range");
  return *reinterpret_cast<float(*)[N]>(&a[Off]);
}

template <>
struct Wgmma<176> {  // S = Q.K^T with 176-key tiles (a tile size measured, not the default)
  // D (+)= A.B^T, A and B from shared memory, both K-major; scale_d = 0 overwrites D
  static __device__ __forceinline__ void ss(float (&d)[88], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87"
        "}, %88, %89, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// Scales, biases and masks one tile of logits (kMask: the tile reaches
// past the visible keys or across the causal diagonal of some row of this
// warpgroup), folds it into the running max m and sum l of the thread's
// two rows, rescales o, and leaves p in bf16 as the A operand of P.V:
// pa[kk] covers keys 16 kk .. 16 kk + 15 of the tile. Logits and m are
// kept in base-2 units (scale2 = scale log2 e, the bias staged times
// log2 e), so p = 2^(x - m) is one subtraction and one ex2; a masked logit
// is kNegInf in those units. brows[r] is row r's staged bias table.
template <int N, int DO, bool kMask, class Bias>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&o)[DO / 2], float (&m)[2],
                                             float (&l)[2], uint32_t (&pa)[N / 16][4], int kt,
                                             int t4, const int (&rows)[2], int skb, int causal,
                                             int offset, float scale2, const Bias& bias,
                                             const float* const (&brows)[2]) {
  float mx[2] = {kNegInf, kNegInf};
  if constexpr (!Bias::kActive) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int r = (i >> 1) & 1;
      float x = s[i] * scale2;
      if (kMask) {
        const int col = kt + 8 * (i / 4) + 2 * t4 + (i & 1);
        const bool valid = col < skb && (!causal || col <= rows[r] + offset);
        x = valid ? x : kNegInf;
      }
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  } else {
    // s[4 j + 2 r + c] is row r's logit of key column 8 j + 2 t4 + c
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = kt + 8 * j + 2 * t4 + c;
        const typename Bias::Col bc = bias.column(col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + c;
          float x = bias.add(s[i] * scale2, brows[r], bc);
          if (kMask) x = col < skb ? x : kNegInf;
          s[i] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = (e >> 1) & 1;
      p[e] = ex2(s[8 * kk + e] - m[r]);
      l[r] += p[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = MmaOps<__nv_bfloat16>::pack(p[2 * e], p[2 * e + 1]);
  }
}

template <int D, bool kKvLen, class Bias>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ Maps maps, float* __restrict__ lse,
                           const int* __restrict__ kv_len, int H, int Sq, int Sk, float scale,
                           int causal, const Bias bias) {
  constexpr int kKeys = Tile<D>::kKeys;
  constexpr int kStages = Tile<D>::kStages;
  constexpr int kHalves = D / kBoxCols;  // 64-column boxes in the 128-byte swizzle
  constexpr int kTail = D % kBoxCols;    // columns in the 32-byte swizzled tail box
  static_assert(kTail == 0 || kTail == 16, "head_dim 64, 80 or 128");
  constexpr int kMainCols = kHalves * kBoxCols;
  constexpr uint32_t kTailRow = kTail * 2;           // bytes of a tail-box row
  constexpr uint32_t kQHalf = kRows * kRowBytes;     // one 64-column half of the q tile
  constexpr uint32_t kKHalf = kKeys * kRowBytes;     // of a k or v tile
  constexpr uint32_t kQTile = kHalves * kQHalf + kRows * kTailRow;
  constexpr uint32_t kTileBytes = kHalves * kKHalf + kKeys * kTailRow;
  if constexpr (Bias::kActive) causal = 0;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;  // q; each warpgroup's rows take its o at the end
  const uint32_t sq_tail = sq + kHalves * kQHalf;  // q's tail box, at D = 80
  const uint32_t sk = sq + kQTile;
  const uint32_t sv = sk + kStages * kTileBytes;
  const uint32_t q_full = sv + kStages * kTileBytes;
  const uint32_t k_full = q_full + 8;                // + 8 stage
  const uint32_t v_full = k_full + 8 * kStages;      // + 8 stage
  const uint32_t empty = v_full + 8 * kStages;       // + 8 stage
  const uint32_t bias_s = (empty + 8 * kStages + 15) & ~15u;  // the bias policy's rows

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = blockIdx.x * kRows;
  const int offset = Sk - Sq;  // causal alignment at the end
  const int skb = visible_keys(kKvLen ? kv_len : nullptr, b, Sk);  // the key tail past skb is masked
  int kend = skb;
  if (causal) {
    // the block's last real row bounds the keys any of its rows can see
    const int last = min(row0 + kRows, Sq) - 1;
    kend = max(0, min(skb, last + offset + 1));
  }
  const int n_tiles = (kend + kKeys - 1) / kKeys;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(q_full, kQTile);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        tma_load(sq + hf * kQHalf, &maps.q, q_full, hf * kBoxCols, row0, h, b);
      }
      if constexpr (kTail > 0) tma_load(sq_tail, &maps.q_tail, q_full, kMainCols, row0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(empty + 8 * stage, ((it / kStages) & 1) ^ 1);  // passes at once on the first round
        const int key0 = it * kKeys;
        const uint32_t k_dst = sk + stage * kTileBytes;
        const uint32_t v_dst = sv + stage * kTileBytes;
        mbar_expect_tx(k_full + 8 * stage, kTileBytes);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load(k_dst + hf * kKHalf, &maps.k, k_full + 8 * stage, hf * kBoxCols, key0, h, b);
        }
        if constexpr (kTail > 0) {
          tma_load(k_dst + kHalves * kKHalf, &maps.k_tail, k_full + 8 * stage, kMainCols, key0, h, b);
        }
        mbar_expect_tx(v_full + 8 * stage, kTileBytes);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load(v_dst + hf * kKHalf, &maps.v, v_full + 8 * stage, hf * kBoxCols, key0, h, b);
        }
        if constexpr (kTail > 0) {
          tma_load(v_dst + kHalves * kKHalf, &maps.v_tail, v_full + 8 * stage, kMainCols, key0, h, b);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = tid / 128 - 1;
    const int ct = tid % 128;
    const int warp = ct / 32;
    const int lane = ct % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const int wg_row0 = row0 + 64 * cw;
    const int rows[2] = {wg_row0 + warp * 16 + g, wg_row0 + warp * 16 + g + 8};
    const uint32_t q_rows = sq + cw * 64 * kRowBytes;  // this warpgroup's rows of half 0
    const uint32_t q_tail_rows = sq_tail + cw * 64 * kTailRow;  // and of the tail box

    // the bias rows this warp reads, staged by the warp itself while the
    // first loads are in flight
    const int gp = bias.row_stride();
    float* warp_bias = reinterpret_cast<float*>(smem_raw + (bias_s - raw)) +
                       (4 * cw + warp) * 2 * kWarpRows * gp;
    if constexpr (Bias::kActive) {
      bias.stage(warp_bias, bh, wg_row0 + 16 * warp, lane);
      __syncwarp();
    }
    const float* const brows[2] = {warp_bias + g * gp, warp_bias + (g + 8) * gp};

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    const float scale2 = scale * kLog2e;
    float m[2] = {kNegInf, kNegInf};  // running max, base-2 units
    float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced over the quad at the end
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int kt = it * kKeys;

      // S = Q.K^T: 64 rows x kKeys keys, k-steps of 16 along D; within a
      // 128-byte swizzled row a step is 32 bytes on, a half is a new box
      float s[kKeys / 2];
      mbar_wait(k_full + 8 * stage, parity);
      const uint32_t k_tile = sk + stage * kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * kHalves; ++kk) {
        Wgmma<kKeys>::ss(s, desc(q_rows + (kk / 4) * kQHalf + (kk % 4) * 32, 16, 8 * kRowBytes),
                         desc(k_tile + (kk / 4) * kKHalf + (kk % 4) * 32, 16, 8 * kRowBytes),
                         kk > 0);
      }
      if constexpr (kTail > 0) {  // Q.K^T's last k-step: the 32-byte rows of the tail boxes
        Wgmma<kKeys>::ss(s, desc(q_tail_rows, 16, 8 * kTailRow, 32),
                         desc(k_tile + kHalves * kKHalf, 16, 8 * kTailRow, 32), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(s);

      uint32_t pa[kKeys / 16][4];
      const bool edge = kt + kKeys > skb || (causal && kt + kKeys - 1 > wg_row0 + offset);
      if (edge) {
        softmax_tile<kKeys, D, true>(s, o, m, l, pa, kt, t4, rows, skb, causal, offset, scale2,
                                     bias, brows);
      } else {
        softmax_tile<kKeys, D, false>(s, o, m, l, pa, kt, t4, rows, skb, causal, offset, scale2,
                                      bias, brows);
      }

      // O += P.V: k-steps of 16 keys (two 8-row swizzle groups); v is
      // MN-major, its two 64-column halves kKHalf bytes apart
      mbar_wait(v_full + 8 * stage, parity);
      const uint32_t v_tile = sv + stage * kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        if constexpr (kTail == 0) {
          Wgmma<D>::rs(o, pa[kk], desc(v_tile + kk * 16 * kRowBytes, kKHalf, 8 * kRowBytes));
        } else {  // D = 80: the first 64 columns, then the last 16 from v's tail box
          Wgmma<kMainCols>::rs(part<0, kMainCols / 2>(o), pa[kk],
                               desc(v_tile + kk * 16 * kRowBytes, kKHalf, 8 * kRowBytes));
          Wgmma<kTail>::rs(part<kMainCols / 2, kTail / 2>(o), pa[kk],
                           desc(v_tile + kHalves * kKHalf + kk * 16 * kTailRow, kKeys * kTailRow,
                                8 * kTailRow, 32));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(o);
      keep(pa);
      mbar_arrive(empty + 8 * stage);
    }

    // epilogue: o / l in bf16 over this warpgroup's rows of the q tile, in
    // the swizzled layouts of the o maps, then one TMA store per box
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    uint8_t* o_rows = smem_raw + (q_rows - raw);
    uint8_t* o_tail = smem_raw + (q_tail_rows - raw);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lrow = warp * 16 + g + 8 * r;  // row within the warpgroup's 64
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < 8 * kHalves; ++j) {
        const int chunk = (j % 8) ^ (lrow % 8);
        *reinterpret_cast<uint32_t*>(o_rows + (j / 8) * kQHalf + lrow * kRowBytes + chunk * 16 +
                                     t4 * 4) =
            MmaOps<__nv_bfloat16>::pack(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
      }
#pragma unroll
      for (int j = 8 * kHalves; j < D / 8; ++j) {
        // the 32-byte swizzle: a row's two 16-byte chunks swap every 4 rows
        const int chunk = (j - 8 * kHalves) ^ ((lrow >> 2) & 1);
        *reinterpret_cast<uint32_t*>(o_tail + lrow * kTailRow + chunk * 16 + t4 * 4) =
            MmaOps<__nv_bfloat16>::pack(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
      }
      if (lse != nullptr && t4 == 0 && rows[r] < Sq) {
        lse[(int64_t)bh * Sq + rows[r]] = m[r] * kLn2 + logf(den);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA store
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (ct == 0 && wg_row0 < Sq) {
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        tma_store(&maps.o, q_rows + hf * kQHalf, hf * kBoxCols, wg_row0, h, b);
      }
      if constexpr (kTail > 0) tma_store(&maps.o_tail, q_tail_rows, kMainCols, wg_row0, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int D, bool kKvLen, class Bias>
cudaError_t launch(const View& q, const View& k, const View& v, const View& o, float* lse,
                   const int* kv_len, int B, int H, int Sq, int Sk, float scale, int causal,
                   const Bias& bias, cudaStream_t stream) {
  constexpr int kTail = D % kBoxCols;
  Maps maps{};
  // with no keys no tile is loaded: q's map stands in for k's and v's
  const View& kx = Sk > 0 ? k : q;
  const View& vx = Sk > 0 ? v : q;
  const int sk = Sk > 0 ? Sk : Sq;
  cudaError_t err = encode(&maps.q, q, D, Sq, H, B, kRows);
  if (err == cudaSuccess) err = encode(&maps.k, kx, D, sk, H, B, Tile<D>::kKeys);
  if (err == cudaSuccess) err = encode(&maps.v, vx, D, sk, H, B, Tile<D>::kKeys);
  if (err == cudaSuccess) err = encode(&maps.o, o, D, Sq, H, B, 64);
  if (kTail > 0) {
    constexpr CUtensorMapSwizzle kSw32 = CU_TENSOR_MAP_SWIZZLE_32B;
    if (err == cudaSuccess) err = encode(&maps.q_tail, q, D, Sq, H, B, kRows, kTail, kSw32);
    if (err == cudaSuccess) err = encode(&maps.k_tail, kx, D, sk, H, B, Tile<D>::kKeys, kTail, kSw32);
    if (err == cudaSuccess) err = encode(&maps.v_tail, vx, D, sk, H, B, Tile<D>::kKeys, kTail, kSw32);
    if (err == cudaSuccess) err = encode(&maps.o_tail, o, D, Sq, H, B, 64, kTail, kSw32);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<D>() + bias.smem_bytes();
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, kKvLen, Bias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_fwd_wgmma_kernel<D, kKvLen, Bias>
      <<<grid, kThreads, smem, stream>>>(maps, lse, kv_len, H, Sq, Sk, scale, causal, bias);
  return cudaGetLastError();
}

// K1: bf16, D in {64, 80, 128}, 16-byte aligned rows (the caller checks).
cudaError_t dispatch(const View& q, const View& k, const View& v, const View& o, float* lse,
                     const int* kv_len, int B, int H, int Sq, int Sk, int D, float scale,
                     int causal, cudaStream_t stream) {
  const NoBias none;
  if (kv_len != nullptr) {
    switch (D) {
      case 64: return launch<64, true>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, scale, causal, none, stream);
      case 80: return launch<80, true>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, scale, causal, none, stream);
      default: return launch<128, true>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, scale, causal, none, stream);
    }
  }
  switch (D) {
    case 64: return launch<64, false>(q, k, v, o, lse, nullptr, B, H, Sq, Sk, scale, causal, none, stream);
    case 80: return launch<80, false>(q, k, v, o, lse, nullptr, B, H, Sq, Sk, scale, causal, none, stream);
    default: return launch<128, false>(q, k, v, o, lse, nullptr, B, H, Sq, Sk, scale, causal, none, stream);
  }
}

// K3: bf16, D in {64, 80}, 16-byte aligned rows, N = G^2 (the caller checks).
cudaError_t dispatch_relpos2d(const View& q, const View& k, const View& v, const View& o, int B,
                              int H, int N, int D, float scale, const RelPos2dBias& bias,
                              cudaStream_t stream) {
  switch (D) {
    case 64: return launch<64, false>(q, k, v, o, nullptr, nullptr, B, H, N, N, scale, 0, bias, stream);
    case 80: return launch<80, false>(q, k, v, o, nullptr, nullptr, B, H, N, N, scale, 0, bias, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace
