// K1's tensor-core path for Hopper (sm_90a) at head_dim 64 and 128: a
// warp-specialised flash-attention forward on TMA and wgmma. Included by
// flash_fwd.cu, whose `ia2p_flash_fwd` routes every bf16 call with
// D in {64, 128} and 16-byte aligned rows here; it computes what the
// mma.sync kernel there computes (and the TPU kernel `_flash_fwd_kernel`
// of instructany2pix_tpu/ops/flash_attention.py): float32 logits with the
// scale applied (log2 e folded into it, so the exponentials are base 2),
// online softmax, the unnormalized p rounded to bf16 for P.V while l sums
// the unrounded p, o = acc / max(l, 1e-30) and float32
// lse = m + log(max(l, 1e-30)), end-aligned causal masking with key tiles
// past a block's last visible key never loaded, ragged Sq/Sk tails and the
// optional per-row kv_len (compiled in only where it is passed).
//
// What bounds it: at the UNet's (2,10,4096,64) the work is 86 GFLOP
// against 21 MB, far above the H100's ~295 FLOP/byte ridge, so the tensor
// cores; the 77- and 4-key cross attentions are bound by reading q and
// writing o. The mma.sync kernel reached ~10 % of the bf16 peak: warp-level
// products, synchronous staging, 64 queries per staged key tile. Here:
//   * one block per (b*h, 128 query rows): a producer warpgroup, of which
//     one thread issues every TMA load, and two consumer warpgroups of 64
//     rows each (wgmma's M). The producer drops to 24 registers
//     (setmaxnreg.dec), the consumers rise to 240;
//   * q, k, v and o are 4-D TMA tensor maps (D, S, H, B) built on the host
//     from the tensors' own strides, so (B, S, H, D) views and fused-qkv
//     chunks need no copy. Boxes are 64 elements (128 bytes) along D with
//     the 128-byte swizzle: one box at D = 64, two at D = 128. TMA
//     zero-fills rows past S; the softmax masks them as before;
//   * q is loaded once; k and v tiles of kKeys rows sit in a ring of
//     kStages stages, each with a full barrier for k, one for v and an
//     empty barrier that both consumer warpgroups arrive on once their
//     P.V wgmma on the stage has completed;
//   * S = Q.K^T is one wgmma m64nKk16 chain per 16 of D, both operands
//     K-major from shared memory, float32 accumulators in registers (the
//     m16n8k16 C layout per warp, so the quad reductions carry over);
//   * P.V takes p, rounded to bf16, straight from registers as wgmma's A
//     operand, and v from its TMA tile as an MN-major B operand (the
//     transpose bit), so v is never transposed by hand;
//   * o / l goes in bf16 through shared memory (each warpgroup's own rows
//     of the q tile, swizzled as the map expects) and out by a TMA store,
//     which clips the rows past Sq; lse is written per row.
// Left for later: ping-pong between the consumer warpgroups, the softmax
// of one tile overlapped with the next tile's Q.K^T, persistent blocks and
// clusters.
//
// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime: it is
// looked up at run time by cudaGetDriverEntryPoint(ByVersion), so the
// library needs no -lcuda at link time.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; nothing from libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {
namespace sm90 {

constexpr int kRows = 128;     // query rows per block: two consumer warpgroups of 64
constexpr int kThreads = 384;  // the producer warpgroup, then the two consumers
constexpr int kBoxCols = 64;   // elements per TMA box along D: one 128-byte swizzle row
constexpr int kRowBytes = 128;
constexpr float kLn2 = 0.6931471805599453f;

// Keys per k/v tile and stages of the ring, per head dim. On the H100, 128
// keys beat 64 at both head dims and matched or beat 176 (PERF.md, from
// benchmarks_torch/k1_ab.py --keys).
template <int D>
struct Tile;
template <> struct Tile<64> { static constexpr int kKeys = 128, kStages = 2; };
template <> struct Tile<128> { static constexpr int kKeys = 128, kStages = 2; };

template <int D>
constexpr size_t smem_bytes() {
  // q (then o), kStages k and v tiles, the barriers, and slack to align the
  // base to 1024 bytes (the 128-byte swizzle repeats every 8 rows)
  return size_t(kRows) * D * 2 + 2 * size_t(Tile<D>::kStages) * Tile<D>::kKeys * D * 2 +
         8 * (1 + 3 * Tile<D>::kStages) + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// arrive once and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared-memory descriptor of a wgmma operand in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x on the special-function unit; results under 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers that a wgmma in flight reads or writes: nothing that
// touches them may be moved across this point, and their physical
// registers are not reused before it.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
  }
}

// m64nNk16, bf16 operands, float32 accumulators: N/2 per thread, laid out
// per warp (16 rows) as N/8 m16n8 C fragments.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // D (+)= A.B^T, A and B from shared memory, both K-major; scale_d = 0 overwrites D
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D += A.B, A (bf16, the m16n8k16 A layout per warp) from registers, B from
  // shared memory MN-major (the transpose bit)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // D (+)= A.B^T, A and B from shared memory, both K-major; scale_d = 0 overwrites D
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D += A.B, A (bf16, the m16n8k16 A layout per warp) from registers, B from
  // shared memory MN-major (the transpose bit)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
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

// Scales and masks one tile of logits (kMask: the tile reaches past the
// visible keys or across the causal diagonal of some row of this
// warpgroup), folds it into the running max m and sum l of the thread's
// two rows, rescales o, and leaves p in bf16 as the A operand of P.V:
// pa[kk] covers keys 16 kk .. 16 kk + 15 of the tile. Logits and m are
// kept in base-2 units (scale2 = scale log2 e), so p = 2^(x - m) is one
// subtraction and one ex2; a masked logit is kNegInf in those units.
template <int N, int DO, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&o)[DO / 2], float (&m)[2],
                                             float (&l)[2], uint32_t (&pa)[N / 16][4], int kt,
                                             int t4, const int (&rows)[2], int skb, int causal,
                                             int offset, float scale2) {
  float mx[2] = {kNegInf, kNegInf};
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

template <int D, bool kKvLen>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
                           const int* __restrict__ kv_len, int H, int Sq, int Sk, float scale,
                           int causal) {
  constexpr int kKeys = Tile<D>::kKeys;
  constexpr int kStages = Tile<D>::kStages;
  constexpr int kHalves = D / kBoxCols;
  constexpr uint32_t kQHalf = kRows * kRowBytes;  // one 64-column half of the q tile
  constexpr uint32_t kKHalf = kKeys * kRowBytes;  // of a k or v tile
  constexpr uint32_t kTileBytes = kHalves * kKHalf;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;  // q; each warpgroup's rows take its o at the end
  const uint32_t sk = sq + kHalves * kQHalf;
  const uint32_t sv = sk + kStages * kTileBytes;
  const uint32_t q_full = sv + kStages * kTileBytes;
  const uint32_t k_full = q_full + 8;                // + 8 stage
  const uint32_t v_full = k_full + 8 * kStages;      // + 8 stage
  const uint32_t empty = v_full + 8 * kStages;       // + 8 stage

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
      mbar_expect_tx(q_full, kHalves * kQHalf);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        tma_load(sq + hf * kQHalf, &tq, q_full, hf * kBoxCols, row0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(empty + 8 * stage, ((it / kStages) & 1) ^ 1);  // passes at once on the first round
        const int key0 = it * kKeys;
        mbar_expect_tx(k_full + 8 * stage, kTileBytes);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load(sk + stage * kTileBytes + hf * kKHalf, &tk, k_full + 8 * stage, hf * kBoxCols,
                   key0, h, b);
        }
        mbar_expect_tx(v_full + 8 * stage, kTileBytes);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load(sv + stage * kTileBytes + hf * kKHalf, &tv, v_full + 8 * stage, hf * kBoxCols,
                   key0, h, b);
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
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<kKeys>::ss(s, desc(q_rows + (kk / 4) * kQHalf + (kk % 4) * 32, 16, 8 * kRowBytes),
                         desc(k_tile + (kk / 4) * kKHalf + (kk % 4) * 32, 16, 8 * kRowBytes),
                         kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(s);

      uint32_t pa[kKeys / 16][4];
      const bool edge = kt + kKeys > skb || (causal && kt + kKeys - 1 > wg_row0 + offset);
      if (edge) {
        softmax_tile<kKeys, D, true>(s, o, m, l, pa, kt, t4, rows, skb, causal, offset, scale2);
      } else {
        softmax_tile<kKeys, D, false>(s, o, m, l, pa, kt, t4, rows, skb, causal, offset, scale2);
      }

      // O += P.V: k-steps of 16 keys (two 8-row swizzle groups); v is
      // MN-major, its two 64-column halves kKHalf bytes apart
      mbar_wait(v_full + 8 * stage, parity);
      const uint32_t v_tile = sv + stage * kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        Wgmma<D>::rs(o, pa[kk], desc(v_tile + kk * 16 * kRowBytes, kKHalf, 8 * kRowBytes));
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(o);
      keep(pa);
      mbar_arrive(empty + 8 * stage);
    }

    // epilogue: o / l in bf16 over this warpgroup's rows of the q tile, in
    // the swizzled layout of the o map, then one TMA store per half
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    uint8_t* o_rows = smem_raw + (q_rows - raw);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lrow = warp * 16 + g + 8 * r;  // row within the warpgroup's 64
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int chunk = (j % 8) ^ (lrow % 8);
        *reinterpret_cast<uint32_t*>(o_rows + (j / 8) * kQHalf + lrow * kRowBytes + chunk * 16 +
                                     t4 * 4) =
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
        tma_store(&to, q_rows + hf * kQHalf, hf * kBoxCols, wg_row0, h, b);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// A (B, H, S, D) bf16 operand: base pointer and element strides.
struct View {
  const void* p;
  int64_t sb, sh, ss;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (D, S, H, B) of `x` with boxes of 64 elements x `rows` rows,
// 128-byte swizzle, zero fill out of bounds. A dimension of extent 1 gets
// a packed stride in place of whatever the tensor carries: it is never
// stepped, and TMA wants a multiple of 16 bytes.
cudaError_t encode(CUtensorMap* map, const View& x, int D, int S, int H, int B, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H), cuuint64_t(B)};
  const int64_t ss = S == 1 ? D : x.ss;
  const int64_t sh = H == 1 ? int64_t(D) * S : x.sh;
  const int64_t sb = B == 1 ? int64_t(D) * S * H : x.sb;
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {kBoxCols, cuuint32_t(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x.p), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool kKvLen>
cudaError_t launch(const View& q, const View& k, const View& v, const View& o, float* lse,
                   const int* kv_len, int B, int H, int Sq, int Sk, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = encode(&tq, q, D, Sq, H, B, kRows);
  // with no keys no tile is loaded: q's map stands in for k's and v's
  if (err == cudaSuccess) err = encode(&tk, Sk > 0 ? k : q, D, Sk > 0 ? Sk : Sq, H, B, Tile<D>::kKeys);
  if (err == cudaSuccess) err = encode(&tv, Sk > 0 ? v : q, D, Sk > 0 ? Sk : Sq, H, B, Tile<D>::kKeys);
  if (err == cudaSuccess) err = encode(&to, o, D, Sq, H, B, 64);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, kKvLen>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_fwd_wgmma_kernel<D, kKvLen>
      <<<grid, kThreads, smem, stream>>>(tq, tk, tv, to, lse, kv_len, H, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

// bf16, D in {64, 128}, 16-byte aligned rows (the caller checks).
cudaError_t dispatch(const View& q, const View& k, const View& v, const View& o, float* lse,
                     const int* kv_len, int B, int H, int Sq, int Sk, int D, float scale,
                     int causal, cudaStream_t stream) {
  if (kv_len != nullptr) {
    return D == 64 ? launch<64, true>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, scale, causal, stream)
                   : launch<128, true>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, scale, causal, stream);
  }
  return D == 64 ? launch<64, false>(q, k, v, o, lse, nullptr, B, H, Sq, Sk, scale, causal, stream)
                 : launch<128, false>(q, k, v, o, lse, nullptr, B, H, Sq, Sk, scale, causal, stream);
}

}  // namespace sm90
}  // namespace
