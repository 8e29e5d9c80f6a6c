// Pieces shared by the flash-attention kernels: K1 and K3 (flash_fwd.cu,
// flash_fwd_sm90.cuh) and K4 (flash_bwd.cu). The kv_len bound, conversions
// between the element types and float, bf16 packing, and the warp-level
// tensor-core product mma.sync m16n8k16 for bf16 with float32 accumulators
// (K4a and K4b at head_dim 80).
//
// Fragment layout of m16n8k16 (groupID g = lane / 4, t4 = lane % 4):
//   A (16 x 16, row-major), four 32-bit registers of two elements each:
//     a0 = (row g, cols 2t4, 2t4+1), a1 = (row g+8, same cols),
//     a2 = (row g, cols 2t4+8, +9),  a3 = (row g+8, cols 2t4+8, +9);
//   B (16 x 8, "col"), two registers: b0 = (rows 2t4, 2t4+1; col g),
//     b1 = (rows 2t4+8, +9; col g);
//   C (16 x 8, float32): c0, c1 = (row g, cols 2t4, 2t4+1),
//     c2, c3 = (row g+8, same cols).
// The element with the lower index sits in the low 16 bits of a register.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Keys row b may see: kv_len[b] (a right-padded batch row), else all Sk.
__device__ __forceinline__ int visible_keys(const int* kv_len, int b, int Sk) {
  return kv_len != nullptr ? min(Sk, kv_len[b]) : Sk;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
struct MmaOps;

template <>
struct MmaOps<__nv_bfloat16> {
  // two floats rounded to bf16, lo first, as one operand register
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  // two bf16 elements, lo first, as one operand register
  static __device__ __forceinline__ uint32_t join(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    __nv_bfloat162 v;
    v.x = lo;
    v.y = hi;
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

}  // namespace
