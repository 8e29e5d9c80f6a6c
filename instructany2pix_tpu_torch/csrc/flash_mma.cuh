// Pieces shared by the flash-attention kernels: K1 and K3 (flash_fwd.cu,
// flash_fwd_sm90.cuh) and K4 (flash_bwd.cu, flash_bwd_sm90.cuh). The kv_len
// bound, conversions between the element types and float, and bf16
// packing of float32 accumulators into operand registers.
//
// A wgmma's registers are laid out per warp as m16n8k16 fragments
// (groupID g = lane / 4, t4 = lane % 4):
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
};

}  // namespace
