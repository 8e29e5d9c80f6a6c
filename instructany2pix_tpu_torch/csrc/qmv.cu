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
//   fmt 2  int4 packed (K/2, N) with group scales (K/g, N)
// Byte row i holds original row 2i in its low nibble and row 2i+1 in its
// high nibble, both signed. x' is x after the optional prologue:
//   RMSNorm   x * rsqrt(mean(x^2) + eps) * g in float32, rounded to x's dtype;
//   SwiGLU    x is (M, 2K): silu(gate) in float32 rounded to x's dtype, times up
//             in x's dtype.
// Staged activations are float32 (int4 calls compute in float32; bf16 int8
// calls multiply bf16 values, whose products are exact in float32). Sums are
// float32; in the grouped format each group's partial dot is scaled by its
// group scale and added to the accumulator.
//
// What bounds it: bytes. At M = 1 every packed weight byte is read once and
// used for one (int8) or two (int4) multiply-adds per row of x, far below the
// card's ~295 operations per byte. The bound is (packed W + scales + x + g +
// residual + out) / 3.35 TB/s: 8.0 us for the 7B qkv (4096 -> 12288, int4
// group 128), 2.7 us for o, 14.3 us for gate_up, 7.2 us for down.
//
// What the design does about it:
//   * Each block owns 128 output columns and one chunk of K; each lane streams
//     4 columns as one 32-bit load per byte row (a warp reads 128 contiguous
//     bytes of one row), with streaming loads that do not stay in L1.
//   * N / 128 tiles alone give 32 blocks at N = 4096, too few to keep 132 SMs
//     streaming, so K is split into chunks of whole scale groups until there
//     are about 528 blocks (4 per SM). Partial sums go to a float32 scratch
//     (ksplit, M, N) and a second kernel adds them in chunk order: the result
//     is deterministic. With one chunk the main kernel writes y itself.
//   * Each block stages only its chunk of x' (after the prologue) in shared
//     memory as float32, so K = 11008 at M = 16 never needs x whole on chip.
//     The RMSNorm statistics need the whole row: a first kernel writes one
//     rstd per row.
//   * Nibbles are unpacked in registers with two shifts; dequantization is
//     the int -> float convert inside the multiply-add.
// Not done yet: cp.async/TMA staging of the weight stream, and one kernel
// in place of the three launches (rstd, matvec, split reduction).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;  // output columns per block: 32 lanes x 4 columns
constexpr int kRedRows = 4;  // rows of x reduced across warps per pass
constexpr int kMaxM = 16;

enum Fmt { kInt8 = 0, kInt4 = 1, kInt4G = 2 };

struct Params {
  const void* x;
  const int8_t* w;
  const float* scale;  // (N,) or (K/g, N)
  const float* g;      // RMSNorm gain (K',) or null
  const float* rstd;   // (M,) written by qmv_rstd_kernel, or null
  const void* residual;
  void* out;
  float* partial;  // (ksplit, M, N) when ksplit > 1
  int M, K, N, xk, group, chunk, ksplit, swiglu, has_norm, act;
};

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

__global__ void __launch_bounds__(kThreads) qmv_rstd_kernel(const void* x, int xk, int act, float eps,
                                                       float* rstd) {
  const int m = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < xk; i += kThreads) {
    float v = load_act(x, (int64_t)m * xk + i, act);
    s += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __shared__ float ws[kWarps];
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += ws[w];
    rstd[m] = 1.0f / sqrtf(t / (float)xk + eps);
  }
}

// one byte row's 4 columns into part[m][c]; xr points at the row of x' that
// multiplies it (int8) or at the pair of rows 2i, 2i+1 (int4)
template <int MT, int FMT>
__device__ __forceinline__ void mac_row(float (&part)[MT][4], uint32_t wd, const float* xr,
                                        int ld) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (FMT == kInt8) {
      const float wv = (float)(int32_t)(int8_t)(wd >> (8 * c));
#pragma unroll
      for (int m = 0; m < MT; ++m) part[m][c] = fmaf(xr[m * ld], wv, part[m][c]);
    } else {
      const float lo = (float)(int32_t(wd << (28 - 8 * c)) >> 28);
      const float hi = (float)(int32_t(wd << (24 - 8 * c)) >> 28);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        part[m][c] = fmaf(xr[m * ld], lo, part[m][c]);
        part[m][c] = fmaf(xr[m * ld + 1], hi, part[m][c]);
      }
    }
  }
}

template <int MT, int FMT>
__global__ void __launch_bounds__(kThreads) qmv_kernel(Params p) {
  extern __shared__ float smem[];
  float* xs = smem;                   // [MT][chunk] staged x'
  float* red = smem + MT * p.chunk;   // [kWarps][kRedRows][kTileN]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kTileN;
  const int split = blockIdx.y;
  const int k0 = split * p.chunk;
  const int kc = min(p.chunk, p.K - k0);

  // 1. stage x' for rows [k0, k0 + kc); rows m >= M stay zero
  for (int i = tid; i < MT * p.chunk; i += kThreads) {
    const int m = i / p.chunk, kk = i - m * p.chunk, k = k0 + kk;
    float v = 0.f;
    if (m < p.M && kk < kc) {
      const int64_t row = (int64_t)m * p.xk;
      if (p.swiglu) {
        float gt = load_act(p.x, row + k, p.act);
        float up = load_act(p.x, row + p.K + k, p.act);
        if (p.has_norm) {
          gt = round_act(gt * p.rstd[m] * p.g[k], p.act);
          up = round_act(up * p.rstd[m] * p.g[p.K + k], p.act);
        }
        const float s = round_act(gt / (1.0f + expf(-gt)), p.act);
        v = round_act(s * up, p.act);
      } else {
        v = load_act(p.x, row + k, p.act);
        if (p.has_norm) v = round_act(v * p.rstd[m] * p.g[k], p.act);
      }
    }
    xs[i] = v;
  }
  __syncthreads();

  // 2. stream this chunk's byte rows; warp w takes rows w, w + 8, ...
  constexpr int kRowsPerByte = (FMT == kInt8) ? 1 : 2;
  const int col = n0 + lane * 4;
  const int nrb = kc / kRowsPerByte;                              // byte rows in the chunk
  const int gb = (FMT == kInt4G) ? p.group / kRowsPerByte : nrb;  // byte rows per scale group
  const uint32_t* wp =
      reinterpret_cast<const uint32_t*>(p.w + (int64_t)(k0 / kRowsPerByte) * p.N + col);
  const int wstride = p.N / 4;  // one byte row, in 32-bit words
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int gs = 0; gs < nrb; gs += gb) {
    const int ge = min(gs + gb, nrb);
    float part[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[m][c] = 0.f;
    int r = gs + warp;
    for (; r + 3 * kWarps < ge; r += 4 * kWarps) {
      const uint32_t w0 = __ldcs(wp + (int64_t)r * wstride);
      const uint32_t w1 = __ldcs(wp + (int64_t)(r + kWarps) * wstride);
      const uint32_t w2 = __ldcs(wp + (int64_t)(r + 2 * kWarps) * wstride);
      const uint32_t w3 = __ldcs(wp + (int64_t)(r + 3 * kWarps) * wstride);
      mac_row<MT, FMT>(part, w0, xs + r * kRowsPerByte, p.chunk);
      mac_row<MT, FMT>(part, w1, xs + (r + kWarps) * kRowsPerByte, p.chunk);
      mac_row<MT, FMT>(part, w2, xs + (r + 2 * kWarps) * kRowsPerByte, p.chunk);
      mac_row<MT, FMT>(part, w3, xs + (r + 3 * kWarps) * kRowsPerByte, p.chunk);
    }
    for (; r < ge; r += kWarps) {
      const uint32_t w0 = __ldcs(wp + (int64_t)r * wstride);
      mac_row<MT, FMT>(part, w0, xs + r * kRowsPerByte, p.chunk);
    }
    if (FMT == kInt4G) {
      const int gidx = k0 / p.group + gs / gb;
      const float4 s4 = *reinterpret_cast<const float4*>(p.scale + (int64_t)gidx * p.N + col);
      const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] += part[m][c] * sc[c];
    } else {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = part[m][c];
    }
  }
  if (FMT != kInt4G) {
    const float4 s4 = *reinterpret_cast<const float4*>(p.scale + col);
    const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] *= sc[c];
  }

  // 3. add the 8 warps' sums in warp order, kRedRows rows of x at a time
#pragma unroll
  for (int m0 = 0; m0 < MT; m0 += kRedRows) {
#pragma unroll
    for (int j = 0; j < kRedRows; ++j) {
      if (m0 + j < MT) {
        float4 v = make_float4(acc[m0 + j][0], acc[m0 + j][1], acc[m0 + j][2], acc[m0 + j][3]);
        *reinterpret_cast<float4*>(red + (warp * kRedRows + j) * kTileN + lane * 4) = v;
      }
    }
    __syncthreads();
    for (int i = tid; i < kRedRows * kTileN; i += kThreads) {
      const int j = i / kTileN, c = i - j * kTileN, m = m0 + j;
      if (m < p.M && m0 + j < MT) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[(w * kRedRows + j) * kTileN + c];
        const int64_t o = (int64_t)m * p.N + n0 + c;
        if (p.ksplit > 1)
          p.partial[(int64_t)split * p.M * p.N + o] = s;
        else
          finish(p, o, s);
      }
    }
    __syncthreads();
  }
}

// adds the ksplit partial sums of each output in chunk order
__global__ void __launch_bounds__(kThreads) qmv_reduce_kernel(Params p) {
  const int64_t o = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t mn = (int64_t)p.M * p.N;
  if (o >= mn) return;
  float s = 0.f;
  for (int i = 0; i < p.ksplit; ++i) s += p.partial[i * mn + o];
  finish(p, o, s);
}

template <int MT, int FMT>
cudaError_t launch_main(const Params& p, dim3 grid, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(qmv_kernel<MT, FMT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  qmv_kernel<MT, FMT><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_fmt(const Params& p, int mt, dim3 grid, size_t smem, cudaStream_t s) {
  switch (mt) {
    case 1: return launch_main<1, FMT>(p, grid, smem, s);
    case 2: return launch_main<2, FMT>(p, grid, smem, s);
    case 4: return launch_main<4, FMT>(p, grid, smem, s);
    case 8: return launch_main<8, FMT>(p, grid, smem, s);
    default: return launch_main<16, FMT>(p, grid, smem, s);
  }
}

}  // namespace

// Returns 0 or a CUDA error code. Launches on `stream`, does not synchronise
// and allocates nothing: rstd (M floats) and partial (ksplit * M * N floats)
// are the caller's scratch.
extern "C" int ia2p_qmv(int fmt, int act, const void* x, const void* w, const void* scale,
                        const void* g, const void* residual, void* out, void* rstd, void* partial,
                        int M, int K, int N, int xk, int group, int chunk, int ksplit, int swiglu,
                        int has_norm, float eps, void* stream) {
  if (fmt < 0 || fmt > 2 || (act != 0 && act != 1) || M < 1 || M > kMaxM || N % kTileN ||
      K < 1 || chunk < 1 || ksplit < 1 || (int64_t)chunk * ksplit < K ||
      (int64_t)chunk * (ksplit - 1) >= K || xk != (swiglu ? 2 * K : K) ||
      (fmt != kInt8 && (K % 2 || chunk % 2)) ||
      (fmt == kInt4G && (group < 2 || group % 2 || K % group || chunk % group)) ||
      (has_norm && (!g || !rstd)) || (ksplit > 1 && !partial) || N / kTileN > 65535 ||
      ksplit > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{x, reinterpret_cast<const int8_t*>(w), reinterpret_cast<const float*>(scale),
           reinterpret_cast<const float*>(g), reinterpret_cast<const float*>(rstd), residual,
           out, reinterpret_cast<float*>(partial), M, K, N, xk, group, chunk, ksplit, swiglu,
           has_norm, act};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (has_norm) {
    qmv_rstd_kernel<<<M, kThreads, 0, s>>>(x, xk, act, eps, reinterpret_cast<float*>(rstd));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int mt = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
  const size_t smem = (size_t)(mt * chunk + kWarps * kRedRows * kTileN) * sizeof(float);
  const dim3 grid(N / kTileN, ksplit);
  cudaError_t e;
  switch (fmt) {
    case kInt8: e = launch_fmt<kInt8>(p, mt, grid, smem, s); break;
    case kInt4: e = launch_fmt<kInt4>(p, mt, grid, smem, s); break;
    default: e = launch_fmt<kInt4G>(p, mt, grid, smem, s); break;
  }
  if (e != cudaSuccess) return (int)e;
  if (ksplit > 1) {
    const int64_t mn = (int64_t)M * N;
    qmv_reduce_kernel<<<(unsigned)((mn + kThreads - 1) / kThreads), kThreads, 0, s>>>(p);
    e = cudaGetLastError();
  }
  return (int)e;
}
