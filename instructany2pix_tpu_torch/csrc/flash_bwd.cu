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
//   * bf16 with head_dim 64, 80 or 128, 16-byte aligned rows and a float32
//     dq accumulator: `sm90::bwd::flash_bwd_wgmma_kernel` in
//     flash_bwd_sm90.cuh, one fused kernel on TMA and wgmma that computes p
//     once per (query tile, key block) and adds dq into the accumulator by
//     TMA reduce-adds (sm_90a only);
//   * otherwise (float32, other head dims up to 256, unaligned strides) two
//     kernels, K4a (dq) then K4b (dk, dv), also reachable on their own
//     through `ia2p_flash_bwd_dq` and `ia2p_flash_bwd_dkv` (there at every
//     dtype and head dim). The TPU kernels keep a whole (b, h)'s K/V (K4a)
//     or Q/dO (K4b) resident in VMEM and walk a sequential grid; here blocks
//     run in parallel in no order, each recomputing p: 7 products where the
//     fused kernel does 5. Both are float32 fma on the CUDA cores: a block
//     owns 16 query rows (K4a) or 16 key rows (K4b), streams 16-row tiles of
//     the other side through shared memory, computes the 16 x 16 p and ds
//     tiles (two pairs a thread) into shared memory, then each thread
//     accumulates D/8 elements of its row of the output; lse and delta are
//     read per row. Any strides with a unit last dim are taken, so the
//     router's (B, S, H, D) views need no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_sm90.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSRows = 16;  // rows a block owns
constexpr int kSTile = 16;  // rows per streamed tile
constexpr int kSMaxDT = 32;  // output elements a thread holds: D / 8, D <= 256

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

// ------------------------------------------------------------------------
// K4a and K4b (float32, or bf16 where the fused kernel does not take the
// call, or either called on its own). Rows in shared memory are float32
// with a stride of D + 1 floats.

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

// TMA needs 16-byte aligned rows: base pointers and every stride a
// multiple of 8 elements.
bool rows_aligned(const BwdArgs& a, bool dkv) {
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

// Which path a call of `ia2p_flash_bwd` took, per calling thread: the codes
// of K4_PATHS in ops/flash_attention.py (1, a warp-level tensor-core
// path, is reported by no kernel of this file).
enum Path { kPathFma = 0, kPathWgmma = 2 };
thread_local int last_path = kPathFma;

// K4a on `a` (dq in a.dq with strides a.ob/oh/os).
cudaError_t run_dq(int dtype, BwdArgs a, int B, cudaStream_t s) {
  const dim3 grid(blocks(a.Sq, kSRows), B * a.H);
  switch (dtype) {
    case 0: return launch(bwd_dq_fma_kernel<float>, grid, dq_fma_smem(a.D), s, a);
    case 1: return launch(bwd_dq_fma_kernel<__nv_bfloat16>, grid, dq_fma_smem(a.D), s, a);
    default: return cudaErrorInvalidValue;
  }
}

// K4b on `a` (dk in a.dk with strides a.ob/oh/os, dv in a.dv with a.o2*).
cudaError_t run_dkv(int dtype, BwdArgs a, int B, cudaStream_t s) {
  const dim3 grid(blocks(a.Sk, kSRows), B * a.H);
  switch (dtype) {
    case 0: return launch(bwd_dkv_fma_kernel<float>, grid, dkv_fma_smem(a.D), s, a);
    case 1: return launch(bwd_dkv_fma_kernel<__nv_bfloat16>, grid, dkv_fma_smem(a.D), s, a);
    default: return cudaErrorInvalidValue;
  }
}

// The fused kernel takes bf16 at head_dim 64, 80 and 128 with 16-byte
// aligned rows and a dq accumulator its TMA maps can address (16-byte
// aligned, strides a multiple of 16 bytes).
bool wgmma_ready(const BwdArgs& dq, const BwdArgs& dkv, const float* dq_acc,
                 const int64_t* acc_st) {
  return dq_acc != nullptr && (dq.D == 64 || dq.D == 80 || dq.D == 128) &&
         rows_aligned(dq, false) && rows_aligned(dkv, true) &&
         reinterpret_cast<uintptr_t>(dq_acc) % 16 == 0 &&
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
  return run_dq(dtype, a, B, static_cast<cudaStream_t>(stream));
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
  return run_dkv(dtype, a, B, static_cast<cudaStream_t>(stream));
}

// The whole backward: dq, dk and dv. As K4a otherwise; strides: 24 int64,
// (b, h, s) of q, k, v, g, dq, dk, dv and dq_acc. dq_acc is a zeroed float32
// (B, H, Sq, D) accumulator or null: the fused wgmma kernel (bf16, head_dim
// 64, 80 or 128, aligned rows, dq_acc given) adds dq into it and leaves dq to
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
  const cudaError_t err = run_dq(dtype, a, B, s);
  return err != cudaSuccess ? err : run_dkv(dtype, b, B, s);
}

// 0 fma, 2 wgmma: the path of this thread's last `ia2p_flash_bwd`.
extern "C" int ia2p_flash_bwd_last_path() { return last_path; }
