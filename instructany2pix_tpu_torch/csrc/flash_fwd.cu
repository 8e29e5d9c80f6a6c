// K1: flash-attention forward for NVIDIA Hopper (sm_90a), and K3, its
// variant with SAM's decomposed 2-D relative-position bias.
//
// K1 replaces the TPU kernel instructany2pix_tpu/ops/flash_attention.py
// `_flash_fwd_kernel` (launched by `_flash_fwd`). Same function:
//   * attention over (B, H, Sq, D) x (B, H, Sk, D), input-dtype operands,
//     float32 logits and accumulators, the scale applied to the f32 logits;
//   * online softmax; the unnormalized p is rounded to v's dtype before
//     P.V, the running sum l uses the unrounded p;
//   * o = acc / max(l, 1e-30) in q's dtype, lse = m + log(max(l, 1e-30))
//     in float32 (the backward reads it);
//   * causal masking aligned at the end: row i sees keys <= i + Sk - Sq;
//     key tiles past the last visible key of a block are never loaded;
//   * ragged tails masked by bounds checks, so the caller pads nothing;
//   * an optional int32 kv_len (B,): row b's keys at or past kv_len[b] are
//     masked and its key tiles stop there. With a causal mask this is the
//     collator's right-padding mask of a training batch (the JAX package
//     takes such calls through its masked XLA path); nullptr masks at Sk.
//
// What bounds it here: at the UNet's shapes ((2,10,4096,64) bf16) the work
// is 86 GFLOP against 21 MB of traffic, ~4000 FLOP/byte, far above the
// H100's ~295 FLOP/byte ridge, so the bound is arithmetic: the tensor
// cores for bf16, the CUDA cores for float32 (no fp32 tensor-core rate
// keeps the plain version's precision). The 77- and 4-key cross
// attentions are bound by reading q and writing o.
//
// Two paths, chosen per call in `ia2p_flash_fwd`, which reports the one it
// took through `ia2p_flash_fwd_last_path`:
//   * bf16 with head_dim 64 (SDXL, the GPT-2 prior), 80 (ImageBind) or 128
//     (Llama) and 16-byte aligned rows: `sm90::flash_fwd_wgmma_kernel` in
//     flash_fwd_sm90.cuh, warp-specialised on TMA and wgmma (sm_90a only;
//     D = 80 through a 64-column and a 16-column box per row);
//   * everything else (float32, other head dims up to 256, unaligned
//     strides): `flash_fwd_kernel`, float32 fma on the CUDA cores:
//   * one block of 128 threads per (b*h, query tile); each query row is
//     owned by TPR threads (1 for D<=64, 2 for D<=128, 4 for D<=256), each
//     holding DT dims of q and of the accumulator in registers;
//   * K/V tiles are converted to float32 once when staged in shared
//     memory, so the inner loops are float4 shared loads feeding fmas; all
//     rows of a warp read the same key, so the loads are broadcasts;
//   * each thread's DT-wide segment of a shared row is padded by 4 floats
//     so that the TPR threads of one row hit different banks;
//   * logits are produced 16 keys at a time and folded into the running
//     max/sum once per 16 keys, which keeps the rescale of the accumulator
//     and the exp count per key low.
// The grid's q-tile index varies fastest so that blocks sharing K/V run
// together and re-read K/V from L2.
//
// K3 (`ia2p_flash_relpos2d`) replaces `_flash_relpos2d_kernel` of the same
// file: bf16 attention over a g x g token grid (N = g^2) whose float32
// logit for query t and key u*g + v is (q_t . k) * scale + bh[t, u] +
// bw[t, v]; no causal mask, no lse. It is the wgmma kernel with the
// `RelPos2dBias` policy (flash_fwd_sm90.cuh): each consumer warp stages its
// 16 rows of bh and bw in dynamic shared memory and each logit reads
// bh[t, key / g] and bw[t, key % g] by index. The TPU kernel adds bh
// through a selection matmul instead (Mosaic cannot load one lane) and
// needs block_k a multiple of g dividing g^2; here key tiles need not align
// with grid rows and any g <= 120 works (the bias rows of 128 queries must
// fit in shared memory beside q and the k/v ring). At SAM ViT-H's global
// blocks ((1,16,4096,80), g = 64) the work is 86 GFLOP against 75 MB,
// bound by the tensor cores; at its window blocks ((25,16,196,80), g = 14)
// 4.9 GFLOP against 59 MB, bound by the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;  // keys per online-softmax update
constexpr int kMaxGrid = 120;  // K3: 2 x 128 bias rows of g + 1 floats fit beside q and k/v

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// kKvLen: the kv_len mask is compiled in only where a caller passes it,
// so the calls without it run the code they ran before it existed.
template <typename T, int TPR, int DT, bool kKvLen>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ kv_len, int H,
                     int Sq, int Sk, int D, Strides st, float scale, int causal) {
  constexpr int BM = kThreads / TPR;  // query rows per block
  constexpr int BN = 64 / TPR;        // keys per shared-memory tile
  constexpr int SEG = DT + 4;         // padded per-thread segment
  constexpr int RS = TPR * SEG;       // padded shared row
  static_assert(BN % kChunk == 0, "tile must hold whole chunks");
  static_assert(DT % 4 == 0, "segments are read as float4");
  __shared__ __align__(16) float ks[BN * RS];
  __shared__ __align__(16) float vs[BN * RS];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int row = blockIdx.x * BM + tid / TPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const bool row_ok = row < Sq;
  const int offset = Sk - Sq;  // causal alignment at the end
  const int row_lim = row + offset;
  const int skb = visible_keys(kKvLen ? kv_len : nullptr, b, Sk);  // the key tail past skb is masked

  const T* qp = q + b * st.qb + h * st.qh + (int64_t)(row_ok ? row : 0) * st.qs;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;

  float qr[DT];
  float acc[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = part * DT + i;
    qr[i] = (row_ok && d < D) ? to_f(qp[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  int kend = skb;
  if (causal) {
    // last real row of the block bounds the keys any row of it can see
    const int last = min((int)(blockIdx.x + 1) * BM, Sq) - 1;
    kend = max(0, min(skb, last + offset + 1));
  }

  for (int kt = 0; kt < kend; kt += BN) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BN * TPR * DT; idx += kThreads) {
      const int j = idx / (TPR * DT);
      const int d = idx % (TPR * DT);
      const int key = kt + j;
      const bool ok = key < Sk && d < D;
      const int s_idx = j * RS + (d / DT) * SEG + d % DT;
      ks[s_idx] = ok ? to_f(kp[(int64_t)key * st.ks + d]) : 0.f;
      vs[s_idx] = ok ? to_f(vp[(int64_t)key * st.vs + d]) : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < BN; c0 += kChunk) {
      if (kt + c0 >= kend) break;  // kend is uniform over the block
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = ks + (c0 + j) * RS + part * SEG;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DT; i += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + i);
          dot = fmaf(qr[i], kv.x, dot);
          dot = fmaf(qr[i + 1], kv.y, dot);
          dot = fmaf(qr[i + 2], kv.z, dot);
          dot = fmaf(qr[i + 3], kv.w, dot);
        }
#pragma unroll
        for (int w = TPR / 2; w > 0; w >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, w);
        }
        const int col = kt + c0 + j;
        const bool valid = col < skb && (!causal || col <= row_lim);
        s[j] = valid ? dot * scale : kNegInf;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
        const float pr = to_f(from_f<T>(p));  // p in v's dtype for P.V
        const float* vr = vs + (c0 + j) * RS + part * SEG;
#pragma unroll
        for (int i = 0; i < DT; i += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + i);
          acc[i] = fmaf(pr, vv.x, acc[i]);
          acc[i + 1] = fmaf(pr, vv.y, acc[i + 1]);
          acc[i + 2] = fmaf(pr, vv.z, acc[i + 2]);
          acc[i + 3] = fmaf(pr, vv.w, acc[i + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float den = fmaxf(l, 1e-30f);
    T* op = o + b * st.ob + h * st.oh + (int64_t)row * st.os;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int d = part * DT + i;
      if (d < D) op[d] = from_f<T>(acc[i] / den);
    }
    if (lse != nullptr && part == 0) {
      lse[(int64_t)bh * Sq + row] = m + logf(den);
    }
  }
}

// The wgmma path needs 16-byte aligned rows (TMA's strides are multiples of
// 16 bytes): base pointers and every stride a multiple of 8 elements.
bool mma_aligned(const void* q, const void* k, const void* v, const void* o,
                 const Strides& st) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const int64_t strides = st.qb | st.qh | st.qs | st.kb | st.kh | st.ks | st.vb | st.vh |
                          st.vs | st.ob | st.oh | st.os;
  return (ptrs % 16) == 0 && (strides % 8) == 0;
}

// Which path a call of `ia2p_flash_fwd` or `ia2p_flash_relpos2d` took, per
// calling thread.
enum Path { kPathFma = 0, kPathWgmma = 1 };
thread_local int last_path = kPathFma;

sm90::View view(const void* p, int64_t sb, int64_t sh, int64_t ss) { return {p, sb, sh, ss}; }

// The tensor-core path of a bf16 call with head_dim 64, 80 or 128 and
// 16-byte aligned rows: wgmma. A call either takes it, whose launch result
// is returned (a refused launch or tensor map included), or not (*taken
// false).
cudaError_t dispatch_tensor_core(const void* q, const void* k, const void* v, void* o,
                                 float* lse, const int* kv_len, int B, int H, int Sq, int Sk,
                                 int D, const Strides& st, float scale, int causal,
                                 cudaStream_t stream, bool* taken) {
  *taken = (D == 64 || D == 80 || D == 128) && mma_aligned(q, k, v, o, st);
  if (!*taken) return cudaSuccess;
  last_path = kPathWgmma;
  return sm90::dispatch(view(q, st.qb, st.qh, st.qs), view(k, st.kb, st.kh, st.ks),
                        view(v, st.vb, st.vh, st.vs), view(o, st.ob, st.oh, st.os), lse, kv_len,
                        B, H, Sq, Sk, D, scale, causal, stream);
}

template <typename T, int TPR, int DT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* kv_len, int B, int H, int Sq, int Sk, int D,
                   const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int BM = kThreads / TPR;
  const dim3 grid((Sq + BM - 1) / BM, B * H);
  if (kv_len != nullptr) {
    flash_fwd_kernel<T, TPR, DT, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, kv_len, H, Sq, Sk, D, st,
        scale, causal);
  } else {
    flash_fwd_kernel<T, TPR, DT, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, nullptr, H, Sq, Sk, D, st,
        scale, causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, const int* kv_len, int B, int H, int Sq, int Sk, int D,
                     const Strides& st, float scale, int causal,
                     cudaStream_t stream) {
  if (D <= 16) return launch<T, 1, 16>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, D, st, scale, causal, stream);
  if (D <= 32) return launch<T, 1, 32>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, D, st, scale, causal, stream);
  if (D <= 64) return launch<T, 1, 64>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, D, st, scale, causal, stream);
  if (D <= 80) return launch<T, 2, 40>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, D, st, scale, causal, stream);
  if (D <= 128) return launch<T, 2, 64>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, D, st, scale, causal, stream);
  if (D <= 256) return launch<T, 4, 64>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, D, st, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Strides are in elements. lse (float32,
// (B*H, Sq)) and kv_len (int32, (B,)) may be null.
// Returns cudaGetLastError() after the launch (0 on success), or the error
// that refused it; `ia2p_flash_fwd_last_path` then tells which path the
// call took.
extern "C" int ia2p_flash_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, float* lse, const int* kv_len,
                              int B, int H,
                              int Sq, int Sk, int D, int64_t qb, int64_t qh,
                              int64_t qs, int64_t kb, int64_t kh, int64_t ks,
                              int64_t vb, int64_t vh, int64_t vs, int64_t ob,
                              int64_t oh, int64_t os, float scale, int causal,
                              void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool taken = false;
  cudaError_t err = cudaSuccess;
  last_path = kPathFma;
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, D, st, scale, causal, s);
    case 1:
      err = dispatch_tensor_core(q, k, v, o, lse, kv_len, B, H, Sq, Sk, D, st, scale, causal, s,
                                 &taken);
      return taken ? err
                   : dispatch<__nv_bfloat16>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, D, st, scale,
                                             causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// 0 fma, 1 wgmma: the path of this thread's last `ia2p_flash_fwd` or
// `ia2p_flash_relpos2d`.
extern "C" int ia2p_flash_fwd_last_path() { return last_path; }

// K3. bfloat16 q, k, v, o with head_dim D in {64, 80} and 16-byte aligned
// rows; float32 bh, bw contiguous (B, H, N, G) with N = G * G, G <= 120.
// Strides of q, k, v, o are in elements. Returns cudaGetLastError() after
// the launch (0 on success), or the error that refused it; the call takes
// the wgmma path, which `ia2p_flash_fwd_last_path` then reports.
extern "C" int ia2p_flash_relpos2d(const void* q, const void* k, const void* v,
                                   const float* bh, const float* bw, void* o, int B, int H,
                                   int N, int G, int D, int64_t qb, int64_t qh, int64_t qs,
                                   int64_t kb, int64_t kh, int64_t ks, int64_t vb, int64_t vh,
                                   int64_t vs, int64_t ob, int64_t oh, int64_t os, float scale,
                                   void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  last_path = kPathWgmma;
  if (G < 1 || G > kMaxGrid || N != G * G || !mma_aligned(q, k, v, o, st)) {
    return cudaErrorInvalidValue;
  }
  return sm90::dispatch_relpos2d(view(q, qb, qh, qs), view(k, kb, kh, ks), view(v, vb, vh, vs),
                                 view(o, ob, oh, os), B, H, N, D, scale,
                                 sm90::RelPos2dBias::make(bh, bw, N, G),
                                 static_cast<cudaStream_t>(stream));
}
