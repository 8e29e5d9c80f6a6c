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
// Three paths, chosen per call in `ia2p_flash_fwd`, which reports the one
// it took through `ia2p_flash_fwd_last_path`:
//   * bf16 with head_dim 64 (SDXL, the GPT-2 prior) or 128 (Llama) and
//     16-byte aligned rows: `sm90::flash_fwd_wgmma_kernel` in
//     flash_fwd_sm90.cuh, warp-specialised on TMA and wgmma (sm_90a only);
//   * bf16 with head_dim 80 (ImageBind, SAM) and 16-byte aligned rows:
//     `flash_fwd_mma_kernel`, warp-level mma.sync m16n8k16 with float32
//     accumulators (below; K3 runs on it too);
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
// bw[t, v]; no causal mask, no lse. It is the tensor-core kernel below
// with the `RelPos2dBias` policy: each block stages its 64 rows of bh and
// bw in dynamic shared memory (32 KB at g = 64, each row padded by one
// float so the 8 rows a warp reads at once fall in different banks) and
// each logit reads bh[t, key / g] and bw[t, key % g] by index. The TPU
// kernel adds bh through a selection matmul instead (Mosaic cannot load
// one lane) and needs block_k a multiple of g dividing g^2; here key tiles
// need not align with grid rows and any g <= 256 works. At SAM ViT-H's
// global blocks ((1,16,4096,80), g = 64) the work is 86 GFLOP against
// 75 MB, bound by the tensor cores; at its window blocks ((25,16,196,80),
// g = 14) 4.9 GFLOP against 59 MB, bound by reading the bias tables.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_fwd_sm90.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;  // keys per online-softmax update

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// kKvLen as for the tensor-core kernel below.
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

// ------------------------------------------------------------------------
// Tensor-core path for bf16 with head_dim 80 and 16-byte aligned rows (and
// K3 at 64 and 80): mma.sync m16n8k16 with float32 accumulators.
// A block of 4 warps owns 64 query rows (16 per warp); 64-key tiles of K
// (row-major) and V (transposed on the way in) sit in padded shared
// memory so every fragment is one conflict-free 32-bit load. S = Q.K^T
// stays in registers, is scaled, biased (the `Bias` policy) and masked in
// float32, folded into the running max/sum, converted to the input dtype
// in place as the A operand of P.V (the JAX kernel's `p.astype(v.dtype)`),
// and never touches memory.

constexpr int kMmaRows = 64;  // query rows per block
constexpr int kMmaKeys = 64;  // keys per shared tile
constexpr int kMaxGrid = 256;  // K3: g <= 256, so the bias rows fit in shared memory

// What the tensor-core kernel adds to a scaled logit. `stage` fills the
// block's dynamic shared memory before the key loop (whose first barrier
// publishes it); `column` is the part of the bias that depends on the key
// only, taken once per key column; `add` takes the row within the block.
struct NoBias {  // K1
  struct Col {};
  __device__ __forceinline__ void stage(float*, int, int, int) const {}
  __device__ __forceinline__ Col column(int) const { return {}; }
  __device__ __forceinline__ float add(float logit, const float*, int, Col) const {
    return logit;
  }
};

struct RelPos2dBias {  // K3
  struct Col {
    int u, w;  // the key's row and column in the grid
  };
  const float* bh;  // (B, H, N, G) float32, contiguous
  const float* bw;
  int N, G;

  static size_t smem_bytes(int G) { return sizeof(float) * 2 * kMmaRows * (G + 1); }

  // this block's rows of bh, then of bw, zero past N
  __device__ __forceinline__ void stage(float* smem, int bhi, int row0, int tid) const {
    const int gp = G + 1;
    const int64_t base = ((int64_t)bhi * N + row0) * G;
    const int nrows = min(kMmaRows, N - row0);
    for (int i = tid; i < kMmaRows * G; i += kThreads) {
      const int r = i / G;
      const int c = i - r * G;
      const bool ok = r < nrows;
      smem[r * gp + c] = ok ? bh[base + i] : 0.f;
      smem[(kMmaRows + r) * gp + c] = ok ? bw[base + i] : 0.f;
    }
  }

  __device__ __forceinline__ Col column(int col) const {
    const int key = min(col, N - 1);  // a masked tail column reads the last key's bias
    const int u = key / G;
    return {u, key - u * G};
  }

  __device__ __forceinline__ float add(float logit, const float* smem, int lrow, Col c) const {
    const int gp = G + 1;
    return logit + smem[lrow * gp + c.u] + smem[(kMmaRows + lrow) * gp + c.w];
  }
};

// kKvLen: the kv_len mask is compiled in only where a caller passes it,
// so the calls without it (every inference path) run the code they ran
// before it existed: with the bound read at run time, K1 took 6.6 % longer
// at (2,10,4096,64) bf16 on an H100 (PERF.md).
template <typename T, int D, typename Bias, bool kKvLen>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, const int* __restrict__ kv_len, int H,
                         int Sq, int Sk, Strides st, float scale, int causal, Bias bias) {
  static_assert(D % 16 == 0 && D <= 128, "mma path takes D = 16..128, step 16");
  constexpr int KS = D + 8;          // padded K row (elements)
  constexpr int VS = kMmaKeys + 8;   // padded transposed-V row (elements)
  constexpr int NT = kMmaKeys / 8;   // n-tiles of S per key tile
  constexpr int DT = D / 8;          // n-tiles of O
  constexpr int KQ = D / 16;         // k-steps of Q.K^T
  __shared__ __align__(16) T ks[kMmaKeys * KS];
  __shared__ __align__(16) T vt[D * VS];
  extern __shared__ __align__(16) float bias_s[];  // the Bias policy's rows

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row group
  const int t4 = lane % 4;  // fragment column pair
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int blk_row0 = blockIdx.x * kMmaRows;
  const int row0 = blk_row0 + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  const int lrows[2] = {warp * 16 + g, warp * 16 + g + 8};  // rows within the block
  const int offset = Sk - Sq;
  const int skb = visible_keys(kKvLen ? kv_len : nullptr, b, Sk);  // the key tail past skb is masked
  bias.stage(bias_s, bh, blk_row0, tid);

  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;

  // Q fragments (A operand of Q.K^T), zero for rows past Sq
  uint32_t qa[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = rows[r & 1];
      const int col = kk * 16 + 2 * t4 + (r >> 1) * 8;
      qa[kk][r] = row < Sq
          ? *reinterpret_cast<const uint32_t*>(qp + (int64_t)row * st.qs + col)
          : 0u;
    }
  }

  float oacc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced over the quad at the end

  int kend = skb;
  if (causal) {
    const int last = min((int)(blockIdx.x + 1) * kMmaRows, Sq) - 1;
    kend = max(0, min(skb, last + offset + 1));
  }

  for (int kt = 0; kt < kend; kt += kMmaKeys) {
    __syncthreads();  // the previous tile is no longer read
    // K: neighbouring threads take neighbouring 16-byte chunks of a row
    for (int c = tid; c < kMmaKeys * (D / 8); c += kThreads) {
      const int key = c / (D / 8);
      const int d8 = (c % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      if (kt + key < Sk) {
        kv = *reinterpret_cast<const uint4*>(kp + (int64_t)(kt + key) * st.ks + d8);
      }
      *reinterpret_cast<uint4*>(ks + key * KS + d8) = kv;
    }
    // V: neighbouring threads take neighbouring keys, so the transposed
    // 2-byte stores of a warp land in one contiguous run of shared memory
    for (int c = tid; c < kMmaKeys * (D / 8); c += kThreads) {
      const int key = c % kMmaKeys;
      const int d8 = (c / kMmaKeys) * 8;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (kt + key < Sk) {
        vv = *reinterpret_cast<const uint4*>(vp + (int64_t)(kt + key) * st.vs + d8);
      }
      const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(d8 + i) * VS + key] = ve[i];
    }
    __syncthreads();

    // S = Q.K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const T* kr = ks + (j * 8 + g) * KS + kk * 16 + 2 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        MmaOps<T>::mma(s[j], qa[kk], b0, b1);
      }
    }

    // scale, bias and mask in float32; running max per row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = kt + j * 8 + 2 * t4 + c;
        const typename Bias::Col bc = bias.column(col);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const bool valid = col < skb && (!causal || col <= rows[r] + offset);
          const float logit = bias.add(s[j][e] * scale, bias_s, lrows[r], bc);
          s[j][e] = valid ? logit : kNegInf;
          mx[r] = fmaxf(mx[r], s[j][e]);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // P.V: p in the input dtype as the A operand, straight from registers
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[half][e] = exp2f((s[2 * kk + half][e] - m[e >> 1]) * kLog2e);
          l[e >> 1] += p[half][e];
        }
      }
      const uint32_t pa[4] = {
          MmaOps<T>::pack(p[0][0], p[0][1]), MmaOps<T>::pack(p[0][2], p[0][3]),
          MmaOps<T>::pack(p[1][0], p[1][1]), MmaOps<T>::pack(p[1][2], p[1][3])};
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const T* vr = vt + (n * 8 + g) * VS + kk * 16 + 2 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vr + 8);
        MmaOps<T>::mma(oacc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = op + (int64_t)rows[r] * st.os;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t4) =
          MmaOps<T>::pack(oacc[n][2 * r] / den, oacc[n][2 * r + 1] / den);
    }
    if (lse != nullptr && t4 == 0) lse[(int64_t)bh * Sq + rows[r]] = m[r] + logf(den);
  }
}

// `smem` bytes of dynamic shared memory for the bias; the kernel's limit
// is raised first, since with the static tiles it may pass 48 KB.
template <typename T, int D, typename Bias = NoBias, bool KvLen = false>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, const int* kv_len, int B, int H, int Sq, int Sk,
                       const Strides& st, float scale, int causal,
                       cudaStream_t stream, const Bias& bias = Bias{}, size_t smem = 0) {
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<T, D, Bias, KvLen>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kMmaRows - 1) / kMmaRows, B * H);
  flash_fwd_mma_kernel<T, D, Bias, KvLen><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, kv_len, H, Sq, Sk, st, scale,
      causal, bias);
  return cudaGetLastError();
}

// The mma path needs 16-byte aligned rows: base pointers and every
// stride a multiple of 8 elements.
bool mma_aligned(const void* q, const void* k, const void* v, const void* o,
                 const Strides& st) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const int64_t strides = st.qb | st.qh | st.qs | st.kb | st.kh | st.ks | st.vb | st.vh |
                          st.vs | st.ob | st.oh | st.os;
  return (ptrs % 16) == 0 && (strides % 8) == 0;
}

// Which path a call of `ia2p_flash_fwd` took, per calling thread.
enum Path { kPathFma = 0, kPathMma = 1, kPathWgmma = 2 };
thread_local int last_path = kPathFma;

// The tensor-core paths of a bf16 call with 16-byte aligned rows: wgmma at
// head_dim 64 and 128, mma.sync at 80. A call either takes one of them,
// whose launch result is returned (a refused wgmma launch or tensor map
// included), or neither (*taken false).
cudaError_t dispatch_tensor_core(const void* q, const void* k, const void* v, void* o,
                                 float* lse, const int* kv_len, int B, int H, int Sq, int Sk,
                                 int D, const Strides& st, float scale, int causal,
                                 cudaStream_t stream, bool* taken) {
  using T = __nv_bfloat16;
  *taken = (D == 64 || D == 80 || D == 128) && mma_aligned(q, k, v, o, st);
  if (!*taken) return cudaSuccess;
  if (D != 80) {
    last_path = kPathWgmma;
    return sm90::dispatch({q, st.qb, st.qh, st.qs}, {k, st.kb, st.kh, st.ks},
                          {v, st.vb, st.vh, st.vs}, {o, st.ob, st.oh, st.os}, lse, kv_len, B, H,
                          Sq, Sk, D, scale, causal, stream);
  }
  last_path = kPathMma;
  if (kv_len != nullptr) {
    return launch_mma<T, 80, NoBias, true>(q, k, v, o, lse, kv_len, B, H, Sq, Sk, st, scale, causal, stream);
  }
  return launch_mma<T, 80>(q, k, v, o, lse, nullptr, B, H, Sq, Sk, st, scale, causal, stream);
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

// 0 fma, 1 mma.sync, 2 wgmma: the path of this thread's last `ia2p_flash_fwd`.
extern "C" int ia2p_flash_fwd_last_path() { return last_path; }

// K3. bfloat16 q, k, v, o with head_dim D in {64, 80} and 16-byte aligned
// rows; float32 bh, bw contiguous (B, H, N, G) with N = G * G. Strides of
// q, k, v, o are in elements. Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int ia2p_flash_relpos2d(const void* q, const void* k, const void* v,
                                   const float* bh, const float* bw, void* o, int B, int H,
                                   int N, int G, int D, int64_t qb, int64_t qh, int64_t qs,
                                   int64_t kb, int64_t kh, int64_t ks, int64_t vb, int64_t vh,
                                   int64_t vs, int64_t ob, int64_t oh, int64_t os, float scale,
                                   void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  if (G < 1 || G > kMaxGrid || N != G * G || !mma_aligned(q, k, v, o, st)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RelPos2dBias bias{bh, bw, N, G};
  const size_t smem = RelPos2dBias::smem_bytes(G);
  switch (D) {
    case 64:
      return launch_mma<__nv_bfloat16, 64>(q, k, v, o, nullptr, nullptr, B, H, N, N, st, scale, 0, s, bias, smem);
    case 80:
      return launch_mma<__nv_bfloat16, 80>(q, k, v, o, nullptr, nullptr, B, H, N, N, st, scale, 0, s, bias, smem);
    default:
      return cudaErrorInvalidValue;
  }
}
