// Flash attention (prefill / training form) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `flash_attention` (_kernel) of
// src/repro/kernels/flash_attention.py:
//
//   q [BH, Sq, D], k / v [BHkv, Sk, D] (query row bh reads kv row
//   bh / rep, rep = BH / BHkv)  ->  out [BH, Sq, D] in q's type
//   s[i, j]  = (q_i . k_j) * scale          fp32, scale = 1/sqrt(D)
//   valid    = (!causal || i >= j) && (!window || i - j < window)
//   s[i, j]  = valid ? s : NEG_INF (-1e30, a finite score)
//   out_i    = softmax_j(s[i, :]) . v       fp32 scores, p and sums
//
// over the Sk keys that exist: a row with no valid key (only when Sq >
// Sk) averages V uniformly over exactly those Sk keys, as the softmax
// oracle does.  fp32 or bf16 in; D up to 128 (a runtime bound, so 80
// works as well as 128).
//
// What bounds it: 4 * D operations a (query, key) pair the masks keep
// (QK^T and PV), 85.9 GFLOP for stablelm-3b's 32 heads of D 80 at S 4096
// causal: 0.087 ms at the card's 989 TFLOP/s in bf16 on tensor cores,
// 1.28 ms at 67 TFLOP/s in fp32 on the CUDA cores.  The bytes (q, k, v
// and out once) are two orders of magnitude less.  This kernel runs SIMT
// fp32 FMAs, so it cannot reach the bf16 bound: mma.sync / wgmma with
// TMA-fed tiles are the redesign's work.
//
// Design.  The TPU kernel walks (bh, query tile, key tile) in order with
// (m, l, acc) in VMEM.  Here a block of 256 threads owns one (bh, 64-row
// query tile) and walks its key tiles of 32 in a loop.  q is staged once
// in shared memory as fp32, transposed ([D][64+1]: a column of q is
// read with one address per half-warp); each key tile's K (transposed,
// [D][32+1]) and V ([32][D]) are staged as fp32.  Thread (ty, tx) scores
// rows ty + 16 i and keys tx + 16 j (i < 4, j < 2) into a [64][33] score
// tile; four threads a row then take the row's max, exp and sum with
// shuffles and rescale (m, l); thread (ty, tx) keeps acc for rows
// ty + 16 i and columns tx + 16 j (j < 8, d < D) in registers.  The
// block visits only the key tiles that its rows' masks reach (causal:
// none past the last row; window: none before the first row's window),
// unless one of its rows has no valid key: then it visits all of them,
// so that such a row sees NEG_INF for every existing key.  Keys past Sk
// in the last tile score -inf, which no softmax counts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64, kBK = 32, kThreads = 256, kMaxD = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * (kBQ + 1) + (size_t)D * (kBK + 1) +
                          (size_t)kBK * D + kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int rep, int Sq, int Sk, int D, int causal,
                           int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [D][kBQ + 1]
  float* ks = qs + D * (kBQ + 1);      // [D][kBK + 1]
  float* vs = ks + D * (kBK + 1);      // [kBK][D]
  float* ss = vs + kBK * D;            // [kBQ][kBK + 1]
  float* m_s = ss + kBQ * (kBK + 1);   // [kBQ]
  float* l_s = m_s + kBQ;              // [kBQ]
  float* corr_s = l_s + kBQ;           // [kBQ]

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t kvh = (size_t)(bh / rep);
  const T* qb = q + ((size_t)bh * Sq) * D;
  const T* kb = k + kvh * Sk * D;
  const T* vb = v + kvh * Sk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[d * (kBQ + 1) + r] = q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * D + d])
                                        : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // the key range the tile's rows reach: [k_begin, k_end)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const bool empty_row =
      window > 0 && (long long)q_last >= (long long)Sk + window - 1;
  int k_begin = 0, k_end = Sk;
  if (!empty_row) {
    if (window > 0) k_begin = max(0, q0 - window + 1);
    if (causal) k_end = min(Sk, q_last + 1);
  }
  __syncthreads();

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e - c * D;
      const bool in = k0 + c < Sk;
      const size_t off = (size_t)(k0 + c) * D + d;
      ks[d * (kBK + 1) + c] = in ? to_f32(kb[off]) : 0.f;
      vs[c * D + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[d * (kBQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = ks[d * (kBK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool valid = true;
        if (causal) valid = valid && qpos >= kpos;
        if (window > 0) valid = valid && qpos - kpos < window;
        const float sc = kpos >= Sk ? -CUDART_INF_F
                                    : (valid ? s[i][j] * scale : kNegInf);
        ss[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = sc;
      }
    }
    __syncthreads();

    // online softmax: four threads a row, eight keys each
    {
      const int r = tid / 4, part = tid % 4;
      float* row = ss + r * (kBK + 1) + part * 8;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float corr = corr_s[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = vs[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = out + ((size_t)bh * Sq + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(&orow[d], acc[i][j] / l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int rep, int Sq, int Sk, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), rep, Sq, Sk, D, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype: 0 fp32,
// 1 bf16.  Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int BH, int rep, int Sq, int Sk,
                               int D, int causal, int window, int dtype,
                               float scale, void* stream) {
  if (BH <= 0 || BH > 65535 || rep <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > kMaxD || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, BH, rep, Sq, Sk, D, causal, window,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, BH, rep, Sq, Sk, D, causal,
                                 window, scale, s);
  return (int)cudaErrorInvalidValue;
}
