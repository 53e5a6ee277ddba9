// Paged single-query decode attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `flash_decode` (_decode_kernel) of
// src/repro/kernels/flash_attention.py: one query token per slot
// against a block-paged KV pool.
//
//   q [B, Hkv, rep, D], k_pool / v_pool [P, ps, Hkv, D],
//   page_table [B, maxp] int32 (pool page ids in token order),
//   seq_lens [B] int32 (valid tokens per slot)  ->  out [B, Hkv, rep, D]
//
// fp32 online softmax (running max m, denominator l, weighted sum acc)
// with NEG_INF = -1e30; a slot with seq_len == 0 reads no page and
// returns exact zeros.
//
// What bounds it: the bytes of the K and V pages the slots' lengths
// cover (each valid token's K and V row read once); the arithmetic is
// 4*D operations per cached token and query head, far below the card's
// rate.  At the serving path's shapes (B 4, 32 kv heads, D 80, at most
// 128 tokens a slot) that is at most 5.2 MB in bf16, so launch and
// latency, not bandwidth, set its time.
//
// Design.  The TPU kernel walks the pages of a slot in order on one core
// and double-buffers the page DMAs.  Here one block serves one
// (slot, kv head) pair, so B * Hkv blocks run in parallel.  The block
// reads the slot's length and page ids itself and visits only the
// ceil(seq_len / ps) pages that hold tokens.  Per page it stages the
// head's K and V rows in shared memory as fp32 (neighbouring threads
// read neighbouring elements of one row), scores every (query, token)
// pair, masks tokens past seq_len to NEG_INF, updates (m, l) per query
// row and rescales acc.  D need not be a power of two (80 here): the
// loops run over D and rep directly.  rep > 1 (grouped queries) shares
// each staged page between the rep query heads of a kv head.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ page_table,
                        const int* __restrict__ seq_lens, T* __restrict__ out,
                        int Hkv, int rep, int D, int ps, int maxp,
                        float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [rep, D]
  float* acc = qs + rep * D;     // [rep, D]
  float* ks = acc + rep * D;     // [ps, D]
  float* vs = ks + ps * D;       // [ps, D]
  float* sc = vs + ps * D;       // [rep, ps] scores, then probabilities
  float* m = sc + rep * ps;      // [rep]
  float* l = m + rep;            // [rep]
  float* corr = l + rep;         // [rep]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n = seq_lens[b];
  const int npages = n > 0 ? min(maxp, (n + ps - 1) / ps) : 0;
  const size_t qoff = ((size_t)b * Hkv + h) * rep * D;

  for (int e = tid; e < rep * D; e += kThreads) {
    qs[e] = to_f32(q[qoff + e]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < npages; ++j) {
    const size_t pid = (size_t)page_table[(size_t)b * maxp + j];
    for (int e = tid; e < ps * D; e += kThreads) {
      const int t = e / D, d = e - t * D;
      const size_t off = ((pid * ps + t) * Hkv + h) * D + d;
      ks[e] = to_f32(k_pool[off]);
      vs[e] = to_f32(v_pool[off]);
    }
    __syncthreads();
    for (int e = tid; e < rep * ps; e += kThreads) {
      const int r = e / ps, t = e - r * ps;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qs[r * D + d] * ks[t * D + d];
      sc[e] = (j * ps + t < n) ? s * scale : kNegInf;
    }
    __syncthreads();
    for (int r = tid; r < rep; r += kThreads) {
      float mx = kNegInf;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sc[r * ps + t]);
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(sc[r * ps + t] - m_new);
        sc[r * ps + t] = p;
        sum += p;
      }
      const float c = expf(m[r] - m_new);
      l[r] = l[r] * c + sum;
      m[r] = m_new;
      corr[r] = c;
    }
    __syncthreads();
    for (int e = tid; e < rep * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      float a = acc[e] * corr[r];
      for (int t = 0; t < ps; ++t) a += sc[r * ps + t] * vs[t * D + d];
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < rep * D; e += kThreads)
    store(&out[qoff + e], acc[e] / fmaxf(l[e / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* seq_lens, void* out, int B,
           int Hkv, int rep, int D, int ps, int maxp, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * rep * D + 2 * ps * D + rep * ps + 3 * rep);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  flash_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), Hkv, rep, D,
      ps, maxp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype: 0 fp32,
// 1 bf16.  Launches on `stream`, allocates nothing, does not synchronise.
// Page ids in page_table must lie in [0, P).
extern "C" int flash_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* page_table,
                            const void* seq_lens, void* out, int B, int Hkv,
                            int rep, int D, int ps, int maxp, float scale,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, page_table, seq_lens, out, B, Hkv,
                         rep, D, ps, maxp, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, seq_lens, out,
                                 B, Hkv, rep, D, ps, maxp, scale, s);
  return (int)cudaErrorInvalidValue;
}
