// Block-sparse junction forward for Hopper (sm_90a), plain C interface:
// the plain junction and the gated (SwiGLU) junction.
//
// Replaces the Pallas TPU kernels `fwd` (fwd_kernel) and `gated_fwd`
// (gated_fwd_kernel) of src/repro/kernels/block_sparse_matmul.py:
//
//   y[e, m, o*bs + c] = act( sum_k sum_i x[e, m, idx[o,k]*bs + i]
//                                        * w[e, o, k, i, c]  + bias[e, o*bs + c] )
//   h = silu(g) * u, with g and u the same sums over wg and wi
//
// x [E, M, nib*bs], w / wg / wi [E, nob, kb, bs, bs], idx [nob, kb] int32,
// bias [E, nob*bs] (already rounded to x's dtype), y / h [E, M, nob*bs].
// fp32 accumulation; the epilogue widens the bias, applies the
// activation in fp32 and stores once in x's dtype (fp32 or bf16).  When
// `pre` is not null the pre-activation s is stored there as well, in
// x's dtype (the backward's residual for silu and gelu).  The gated form
// takes no bias; h is computed from the fp32 g and u, and with `g` and
// `u` not null those are stored in x's dtype (the gated backward's
// residuals).
//
// What bounds it: on the serving path M is the decode batch (4) or the
// prefill chunk (32), so every weight element feeds only M
// multiply-adds and the kernel is bound by the weight bytes it streams
// (8.85 MB in bf16 for a 2560->6912 junction at kb 5; 0.20 GB for the
// two gate streams of 128 experts of qwen3-moe at 2048->768, kb 4), not
// by arithmetic.
//
// Design.  The TPU kernel keeps the whole x row block resident in VMEM
// and walks output bundles in order on one core.  Here every
// (unit e, row tile, output block o, 32-column chunk) is its own block,
// so the weight stream is spread over many SMs.  Lane l of a block owns
// output column (chunk*32 + l) of block o; its eight warps split the
// fan-in rows (k, i) of the bundle between them, so each weight row
// segment a warp reads is 32 consecutive elements (coalesced) and each
// weight element is read from device memory once per row tile.  The
// x elements a warp reads are the same for all its lanes (broadcast
// loads that hit L1); the gated form keeps two accumulators side by side
// over the same x loads, so x is read once for both branches.  The block
// reads its own idx[o, :]; the ragged M edge is masked in the kernel (no
// row padding); the eight partial sums of a column are reduced through
// shared memory in a fixed order, so the result does not depend on
// scheduling.  A simple SIMT kernel: wgmma and TMA are later work.
#include "junction_common.cuh"

namespace {

using namespace junction;

constexpr int kCols = 32;   // output columns per block, one per lane
constexpr int kWarps = 8;   // warps splitting the fan-in rows
constexpr int kRows = 8;    // rows of x per block (row tile)
static_assert(kRows == kWarps, "the epilogue gives one row to each warp");

template <typename T, int BS>
__global__ void __launch_bounds__(kCols * kWarps)
    junction_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const int* __restrict__ idx,
                        const T* __restrict__ bias, T* __restrict__ y,
                        T* __restrict__ pre, int M, int nib, int nob, int kb,
                        int act) {
  constexpr int kChunks = BS / kCols;
  constexpr int kPerWarp = BS / kWarps;  // fan-in rows per warp per slot
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int o = blockIdx.x / kChunks;
  const int c = (blockIdx.x % kChunks) * kCols + lane;
  const int m0 = blockIdx.y * kRows;
  const int e = blockIdx.z;
  const int rows = min(kRows, M - m0);
  const size_t n_in = (size_t)nib * BS;
  const size_t n_out = (size_t)nob * BS;

  const T* xe = x + ((size_t)e * M + m0) * n_in;
  const T* wo = w + ((size_t)e * nob + o) * kb * BS * BS;
  const int* io = idx + (size_t)o * kb;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int k = 0; k < kb; ++k) {
    const T* wk = wo + (size_t)k * BS * BS + c;
    const T* xk = xe + (size_t)io[k] * BS;
    float wv[kPerWarp];
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t)
      wv[t] = to_f32(wk[(size_t)(warp + t * kWarps) * BS]);
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) {
      const int i = warp + t * kWarps;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) acc[r] += to_f32(xk[r * n_in + i]) * wv[t];
    }
  }

  __shared__ float red[kWarps][kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();

  const int r = warp;
  if (r < rows) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += red[v][r][lane];
    const size_t n = (size_t)o * BS + c;
    s += to_f32(bias[(size_t)e * n_out + n]);
    const size_t out = ((size_t)e * M + m0 + r) * n_out + n;
    if (pre != nullptr) store(&pre[out], s);
    store(&y[out], act_fwd(s, act));
  }
}

// The gated form: two accumulators a row over the same x loads, the
// epilogue h = silu(g) * u from the fp32 sums, g and u stored when given.
template <typename T, int BS>
__global__ void __launch_bounds__(kCols * kWarps)
    junction_gated_fwd_kernel(const T* __restrict__ x,
                              const T* __restrict__ wg,
                              const T* __restrict__ wi,
                              const int* __restrict__ idx,
                              T* __restrict__ h, T* __restrict__ g,
                              T* __restrict__ u, int M, int nib, int nob,
                              int kb) {
  constexpr int kChunks = BS / kCols;
  constexpr int kPerWarp = BS / kWarps;  // fan-in rows per warp per slot
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int o = blockIdx.x / kChunks;
  const int c = (blockIdx.x % kChunks) * kCols + lane;
  const int m0 = blockIdx.y * kRows;
  const int e = blockIdx.z;
  const int rows = min(kRows, M - m0);
  const size_t n_in = (size_t)nib * BS;
  const size_t n_out = (size_t)nob * BS;

  const T* xe = x + ((size_t)e * M + m0) * n_in;
  const size_t wofs = ((size_t)e * nob + o) * kb * BS * BS;
  const int* io = idx + (size_t)o * kb;

  float ag[kRows], au[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) ag[r] = au[r] = 0.f;

  for (int k = 0; k < kb; ++k) {
    const T* wgk = wg + wofs + (size_t)k * BS * BS + c;
    const T* wik = wi + wofs + (size_t)k * BS * BS + c;
    const T* xk = xe + (size_t)io[k] * BS;
    float gv[kPerWarp], iv[kPerWarp];
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) {
      gv[t] = to_f32(wgk[(size_t)(warp + t * kWarps) * BS]);
      iv[t] = to_f32(wik[(size_t)(warp + t * kWarps) * BS]);
    }
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) {
      const int i = warp + t * kWarps;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) {
          const float xv = to_f32(xk[r * n_in + i]);
          ag[r] += xv * gv[t];
          au[r] += xv * iv[t];
        }
    }
  }

  __shared__ float red[2][kWarps][kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    red[0][warp][r][lane] = ag[r];
    red[1][warp][r][lane] = au[r];
  }
  __syncthreads();

  const int r = warp;
  if (r < rows) {
    float sg = 0.f, su = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      sg += red[0][v][r][lane];
      su += red[1][v][r][lane];
    }
    const size_t out = ((size_t)e * M + m0 + r) * n_out + (size_t)o * BS + c;
    if (g != nullptr) {
      store(&g[out], sg);
      store(&u[out], su);
    }
    store(&h[out], act_fwd(sg, kSilu) * su);
  }
}

template <typename T, int BS>
int launch(const void* x, const void* w, const void* idx, const void* bias,
           void* y, void* pre, int E, int M, int nib, int nob, int kb,
           int act, cudaStream_t stream) {
  const dim3 grid(nob * (BS / kCols), (M + kRows - 1) / kRows, E);
  junction_fwd_kernel<T, BS><<<grid, dim3(kCols, kWarps), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(idx), static_cast<const T*>(bias),
      static_cast<T*>(y), static_cast<T*>(pre), M, nib, nob, kb, act);
  return (int)cudaGetLastError();
}

template <typename T, int BS>
int launch_gated(const void* x, const void* wg, const void* wi,
                 const void* idx, void* h, void* g, void* u, int E, int M,
                 int nib, int nob, int kb, cudaStream_t stream) {
  const dim3 grid(nob * (BS / kCols), (M + kRows - 1) / kRows, E);
  junction_gated_fwd_kernel<T, BS><<<grid, dim3(kCols, kWarps), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wi), static_cast<const int*>(idx),
      static_cast<T*>(h), static_cast<T*>(g), static_cast<T*>(u), M, nib,
      nob, kb);
  return (int)cudaGetLastError();
}

bool valid_bs(int bs) { return bs == 32 || bs == 64 || bs == 128; }

}  // namespace

#define JUNCTION_BS_SWITCH(CALL) \
  switch (bs) {                     \
    case 32: {                      \
      constexpr int BS = 32;        \
      return CALL;                  \
    }                               \
    case 64: {                      \
      constexpr int BS = 64;        \
      return CALL;                  \
    }                               \
    default: {                      \
      constexpr int BS = 128;       \
      return CALL;                  \
    }                               \
  }

// Both return the cudaError_t of the launch (0 on success).  dtype: 0
// fp32, 1 bf16.  They launch on `stream`, allocate nothing and do not
// synchronise.

// The plain junction; `pre` may be null.
extern "C" int junction_fwd(const void* x, const void* w, const void* idx,
                            const void* bias, void* y, void* pre, int E,
                            int M, int nib, int nob, int kb, int bs, int act,
                            int dtype, void* stream) {
  if (!valid_bs(bs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    JUNCTION_BS_SWITCH((launch<float, BS>(x, w, idx, bias, y, pre, E, M, nib,
                                          nob, kb, act, s)))
  }
  if (dtype == 1) {
    JUNCTION_BS_SWITCH((launch<__nv_bfloat16, BS>(x, w, idx, bias, y, pre, E,
                                                  M, nib, nob, kb, act, s)))
  }
  return (int)cudaErrorInvalidValue;
}

// The gated junction: h = silu(x @ wg) * (x @ wi); g and u (the
// residuals) are both null or both given.
extern "C" int junction_gated_fwd(const void* x, const void* wg,
                                  const void* wi, const void* idx, void* h,
                                  void* g, void* u, int E, int M, int nib,
                                  int nob, int kb, int bs, int dtype,
                                  void* stream) {
  if (!valid_bs(bs) || (g == nullptr) != (u == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    JUNCTION_BS_SWITCH((launch_gated<float, BS>(x, wg, wi, idx, h, g, u, E, M,
                                                nib, nob, kb, s)))
  }
  if (dtype == 1) {
    JUNCTION_BS_SWITCH((launch_gated<__nv_bfloat16, BS>(
        x, wg, wi, idx, h, g, u, E, M, nib, nob, kb, s)))
  }
  return (int)cudaErrorInvalidValue;
}
