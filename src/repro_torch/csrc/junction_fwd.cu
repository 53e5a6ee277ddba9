// Block-sparse junction forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `fwd` (fwd_kernel) of
// src/repro/kernels/block_sparse_matmul.py:
//
//   y[e, m, o*bs + c] = act( sum_k sum_i x[e, m, idx[o,k]*bs + i]
//                                        * w[e, o, k, i, c]  + bias[e, o*bs + c] )
//
// x [E, M, nib*bs], w [E, nob, kb, bs, bs], idx [nob, kb] int32,
// bias [E, nob*bs] (already rounded to x's dtype), y [E, M, nob*bs].
// fp32 accumulation; the epilogue widens the bias, applies the
// activation in fp32 and stores once in x's dtype (fp32 or bf16).  When
// `pre` is not null the pre-activation s is stored there as well, in
// x's dtype (the backward's residual for silu and gelu).
//
// What bounds it: on the serving path M is the decode batch (4) or the
// prefill chunk (32), so every weight element feeds only M
// multiply-adds and the kernel is bound by the weight bytes it streams
// (8.85 MB in bf16 for a 2560->6912 junction at kb 5), not by
// arithmetic.
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
// loads that hit L1).  The block reads its own idx[o, :]; the ragged M
// edge is masked in the kernel (no row padding); the eight partial sums
// of a column are reduced through shared memory in a fixed order, so the
// result does not depend on scheduling.  A simple SIMT kernel: wgmma and
// TMA are later work.
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

template <typename T, int BS>
void launch(const void* x, const void* w, const void* idx, const void* bias,
            void* y, void* pre, int E, int M, int nib, int nob, int kb,
            int act, cudaStream_t stream) {
  const dim3 block(kCols, kWarps);
  const dim3 grid(nob * (BS / kCols), (M + kRows - 1) / kRows, E);
  junction_fwd_kernel<T, BS><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(idx), static_cast<const T*>(bias),
      static_cast<T*>(y), static_cast<T*>(pre), M, nib, nob, kb, act);
}

template <typename T>
int dispatch_bs(const void* x, const void* w, const void* idx,
                const void* bias, void* y, void* pre, int E, int M, int nib,
                int nob, int kb, int bs, int act, cudaStream_t stream) {
  switch (bs) {
    case 32:
      launch<T, 32>(x, w, idx, bias, y, pre, E, M, nib, nob, kb, act,
                    stream);
      break;
    case 64:
      launch<T, 64>(x, w, idx, bias, y, pre, E, M, nib, nob, kb, act,
                    stream);
      break;
    case 128:
      launch<T, 128>(x, w, idx, bias, y, pre, E, M, nib, nob, kb, act,
                     stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype: 0 fp32,
// 1 bf16; `pre` may be null.  Launches on `stream`, allocates nothing,
// does not synchronise.
extern "C" int junction_fwd(const void* x, const void* w, const void* idx,
                            const void* bias, void* y, void* pre, int E,
                            int M, int nib, int nob, int kb, int bs, int act,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bs<float>(x, w, idx, bias, y, pre, E, M, nib, nob, kb, bs,
                              act, s);
  if (dtype == 1)
    return dispatch_bs<__nv_bfloat16>(x, w, idx, bias, y, pre, E, M, nib, nob,
                                      kb, bs, act, s);
  return (int)cudaErrorInvalidValue;
}
