// Block-sparse junction backward to the input (BP) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel `dx` (dx_kernel) of
// src/repro/kernels/block_sparse_matmul.py:
//
//   dx[e, m, i*bs + a] = sum_{f < rev_cnt[i]} sum_c
//       dz[e, m, rev_ob[i,f]*bs + c] * w[e, rev_ob[i,f], rev_t[i,f], a, c]
//
// with dz = (dy * act'(res)) rounded to dy's dtype (dy itself for "none")
// recomputed per tile from the saved residual, an fp32 sum and one store
// in dy's dtype.  dy, res [E, M, nob*bs]; w [E, nob, kb, bs, bs] in the
// forward layout (read transposed, never gathered); rev_ob / rev_t
// [nib, fb], rev_cnt [nib] int32; dx [E, M, nib*bs].
//
// What bounds it: at the training shapes (M = 2048 rows of bf16, 128-wide
// blocks) the least time is set by the bytes of dy and the residual
// (2 x 28 MB for the 6912-wide junctions) against some 18 GFLOP, so
// bytes and operations are within 25 % of each other on the card.
//
// Design.  The TPU kernel walks one (row tile, input block) per grid step
// and DMAs the reverse weight tiles in pairs.  Here every (unit e, 64-row
// tile, input block i, 64-column chunk of it) is a block of 256 threads,
// each summing a 4 x 4 patch of the output in registers (4 x 2 for
// block 32) — a plain shared-memory tiled product.  The block walks only
// the rev_cnt[i] valid reverse slots: a padded slot is never read, so it
// adds exactly nothing even when dy holds inf or NaN, and an input block
// that feeds no output gets exact zeros.  Per slot it stages 32 columns
// of dz (activation gradient recomputed on the way in) and the matching
// 32 columns of the weight tile, transposed in shared memory; the sum
// runs in a fixed order (slot, column), so the result does not depend on
// scheduling.  No atomics.  The ragged M edge is masked.  wgmma and TMA
// are later work.
#include "junction_common.cuh"

namespace {

using namespace junction;

constexpr int kBM = 64;        // rows of dx per block
constexpr int kBK = 32;        // dz columns staged per step
constexpr int kThreads = 256;  // 16 x 16: rows ty + 16r, columns tx + 16j

template <typename T, int BS>
__global__ void __launch_bounds__(kThreads)
    junction_dx_kernel(const T* __restrict__ dy, const T* __restrict__ res,
                       const T* __restrict__ w,
                       const int* __restrict__ rev_ob,
                       const int* __restrict__ rev_t,
                       const int* __restrict__ rev_cnt, T* __restrict__ dx,
                       int M, int nob, int kb, int nib, int fb, int act) {
  constexpr int BN = BS < 64 ? BS : 64;  // dx columns per block
  constexpr int TN = BN / 16;
  constexpr int kChunks = BS / BN;
  __shared__ float As[kBK][kBM + 1];     // dz, [column c][row m]
  __shared__ float Bs[kBK][BN + 1];      // w tile, [column c][input a]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i = blockIdx.x / kChunks;
  const int a0 = (blockIdx.x % kChunks) * BN;
  const int m0 = blockIdx.y * kBM;
  const int e = blockIdx.z;
  const size_t n_out = (size_t)nob * BS;
  const size_t n_in = (size_t)nib * BS;
  const T* dye = dy + (size_t)e * M * n_out;
  const T* rese = res == nullptr ? nullptr : res + (size_t)e * M * n_out;
  const T* we = w + (size_t)e * nob * kb * BS * BS;

  float acc[4][TN];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0.f;

  const int cnt = rev_cnt[i];
  const int c = tid % kBK;               // column this thread stages
  for (int f = 0; f < cnt; ++f) {
    const int ob = rev_ob[(size_t)i * fb + f];
    const T* wt = we + ((size_t)ob * kb + rev_t[(size_t)i * fb + f]) * BS * BS;
    for (int c0 = 0; c0 < BS; c0 += kBK) {
#pragma unroll
      for (int q = 0; q < kBM * kBK / kThreads; ++q) {
        const int m = tid / kBK + q * (kThreads / kBK);
        float v = 0.f;
        if (m0 + m < M) {
          float unused;
          v = dz_of(dye, rese,
                    (size_t)(m0 + m) * n_out + (size_t)ob * BS + c0 + c, act,
                    &unused);
        }
        As[c][m] = v;
      }
#pragma unroll
      for (int q = 0; q < BN * kBK / kThreads; ++q) {
        const int a = tid / kBK + q * (kThreads / kBK);
        Bs[c][a] = to_f32(wt[(size_t)(a0 + a) * BS + c0 + c]);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        float av[4], bv[TN];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = As[k][ty + 16 * r];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[r][j] += av[r] * bv[j];
      }
      __syncthreads();
    }
  }

  T* dxe = dx + (size_t)e * M * n_in + (size_t)i * BS + a0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) store(&dxe[(size_t)m * n_in + tx + 16 * j],
                                       acc[r][j]);
  }
}

template <typename T, int BS>
void launch(const void* dy, const void* res, const void* w,
            const void* rev_ob, const void* rev_t, const void* rev_cnt,
            void* dx, int E, int M, int nob, int kb, int nib, int fb, int act,
            cudaStream_t stream) {
  constexpr int BN = BS < 64 ? BS : 64;
  const dim3 grid(nib * (BS / BN), (M + kBM - 1) / kBM, E);
  junction_dx_kernel<T, BS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(res),
      static_cast<const T*>(w), static_cast<const int*>(rev_ob),
      static_cast<const int*>(rev_t), static_cast<const int*>(rev_cnt),
      static_cast<T*>(dx), M, nob, kb, nib, fb, act);
}

template <typename T>
int dispatch_bs(const void* dy, const void* res, const void* w,
                const void* rev_ob, const void* rev_t, const void* rev_cnt,
                void* dx, int E, int M, int nob, int kb, int nib, int fb,
                int bs, int act, cudaStream_t stream) {
  switch (bs) {
    case 32:
      launch<T, 32>(dy, res, w, rev_ob, rev_t, rev_cnt, dx, E, M, nob, kb,
                    nib, fb, act, stream);
      break;
    case 64:
      launch<T, 64>(dy, res, w, rev_ob, rev_t, rev_cnt, dx, E, M, nob, kb,
                    nib, fb, act, stream);
      break;
    case 128:
      launch<T, 128>(dy, res, w, rev_ob, rev_t, rev_cnt, dx, E, M, nob, kb,
                     nib, fb, act, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype: 0 fp32,
// 1 bf16; `res` is null for act "none".  Launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int junction_dx(const void* dy, const void* res, const void* w,
                           const void* rev_ob, const void* rev_t,
                           const void* rev_cnt, void* dx, int E, int M,
                           int nob, int kb, int nib, int fb, int bs, int act,
                           int dtype, void* stream) {
  if ((act != kNone && res == nullptr) || M <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bs<float>(dy, res, w, rev_ob, rev_t, rev_cnt, dx, E, M,
                              nob, kb, nib, fb, bs, act, s);
  if (dtype == 1)
    return dispatch_bs<__nv_bfloat16>(dy, res, w, rev_ob, rev_t, rev_cnt, dx,
                                      E, M, nob, kb, nib, fb, bs, act, s);
  return (int)cudaErrorInvalidValue;
}
