// Block-sparse junction backward to the input (BP) for Hopper (sm_90a),
// plain C interface: the plain junction and the gated (SwiGLU) junction.
//
// Replaces the Pallas TPU kernels `dx` (dx_kernel) and `gated_dx`
// (gated_dx_kernel) of src/repro/kernels/block_sparse_matmul.py:
//
//   dx[e, m, i*bs + a] = sum_{f < rev_cnt[i]} sum_c
//       dz[e, m, rev_ob[i,f]*bs + c] * w[e, rev_ob[i,f], rev_t[i,f], a, c]
//
// with dz = (dy * act'(res)) rounded to dy's dtype (dy itself for "none")
// recomputed per tile from the saved residual, an fp32 sum and one store
// in dy's dtype.  The gated form sums two such products per slot,
// dz_g against wg and dz_u against wi, with dz_g = dh * u * silu'(g) and
// dz_u = dh * silu(g) recomputed from the saved g and u and rounded to
// dh's dtype.  dy (dh), res (g), u [E, M, nob*bs]; w, wi
// [E, nob, kb, bs, bs] in the forward layout (read transposed, never
// gathered); rev_ob / rev_t [nib, fb], rev_cnt [nib] int32; dx
// [E, M, nib*bs].
//
// What bounds it: at the dense training shapes (M = 2048 rows of bf16,
// 128-wide blocks) the least time is set by the bytes of dy and the
// residual (2 x 28 MB for the 6912-wide junctions) against some 18
// GFLOP, so bytes and operations are within 25 % of each other on the
// card.  The gated expert junction of qwen3-moe (128 experts, M = 160
// rows each) reads dh, g and u (3 x 31 MB) and both weight streams
// (0.20 GB): bound by those bytes.
//
// Design.  The TPU kernel walks one (row tile, input block) per grid step
// and DMAs the reverse weight tiles in pairs.  Here every (unit e, 64-row
// tile, input block i, 64-column chunk of it) is a block of 256 threads,
// each summing a 4 x 4 patch of the output in registers (4 x 2 for
// block 32) — a plain shared-memory tiled product.  The block walks only
// the rev_cnt[i] valid reverse slots: a padded slot is never read, so it
// adds exactly nothing even when dy holds inf or NaN, and an input block
// that feeds no output gets exact zeros.  Per slot it stages 32 columns
// of dz (activation gradient recomputed on the way in; both branch
// gradients for the gated form) and the matching 32 columns of the
// weight tile (of both streams), transposed in shared memory; the sum
// runs in a fixed order (slot, column), so the result does not depend on
// scheduling.  No atomics.  The ragged M edge is masked.  wgmma and TMA
// are later work.
#include "junction_common.cuh"

namespace {

using namespace junction;

constexpr int kBM = 64;        // rows of dx per block
constexpr int kBK = 32;        // dz columns staged per step
constexpr int kThreads = 256;  // 16 x 16: rows ty + 16r, columns tx + 16j

template <typename T, int BS, bool GATED>
__global__ void __launch_bounds__(kThreads)
    junction_dx_kernel(const T* __restrict__ dy, const T* __restrict__ res,
                       const T* __restrict__ u, const T* __restrict__ w,
                       const T* __restrict__ wi,
                       const int* __restrict__ rev_ob,
                       const int* __restrict__ rev_t,
                       const int* __restrict__ rev_cnt, T* __restrict__ dx,
                       int M, int nob, int kb, int nib, int fb, int act) {
  constexpr int NW = GATED ? 2 : 1;      // weight streams
  constexpr int BN = BS < 64 ? BS : 64;  // dx columns per block
  constexpr int TN = BN / 16;
  constexpr int kChunks = BS / BN;
  __shared__ float As[NW][kBK][kBM + 1];  // dz, [column c][row m]
  __shared__ float Bs[NW][kBK][BN + 1];   // w tile, [column c][input a]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i = blockIdx.x / kChunks;
  const int a0 = (blockIdx.x % kChunks) * BN;
  const int m0 = blockIdx.y * kBM;
  const int e = blockIdx.z;
  const size_t n_out = (size_t)nob * BS;
  const size_t n_in = (size_t)nib * BS;
  const size_t ofs = (size_t)e * M * n_out;
  const T* dye = dy + ofs;
  const T* rese = res == nullptr ? nullptr : res + ofs;
  const T* ue = GATED ? u + ofs : nullptr;
  const size_t wofs = (size_t)e * nob * kb * BS * BS;
  const T* ws[NW];
  ws[0] = w + wofs;
  if constexpr (GATED) ws[1] = wi + wofs;

  float acc[4][TN];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0.f;

  const int cnt = rev_cnt[i];
  const int c = tid % kBK;               // column this thread stages
  for (int f = 0; f < cnt; ++f) {
    const int ob = rev_ob[(size_t)i * fb + f];
    const size_t tofs =
        ((size_t)ob * kb + rev_t[(size_t)i * fb + f]) * BS * BS;
    for (int c0 = 0; c0 < BS; c0 += kBK) {
#pragma unroll
      for (int q = 0; q < kBM * kBK / kThreads; ++q) {
        const int m = tid / kBK + q * (kThreads / kBK);
        float v[NW];
#pragma unroll
        for (int s = 0; s < NW; ++s) v[s] = 0.f;
        if (m0 + m < M) {
          const size_t off =
              (size_t)(m0 + m) * n_out + (size_t)ob * BS + c0 + c;
          if constexpr (GATED) {
            gated_dz(dye, rese, ue, off, &v[0], &v[1]);
          } else {
            float unused;
            v[0] = dz_of(dye, rese, off, act, &unused);
          }
        }
#pragma unroll
        for (int s = 0; s < NW; ++s) As[s][c][m] = v[s];
      }
#pragma unroll
      for (int q = 0; q < BN * kBK / kThreads; ++q) {
        const int a = tid / kBK + q * (kThreads / kBK);
#pragma unroll
        for (int s = 0; s < NW; ++s)
          Bs[s][c][a] = to_f32(ws[s][tofs + (size_t)(a0 + a) * BS + c0 + c]);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
#pragma unroll
        for (int s = 0; s < NW; ++s) {
          float av[4], bv[TN];
#pragma unroll
          for (int r = 0; r < 4; ++r) av[r] = As[s][k][ty + 16 * r];
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = Bs[s][k][tx + 16 * j];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[r][j] += av[r] * bv[j];
        }
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

template <typename T, bool GATED>
int launch(const void* dy, const void* res, const void* u, const void* w,
           const void* wi, const void* rev_ob, const void* rev_t,
           const void* rev_cnt, void* dx, int E, int M, int nob, int kb,
           int nib, int fb, int bs, int act, cudaStream_t stream) {
  const int gy = (M + kBM - 1) / kBM;
#define JUNCTION_DX_CASE(B)                                                  \
  case B: {                                                                  \
    constexpr int BN = B < 64 ? B : 64;                                      \
    junction_dx_kernel<T, B, GATED>                                          \
        <<<dim3(nib * (B / BN), gy, E), kThreads, 0, stream>>>(              \
            static_cast<const T*>(dy), static_cast<const T*>(res),           \
            static_cast<const T*>(u), static_cast<const T*>(w),              \
            static_cast<const T*>(wi), static_cast<const int*>(rev_ob),      \
            static_cast<const int*>(rev_t),                                  \
            static_cast<const int*>(rev_cnt), static_cast<T*>(dx), M, nob,   \
            kb, nib, fb, act);                                               \
    break;                                                                   \
  }
  switch (bs) {
    JUNCTION_DX_CASE(32)
    JUNCTION_DX_CASE(64)
    JUNCTION_DX_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef JUNCTION_DX_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).  dtype: 0
// fp32, 1 bf16.  They launch on `stream`, allocate nothing and do not
// synchronise.

// The plain junction; `res` is null for act "none".
extern "C" int junction_dx(const void* dy, const void* res, const void* w,
                           const void* rev_ob, const void* rev_t,
                           const void* rev_cnt, void* dx, int E, int M,
                           int nob, int kb, int nib, int fb, int bs, int act,
                           int dtype, void* stream) {
  if ((act != kNone && res == nullptr) || M <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(dy, res, nullptr, w, nullptr, rev_ob, rev_t,
                                rev_cnt, dx, E, M, nob, kb, nib, fb, bs, act,
                                s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(dy, res, nullptr, w, nullptr, rev_ob,
                                        rev_t, rev_cnt, dx, E, M, nob, kb,
                                        nib, fb, bs, act, s);
  return (int)cudaErrorInvalidValue;
}

// The gated junction, from dh and the residuals g and u.
extern "C" int junction_gated_dx(const void* dh, const void* g, const void* u,
                                 const void* wg, const void* wi,
                                 const void* rev_ob, const void* rev_t,
                                 const void* rev_cnt, void* dx, int E, int M,
                                 int nob, int kb, int nib, int fb, int bs,
                                 int dtype, void* stream) {
  if (g == nullptr || u == nullptr || M <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(dh, g, u, wg, wi, rev_ob, rev_t, rev_cnt, dx,
                               E, M, nob, kb, nib, fb, bs, kSilu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(dh, g, u, wg, wi, rev_ob, rev_t,
                                       rev_cnt, dx, E, M, nob, kb, nib, fb,
                                       bs, kSilu, s);
  return (int)cudaErrorInvalidValue;
}
