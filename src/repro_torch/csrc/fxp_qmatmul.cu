// Fixed-point matmul of integer codes for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `qmatmul` (_kernel) of
// src/repro/kernels/fxp_qmatmul.py:
//
//   acc[m, n] = sum_k a[m, k] * w[k, n]     int32, wrapping mod 2^32
//   out[m, n] = clip((acc + 2^(bf-1)) >> bf, -2^(bn+bf), 2^(bn+bf) - 1)
//
// a [M, K], w [K, N], out [M, N], all int32 codes, row-major; any M, K,
// N (ragged edges are masked, not padded in memory).
//
// Exactness.  The products and sums are uint32 multiply-adds: they wrap
// mod 2^32 exactly as the reference's int32 dot does (signed overflow
// is undefined in C++, unsigned is not), in any order.  The epilogue
// adds 2^(bf-1) in uint32 (wrapping), reinterprets the sum as int32 (two's
// complement) and shifts it arithmetically, then clamps in 64 bits.
//
// What bounds it: 2*M*K*N integer operations against (M*K + K*N + M*N)
// * 4 bytes, so the operations at all but the smallest shapes; the card
// has no int32 rate on its data sheet (the fp32 CUDA-core rate, 67 T/s,
// stands in).  Tensor cores are out for now: int8 MMA takes 8-bit
// operands and the codes reach 16 bits (bw 16); splitting codes into
// bytes is later work.
//
// Design.  A block of 256 threads computes a 64 x 64 output tile.  K is
// walked in tiles of 16: the block stages a [64, 16] tile of a
// (transposed, so that the inner loop reads a column of a as one
// address per half-warp) and a [16, 64] tile of w in shared memory, zeros
// past the edges.  Thread (ty, tx) keeps a 4 x 4 register tile of
// accumulators for rows ty + 16 i and columns tx + 16 j: per k it reads
// four a values (broadcast) and four w values (16 consecutive words a
// half-warp) and does 16 multiply-adds.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    fxp_qmatmul_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ w,
                       int32_t* __restrict__ out, int M, int K, int N, int bf,
                       int bn) {
  __shared__ uint32_t as[kBK][kBM + 1];  // a tile, transposed: as[k][m]
  __shared__ uint32_t ws[kBK][kBN];      // w tile: ws[k][n]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  uint32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gm = m0 + r, gk = k0 + c;
      as[c][r] = (gm < M && gk < K)
                     ? static_cast<uint32_t>(a[(size_t)gm * K + gk])
                     : 0u;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N)
                     ? static_cast<uint32_t>(w[(size_t)gk * N + gn])
                     : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      uint32_t av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
    }
    __syncthreads();
  }

  const long long lim = 1LL << (bn + bf);
  const uint32_t half = 1u << (bf - 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const int32_t s = static_cast<int32_t>(acc[i][j] + half) >> bf;
      long long v = s;
      v = v < -lim ? -lim : (v > lim - 1 ? lim - 1 : v);
      out[(size_t)gm * N + gn] = static_cast<int32_t>(v);
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  Launches on
// `stream`, allocates nothing, does not synchronise.  Needs 1 <= bf,
// 0 <= bn, bn + bf <= 31.
extern "C" int fxp_qmatmul(const void* a, const void* w, void* out, int M,
                           int K, int N, int bf, int bn, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || bf < 1 || bn < 0 || bn + bf > 31)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  fxp_qmatmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(w),
      static_cast<int32_t*>(out), M, K, N, bf, bn);
  return (int)cudaGetLastError();
}
