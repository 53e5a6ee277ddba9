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
// What bounds it: 2*M*K*N integer operations against (M*K + K*N + M*N)
// * 4 bytes, so the operations at all but the smallest shapes.  The card
// has no int32 multiply-add rate on its data sheet: on the CUDA cores
// (IMAD, at most the fp32 rate, 67 T/s) 4096^3 takes at least 2 ms.  The
// int8 tensor cores do 1,979 T/s: split into byte planes, a 16-bit code
// product is four int8 products (ten for codes beyond 16 bits, one at 8
// bits), 7x the CUDA-core rate.
//
// Design: fxp_tc.cuh's byte-plane product on int8 mma.sync, in two
// kernels.  Read as int32 codes, a 64 x 128 output tile takes (64 + 128)
// * 4 bytes a k from L2 (6.4 GB at 4096^3) and converts every code to
// planes again in each tile that reads it.  So fxp_pack_kernel first
// writes each operand once as byte planes, a [4][M][Kp] and w transposed
// (K-major, as the MMA takes B) [4][N][Kp] (Kp = K rounded up to 128,
// zero codes past K), and ORs the vote of the codes it saw into
// votes[operand]; fxp_qmatmul_kernel then reads only the planes the votes
// ask for (two at 16-bit codes: half the bytes of int32): 16-byte
// cp.async of plane rows straight into a ring of stages in the layout
// k_step reads, one barrier a K tile of 128 (four m16n8k32 steps).
// 64 x 128 output tiles of eight warps.  The exactness argument is
// fxp_tc.cuh's: uint32 sums of products of planes, every int32
// accumulator bounded by a K chunk of at most 8192.
// A K split (`run` K tiles a block, `nsplit` blocks a tile, from
// fxp_qmatmul.qmatmul_plan on the shapes alone) also fills the card when
// the output has few tiles (512 x 512 has 32): each block writes its
// uint32 sums to scratch and the last block of a tile to arrive adds them
// (a self-resetting ticket) and runs the epilogue.  The epilogue adds
// 2^(bf-1) in uint32 (wrapping), reinterprets the sum as int32 (two's
// complement), shifts it arithmetically and clamps in 64 bits.
#include <cstdint>

#include <cuda_runtime.h>

#include "fxp_tc.cuh"

namespace {

using namespace fxp_tc;

constexpr int kBN = 128;
using S = Shape<kBN>;
// The packed kernel's K tiles: 128 codes (4 k steps), rows of 128 plane
// bytes padded to 36 words; at most kChunk of them a block (8192 of K);
// a ring of as many stages of the planes the votes ask for as fit in
// kRingBytes, at most kMaxStages (4 with up to two planes an operand, 2
// with four each).
constexpr int kPK = 128;
constexpr int kPRow = kPK / 4 + 4;
constexpr int kChunk = kChunkTiles * kBK / kPK;
constexpr int kRingBytes = 224 * 1024;
constexpr int kMaxStages = 4;

// Four codes a thread: k = gk .. gk + 3 of `row` (zero past K), one
// 16-byte load when vec.
__device__ __forceinline__ void load_quad(const int* row, int gk, int K,
                                          bool vec, int (&c)[4]) {
  if (vec && gk < K) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(row + gk));
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j] = gk + j < K ? __ldg(row + gk + j) : 0;
}

// Blocks 0 .. a_blocks - 1: a quad of a a thread (row q / (Kp / 4), k
// 4 (q % (Kp / 4))), its planes one word each in ap.  The rest: a 32 x
// 128 tile of w a block, thread (kq, nq) = (lane % 8, 4 warp + lane /
// 8) the 4 x 4 group of code rows 4 kq .. and columns 4 nq .., each
// column's planes one word each in bp (lanes 0..7 write 32 bytes of one
// row of bp).  Every block ORs its vote into votes[operand].
__global__ void __launch_bounds__(S::kThreads)
    fxp_pack_kernel(const int* __restrict__ a, const int* __restrict__ w,
                    uint32_t* __restrict__ ap, uint32_t* __restrict__ bp,
                    int* __restrict__ votes, int M, int K, int N, int Kp,
                    int a_blocks, int a_vec, int w_vec) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t words = (size_t)Kp / 4;  // plane words a row
  unsigned mag = 0;
  int which = 0;
  if ((int)blockIdx.x < a_blocks) {
    const size_t q = (size_t)blockIdx.x * S::kThreads + tid;
    if (q < (size_t)M * words) {
      const size_t m = q / words, kw = q % words;
      int c[4], pl[4];
      load_quad(a + m * K, 4 * (int)kw, K, a_vec != 0, c);
      transpose4x4(c, pl);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        mag |= magnitude(c[p]);
        ap[((size_t)p * M + m) * words + kw] = static_cast<uint32_t>(pl[p]);
      }
    }
  } else {
    which = 1;
    const int b = blockIdx.x - a_blocks, tiles_n = (N + kBN - 1) / kBN;
    const int kq = (b / tiles_n) * 8 + (lane & 7);
    const int gn = (b % tiles_n) * kBN + 4 * (warp * 4 + (lane >> 3));
    int c[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gk = 4 * kq + r;
      if (gk < K) {
        load_quad(w + (size_t)gk * N, gn, N, w_vec != 0, c[r]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) c[r][j] = 0;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (gn + j >= N) break;
      const int col[4] = {c[0][j], c[1][j], c[2][j], c[3][j]};
      int pl[4];
      transpose4x4(col, pl);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        mag |= magnitude(col[p]);
        bp[((size_t)p * N + gn + j) * words + kq] =
            static_cast<uint32_t>(pl[p]);
      }
    }
  }
  const int bits = wide_bits(__reduce_or_sync(0xffffffffu, mag));
  if (lane == 0 && bits) atomicOr(votes + which, bits);
}

// grid (tiles of 64 x 128, nsplit): block (x, s) takes K tiles of 128
// s * run .. min(Kp / 128, (s + 1) * run) - 1 of output tile x.  A stage
// holds the planes the votes ask for of one K tile as k_step reads them:
// rows of 128 bytes padded to 144, A [pa][64][.] then B [pb][128][.].
// votes: [a's, w's, blocks that read them]; the last block to read them
// leaves all three zero.
__global__ void __launch_bounds__(S::kThreads, 1)
    fxp_qmatmul_kernel(const unsigned char* __restrict__ ap,
                       const unsigned char* __restrict__ bp,
                       int* __restrict__ votes, int* __restrict__ out,
                       uint32_t* __restrict__ part, int* __restrict__ tickets,
                       int M, int Kp, int N, int bf, int bn, int run,
                       int nsplit) {
  extern __shared__ __align__(16) uint32_t sm[];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
  const int t0 = split * run;
  const int nt = min(run, Kp / kPK - t0);
  const int pa = planes_of(votes[0]), pb = planes_of(votes[1]);
  __threadfence();
  __syncthreads();
  if (tid == 0 &&
      atomicAdd(votes + 2, 1) == (int)(gridDim.x * gridDim.y) - 1) {
    votes[0] = votes[1] = votes[2] = 0;
  }
  const int a_words = pa * kBM * kPRow;
  const int stage_words = a_words + pb * kBN * kPRow;
  const int ns = min(kMaxStages, kRingBytes / 4 / stage_words);

  // K tile i's planes into stage i % ns: 16-byte eighths of plane rows
  // (chunk c: plane c / (8 rows), row c / 8 % rows, eighth c % 8), zeros
  // for rows past M or N
  auto copy_planes = [&](const unsigned char* src, int planes, int rows,
                         int g0, int limit, uint32_t* dst, size_t k0) {
    for (int c = tid; c < planes * rows * 8; c += S::kThreads) {
      const int pr = c >> 3, r = pr % rows, h = c & 7;
      const bool ok = g0 + r < limit;
      cp_async<16>(dst + pr * kPRow + 4 * h,
                   ok ? src + ((size_t)(pr / rows) * limit + g0 + r) * Kp +
                            k0 + 16 * h
                      : src,
                   ok);
    }
  };
  auto copy = [&](int i) {
    if (i < nt) {
      uint32_t* st = sm + (i % ns) * stage_words;
      const size_t k0 = (size_t)(t0 + i) * kPK;
      copy_planes(ap, pa, kBM, m0, M, st, k0);
      copy_planes(bp, pb, kBN, n0, N, st + a_words, k0);
    }
    cp_commit();
  };
  // ns - 2 groups may stay pending while K tile i is read
  auto wait = [&]() {
    if (ns >= 4)
      cp_wait<2>();
    else if (ns == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
  };

  int acc[2][4][4][4];
  zero_acc(acc);
  for (int i = 0; i < ns - 1; ++i) copy(i);
  for (int i = 0; i < nt; ++i) {
    wait();           // K tile i's group
    __syncthreads();  // ... of every thread; stage (i - 1) % ns free
    copy(i + ns - 1);
    const uint32_t* st = sm + (i % ns) * stage_words;
#pragma unroll
    for (int k = 0; k < kPK / kBK; ++k)
      k_step_at<kBN, kPRow>(pa, pb, st + 8 * k, st + a_words + 8 * k, acc,
                            warp / S::kWN, warp % S::kWN, lane >> 2,
                            lane & 3);
  }
  cp_wait<0>();
  uint32_t v[kVals];
  combine_acc(acc, v);
  if (!combine_splits<kBN>(v, part + (size_t)tile * kBM * kBN,
                           (size_t)gridDim.x * kBM * kBN, split, nsplit,
                           tickets + tile, &s_last))
    return;

  const long long lim = 1LL << (bn + bf);
#pragma unroll
  for (int u = 0; u < kVals; ++u) {
    const int gm = m0 + row_of<kBN>(u), gn = n0 + col_of<kBN>(u);
    if (gm >= M || gn >= N) continue;
    long long s = round_shift(v[u], bf);
    s = s < -lim ? -lim : (s > lim - 1 ? lim - 1 : s);
    out[(size_t)gm * N + gn] = static_cast<int>(s);
  }
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success): fxp_pack_kernel,
// then fxp_qmatmul_kernel.  Launches on `stream`, allocates
// nothing, does not synchronise.  Needs 1 <= bf, 0 <= bn, bn + bf <= 31,
// the split plan of fxp_qmatmul.qmatmul_plan (1 <= run <= 64 K tiles of
// 128 a block, nsplit blocks a tile covering max(1, ceil(K / 128)) of
// them), scratch `ap` of 4 * M * Kp and `bp` of 4 * N * Kp bytes (Kp =
// 128 max(1, ceil(K / 128)); 16-byte aligned), three int32 `votes`, zero,
// left zero, and, for nsplit > 1, uint32 scratch `part` of nsplit * tiles
// * 64 * 128 words and int32 `tickets`, one a tile of 64 x 128, zero,
// left zero.
extern "C" int fxp_qmatmul(const void* a, const void* w, void* out, void* ap,
                           void* bp, void* votes, void* part, void* tickets,
                           int M, int K, int N, int bf, int bn, int run,
                           int nsplit, void* stream) {
  const int kt = K > 0 ? (K + kPK - 1) / kPK : 1;
  const long long Kp = (long long)kt * kPK;
  if (M <= 0 || N <= 0 || K < 0 || bf < 1 || bn < 0 || bn + bf > 31 ||
      run < 1 || run > kChunk || nsplit < 1 ||
      (nsplit - 1) * run >= kt || nsplit * run < kt || ap == nullptr ||
      bp == nullptr || votes == nullptr ||
      reinterpret_cast<uintptr_t>(ap) % 16 ||
      reinterpret_cast<uintptr_t>(bp) % 16 ||
      (nsplit > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const long long a_blocks = ((long long)M * (Kp / 4) + S::kThreads - 1) /
                             S::kThreads;
  const long long b_blocks = Kp / kBK * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL || nsplit > 65535 ||
      a_blocks + b_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr size_t kSmem = kRingBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fxp_qmatmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool w_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  fxp_pack_kernel<<<(unsigned)(a_blocks + b_blocks), S::kThreads, 0, s>>>(
      static_cast<const int*>(a), static_cast<const int*>(w),
      static_cast<uint32_t*>(ap), static_cast<uint32_t*>(bp),
      static_cast<int*>(votes), M, K, N, (int)Kp, (int)a_blocks,
      a_vec ? 1 : 0, w_vec ? 1 : 0);
  const cudaError_t packed = cudaGetLastError();
  if (packed != cudaSuccess) return (int)packed;
  fxp_qmatmul_kernel<<<dim3((unsigned)tiles, nsplit), S::kThreads, kSmem,
                       s>>>(
      static_cast<const unsigned char*>(ap),
      static_cast<const unsigned char*>(bp), static_cast<int*>(votes),
      static_cast<int*>(out), static_cast<uint32_t*>(part),
      static_cast<int*>(tickets), M, (int)Kp, N, bf, bn, run, nsplit);
  return (int)cudaGetLastError();
}
