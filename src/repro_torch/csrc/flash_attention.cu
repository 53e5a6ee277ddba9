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
// oracle does.  fp32 or bf16 in; any D from 1 to 128.
//
// What bounds it: 4 * D operations a (query, key) pair the masks keep
// (QK^T and PV), 85.9 GFLOP for stablelm-3b's 32 heads of D 80 at S 4096
// causal: 0.087 ms at the card's 989 TFLOP/s in bf16 on tensor cores,
// 1.28 ms at 67 TFLOP/s in fp32 on the CUDA cores.  The bytes (q, k, v
// and out once) are two orders of magnitude less.
//
// Which blocks run: a block owns one (bh, query tile) and walks only the
// key tiles its rows' masks reach (causal: none past the last row;
// window: none before the first row's window), unless one of its rows
// has no valid key: then it visits all of them, so that such a row sees
// NEG_INF for every existing key.  Keys past Sk score -inf, which no
// softmax counts.
//
// bf16: tensor cores, wgmma (Hopper's warpgroup MMA, bf16 in, fp32
// accumulate).  A block of two warpgroups owns 128 query rows, 64 each;
// key tiles are 64 keys; two blocks an SM (128 registers a thread).  q's
// tile, and each key tile's K and V (double-buffered), are staged in
// shared memory by 16-byte cp.async as bf16, never widened, in 32-byte
// swizzled atoms of 8 rows x 16 columns (the one swizzle whose atom
// divides every D a multiple of 16, 80 included); K and V share one
// layout, read K-major for QK^T and MN-major (transposed) for PV.
// S = QK^T (both operands from shared memory) lands in fp32 registers
// (products of bf16 are exact in fp32).  Scores are pre-scaled by
// scale * log2(e) and the online softmax runs in registers on
// ex2.approx, each row's max and sum over its four threads by two xor
// shuffles; a row's running max moves only when a tile passes it by
// 2^8, so O is rarely rescaled.  The tiles that straddle the causal
// diagonal, the window's edge or Sk are masked; interior tiles take no
// mask.  P's A fragments (registers) come straight from the S
// accumulators, split as hi = bf16(p) and lo = bf16(p - hi): two wgmmas
// into one fp32 O accumulator keep p to about 2^-16, where a single bf16
// P (2^-9) leaves outputs that are small next to their row's scale more
// than a bf16 ulp from the fp32-softmax plain version.  D is zero-padded
// to a multiple of 16 in shared memory (80 takes 5 k-steps, 128 takes
// 8); rows whose byte width is not a multiple of 16 are staged by a
// plain element loop in the same kernel.  Under causal masking the
// heaviest query tiles launch first; a kv head's rep query heads are
// adjacent in the grid, so their K and V tiles meet in L2.  Each
// warpgroup waits for its own wgmmas; the SM overlaps one warpgroup's
// softmax with another's products.
//
// fp32: SIMT fp32 FMAs.  A block of 256 threads owns a 64-row query tile
// and walks key tiles of 32: q is staged once in shared memory as fp32,
// transposed; each key tile's K (transposed) and V are staged as fp32;
// thread (ty, tx) scores rows ty + 16 i and keys tx + 16 j into a score
// tile, four threads a row take its max, exp and sum with shuffles and
// rescale (m, l), and thread (ty, tx) keeps acc for rows ty + 16 i and
// columns tx + 16 j in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

// The key range [k_begin, k_end) that the rows q0 .. q_last reach.
__device__ __forceinline__ void key_range(int q0, int q_last, int Sk,
                                          int causal, int window,
                                          int& k_begin, int& k_end) {
  const bool empty_row =
      window > 0 && (long long)q_last >= (long long)Sk + window - 1;
  k_begin = 0;
  k_end = Sk;
  if (!empty_row) {
    if (window > 0) k_begin = max(0, q0 - window + 1);
    if (causal) k_end = min(Sk, q_last + 1);
  }
}

// ------------------------------------------------------------ fp32: SIMT
namespace simt {

constexpr int kBQ = 64, kBK = 32, kThreads = 256;

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * (kBQ + 1) + (size_t)D * (kBK + 1) +
                          (size_t)kBK * D + kBQ * (kBK + 1) + 3 * kBQ);
}

__global__ void __launch_bounds__(kThreads)
    kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, int rep,
           int Sq, int Sk, int D, int causal, int window, float scale) {
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
  const float* qb = q + ((size_t)bh * Sq) * D;
  const float* kb = k + kvh * Sk * D;
  const float* vb = v + kvh * Sk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[d * (kBQ + 1) + r] = q0 + r < Sq ? qb[(size_t)(q0 + r) * D + d] : 0.f;
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

  int k_begin, k_end;
  key_range(q0, min(q0 + kBQ, Sq) - 1, Sk, causal, window, k_begin, k_end);
  __syncthreads();

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e - c * D;
      const bool in = k0 + c < Sk;
      const size_t off = (size_t)(k0 + c) * D + d;
      ks[d * (kBK + 1) + c] = in ? kb[off] : 0.f;
      vs[c * D + d] = in ? vb[off] : 0.f;
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
    float* orow = out + ((size_t)bh * Sq + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = acc[i][j] / l;
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int rep, int Sq, int Sk, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), rep, Sq, Sk, D,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ------------------------------------------------- bf16: tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
// two warpgroups of 64 query rows (a block's query tile is BQ rows), key
// tiles of BK keys, two blocks an SM
constexpr int kThreads = 256, BQ = 128, BK = 64, kMinBlocks = 2;

// A row's running max moves only when a tile's max passes it by more than
// this (log2 units), so O and l are rescaled rarely; p then stays below
// 2^8, far inside fp32 and with bf16's relative precision unchanged.
constexpr float kLazy = 8.f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros (rows past the end)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// what this thread's cp.async and stores wrote becomes visible to wgmma
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps reads of wgmma accumulators after the wait that completes them
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor of a tile in 32-byte swizzled atoms:
// start address, leading (lbo) and stride (sbo) byte offsets
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (3ull << 62);
}

// One wgmma m64nNk16 (bf16 in, fp32 accumulate) of a warpgroup: Ss<N>
// with both operands in shared memory, K-major (D = A B if scale_d is
// 0, else D += A B); Rs<N> with A in registers and B in shared memory,
// MN-major (D += A B).
template <int N>
struct Ss;
template <int N>
struct Rs;

template <>
struct Ss<64> {
  __device__ static void run(float (&d)[32], uint64_t a, uint64_t b,
                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Rs<32> {
  __device__ static void run(float (&d)[16], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Rs<64> {
  __device__ static void run(float (&d)[32], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Rs<80> {
  __device__ static void run(float (&d)[40], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Rs<96> {
  __device__ static void run(float (&d)[48], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Rs<128> {
  __device__ static void run(float (&d)[64], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as hi = bf16 pairs and lo = bf16 of what hi leaves out
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// 2^x by one ex2.approx.ftz (relative error about 2^-22; a result below
// 2^-126 flushes to 0, which no bf16 output can see)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Element (r, d) of a tile of ROWS rows: atoms of 8 rows x 16 columns
// (32 bytes a row), the two 16-byte halves of rows 4-7 swapped (the
// 32-byte swizzle); the atoms of one 16-column block stacked by rows.
template <int ROWS>
__device__ __forceinline__ int swz(int r, int d) {
  const int c = d >> 3;
  return (c >> 1) * ROWS * 16 + r * 16 + (((c & 1) ^ ((r >> 2) & 1)) << 3) +
         (d & 7);
}

// Rows [r0, r0 + ROWS) of a [rows, D] matrix into a tile; rows past
// `rows` are zeros.  vec: 16-byte cp.async, two threads a 32-byte
// sector (D % 8 == 0 and aligned pointers), else a plain element loop.
// Columns D.. are left alone.
template <int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int rows, int D, bool vec) {
  if (vec) {
    const int chunks = D / 8, pairs = (chunks + 1) / 2;
    for (int e = threadIdx.x; e < ROWS * 2 * pairs; e += kThreads) {
      const int r = (e >> 1) % ROWS, c = 2 * ((e >> 1) / ROWS) + (e & 1);
      if (c >= chunks) continue;
      const bool in = r0 + r < rows;
      const bf16* s = src + (size_t)(in ? r0 + r : 0) * D + c * 8;
      cp_async16(smem_u32(dst + swz<ROWS>(r, c * 8)), s, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      dst[swz<ROWS>(r, d)] = r0 + r < rows ? src[(size_t)(r0 + r) * D + d]
                                           : __float2bfloat16(0.f);
    }
  }
}

// zero columns D .. DP of a tile once: no load writes them
template <int ROWS>
__device__ __forceinline__ void zero_pad(bf16* dst, int D, int DP) {
  const int pad = DP - D;
  for (int e = threadIdx.x; e < ROWS * pad; e += kThreads) {
    const int r = e / pad;
    dst[swz<ROWS>(r, D + e - r * pad)] = __float2bfloat16(0.f);
  }
}

// KD k-steps of 16: the head dim padded to DP = 16 * KD
template <int KD>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out, int rep,
           int Sq, int Sk, int D, int causal, int window, float scale_log2,
           int vec) {
  constexpr int DP = 16 * KD, NO = DP / 2, QE = BQ * DP, TE = BK * DP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // q's tile, then stage st: K at QE + 2 st TE, V at QE + (2 st + 1) TE
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);

  const int bh = blockIdx.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, wgi = tid >> 7, lane = tid & 31;
  const int wi = (tid >> 5) & 3, g = lane >> 2, tig = lane & 3;
  const size_t kvh = (size_t)(bh / rep);
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + kvh * Sk * D;
  const bf16* vb = v + kvh * Sk * D;

  zero_pad<BQ>(sm, D, DP);
#pragma unroll
  for (int t = 0; t < 4; ++t) zero_pad<BK>(sm + QE + t * TE, D, DP);

  int k_begin, k_end;
  key_range(q0, min(q0 + BQ, Sq) - 1, Sk, causal, window, k_begin, k_end);
  const int t_begin = k_begin / BK, t_end = (k_end + BK - 1) / BK;
  const bool vk = vec != 0;

  load_tile<BQ>(sm, qb, q0, Sq, D, vk);
  cp_async_commit();
  load_tile<BK>(sm + QE, kb, t_begin * BK, Sk, D, vk);
  load_tile<BK>(sm + QE + TE, vb, t_begin * BK, Sk, D, vk);
  cp_async_commit();

  // this warpgroup's 64 rows of q
  const uint32_t q_addr = smem_u32(sm) + wgi * 64 * 32;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // the thread's rows (accumulator layout: warp wi of the warpgroup holds
  // rows 16 wi + g and + 8; element 4 j + e is column 8 j + 2 tig + (e & 1)
  // of row g + 8 (e >> 1))
  const int row0 = q0 + wgi * 64 + wi * 16 + g;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      bf16* const next = sm + QE + 2 * (st ^ 1) * TE;
      load_tile<BK>(next, kb, (t + 1) * BK, Sk, D, vk);
      load_tile<BK>(next + TE, vb, (t + 1) * BK, Sk, D, vk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    proxy_fence();
    __syncthreads();
    const int k0 = t * BK;
    const uint32_t k_addr = smem_u32(sm + QE + 2 * st * TE);
    const uint32_t v_addr = k_addr + TE * (int)sizeof(bf16);

    // S = Q K^T: both K-major, 8-row groups 256 bytes apart
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      Ss<64>::run(s, desc(q_addr + kk * BQ * 32, 16, 256),
                  desc(k_addr + kk * BK * 32, 16, 256), kk > 0);
    wg_commit();
    wg_wait0();
    pin(s);

    // scale to log2 units; mask only the tiles that need it
    const bool need_mask = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                           (window > 0 && q0 + BQ - 1 - k0 >= window);
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        const int row = row0 + ((i >> 1) & 1) * 8;
        bool valid = true;
        if (causal) valid = valid && row >= key;
        if (window > 0) valid = valid && row - key < window;
        s[i] = key >= Sk ? -CUDART_INF_F
                         : (valid ? s[i] * scale_log2 : kNegInf);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
    }

    // online softmax of rows g (h 0) and g + 8 (h 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const bool bump = mx > m[h] + kLazy;
      const float mn = bump ? mx : m[h];
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j + 2 * h] = ex2(s[4 * j + 2 * h] - mn);
        s[4 * j + 2 * h + 1] = ex2(s[4 * j + 2 * h + 1] - mn);
        ps += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
      }
      if (bump) {
        const float c = ex2(m[h] - mn);
        l[h] *= c;
#pragma unroll
        for (int j = 0; j < NO / 4; ++j) {
          o[4 * j + 2 * h] *= c;
          o[4 * j + 2 * h + 1] *= c;
        }
      }
      m[h] = mn;
      l[h] += ps;
    }

    // O += (P_hi + P_lo) V: P's A fragments of k-step kk (keys 16 kk ..)
    // are the accumulators of n-blocks 2 kk and 2 kk + 1; V is MN-major,
    // 16-column atoms BK * 32 bytes apart, 8-key groups 256 bytes apart
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split2(s[8 * kk + 0], s[8 * kk + 1], ah[kk][0], al[kk][0]);
      split2(s[8 * kk + 2], s[8 * kk + 3], ah[kk][1], al[kk][1]);
      split2(s[8 * kk + 4], s[8 * kk + 5], ah[kk][2], al[kk][2]);
      split2(s[8 * kk + 6], s[8 * kk + 7], ah[kk][3], al[kk][3]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc(v_addr + kk * 16 * 32, BK * 32, 256);
      Rs<DP>::run(o, ah[kk], dv);
      Rs<DP>::run(o, al[kk], dv);
    }
    wg_commit();
    wg_wait0();
    pin(o);
    __syncthreads();   // stage st is free for tile t + 2
  }

  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float den = fmaxf(sum, 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    bf16* orow = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = 8 * j + 2 * tig;
      if (col >= D) continue;
      const float x = o[4 * j + 2 * h] / den, y = o[4 * j + 2 * h + 1] / den;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x, y);
      } else {
        orow[col] = __float2bfloat16(x);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16(y);
      }
    }
  }
}

template <int KD>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int rep, int Sq, int Sk, int D, int causal, int window,
           float scale, int vec, cudaStream_t stream) {
  constexpr size_t SMEM = (size_t)(BQ + 4 * BK) * 16 * KD * sizeof(bf16);
  auto* fn = kernel<KD>;
  if (SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_qtiles = (Sq + BQ - 1) / BQ;
  if (n_qtiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(BH, n_qtiles);
  fn<<<grid, kThreads, SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), rep, Sq, Sk, D,
      causal, window, scale * kLog2e, vec);
  return (int)cudaGetLastError();
}

// the instantiation of the padded head dim
int dispatch(const void* q, const void* k, const void* v, void* out, int BH,
             int rep, int Sq, int Sk, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  const int vec = D % 8 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const int kd = (D + 15) / 16;
#define FA_LAUNCH(KD)                                                    \
  launch<KD>(q, k, v, out, BH, rep, Sq, Sk, D, causal, window, scale, vec, \
             stream)
  if (kd <= 2) return FA_LAUNCH(2);
  if (kd <= 4) return FA_LAUNCH(4);
  if (kd == 5) return FA_LAUNCH(5);
  if (kd == 6) return FA_LAUNCH(6);
  return FA_LAUNCH(8);
#undef FA_LAUNCH
}

}  // namespace tc

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype: 0 fp32,
// 1 bf16.  Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int BH, int rep, int Sq, int Sk,
                               int D, int causal, int window, int dtype,
                               float scale, void* stream) {
  if (BH <= 0 || rep <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > kMaxD ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (BH > 65535) return (int)cudaErrorInvalidValue;
    return simt::launch(q, k, v, out, BH, rep, Sq, Sk, D, causal, window,
                        scale, s);
  }
  if (dtype == 1)
    return tc::dispatch(q, k, v, out, BH, rep, Sq, Sk, D, causal, window,
                        scale, s);
  return (int)cudaErrorInvalidValue;
}
