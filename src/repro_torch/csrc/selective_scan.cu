// Fused Mamba-1 selective scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `selective_scan` (_kernel) of
// src/repro/kernels/selective_scan.py:
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t
//   y_t = h_t . C_t
//
// dt, x [B, S, di] and bc, cc [B, S, N] in one type T (fp32 or bf16),
// a [di, N] and h0 [B, di, N] fp32  ->  y [B, S, di] in T, h_last
// [B, di, N] fp32.  Everything is computed in fp32 with IEEE expf (no
// --use_fast_math); any S and di, N up to 32.
//
// What bounds it: the bytes it must move, each operand once (dt, x and
// y are 3 * B * S * di elements, the rest is small): 0.40 GB at
// falcon-mamba-7b's d_inner 8192, B 1, S 4096 in fp32, 0.12 ms at the
// card's 3.35 TB/s.  Its operations (an expf and five fp32 operations a
// (t, channel, state)) come close behind, and the recurrence is
// sequential in t, so the latency of one step times S is a floor of its
// own.
//
// Design.  The TPU kernel walks the sequence in chunks on one core with
// the state tile [bd, N] in VMEM.  Here a block owns 32 channels of one
// batch row and walks the whole sequence; a thread owns one (channel,
// state n) pair and keeps h in a register, so the state never leaves
// the SM.  The N states of a channel are NP = next power of two >= N
// consecutive lanes of a warp (lanes n >= N hold zeros), and y_t is
// their sum by a butterfly of shuffles.  Per chunk of 64 steps the block
// stages dt and x [64, 32] (128 contiguous bytes a row in fp32) and B, C
// [64, N] in shared memory as fp32, runs the 64 steps, and writes the
// chunk's y [64, 32] back with coalesced stores.  Parallelism is
// B * di * N threads: 131 k at B 1 and di 8192 (256 blocks, all resident
// at once).  If that proves too few to hide each step's latency, the next
// design splits the sequence into chunks scanned in parallel from a zero
// state, and a second pass carries each chunk's end state (the product
// of its decays) into the next.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;     // channels a block
constexpr int kChunk = 64;  // steps staged at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(1024)
    selective_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                          const T* __restrict__ bc, const T* __restrict__ cc,
                          const float* __restrict__ a,
                          const float* __restrict__ h0, T* __restrict__ y,
                          float* __restrict__ h_last, int S, int di, int N,
                          int NP) {
  __shared__ float dts[kChunk * kCh];
  __shared__ float xs[kChunk * kCh];
  __shared__ float ys[kChunk * kCh];
  __shared__ float bs[kChunk * 32];
  __shared__ float cs[kChunk * 32];

  const int b = blockIdx.y, d0 = blockIdx.x * kCh;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int c = tid / NP, n = tid % NP, d = d0 + c;
  const bool live = n < N && d < di;
  const size_t hoff = ((size_t)b * di + d) * N + n;
  float h = live ? h0[hoff] : 0.f;
  const float av = live ? a[(size_t)d * N + n] : 0.f;
  const size_t row0 = (size_t)b * S;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int tc = min(kChunk, S - t0);
    for (int e = tid; e < tc * kCh; e += nthreads) {
      const int t = e / kCh, dd = d0 + e % kCh;
      const size_t off = (row0 + t0 + t) * di + dd;
      dts[e] = dd < di ? to_f32(dt[off]) : 0.f;
      xs[e] = dd < di ? to_f32(x[off]) : 0.f;
    }
    for (int e = tid; e < tc * N; e += nthreads) {
      const size_t off = (row0 + t0) * N + e;
      bs[e] = to_f32(bc[off]);
      cs[e] = to_f32(cc[off]);
    }
    __syncthreads();
    for (int t = 0; t < tc; ++t) {
      float p = 0.f;
      if (live) {
        const float dtv = dts[t * kCh + c];
        const float decay = expf(dtv * av);
        h = decay * h + (dtv * xs[t * kCh + c]) * bs[t * N + n];
        p = h * cs[t * N + n];
      }
      for (int off = NP / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) ys[t * kCh + c] = p;
    }
    __syncthreads();
    for (int e = tid; e < tc * kCh; e += nthreads) {
      const int t = e / kCh, dd = d0 + e % kCh;
      if (dd < di) store(&y[(row0 + t0 + t) * di + dd], ys[e]);
    }
    // the next chunk's staging writes dts, xs, bs and cs only (every
    // thread is past its reads of them), and ys only after its barrier
  }
  if (live) h_last[hoff] = h;
}

template <typename T>
int launch(const void* dt, const void* x, const void* bc, const void* cc,
           const void* a, const void* h0, void* y, void* h_last, int B, int S,
           int di, int N, cudaStream_t stream) {
  int NP = 1;
  while (NP < N) NP *= 2;
  const dim3 grid((di + kCh - 1) / kCh, B);
  selective_scan_kernel<T><<<grid, kCh * NP, 0, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(bc), static_cast<const T*>(cc),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_last), S, di, N, NP);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype (of dt, x,
// bc, cc and y): 0 fp32, 1 bf16.  Launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int selective_scan(const void* dt, const void* x, const void* bc,
                              const void* cc, const void* a, const void* h0,
                              void* y, void* h_last, int B, int S, int di,
                              int N, int dtype, void* stream) {
  if (B <= 0 || di <= 0 || S < 0 || N < 1 || N > 32 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(dt, x, bc, cc, a, h0, y, h_last, B, S, di, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dt, x, bc, cc, a, h0, y, h_last, B, S, di,
                                 N, s);
  return (int)cudaErrorInvalidValue;
}
