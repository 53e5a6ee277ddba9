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
// What bounds it.  Every (t, channel, state) element needs one expf, and
// that issues one MUFU.EX2 on the special-function units: 16 results a
// clock an SM on compute capability 9.0, 4.18 T/s on the card, so
// falcon-mamba-7b's 536.9 M elements at d_inner 8192, N 16 take at least
// 0.128 ms, above their bytes (0.12 ms in fp32, 0.06 in bf16: dt, x and y
// once).  Around the MUFU.EX2 an element issues some 14 more
// instructions (the product dt * a, expf's range reduction and scale,
// dt x * B, the FMA on h, the FMA of y, addressing), so the issue of the
// four schedulers an SM is the next floor.
//
// Design.  One thread a (channel, state) pair would pay, for every
// element, four shared loads, a four-level shuffle butterfly for y and a
// shared store: some 9 instructions of the shared-memory / shuffle (MIO)
// pipe, which would set its pace.  Here a channel has
// NT lanes (1, 2 or 4) and each lane holds NS = N / NT states (the next
// power of two; states past N are zeros) in registers.  A step reads dt_t
// and x_t once, B_t and C_t as 16-byte broadcast vectors of fp32, sums y
// over the lane's states in registers in state order and over the NT
// lanes by log2(NT) shuffles, and the channel's first lane stores y_t
// straight to device memory (neighbouring lanes, neighbouring channels).
// Only the FMA on h depends on h: the NS exps of a step and those of the
// next (the loop is unrolled by two) issue while it runs.
//
// Loads.  A block of kThreads (kThreads / NT channels of one batch row)
// stages kSteps steps at a time by 16-byte cp.async into a ring of
// kStages stages: dt and x [kSteps, channels] as stored, and the
// [kSteps * N] run of B (and C) from its 16-byte-aligned start.  While
// stage i runs, stage i + 1 is widened (B and C to fp32 rows of NT * NS,
// zeros past N, once for the whole block) and stage i + 2 loads: one
// barrier a stage.  Tensors that are not 16-byte aligned (di not a
// multiple of 16 bytes, or an offset view) are staged by plain loads
// instead, through the same ring.
//
// Parallelism.  With NT = 1 (N <= 16) a batch row of falcon-mamba-7b
// fills 64 blocks, too few for the 132 SMs.  Where the unsplit grid has
// fewer blocks than SMs the sequence is split into L chunks of `chunk`
// steps (selective_scan.scan_plan), in three launches:
//   1. each chunk but the last, from a zero state: its end state hl_k
//      and the product of its exps pd_k (scratch [L-1, B, di, N] each);
//   2. the carry: h = h0, then h = pd_k * h + hl_k in chunk order, each
//      chunk's true start state written over hl_k;
//   3. every chunk again from its true start state, writing y; the last
//      writes h_last.
// The split costs a second pass of the exps over L-1 chunks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // a block: kThreads / NT channels
constexpr int kSteps = 16;     // steps a ring stage
constexpr int kStages = 3;     // ring depth
constexpr int kMaxNS = 16;     // states a lane at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// cp.async of 16 bytes of which the first `bytes` are read (the rest
// zeros); src is not read when bytes is 0.
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// The shared memory of a block: kStages ring stages of dt, x [kSteps, ch]
// and the raw B (C) run, then two buffers of B (C) widened to fp32
// [kSteps, npad].
template <typename T>
struct Layout {
  int ch, npad, row_bytes, run_elts, stage_bytes;
  bool with_c;
  __host__ __device__ Layout(int nt, int ns, int N, bool c) {
    ch = kThreads / nt;
    npad = nt * ns;
    with_c = c;
    row_bytes = kSteps * ch * (int)sizeof(T);
    // a run of kSteps * N elements from its start rounded down to 16 bytes
    run_elts = round16((kSteps * N + 16 / (int)sizeof(T)) * sizeof(T)) /
               (int)sizeof(T);
    stage_bytes = 2 * row_bytes + (c ? 2 : 1) * run_elts * (int)sizeof(T);
  }
  __host__ __device__ int bytes() const {
    return kStages * stage_bytes + 2 * (with_c ? 2 : 1) * kSteps * npad * 4;
  }
};

// One launch of the scan over chunk blockIdx.z (of `chunk` steps) of the
// channels [blockIdx.x * ch, + ch) of batch row blockIdx.y.
//   kLocal: from a zero state, no y; writes the chunk's end state and the
//           product of its exps to hl / pd [k] (chunks 0 .. L-2);
//   else:   from h0 (chunk 0) or the carried hl[k - 1], writes y; the last
//           chunk writes h_last.
// ch, nt and npad are powers of two: indices split by shifts and masks.
template <typename T, int NS, bool kLocal>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                const T* __restrict__ bc, const T* __restrict__ cc,
                const float* __restrict__ a, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_last,
                float* __restrict__ hl, float* __restrict__ pd, int S,
                int di, int N, int nt, int chunk, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = 16 / (int)sizeof(T);    // elements a 16-byte piece
  const Layout<T> lay(nt, NS, N, !kLocal);
  const int ch = lay.ch, npad = lay.npad;
  const int lg_nt = __ffs(nt) - 1, lg_ch = __ffs(ch) - 1;
  const int lg_npad = __ffs(npad) - 1, lg_p = __ffs(ch / V) - 1;
  const int tid = threadIdx.x, c = tid >> lg_nt, j = tid & (nt - 1);
  const int b = blockIdx.y, k = blockIdx.z, B = gridDim.y;
  const int d0 = blockIdx.x * ch, d = d0 + c;
  const int t_begin = k * chunk, len = min(chunk, S - t_begin);
  const int nstage = (len + kSteps - 1) / kSteps;
  const size_t plane = (size_t)B * di * N;  // one chunk's states in hl, pd
  const size_t hrow = ((size_t)b * di + d) * N;
  const int nrun = kLocal ? 1 : 2;          // B, or B and C

  float h[NS], av[NS], pr[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int n = j * NS + s;
    const bool live = d < di && n < N;
    av[s] = live ? a[(size_t)d * N + n] : 0.f;
    pr[s] = 1.f;
    if (kLocal || !live)
      h[s] = 0.f;
    else
      h[s] = k == 0 ? h0[hrow + n] : hl[(k - 1) * plane + hrow + n];
  }

  auto slot = [&](int i) -> unsigned char* {
    return smem + (i % kStages) * lay.stage_bytes;
  };
  // B (C) widened to fp32 for stage i: two buffers, stage i in i % 2
  auto widened = [&](int i) -> float* {
    return reinterpret_cast<float*>(smem + kStages * lay.stage_bytes) +
           (i & 1) * nrun * kSteps * npad;
  };
  auto steps_of = [&](int i) { return min(kSteps, len - i * kSteps); };
  // the B / C run of stage i starts `off` elements into its ring slot
  auto run_off = [&](int i) -> int {
    return vec ? (int)(((size_t)b * S + t_begin + i * kSteps) * N % V) : 0;
  };
  auto stage = [&](int i) {
    unsigned char* base = slot(i);
    T* dts = reinterpret_cast<T*>(base);
    T* bs = reinterpret_cast<T*>(base + 2 * lay.row_bytes);
    const int tc = steps_of(i);
    const size_t row0 = (size_t)b * S + t_begin + i * kSteps;
    if (vec) {
      // 16-byte pieces: kSteps rows of ch / V for dt, then for x
      for (int e = tid; e < (2 * kSteps) << lg_p; e += kThreads) {
        const int r = e >> lg_p, w = r >= kSteps, t = r - w * kSteps;
        const int dd = d0 + ((e & ((1 << lg_p) - 1)) * V);
        if (t < tc && dd < di)
          cp16(dts + (r << lg_ch) + dd - d0,
               (w ? x : dt) + (row0 + t) * di + dd, 16);
      }
      const size_t e0 = row0 * N;
      const int off = (int)(e0 % V), n_el = off + tc * N;
      const int runp = (n_el + V - 1) / V;
      for (int e = tid; e < nrun * runp; e += kThreads) {
        const int w = e >= runp, q = e - w * runp;
        cp16(bs + w * lay.run_elts + q * V,
             (w ? cc : bc) + (e0 - off) + q * V,
             min(V, n_el - q * V) * (int)sizeof(T));
      }
    } else {
      for (int e = tid; e < (2 * kSteps) << lg_ch; e += kThreads) {
        const int r = e >> lg_ch, w = r >= kSteps, t = r - w * kSteps;
        const int dd = d0 + (e & (ch - 1));
        if (t < tc && dd < di) dts[e] = (w ? x : dt)[(row0 + t) * di + dd];
      }
      for (int e = tid; e < nrun * tc * N; e += kThreads) {
        const int w = e >= tc * N, r = e - w * tc * N;
        bs[w * lay.run_elts + r] = (w ? cc : bc)[row0 * N + r];
      }
    }
  };
  // stage i's B (C) rows [t][npad], zeros past N and past its steps
  auto widen = [&](int i) {
    const T* bs = reinterpret_cast<const T*>(slot(i) + 2 * lay.row_bytes);
    float* out = widened(i);
    const int tc = steps_of(i), off = run_off(i);
    for (int e = tid; e < (nrun * kSteps) << lg_npad; e += kThreads) {
      const int r = e >> lg_npad, w = r >= kSteps, t = r - w * kSteps;
      const int n = e & (npad - 1);
      out[e] = t < tc && n < N ? to_f32(bs[w * lay.run_elts + off + t * N + n])
                               : 0.f;
    }
  };

  // ring: stage i + 2 is loaded while stage i + 1 is widened and stage i
  // runs; one barrier a stage
  if (nstage > 0) stage(0);
  cp_commit();
  if (nstage > 1) stage(1);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  if (nstage > 0) widen(0);
  for (int i = 0; i < nstage; ++i) {
    cp_wait<0>();
    // stage i + 1 has landed and stage i is widened for every thread, and
    // every thread is past its reads of stage i - 1
    __syncthreads();
    if (i + 2 < nstage) stage(i + 2);
    cp_commit();
    if (i + 1 < nstage) widen(i + 1);

    const unsigned char* base = slot(i);
    const T* dts = reinterpret_cast<const T*>(base) + c;
    const T* xs = reinterpret_cast<const T*>(base + lay.row_bytes) + c;
    const float* bf = widened(i) + j * NS;
    const float* cf = bf + kSteps * npad;
    const int tc = steps_of(i);
    T* yp = y + ((size_t)b * S + t_begin + i * kSteps) * di + d;
#pragma unroll 2
    for (int t = 0; t < tc; ++t) {
      const float dtv = to_f32(dts[t << lg_ch]);
      const float dx = dtv * to_f32(xs[t << lg_ch]);
      float bv[NS], cv[NS];
      const float* brow = bf + (t << lg_npad);
      const float* crow = cf + (t << lg_npad);
      if constexpr (NS >= 4) {
#pragma unroll
        for (int s = 0; s < NS; s += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(brow + s);
          bv[s] = b4.x, bv[s + 1] = b4.y, bv[s + 2] = b4.z, bv[s + 3] = b4.w;
          if (!kLocal) {
            const float4 c4 = *reinterpret_cast<const float4*>(crow + s);
            cv[s] = c4.x, cv[s + 1] = c4.y, cv[s + 2] = c4.z,
            cv[s + 3] = c4.w;
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          bv[s] = brow[s];
          if (!kLocal) cv[s] = crow[s];
        }
      }
      float p = 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float e = expf(dtv * av[s]);
        h[s] = e * h[s] + dx * bv[s];
        if (kLocal)
          pr[s] *= e;
        else
          p += h[s] * cv[s];
      }
      if (!kLocal) {
        for (int o = nt / 2; o > 0; o >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        if (j == 0 && d < di) store(yp + (size_t)t * di, p);
      }
    }
  }

#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int n = j * NS + s;
    if (d >= di || n >= N) continue;
    if (kLocal) {
      hl[k * plane + hrow + n] = h[s];
      pd[k * plane + hrow + n] = pr[s];
    } else if (k == (int)gridDim.z - 1) {
      h_last[hrow + n] = h[s];
    }
  }
}

// The carry: each chunk's true start state from h0, in chunk order,
// written over that chunk's local end state (hl[k] becomes the start of
// chunk k + 1).
__global__ void __launch_bounds__(256)
    scan_carry_kernel(const float* __restrict__ h0, float* __restrict__ hl,
                      const float* __restrict__ pd, int L, size_t plane) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < plane;
       e += (size_t)gridDim.x * blockDim.x) {
    float h = h0[e];
    for (int k = 0; k < L - 1; ++k) {
      h = pd[k * plane + e] * h + hl[k * plane + e];
      hl[k * plane + e] = h;
    }
  }
}

template <typename T, int NS, bool kLocal>
cudaError_t launch_pass(const void* dt, const void* x, const void* bc,
                        const void* cc, const void* a, const void* h0,
                        void* y, void* h_last, float* hl, float* pd, int B,
                        int S, int di, int N, int nt, int nchunk, int chunk,
                        int vec, cudaStream_t stream) {
  const Layout<T> lay(nt, NS, N, !kLocal);
  const dim3 grid((di + lay.ch - 1) / lay.ch, B, nchunk);
  if (lay.bytes() > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<T, NS, kLocal>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes());
    if (err != cudaSuccess) return err;
  }
  scan_kernel<T, NS, kLocal><<<grid, kThreads, lay.bytes(), stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(bc), static_cast<const T*>(cc),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_last), hl, pd, S, di, N, nt,
      chunk, vec);
  return cudaGetLastError();
}

template <typename T, int NS>
int launch(const void* dt, const void* x, const void* bc, const void* cc,
           const void* a, const void* h0, void* y, void* h_last,
           void* scratch, int B, int S, int di, int N, int nt, int L,
           int chunk, cudaStream_t stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = aligned(dt) && aligned(x) && aligned(bc) && aligned(cc) &&
                  (size_t)di * sizeof(T) % 16 == 0;
  const size_t plane = (size_t)B * di * N;
  float* hl = static_cast<float*>(scratch);
  float* pd = L > 1 ? hl + (size_t)(L - 1) * plane : nullptr;
  cudaError_t err;
  if (L > 1) {
    err = launch_pass<T, NS, true>(dt, x, bc, cc, a, h0, y, h_last, hl, pd,
                                   B, S, di, N, nt, L - 1, chunk, vec,
                                   stream);
    if (err != cudaSuccess) return (int)err;
    const size_t want = (plane + 255) / 256;
    const int blocks = want < 4096 ? (int)want : 4096;
    scan_carry_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(h0), hl, pd, L, plane);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = launch_pass<T, NS, false>(dt, x, bc, cc, a, h0, y, h_last, hl, pd, B,
                                  S, di, N, nt, L, chunk, vec, stream);
  return (int)err;
}

template <typename T>
int launch_t(const void* dt, const void* x, const void* bc, const void* cc,
             const void* a, const void* h0, void* y, void* h_last,
             void* scratch, int B, int S, int di, int N, int nt, int ns,
             int L, int chunk, cudaStream_t s) {
#define SCAN_NS(NS)                                                        \
  case NS:                                                                 \
    return launch<T, NS>(dt, x, bc, cc, a, h0, y, h_last, scratch, B, S, \
                         di, N, nt, L, chunk, s);
  switch (ns) {
    SCAN_NS(1)
    SCAN_NS(2)
    SCAN_NS(4)
    SCAN_NS(8)
    SCAN_NS(16)
  }
#undef SCAN_NS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success).  dtype (of dt,
// x, bc, cc and y): 0 fp32, 1 bf16.  The plan (selective_scan.scan_plan):
// nt lanes a channel (1, 2 or 4; each holds ns = N / nt states rounded up
// to a power of two, at most 16), the sequence in L chunks of `chunk`
// steps ((L - 1) * chunk < S <= L * chunk; L = 1 when S = 0).  With L > 1,
// `scratch` holds 2 * (L - 1) * B * di * N fp32 (the chunks' end states,
// then their exp products) and three kernels run; else one.  Launches on
// `stream`, allocates nothing, does not synchronise.
extern "C" int selective_scan(const void* dt, const void* x, const void* bc,
                              const void* cc, const void* a, const void* h0,
                              void* y, void* h_last, void* scratch, int B,
                              int S, int di, int N, int nt, int L, int chunk,
                              int dtype, void* stream) {
  if (B <= 0 || di <= 0 || S < 0 || N < 1 || N > 32 || B > 65535 ||
      (nt != 1 && nt != 2 && nt != 4) || L < 1 || L > 65535 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  int ns = 1;
  while (ns * nt < N) ns *= 2;
  if (ns > kMaxNS) return (int)cudaErrorInvalidValue;
  if (S == 0 ? L != 1
             : ((long long)(L - 1) * chunk >= S || (long long)L * chunk < S))
    return (int)cudaErrorInvalidValue;
  if (L > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(dt, x, bc, cc, a, h0, y, h_last, scratch, B, S, di,
                           N, nt, ns, L, chunk, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(dt, x, bc, cc, a, h0, y, h_last, scratch,
                                   B, S, di, N, nt, ns, L, chunk, s);
  return (int)cudaErrorInvalidValue;
}
