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
// fp32 softmax (running max m, denominator l, weighted sum acc); a slot
// with seq_len 0 reads no page and returns exact zeros.
//
// What bounds it: the bytes of the K and V rows the slots' lengths cover
// (each read once); the arithmetic is 4*D operations a cached token and
// query head, far below the card's rate.  At the serving path's shapes
// (B 4, at most 128 tokens a slot) launch and latency set its time; a
// long cache (thousands of tokens a slot) is bandwidth.
//
// Design.  The TPU kernel walks a slot's pages in order on one core.
// Here the pages are split: one block per (split, kv head, slot) (and
// chunk of at most 8 query heads when rep > 8), each split a fixed range
// of `pps` pages, so that B * Hkv blocks become enough to fill the card.
// The host picks the split count from shapes alone (B * Hkv, maxp, the
// SM count) and never reads seq_lens.  A block whose range lies past its
// slot's length reads nothing and writes no partial; no block reads a
// page id at or past ceil(n / ps).
//
// Inside a block four warps take chunks of tokens in turn.  A token is
// read by a half-warp: each lane loads 16-byte vectors of its K and V
// rows (D 80 in bf16: ten lanes, one vector each), dots them with q
// (staged once in shared memory) and the half-warp sums the dot by xor
// shuffles.  A chunk's scores stay in registers; its max rescales the
// warp's (m, l, acc) once, then its probabilities weight the V rows.
// No __syncthreads runs inside the token loop.  The four warps' states
// merge in shared memory in warp order, then the splits' (m, l, acc)
// merge in split order: the last block of a (slot, kv head) to finish,
// counted by an int32 ticket that it resets to 0, reads the partials of
// the splits that hold tokens.  No float atomics, so a run repeats bit
// for bit.  Rows that are not 16-byte vectors (D not a multiple of the
// vector, or unaligned pools) take an element loop in the same kernel.
// acc covers 128 columns of D a pass; a larger D takes more passes, each
// recomputing the (bit-identical) scores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128, kWarps = 4, kHalf = 16;
// the combine keeps a weight a split and query head in the block's
// shared memory for the warps' accumulators (at least 4 * 128 floats)
constexpr int kMaxSplits = 256;
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;          // elements a 16-byte vector
  __device__ static void unpack(const uint4& u, float (&x)[4]) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
  __device__ static float zero() { return 0.f; }
  __device__ static void store(float* p, float v) { *p = v; }
};
template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float (&x)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static bf16 zero() { return __float2bfloat16(0.f); }
  __device__ static void store(bf16* p, float v) { *p = __float2bfloat16(v); }
};

// The vector of row[d .. d + N): one 16-byte load, or elements (zeros
// past D) when the rows are not 16-byte vectors.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ row, int d,
                                          int D, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + d));
  T e[Vec<T>::N];
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i)
    e[i] = d + i < D ? row[d + i] : Vec<T>::zero();
  uint4 u;
  memcpy(&u, e, sizeof(u));
  return u;
}

// R query heads a block, S steps of two tokens a chunk (a warp's two
// half-warps take one token each; fewer steps for 8 heads, whose chunks
// hold the most registers), NVL vectors of acc a lane.
template <typename T, int R>
struct Cfg {
  static constexpr int VEC = Vec<T>::N;
  static constexpr int NVL = 8 / VEC;               // 128 columns a pass
  static constexpr int DCH = kHalf * NVL * VEC;
  static constexpr int S = R >= 8 ? 2 : 4;
};

template <typename T, int R>
size_t smem_bytes(int D) {
  using C = Cfg<T, R>;
  const int QD = (D + C::VEC - 1) / C::VEC * C::VEC;
  return (size_t)R * QD * sizeof(T) +
         sizeof(float) * (size_t)kWarps * R * (2 + C::DCH);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ page_table,
                  const int* __restrict__ seq_lens, T* __restrict__ out,
                  float* __restrict__ part, int* __restrict__ tickets,
                  int Hkv, int rep, int D, int ps, int maxp, int pps,
                  int rchunks, float scale, int vec) {
  using C = Cfg<T, R>;
  constexpr int VEC = C::VEC, NVL = C::NVL, DCH = C::DCH, S = C::S;
  const int QD = (D + VEC - 1) / VEC * VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);                         // [R][QD]
  float* wm = reinterpret_cast<float*>(smem_raw + (size_t)R * QD * sizeof(T));
  float* wl = wm + kWarps * R;                                     // [4][R]
  float* wacc = wl + kWarps * R;                                   // [4][R][DCH]
  __shared__ int s_last;

  const int split = blockIdx.x, h = blockIdx.y;
  const int nsplit = gridDim.x;
  const int b = blockIdx.z / rchunks, r_first = (blockIdx.z % rchunks) * R;
  const int nr = min(R, rep - r_first);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane >> 4, hl = lane & 15;
  const bool vk = vec != 0;
  const int n = min(max(seq_lens[b], 0), maxp * ps);
  const int span = pps * ps;
  const int t_begin = split * span, t_end = min(n, t_begin + span);
  const size_t row0 = ((size_t)b * Hkv + h) * rep + r_first;  // q / out row
  const int* pt = page_table + (size_t)b * maxp;
  float* part_ml = part;                                  // [rows][nsplit][2]
  float* part_acc = part + (size_t)gridDim.z / rchunks * Hkv * rep * nsplit * 2;

  if (t_begin < t_end) {
    for (int e = tid; e < R * QD; e += kThreads) {
      const int r = e / QD, d = e - r * QD;
      qs[e] = r < nr && d < D ? q[(row0 + r) * D + d] : Vec<T>::zero();
    }
    __syncthreads();

    for (int dc = 0; dc < D; dc += DCH) {
      float m[R], l[R], acc[R][NVL][VEC];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] = kNegInf;
        l[r] = 0.f;
#pragma unroll
        for (int j = 0; j < NVL; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][j][e] = 0.f;
      }

      for (int c0 = t_begin + warp * 2 * S; c0 < t_end;
           c0 += kWarps * 2 * S) {
        // the chunk's rows (tokens past t_end read the last live row and
        // score -inf)
        size_t off[S];
        bool live[S];
#pragma unroll
        for (int st = 0; st < S; ++st) {
          const int tok = c0 + 2 * st + half;
          live[st] = tok < t_end;
          const int tc = live[st] ? tok : t_end - 1;
          const int pid = pt[tc / ps];
          off[st] = (((size_t)pid * ps + tc % ps) * Hkv + h) * D;
        }
        // scores over all of D
        float s[R][S];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int st = 0; st < S; ++st) s[r][st] = 0.f;
        // this pass's V vectors, loaded beside K's
        uint4 vx[S][NVL];
#pragma unroll
        for (int st = 0; st < S; ++st)
#pragma unroll
          for (int j = 0; j < NVL; ++j) {
            const int d = dc + (hl + kHalf * j) * VEC;
            vx[st][j] = d < D ? load_vec(v_pool + off[st], d, D, vk)
                              : make_uint4(0u, 0u, 0u, 0u);
          }
        for (int d = hl * VEC; d < D; d += kHalf * VEC) {
          uint4 kx[S];
#pragma unroll
          for (int st = 0; st < S; ++st)
            kx[st] = load_vec(k_pool + off[st], d, D, vk);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float qf[VEC];
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(qs + r * QD + d),
                           qf);
#pragma unroll
            for (int st = 0; st < S; ++st) {
              float kf[VEC];
              Vec<T>::unpack(kx[st], kf);
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                s[r][st] = fmaf(qf[e], kf[e], s[r][st]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int st = 0; st < S; ++st) {
            float x = s[r][st];
#pragma unroll
            for (int o = 8; o > 0; o >>= 1)
              x += __shfl_xor_sync(0xffffffffu, x, o);
            s[r][st] = live[st] ? x * scale : -CUDART_INF_F;
          }
        // one rescale a chunk, then p = exp(s - m)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float mx = -CUDART_INF_F;
#pragma unroll
          for (int st = 0; st < S; ++st) mx = fmaxf(mx, s[r][st]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float mn = fmaxf(m[r], mx);
          const float c = expf(m[r] - mn);
          m[r] = mn;
          l[r] *= c;
#pragma unroll
          for (int j = 0; j < NVL; ++j)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][j][e] *= c;
#pragma unroll
          for (int st = 0; st < S; ++st) {
            s[r][st] = expf(s[r][st] - mn);
            l[r] += s[r][st];
          }
        }
        // acc += p v over this lane's columns of the pass
#pragma unroll
        for (int st = 0; st < S; ++st) {
#pragma unroll
          for (int j = 0; j < NVL; ++j) {
            float vf[VEC];
            Vec<T>::unpack(vx[st][j], vf);
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[r][j][e] = fmaf(s[r][st], vf[e], acc[r][j][e]);
          }
        }
      }

      // the two half-warps' tokens, then the four warps in order
#pragma unroll
      for (int r = 0; r < R; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 16);
#pragma unroll
        for (int j = 0; j < NVL; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r][j][e] += __shfl_xor_sync(0xffffffffu, acc[r][j][e], 16);
      }
      if (half == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (hl == 0) {
            wm[warp * R + r] = m[r];
            wl[warp * R + r] = l[r];
          }
#pragma unroll
          for (int j = 0; j < NVL; ++j)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              wacc[(warp * R + r) * DCH + (hl + kHalf * j) * VEC + e] =
                  acc[r][j][e];
        }
      }
      __syncthreads();
      for (int e = tid; e < R * DCH; e += kThreads) {
        const int r = e / DCH, dd = e - r * DCH, d = dc + dd;
        if (r >= nr || d >= D) continue;
        float M = kNegInf;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * R + r]);
        float L = 0.f, A = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float f = expf(wm[w * R + r] - M);
          L += f * wl[w * R + r];
          A += f * wacc[(w * R + r) * DCH + dd];
        }
        const size_t row = row0 + r;
        if (nsplit == 1) {
          Vec<T>::store(&out[row * D + d], A / L);
        } else {
          part_acc[(row * nsplit + split) * D + d] = A;
          if (dd == 0) {
            part_ml[(row * nsplit + split) * 2] = M;
            part_ml[(row * nsplit + split) * 2 + 1] = L;
          }
        }
      }
      __syncthreads();
    }
  } else if (nsplit == 1) {
    for (int e = tid; e < nr * D; e += kThreads)
      Vec<T>::store(&out[row0 * D + e], 0.f);
  }
  if (nsplit == 1) return;

  // the last split of this (slot, kv head, head chunk) to finish combines
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = tickets + (size_t)blockIdx.z * Hkv + h;
    const int seen = atomicAdd(ticket, 1);
    s_last = seen == nsplit - 1;
    if (s_last) *ticket = 0;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // one warp a query head: the splits' weights exp(m_s - M) and L; then
  // every column sums its splits' acc in split order
  const int n_used = (n + span - 1) / span;       // splits holding tokens
  float* fw = wacc;                               // [R][n_used] weights
  for (int r = warp; r < nr; r += kWarps) {
    const size_t base = (row0 + r) * nsplit;
    float M = kNegInf;
    for (int sp = lane; sp < n_used; sp += 32)
      M = fmaxf(M, __ldcg(&part_ml[(base + sp) * 2]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    for (int sp = lane; sp < n_used; sp += 32) {
      const float f = expf(__ldcg(&part_ml[(base + sp) * 2]) - M);
      fw[r * n_used + sp] = f;
      L += f * __ldcg(&part_ml[(base + sp) * 2 + 1]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    if (lane == 0) wl[r] = L;
  }
  __syncthreads();
  for (int e = tid; e < nr * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const float* accs = part_acc + (row0 + r) * nsplit * D + d;
    float A = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_used; ++sp)
      A = fmaf(fw[r * n_used + sp], __ldcg(accs + (size_t)sp * D), A);
    Vec<T>::store(&out[(row0 + r) * D + d], n_used > 0 ? A / wl[r] : 0.f);
  }
}

template <typename T, int R>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* seq_lens, void* out,
           void* part, void* tickets, int B, int Hkv, int rep, int D, int ps,
           int maxp, int nsplit, int pps, float scale, int vec,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, R>(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int rchunks = (rep + R - 1) / R;
  if ((long long)B * rchunks > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nsplit, Hkv, B * rchunks);
  decode_kernel<T, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(seq_lens), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), Hkv, rep, D, ps,
      maxp, pps, rchunks, scale, vec);
  return (int)cudaGetLastError();
}

// R = the smallest power of two >= rep, at most 8; halved while the
// block's shared memory would pass 96 KiB (a head dim in the thousands)
template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* page_table, const void* seq_lens, void* out,
             void* part, void* tickets, int B, int Hkv, int rep, int D,
             int ps, int maxp, int nsplit, int pps, float scale,
             cudaStream_t stream) {
  const int vec = D % Vec<T>::N == 0 &&
                  ((uintptr_t)q | (uintptr_t)k_pool | (uintptr_t)v_pool) %
                          16 == 0;
  int R = 1;
  while (R < rep && R < 8) R *= 2;
  const size_t cap = 96 * 1024;
  if (R == 8 && smem_bytes<T, 8>(D) > cap) R = 4;
  if (R == 4 && smem_bytes<T, 4>(D) > cap) R = 2;
  if (R == 2 && smem_bytes<T, 2>(D) > cap) R = 1;
#define FD_LAUNCH(RR)                                                        \
  launch<T, RR>(q, k_pool, v_pool, page_table, seq_lens, out, part, tickets, \
                B, Hkv, rep, D, ps, maxp, nsplit, pps, scale, vec, stream)
  switch (R) {
    case 8: return FD_LAUNCH(8);
    case 4: return FD_LAUNCH(4);
    case 2: return FD_LAUNCH(2);
    default: return FD_LAUNCH(1);
  }
#undef FD_LAUNCH
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype: 0 fp32,
// 1 bf16.  Launches on `stream`, allocates nothing, does not synchronise.
// Page ids in page_table must lie in [0, P).  nsplit splits of pps pages
// (nsplit = ceil(maxp / pps) <= 256); when nsplit > 1, `part` holds
// B * Hkv * rep * nsplit * (D + 2) floats of scratch and `tickets`
// B * Hkv * rep int32 zeros, which every call leaves zero again.
extern "C" int flash_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* page_table,
                            const void* seq_lens, void* out, void* part,
                            void* tickets, int B, int Hkv, int rep, int D,
                            int ps, int maxp, int nsplit, int pps,
                            float scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || rep <= 0 || D <= 0 || ps <= 0 || maxp <= 0 ||
      pps <= 0 || nsplit != (maxp + pps - 1) / pps || nsplit > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k_pool, v_pool, page_table, seq_lens, out, part,
                           tickets, B, Hkv, rep, D, ps, maxp, nsplit, pps,
                           scale, s);
  if (dtype == 1)
    return dispatch<bf16>(q, k_pool, v_pool, page_table, seq_lens, out, part,
                          tickets, B, Hkv, rep, D, ps, maxp, nsplit, pps,
                          scale, s);
  return (int)cudaErrorInvalidValue;
}
