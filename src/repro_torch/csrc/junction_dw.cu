// Block-sparse junction weight gradient (UP) and the fused BP+UP update
// for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels `dw` (dw_kernel) and `update_dw`
// (fused_update_dw) of src/repro/kernels/block_sparse_matmul.py:
//
//   dw[e, o, k, a, c] = sum_m x[e, m, idx[o,k]*bs + a] * dz[e, m, o*bs + c]
//   db[e, o*bs + c]   = sum_m dzf[e, m, o*bs + c]
//
// dz = (dy * act'(res)) rounded to dy's dtype for the products, dzf the
// fp32 value before that rounding for the bias; sums in fp32.
// `junction_dw` writes dw [E, nob, kb, bs, bs] and db [E, nob*bs] (fp32).
// `junction_update_dw` instead applies one optimizer step to each
// element as it leaves the sum — SGD, SGD+momentum or Adam, chosen by
// which fp32 slots are given, with unit e's row of the [E, 7] hyp table
// (lr, b1, b2, eps, wd, t, gs) — writing w (in x's dtype), b and the
// slots in place, so the gradient never reaches device memory.  It also
// counts, per unit, the (e, o) tiles whose update went non-finite.
//
// What bounds them: at the training shapes (M = 2048, 128-wide blocks)
// some 18 GFLOP per junction against 85 MB (dw) or 156 MB (Adam update:
// w, m and v read and written) of operands, so dw sits near the
// crossover of the card's bf16 roofline and the Adam update is bound by
// its bytes.
//
// Design.  One (e, o) output tile is kb x bs x bs fp32 (327 KB for
// 2560->6912 and 917 KB for 6912->2560): far beyond one block's shared
// memory.  So the grid splits it by (slot k, 64-row chunk of a, 64-column
// chunk of c) and each block of 256 threads walks all M rows in steps of
// 32, staging 32 rows of x (the slot's gathered input block) and of dz
// (activation gradient recomputed on the way in) in shared memory; each
// thread sums a 4 x 4 patch in registers.  The M reduction runs in one
// fixed order in one block — no atomics on floats — and `dw_tile` is the
// one routine both entry points use, so the fused update sees bit for
// bit the gradient the two-pass path materialises.  The blocks of slot 0
// and row chunk 0 also sum db for their columns.  Health: a block that
// writes any non-finite m' / v' (Adam) or momentum-updated gradient
// (SGD) sets the (e, o) flag with an integer atomicOr; a second small
// kernel sums the flags of each unit, so the count is of tiles, not of
// blocks.  Built without --use_fast_math: an all-zero hyp row must give
// w' = w bit for bit through pow(0, 0) = 1, the c == 0 -> 1 guards and
// den == 0 -> 0.  wgmma and TMA are later work.
#include "junction_common.cuh"

namespace {

using namespace junction;

constexpr int kBK = 32;        // rows of M staged per step
constexpr int kThreads = 256;  // 16 x 16: a = ty + 16r, c = tx + 16j
constexpr int kHypK = 7;
enum HypCol { kLr = 0, kB1, kB2, kEps, kWd, kT, kGs };

template <int BS>
struct Tile {
  static constexpr int N = BS < 64 ? BS : 64;  // a (and c) per block
  static constexpr int PT = N / 16;            // per thread, each way
  static constexpr int kChunks = BS / N;
  static constexpr int kPerSlot = kChunks * kChunks;
};

// The fp32 sum over all M rows for this block's N x N patch of
// dw[e, o, k]: thread (ty, tx) returns acc[r][j] for a = a0 + ty + 16r,
// c = c0 + tx + 16j.  With `db` not null, threads tid < N also return
// the column sums of dzf for c = c0 + tid.
template <typename T, int BS>
__device__ __forceinline__ void dw_tile(
    const T* __restrict__ xe, const T* __restrict__ dye,
    const T* __restrict__ rese, int M, int nib, int nob, int o, int ib,
    int a0, int c0, int act, bool want_db,
    float (&acc)[Tile<BS>::PT][Tile<BS>::PT], float* db_sum) {
  constexpr int N = Tile<BS>::N;
  constexpr int TT = Tile<BS>::PT;
  __shared__ float Xs[kBK][N];
  __shared__ float Zs[kBK][N];
  __shared__ float Zf[kBK][N];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int col = tid % N;
  const size_t n_in = (size_t)nib * BS;
  const size_t n_out = (size_t)nob * BS;
#pragma unroll
  for (int r = 0; r < TT; ++r)
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[r][j] = 0.f;
  float dbs = 0.f;

  for (int m0 = 0; m0 < M; m0 += kBK) {
#pragma unroll
    for (int q = 0; q < kBK * N / kThreads; ++q) {
      const int mm = tid / N + q * (kThreads / N);
      const int m = m0 + mm;
      float xv = 0.f, z = 0.f, zf = 0.f;
      if (m < M) {
        xv = to_f32(xe[(size_t)m * n_in + (size_t)ib * BS + a0 + col]);
        z = dz_of(dye, rese, (size_t)m * n_out + (size_t)o * BS + c0 + col,
                  act, &zf);
      }
      Xs[mm][col] = xv;
      Zs[mm][col] = z;
      if (want_db) Zf[mm][col] = zf;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float av[TT], bv[TT];
#pragma unroll
      for (int r = 0; r < TT; ++r) av[r] = Xs[k][ty + 16 * r];
#pragma unroll
      for (int j = 0; j < TT; ++j) bv[j] = Zs[k][tx + 16 * j];
#pragma unroll
      for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int j = 0; j < TT; ++j) acc[r][j] += av[r] * bv[j];
    }
    if (want_db && tid < N) {
      for (int k = 0; k < kBK; ++k) dbs += Zf[k][tid];
    }
    __syncthreads();
  }
  if (want_db && tid < N) *db_sum = dbs;
}

// Which part of the (e, o) tile this block owns.
template <int BS>
struct Place {
  int k, a0, c0;
  bool db;  // this block also sums (and updates) the bias columns
  __device__ Place(int bx) {
    constexpr int N = Tile<BS>::N;
    constexpr int C = Tile<BS>::kChunks;
    k = bx / Tile<BS>::kPerSlot;
    const int rem = bx % Tile<BS>::kPerSlot;
    a0 = (rem / C) * N;
    c0 = (rem % C) * N;
    db = k == 0 && a0 == 0;
  }
};

template <typename T, int BS>
__global__ void __launch_bounds__(kThreads)
    junction_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const T* __restrict__ res, const int* __restrict__ idx,
                       float* __restrict__ dw, float* __restrict__ db, int M,
                       int nib, int nob, int kb, int act) {
  constexpr int TT = Tile<BS>::PT;
  const Place<BS> p(blockIdx.x);
  const int o = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t n_out = (size_t)nob * BS;
  const bool want_db = db != nullptr && p.db;
  float acc[TT][TT];
  float dbs = 0.f;
  dw_tile<T, BS>(x + (size_t)e * M * nib * BS, dy + (size_t)e * M * n_out,
                 res == nullptr ? nullptr : res + (size_t)e * M * n_out, M,
                 nib, nob, o, idx[(size_t)o * kb + p.k], p.a0, p.c0, act,
                 want_db, acc, &dbs);
  float* t = dw + (((size_t)e * nob + o) * kb + p.k) * BS * BS;
#pragma unroll
  for (int r = 0; r < TT; ++r)
#pragma unroll
    for (int j = 0; j < TT; ++j)
      t[(size_t)(p.a0 + ty + 16 * r) * BS + p.c0 + tx + 16 * j] = acc[r][j];
  if (want_db && tid < Tile<BS>::N)
    db[(size_t)e * n_out + (size_t)o * BS + p.c0 + tid] = dbs;
}

struct Hyp {
  float lr, b1, b2, eps, wd, t, gs;
};

// One optimizer step of one element from its fp32 gradient `acc`
// (block_sparse_matmul._epilogue_step): SGD when mom is null,
// SGD+momentum when only vel is null, else Adam.  Updates the slots in
// place, returns the new weight in fp32 and clears `ok` on a non-finite
// m' / v' (Adam) or momentum-updated gradient (SGD).
__device__ __forceinline__ float opt_step(const Hyp& h, float acc, float w32,
                                          float* mom, float* vel, bool& ok) {
  const float g = h.gs * acc;
  if (vel == nullptr) {
    float mv = g;
    if (mom != nullptr) {
      mv = h.b1 * *mom + g;
      *mom = mv;
    }
    ok = ok && isfinite(mv);
    return w32 - h.lr * mv;
  }
  const float m1 = h.b1 * *mom + (1.f - h.b1) * g;
  const float v2 = h.b2 * *vel + (1.f - h.b2) * (g * g);
  float c1 = 1.f - powf(h.b1, h.t);
  float c2 = 1.f - powf(h.b2, h.t);
  if (c1 == 0.f) c1 = 1.f;
  if (c2 == 0.f) c2 = 1.f;
  const float den = sqrtf(v2 / c2) + h.eps;
  float upd = den == 0.f ? 0.f : (m1 / c1) / den;
  upd = upd + h.wd * w32;
  *mom = m1;
  *vel = v2;
  ok = ok && isfinite(m1) && isfinite(v2);
  return w32 - h.lr * upd;
}

template <typename T, int BS>
__global__ void __launch_bounds__(kThreads)
    junction_update_dw_kernel(
        const T* __restrict__ x, const T* __restrict__ dy,
        const T* __restrict__ res, const int* __restrict__ idx,
        const float* __restrict__ hyp, T* __restrict__ w, T* __restrict__ b,
        float* __restrict__ mom, float* __restrict__ mom_b,
        float* __restrict__ vel, float* __restrict__ vel_b,
        int* __restrict__ bad, int M, int nib, int nob, int kb, int act) {
  constexpr int TT = Tile<BS>::PT;
  const Place<BS> p(blockIdx.x);
  const int o = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t n_out = (size_t)nob * BS;
  const bool want_db = b != nullptr && p.db;
  float acc[TT][TT];
  float dbs = 0.f;
  dw_tile<T, BS>(x + (size_t)e * M * nib * BS, dy + (size_t)e * M * n_out,
                 res == nullptr ? nullptr : res + (size_t)e * M * n_out, M,
                 nib, nob, o, idx[(size_t)o * kb + p.k], p.a0, p.c0, act,
                 want_db, acc, &dbs);

  const float* hr = hyp + (size_t)e * kHypK;
  const Hyp h{hr[kLr], hr[kB1], hr[kB2], hr[kEps], hr[kWd], hr[kT], hr[kGs]};
  bool ok = true;
  const size_t base = (((size_t)e * nob + o) * kb + p.k) * BS * BS;
#pragma unroll
  for (int r = 0; r < TT; ++r)
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const size_t off =
          base + (size_t)(p.a0 + ty + 16 * r) * BS + p.c0 + tx + 16 * j;
      const float nw =
          opt_step(h, acc[r][j], to_f32(w[off]),
                   mom == nullptr ? nullptr : mom + off,
                   vel == nullptr ? nullptr : vel + off, ok);
      store(&w[off], nw);
    }
  if (want_db && tid < Tile<BS>::N) {
    const size_t off = (size_t)e * n_out + (size_t)o * BS + p.c0 + tid;
    const float nb =
        opt_step(h, dbs, to_f32(b[off]),
                 mom_b == nullptr ? nullptr : mom_b + off,
                 vel_b == nullptr ? nullptr : vel_b + off, ok);
    store(&b[off], nb);
  }
  if (__syncthreads_or(!ok) && tid == 0)
    atomicOr(&bad[(size_t)e * nob + o], 1);
}

// health[e] = number of flagged (e, o) tiles.
__global__ void health_kernel(const int* __restrict__ bad,
                              int* __restrict__ health, int nob) {
  const int e = blockIdx.x;
  int n = 0;
  for (int o = threadIdx.x; o < nob; o += 32) n += bad[(size_t)e * nob + o];
  for (int s = 16; s > 0; s >>= 1) n += __shfl_down_sync(0xffffffffu, n, s);
  if (threadIdx.x == 0) health[e] = n;
}

template <typename T, int BS>
int launch_dw(const void* x, const void* dy, const void* res,
              const void* idx, float* dw, float* db, int E, int M, int nib,
              int nob, int kb, int act, cudaStream_t stream) {
  const dim3 grid(kb * Tile<BS>::kPerSlot, nob, E);
  junction_dw_kernel<T, BS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(res), static_cast<const int*>(idx), dw, db, M,
      nib, nob, kb, act);
  return (int)cudaGetLastError();
}

template <typename T, int BS>
int launch_update(const void* x, const void* dy, const void* res,
                  const void* idx, const float* hyp, void* w, void* b,
                  float* mom, float* mom_b, float* vel, float* vel_b,
                  int* bad, int* health, int E, int M, int nib, int nob,
                  int kb, int act, cudaStream_t stream) {
  const dim3 grid(kb * Tile<BS>::kPerSlot, nob, E);
  junction_update_dw_kernel<T, BS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(res), static_cast<const int*>(idx), hyp,
      static_cast<T*>(w), static_cast<T*>(b), mom, mom_b, vel, vel_b, bad, M,
      nib, nob, kb, act);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  health_kernel<<<E, 32, 0, stream>>>(bad, health, nob);
  return (int)cudaGetLastError();
}

bool valid(int bs, int act, const void* res) {
  return (bs == 32 || bs == 64 || bs == 128) &&
         (act == kNone || res != nullptr);
}

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

// Both return the cudaError_t of their launches (0 on success).  dtype:
// 0 fp32, 1 bf16; `res` is null for act "none".  They launch on
// `stream`, allocate nothing and do not synchronise.

// dw and (when db is not null) db, in fp32.
extern "C" int junction_dw(const void* x, const void* dy, const void* res,
                           const void* idx, void* dw, void* db, int E, int M,
                           int nib, int nob, int kb, int bs, int act,
                           int dtype, void* stream) {
  if (!valid(bs, act, res)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  if (dtype == 0) {
    JUNCTION_BS_SWITCH((launch_dw<float, BS>(
        x, dy, res, idx, dwf, dbf, E, M, nib, nob, kb, act, s)))
  }
  if (dtype == 1) {
    JUNCTION_BS_SWITCH((launch_dw<__nv_bfloat16, BS>(
        x, dy, res, idx, dwf, dbf, E, M, nib, nob, kb, act, s)))
  }
  return (int)cudaErrorInvalidValue;
}

// The fused update: w (x's dtype), b (null: no bias), the fp32 slots
// (null where absent; vel needs mom), `bad` [E, nob] int32 zeros and
// `health` [E] int32 (written).
extern "C" int junction_update_dw(const void* x, const void* dy,
                                  const void* res, const void* idx,
                                  const void* hyp, void* w, void* b,
                                  void* mom, void* mom_b, void* vel,
                                  void* vel_b, void* bad, void* health, int E,
                                  int M, int nib, int nob, int kb, int bs,
                                  int act, int dtype, void* stream) {
  if (!valid(bs, act, res) || (vel != nullptr && mom == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hyp);
  float* m = static_cast<float*>(mom);
  float* mb = static_cast<float*>(mom_b);
  float* v = static_cast<float*>(vel);
  float* vb = static_cast<float*>(vel_b);
  int* bd = static_cast<int*>(bad);
  int* hl = static_cast<int*>(health);
  if (dtype == 0) {
    JUNCTION_BS_SWITCH((launch_update<float, BS>(
        x, dy, res, idx, h, w, b, m, mb, v, vb, bd, hl, E, M, nib, nob, kb,
        act, s)))
  }
  if (dtype == 1) {
    JUNCTION_BS_SWITCH((launch_update<__nv_bfloat16, BS>(
        x, dy, res, idx, h, w, b, m, mb, v, vb, bd, hl, E, M, nib, nob, kb,
        act, s)))
  }
  return (int)cudaErrorInvalidValue;
}
