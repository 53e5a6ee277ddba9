// Block-sparse junction weight gradient (UP) and the fused BP+UP update
// for Hopper (sm_90a), plain C interface: the plain junction and the
// gated (SwiGLU) junction.
//
// Replaces the Pallas TPU kernels `dw` (dw_kernel), `update_dw`
// (fused_update_dw), `gated_dw` (gated_dw_kernel) and `update_gated_dw`
// (fused_update_gated_dw) of src/repro/kernels/block_sparse_matmul.py:
//
//   dw[e, o, k, a, c] = sum_m x[e, m, idx[o,k]*bs + a] * dz[e, m, o*bs + c]
//   db[e, o*bs + c]   = sum_m dzf[e, m, o*bs + c]
//
// dz = (dy * act'(res)) rounded to dy's dtype for the products, dzf the
// fp32 value before that rounding for the bias; sums in fp32.  The gated
// form has two such sums over the same x, dwg from dz_g = dh * u *
// silu'(g) and dwi from dz_u = dh * silu(g) (recomputed from the saved g
// and u, rounded to dh's dtype), and no bias.
// `junction_dw` writes dw [E, nob, kb, bs, bs] and db [E, nob*bs] (fp32);
// `junction_gated_dw` writes dwg and dwi.  `junction_update_dw` and
// `junction_update_gated_dw` instead apply one optimizer step to each
// element as it leaves the sum — SGD, SGD+momentum or Adam, chosen by
// which fp32 slots are given, with unit e's row of the [E, 7] hyp table
// (lr, b1, b2, eps, wd, t, gs) — writing the weights (in x's dtype), b
// and the slots in place, so the gradient never reaches device memory.
// They also count, per unit, the (e, o) tiles whose update went
// non-finite; a gated tile counts once whichever branch went.
//
// What bounds them: at the dense training shapes (M = 2048, 128-wide
// blocks) some 18 GFLOP per junction against 85 MB (dw) or 156 MB (Adam
// update: w, m and v read and written) of operands, so dw sits near the
// crossover of the card's bf16 roofline and the Adam update is bound by
// its bytes.  The gated expert junction of qwen3-moe (128 experts,
// M = 160 rows each) moves 0.40 GB of fp32 gradients (gated_dw) or some
// 2.2 GB of weights and slots (the Adam update) against 32 GFLOP: bound
// by bytes.
//
// Design.  One (e, o) output tile is kb x bs x bs fp32 (327 KB for
// 2560->6912 and 917 KB for 6912->2560): far beyond one block's shared
// memory.  So the grid splits it by (slot k, 64-row chunk of a, 64-column
// chunk of c) and each block of 256 threads walks all M rows in steps of
// 32, staging 32 rows of x (the slot's gathered input block) and of dz
// (activation gradient recomputed on the way in; both branch gradients
// for the gated form) in shared memory; each thread sums a 4 x 4 patch
// per branch in registers.  The M reduction runs in one fixed order in
// one block — no atomics on floats — and `dw_tile` is the one routine
// all four entry points use, so in fp32 (and for the gated junction) a
// fused update sees bit for bit the gradient its two-pass path
// materialises.  In bf16 the plain junction's fused update runs on tensor
// cores instead (junction_tc.cu, `junction_update_dw_tc`, routed by
// block_sparse_matmul.junction_variant), which sums over M in another
// order than `junction_dw`: its gradient agrees with the two-pass one to
// fp32 round-off, not bit for bit.  The blocks of slot 0 and row chunk 0
// also sum db for their columns.  Health: a block that writes any
// non-finite m' / v' (Adam) or momentum-updated gradient (SGD) in either
// branch sets the (e, o) flag with an integer atomicOr; a second small
// kernel sums the flags of each unit, so the count is of tiles, not of
// blocks.  The optimizer step, the hyp row and that kernel are
// junction_update.cuh's, shared with the tensor-core update.  Built
// without --use_fast_math: an all-zero hyp row must give w' = w bit for
// bit through pow(0, 0) = 1, the c == 0 -> 1 guards and den == 0 -> 0.
#include "junction_update.cuh"

namespace {

using namespace junction;

constexpr int kBK = 32;        // rows of M staged per step
constexpr int kThreads = 256;  // 16 x 16: a = ty + 16r, c = tx + 16j

template <int BS>
struct Tile {
  static constexpr int N = BS < 64 ? BS : 64;  // a (and c) per block
  static constexpr int PT = N / 16;            // per thread, each way
  static constexpr int kChunks = BS / N;
  static constexpr int kPerSlot = kChunks * kChunks;
};

// dz of a plain junction at flat offset `off`: z[0] for the products,
// *zf the fp32 value before rounding (for db).  `at` moves the pointers
// to one unit's rows.
template <typename T>
struct PlainDz {
  static constexpr int NB = 1;
  const T* dy;
  const T* res;
  int act;
  __device__ __forceinline__ PlainDz at(size_t ofs) const {
    return {dy + ofs, res == nullptr ? nullptr : res + ofs, act};
  }
  __device__ __forceinline__ void operator()(size_t off, float* z,
                                             float* zf) const {
    z[0] = dz_of(dy, res, off, act, zf);
  }
};

// The gated junction's two branch gradients (dz_g, dz_u) at `off`.
template <typename T>
struct GatedDz {
  static constexpr int NB = 2;
  const T* dh;
  const T* g;
  const T* u;
  __device__ __forceinline__ GatedDz at(size_t ofs) const {
    return {dh + ofs, g + ofs, u + ofs};
  }
  __device__ __forceinline__ void operator()(size_t off, float* z,
                                             float* zf) const {
    gated_dz(dh, g, u, off, &z[0], &z[1]);
    *zf = 0.f;
  }
};

// The fp32 sums over all M rows for this block's N x N patch of
// dw[e, o, k], one per branch of `dz`: thread (ty, tx) returns
// acc[b][r][j] for a = a0 + ty + 16r, c = c0 + tx + 16j.  With `want_db`
// (plain junction only), threads tid < N also return the column sums of
// dzf for c = c0 + tid.
template <typename T, int BS, typename Dz>
__device__ __forceinline__ void dw_tile(
    const T* __restrict__ xe, const Dz& dz, int M, int nib, int nob, int o,
    int ib, int a0, int c0, bool want_db,
    float (&acc)[Dz::NB][Tile<BS>::PT][Tile<BS>::PT], float* db_sum) {
  constexpr int N = Tile<BS>::N;
  constexpr int TT = Tile<BS>::PT;
  constexpr int NB = Dz::NB;
  __shared__ float Xs[kBK][N];
  __shared__ float Zs[NB][kBK][N];
  __shared__ float Zf[NB == 1 ? kBK : 1][N];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int col = tid % N;
  const size_t n_in = (size_t)nib * BS;
  const size_t n_out = (size_t)nob * BS;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < TT; ++r)
#pragma unroll
      for (int j = 0; j < TT; ++j) acc[b][r][j] = 0.f;
  float dbs = 0.f;

  for (int m0 = 0; m0 < M; m0 += kBK) {
#pragma unroll
    for (int q = 0; q < kBK * N / kThreads; ++q) {
      const int mm = tid / N + q * (kThreads / N);
      const int m = m0 + mm;
      float xv = 0.f, z[NB], zf = 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) z[b] = 0.f;
      if (m < M) {
        xv = to_f32(xe[(size_t)m * n_in + (size_t)ib * BS + a0 + col]);
        dz((size_t)m * n_out + (size_t)o * BS + c0 + col, z, &zf);
      }
      Xs[mm][col] = xv;
#pragma unroll
      for (int b = 0; b < NB; ++b) Zs[b][mm][col] = z[b];
      if constexpr (NB == 1) {
        if (want_db) Zf[mm][col] = zf;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float av[TT];
#pragma unroll
      for (int r = 0; r < TT; ++r) av[r] = Xs[k][ty + 16 * r];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float bv[TT];
#pragma unroll
        for (int j = 0; j < TT; ++j) bv[j] = Zs[b][k][tx + 16 * j];
#pragma unroll
        for (int r = 0; r < TT; ++r)
#pragma unroll
          for (int j = 0; j < TT; ++j) acc[b][r][j] += av[r] * bv[j];
      }
    }
    if constexpr (NB == 1) {
      if (want_db && tid < N) {
        for (int k = 0; k < kBK; ++k) dbs += Zf[k][tid];
      }
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

// The gradient of each branch of `dz` (dw0, and dw1 for the gated form)
// and, with `db` not null, the bias gradient.
template <typename T, int BS, typename Dz>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const T* __restrict__ x, Dz dz, const int* __restrict__ idx,
              float* __restrict__ dw0, float* __restrict__ dw1,
              float* __restrict__ db, int M, int nib, int nob, int kb) {
  constexpr int TT = Tile<BS>::PT;
  constexpr int NB = Dz::NB;
  const Place<BS> p(blockIdx.x);
  const int o = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t n_out = (size_t)nob * BS;
  const bool want_db = db != nullptr && p.db;
  float acc[NB][TT][TT];
  float dbs = 0.f;
  dw_tile<T, BS>(x + (size_t)e * M * nib * BS, dz.at((size_t)e * M * n_out),
                 M, nib, nob, o, idx[(size_t)o * kb + p.k], p.a0, p.c0,
                 want_db, acc, &dbs);
  const size_t base = (((size_t)e * nob + o) * kb + p.k) * BS * BS;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float* t = (b == 0 ? dw0 : dw1) + base;
#pragma unroll
    for (int r = 0; r < TT; ++r)
#pragma unroll
      for (int j = 0; j < TT; ++j)
        t[(size_t)(p.a0 + ty + 16 * r) * BS + p.c0 + tx + 16 * j] =
            acc[b][r][j];
  }
  if (want_db && tid < Tile<BS>::N)
    db[(size_t)e * n_out + (size_t)o * BS + p.c0 + tid] = dbs;
}

// One weight stream updated in place: the weights (in x's dtype) and
// their fp32 slots (null where absent; vel needs mom).
template <typename T>
struct Stream {
  T* w;
  float* mom;
  float* vel;
};

// The fused update of each branch of `dz` (stream s0, and s1 for the
// gated form) and, with `b` not null, of the bias; one health flag per
// (e, o) tile whichever branch went non-finite.
template <typename T, int BS, typename Dz>
__global__ void __launch_bounds__(kThreads)
    update_kernel(const T* __restrict__ x, Dz dz, const int* __restrict__ idx,
                  const float* __restrict__ hyp, Stream<T> s0, Stream<T> s1,
                  T* __restrict__ b, float* __restrict__ mom_b,
                  float* __restrict__ vel_b, int* __restrict__ bad, int M,
                  int nib, int nob, int kb) {
  constexpr int TT = Tile<BS>::PT;
  constexpr int NB = Dz::NB;
  const Place<BS> p(blockIdx.x);
  const int o = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t n_out = (size_t)nob * BS;
  const bool want_db = b != nullptr && p.db;
  float acc[NB][TT][TT];
  float dbs = 0.f;
  dw_tile<T, BS>(x + (size_t)e * M * nib * BS, dz.at((size_t)e * M * n_out),
                 M, nib, nob, o, idx[(size_t)o * kb + p.k], p.a0, p.c0,
                 want_db, acc, &dbs);

  const Hyp h = hyp_row(hyp, e);
  bool ok = true;
  const size_t base = (((size_t)e * nob + o) * kb + p.k) * BS * BS;
#pragma unroll
  for (int bi = 0; bi < NB; ++bi) {
    const Stream<T> st = bi == 0 ? s0 : s1;
#pragma unroll
    for (int r = 0; r < TT; ++r)
#pragma unroll
      for (int j = 0; j < TT; ++j) {
        const size_t off =
            base + (size_t)(p.a0 + ty + 16 * r) * BS + p.c0 + tx + 16 * j;
        const float nw =
            opt_step(h, acc[bi][r][j], to_f32(st.w[off]),
                     st.mom == nullptr ? nullptr : st.mom + off,
                     st.vel == nullptr ? nullptr : st.vel + off, ok);
        store(&st.w[off], nw);
      }
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

template <typename T, int BS, typename Dz>
int launch_dw(const void* x, Dz dz, const void* idx, void* dw0, void* dw1,
              void* db, int E, int M, int nib, int nob, int kb,
              cudaStream_t stream) {
  const dim3 grid(kb * Tile<BS>::kPerSlot, nob, E);
  dw_kernel<T, BS, Dz><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dz, static_cast<const int*>(idx),
      static_cast<float*>(dw0), static_cast<float*>(dw1),
      static_cast<float*>(db), M, nib, nob, kb);
  return (int)cudaGetLastError();
}

template <typename T, int BS, typename Dz>
int launch_update(const void* x, Dz dz, const void* idx, const void* hyp,
                  Stream<T> s0, Stream<T> s1, void* b, void* mom_b,
                  void* vel_b, void* bad, void* health, int E, int M,
                  int nib, int nob, int kb, cudaStream_t stream) {
  const dim3 grid(kb * Tile<BS>::kPerSlot, nob, E);
  update_kernel<T, BS, Dz><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), dz, static_cast<const int*>(idx),
      static_cast<const float*>(hyp), s0, s1, static_cast<T*>(b),
      static_cast<float*>(mom_b), static_cast<float*>(vel_b),
      static_cast<int*>(bad), M, nib, nob, kb);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  health_kernel<<<E, 32, 0, stream>>>(static_cast<const int*>(bad),
                                      static_cast<int*>(health), nob);
  return (int)cudaGetLastError();
}

template <typename T>
PlainDz<T> plain_dz(const void* dy, const void* res, int act) {
  return {static_cast<const T*>(dy), static_cast<const T*>(res), act};
}

template <typename T>
GatedDz<T> gated_dz_of(const void* dh, const void* g, const void* u) {
  return {static_cast<const T*>(dh), static_cast<const T*>(g),
          static_cast<const T*>(u)};
}

template <typename T>
Stream<T> stream_of(void* w, void* mom, void* vel) {
  return {static_cast<T*>(w), static_cast<float*>(mom),
          static_cast<float*>(vel)};
}

bool valid_bs(int bs) { return bs == 32 || bs == 64 || bs == 128; }

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

// Each returns the cudaError_t of its launches (0 on success).  dtype:
// 0 fp32, 1 bf16; `res` is null for act "none".  They launch on
// `stream`, allocate nothing and do not synchronise.  The updates take
// `bad` [E, nob] int32 zeros and write `health` [E] int32.

// dw and (when db is not null) db, in fp32.
extern "C" int junction_dw(const void* x, const void* dy, const void* res,
                           const void* idx, void* dw, void* db, int E, int M,
                           int nib, int nob, int kb, int bs, int act,
                           int dtype, void* stream) {
  if (!valid_bs(bs) || (act != kNone && res == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    JUNCTION_BS_SWITCH((launch_dw<float, BS>(
        x, plain_dz<float>(dy, res, act), idx, dw, nullptr, db, E, M, nib,
        nob, kb, s)))
  }
  if (dtype == 1) {
    JUNCTION_BS_SWITCH((launch_dw<__nv_bfloat16, BS>(
        x, plain_dz<__nv_bfloat16>(dy, res, act), idx, dw, nullptr, db, E, M,
        nib, nob, kb, s)))
  }
  return (int)cudaErrorInvalidValue;
}

// The fused update: w (x's dtype), b (null: no bias), the fp32 slots
// (null where absent; vel needs mom).
extern "C" int junction_update_dw(const void* x, const void* dy,
                                  const void* res, const void* idx,
                                  const void* hyp, void* w, void* b,
                                  void* mom, void* mom_b, void* vel,
                                  void* vel_b, void* bad, void* health, int E,
                                  int M, int nib, int nob, int kb, int bs,
                                  int act, int dtype, void* stream) {
  if (!valid_bs(bs) || (act != kNone && res == nullptr) ||
      (vel != nullptr && mom == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    JUNCTION_BS_SWITCH((launch_update<float, BS>(
        x, plain_dz<float>(dy, res, act), idx, hyp,
        stream_of<float>(w, mom, vel), Stream<float>{}, b, mom_b, vel_b, bad,
        health, E, M, nib, nob, kb, s)))
  }
  if (dtype == 1) {
    JUNCTION_BS_SWITCH((launch_update<__nv_bfloat16, BS>(
        x, plain_dz<__nv_bfloat16>(dy, res, act), idx, hyp,
        stream_of<__nv_bfloat16>(w, mom, vel), Stream<__nv_bfloat16>{}, b,
        mom_b, vel_b, bad, health, E, M, nib, nob, kb, s)))
  }
  return (int)cudaErrorInvalidValue;
}

// The gated junction's (dwg, dwi), in fp32, from dh and the residuals g
// and u.
extern "C" int junction_gated_dw(const void* x, const void* dh, const void* g,
                                 const void* u, const void* idx, void* dwg,
                                 void* dwi, int E, int M, int nib, int nob,
                                 int kb, int bs, int dtype, void* stream) {
  if (!valid_bs(bs) || g == nullptr || u == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    JUNCTION_BS_SWITCH((launch_dw<float, BS>(
        x, gated_dz_of<float>(dh, g, u), idx, dwg, dwi, nullptr, E, M, nib,
        nob, kb, s)))
  }
  if (dtype == 1) {
    JUNCTION_BS_SWITCH((launch_dw<__nv_bfloat16, BS>(
        x, gated_dz_of<__nv_bfloat16>(dh, g, u), idx, dwg, dwi, nullptr, E,
        M, nib, nob, kb, s)))
  }
  return (int)cudaErrorInvalidValue;
}

// The gated fused update: wg and wi (x's dtype) with their fp32 slots
// (mg / mi both null or both given, vg / vi likewise; v needs m).
extern "C" int junction_update_gated_dw(
    const void* x, const void* dh, const void* g, const void* u,
    const void* idx, const void* hyp, void* wg, void* wi, void* mg, void* mi,
    void* vg, void* vi, void* bad, void* health, int E, int M, int nib,
    int nob, int kb, int bs, int dtype, void* stream) {
  if (!valid_bs(bs) || g == nullptr || u == nullptr ||
      (mg == nullptr) != (mi == nullptr) ||
      (vg == nullptr) != (vi == nullptr) ||
      (vg != nullptr && mg == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    JUNCTION_BS_SWITCH((launch_update<float, BS>(
        x, gated_dz_of<float>(dh, g, u), idx, hyp,
        stream_of<float>(wg, mg, vg), stream_of<float>(wi, mi, vi), nullptr,
        nullptr, nullptr, bad, health, E, M, nib, nob, kb, s)))
  }
  if (dtype == 1) {
    JUNCTION_BS_SWITCH((launch_update<__nv_bfloat16, BS>(
        x, gated_dz_of<__nv_bfloat16>(dh, g, u), idx, hyp,
        stream_of<__nv_bfloat16>(wg, mg, vg),
        stream_of<__nv_bfloat16>(wi, mi, vi), nullptr, nullptr, nullptr, bad,
        health, E, M, nib, nob, kb, s)))
  }
  return (int)cudaErrorInvalidValue;
}
