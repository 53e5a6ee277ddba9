// The fused BP+UP epilogue shared by the update kernels of junction_dw.cu
// (SIMT, plain and gated) and junction_tc.cu (bf16 tensor cores): the
// [E, 7] hyp row, one optimizer step of one element
// (block_sparse_matmul._epilogue_step) and the per-unit count of the
// (e, o) tiles whose update went non-finite.  Built without
// --use_fast_math: an all-zero hyp row must give w' = w bit for bit
// through pow(0, 0) = 1, the c == 0 -> 1 guards and den == 0 -> 0.
#pragma once

#include "junction_common.cuh"

namespace junction {

constexpr int kHypK = 7;
enum HypCol { kLr = 0, kB1, kB2, kEps, kWd, kT, kGs };

// One unit's hyp row, with Adam's two bias corrections c1 = 1 - b1^t and
// c2 = 1 - b2^t (1 where that is 0) computed once for all its elements.
struct Hyp {
  float lr, b1, b2, eps, wd, t, gs, c1, c2;
};

// unit e's row of the [E, kHypK] table
__device__ __forceinline__ Hyp hyp_row(const float* hyp, int e) {
  const float* hr = hyp + (size_t)e * kHypK;
  Hyp h{hr[kLr], hr[kB1], hr[kB2], hr[kEps], hr[kWd], hr[kT], hr[kGs],
        0.f,     0.f};
  h.c1 = 1.f - powf(h.b1, h.t);
  h.c2 = 1.f - powf(h.b2, h.t);
  if (h.c1 == 0.f) h.c1 = 1.f;
  if (h.c2 == 0.f) h.c2 = 1.f;
  return h;
}

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
  const float den = sqrtf(v2 / h.c2) + h.eps;
  float upd = den == 0.f ? 0.f : (m1 / h.c1) / den;
  upd = upd + h.wd * w32;
  *mom = m1;
  *vel = v2;
  ok = ok && isfinite(m1) && isfinite(v2);
  return w32 - h.lr * upd;
}

// health[e] = number of flagged (e, o) tiles of bad [E, nob].
__global__ void health_kernel(const int* __restrict__ bad,
                              int* __restrict__ health, int nob) {
  const int e = blockIdx.x;
  int n = 0;
  for (int o = threadIdx.x; o < nob; o += 32) n += bad[(size_t)e * nob + o];
  for (int s = 16; s > 0; s >>= 1) n += __shfl_down_sync(0xffffffffu, n, s);
  if (threadIdx.x == 0) health[e] = n;
}

}  // namespace junction
