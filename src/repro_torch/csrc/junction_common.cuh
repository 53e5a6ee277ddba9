// Device helpers shared by the junction kernels (junction_fwd.cu,
// junction_dx.cu, junction_dw.cu): element conversion, rounding to the
// operand type, the activation table of block_sparse_matmul.act_fwd /
// act_bwd, and the branch gradients of the gated junction.  Built
// without --use_fast_math: the Adam guards and isfinite() of the update
// kernel need IEEE semantics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace junction {

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kSilu = 3, kGelu = 4 };

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float kGeluA = 0.044715f;
// 3 * kGeluA as the plain version has it: the product in double, then
// rounded to fp32 (3.f * kGeluA rounds to the fp32 value below it)
constexpr float kGelu3A = static_cast<float>(3.0 * 0.044715);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// v rounded to T and widened back (the reference's .astype(dy.dtype)).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The activation; gelu is the tanh form.
__device__ __forceinline__ float act_fwd(float s, int act) {
  switch (act) {
    case kRelu:
      return s < 0.f ? 0.f : s;  // keeps NaN, like maximum(s, 0)
    case kSigmoid:
      return 1.f / (1.f + expf(-s));
    case kSilu:
      return s * (1.f / (1.f + expf(-s)));
    case kGelu: {
      const float u = kGeluC * (s + kGeluA * s * s * s);
      return 0.5f * s * (1.f + tanhf(u));
    }
    default:
      return s;
  }
}

// silu'(r) = s (1 + r (1 - s)), s = sigmoid(r), one rounding a step in
// the plain version's order: nvcc would contract 1 + r (1 - s) into one
// FMA, which moves about one dz in 10^5 to the other bf16 neighbour.
__device__ __forceinline__ float silu_grad(float r, float s) {
  return __fmul_rn(s, __fadd_rn(1.f, __fmul_rn(r, __fsub_rn(1.f, s))));
}

// d act / d s from the residual: y for relu and sigmoid, the
// pre-activation s for silu and gelu.  Not called for kNone.  silu and
// gelu round every step as block_sparse_matmul.act_bwd does (no FMA).
__device__ __forceinline__ float act_bwd(float r, int act) {
  switch (act) {
    case kRelu:
      return r > 0.f ? 1.f : 0.f;
    case kSigmoid:
      return r * (1.f - r);
    case kSilu:
      return silu_grad(r, 1.f / (1.f + expf(-r)));
    case kGelu: {
      // u = c (r + a r r r); du = c (1 + 3a r r);
      // 0.5 (1 + t) + 0.5 r (1 - t t) du, t = tanh(u)
      const float cube = __fmul_rn(__fmul_rn(__fmul_rn(kGeluA, r), r), r);
      const float t = tanhf(__fmul_rn(kGeluC, __fadd_rn(r, cube)));
      const float du = __fmul_rn(
          kGeluC, __fadd_rn(1.f, __fmul_rn(__fmul_rn(kGelu3A, r), r)));
      const float a = __fmul_rn(0.5f, __fadd_rn(1.f, t));
      const float b = __fmul_rn(
          __fmul_rn(__fmul_rn(0.5f, r), __fsub_rn(1.f, __fmul_rn(t, t))), du);
      return __fadd_rn(a, b);
    }
    default:
      return 1.f;
  }
}

// dz = (dy * act'(res)) rounded to T, as the backward kernels consume it;
// `dzf` receives the value before that rounding (db sums it).
template <typename T>
__device__ __forceinline__ float dz_of(const T* dy, const T* res, size_t off,
                                       int act, float* dzf) {
  const float d = to_f32(dy[off]);
  if (act == kNone) {
    *dzf = d;
    return d;
  }
  const float f = d * act_bwd(to_f32(res[off]), act);
  *dzf = f;
  return round_to<T>(f);
}

// The gated junction's branch gradients at `off`, from its residuals g and
// u (stored in T): dz_g = dh * u * silu'(g) and dz_u = dh * silu(g), each
// computed in fp32 and rounded to T (block_sparse_matmul._gated_dz).
template <typename T>
__device__ __forceinline__ void gated_dz(const T* dh, const T* g, const T* u,
                                         size_t off, float* dzg, float* dzu) {
  const float d = to_f32(dh[off]);
  const float gv = to_f32(g[off]);
  *dzg = round_to<T>(d * to_f32(u[off]) * act_bwd(gv, kSilu));
  *dzu = round_to<T>(d * act_fwd(gv, kSilu));
}

}  // namespace junction
