// Quantized block-sparse junction forwards for Hopper (sm_90a), plain C
// interface: int8 (plain and gated) and the paper's fixed point.
//
// Replaces the Pallas TPU kernels `fwd_int8`, `gated_fwd_int8` and
// `fwd_fxp` of src/repro/kernels/block_sparse_matmul.py.  For unit e,
// output block o and fan-in slot k (input block ib = idx[o, k]):
//
//   int8:  sx  = absmax(x[e, m, ib*bs : ib*bs+bs]) / 127 (1 where the
//                absmax is 0), or the static x_scale[e]
//          xq  = clip(rint(x / sx), -127, 127)                 (int8)
//          acc = acc + float(xq . wq[e, o, k][:, c]) * (sx * w_scale[e, o, k])
//          y   = act(acc + bias[e, o*bs + c])    in x's dtype
//   gated: the same activation codes against wg and wi, two accumulators,
//          h = silu(g) * u (no bias, no act)
//   fxp:   xq  = clip(rint(x * 2^bf), -lim, lim - 1)  (lim = n_lut / 2)
//          acc = sum over k of xq . wq[e, o, k][:, c] in int32, wrapping
//                mod 2^32 as the reference's int32 dot does
//          s   = clip((acc + 2^(bf-1)) >> bf)     (round half up, saturate)
//          s   = clip(s + clip(rint(bias * 2^bf)))             (q_add)
//          y   = lut[s & (n_lut - 1)]             in x's dtype
//
// x [E, M, nib*bs] (fp32 or bf16), wq / wg / wi [E, nob, kb, bs, bs]
// (int8 codes, int32 for fxp), idx [nob, kb] int32, scales [E, nob, kb]
// fp32, bias [E, nob*bs] fp32, x_scale [E] fp32 or null, qfmt [2] int32
// = [bf, bn] read on the card, lut [n_lut] fp32.
//
// Exactness.  The int8 dot of one slot is an exact int32 (|sum| <=
// 127^2 * 128 < 2^24) from __dp4a; the dequant step is __fmul_rn /
// __fadd_rn (no FMA contraction), and the slots are added in the order
// k = 0 .. kb-1 whatever warp computed them, so with act "none" the
// result equals the plain PyTorch version bit for bit.  The fxp sum is
// accumulated in uint32 (wrapping, defined) and reinterpreted, so it is
// exact integer arithmetic in any order.  Built without --use_fast_math:
// x / sx must be IEEE division and rintf round half to even.
//
// What bounds it: on the serving path M is 4 (decode) or 32 (prefill),
// so every weight byte feeds at most M multiply-adds and the kernel is
// bound by the int8 codes it streams (13.4 MB a stablelm-3b layer, half
// the bf16 bytes; 0.10 GB for the two gate streams of qwen3-moe's 128
// experts).  The sweep's shapes (E <= 6, 0.5 MB of codes) are launch
// bound.
//
// Design.  Every (unit e, 8-row tile, output block o, 32-column chunk)
// is a block, as in junction_fwd.cu.  Its warps take the fan-in slots in
// turn (warp w: slots w, w + W, ...).  The warp that owns a slot loads
// the slot's 8 x rows, reduces each row's absmax with shuffles, and
// writes the activation codes to shared memory; then lane (rq, q) forms
// the dots of rows rq and rq + 4 with columns 4q .. 4q+3.  It reads four
// weight rows of those columns as four 32-bit words (eight lanes cover
// the chunk's 32 bytes of a row: one sector), transposes the 4x4 bytes
// with __byte_perm so that each word holds one column over four input
// rows, and feeds __dp4a against the codes of the row.  The dequantized
// slot values go to shared memory and are added into the tile's
// accumulator in slot order.  The fxp kernel has the same layout with
// int32 codes, 16-byte weight loads and a uint32 multiply-add; the LUT
// (256 KiB at bw 16, more than a block's shared memory) is read through
// __ldg.  A simple SIMT kernel: mma.sync s8 and wgmma are later work.
#include <cstdint>

#include "junction_common.cuh"

namespace {

using namespace junction;

constexpr int kCols = 32;  // output columns per block
constexpr int kRows = 8;   // rows of x per block (row tile)
// lane (rq, q): q = lane % 8 owns columns 4q .. 4q+3 of the chunk, rq =
// lane / 8 owns rows rq and rq + 4 of the tile
constexpr int kLaneRows = kRows / 4;
constexpr int kInt8Warps = 8;  // at most this many slots in flight a block
constexpr int kFxpWarps = 4;

// Columns 4q .. 4q+3 of four consecutive weight rows a[0..3] (a word a
// row) -> b[j] = column j over the four rows, row 0 in the low byte.
__device__ __forceinline__ void transpose4x4(const int (&a)[4], int (&b)[4]) {
  const int t0 = __byte_perm(a[0], a[1], 0x5140);
  const int t1 = __byte_perm(a[0], a[1], 0x7362);
  const int t2 = __byte_perm(a[2], a[3], 0x5140);
  const int t3 = __byte_perm(a[2], a[3], 0x7362);
  b[0] = __byte_perm(t0, t2, 0x5410);
  b[1] = __byte_perm(t0, t2, 0x7632);
  b[2] = __byte_perm(t1, t3, 0x5410);
  b[3] = __byte_perm(t1, t3, 0x7632);
}

// One warp: the int8 codes of the tile's rows of one slot's input block
// (xblk points at row m0, column ib*bs) into xq [kRows][BS + 4], and each
// row's scale into sx [kRows].  Rows past `rows` are zeros.
template <typename T, int BS>
__device__ __forceinline__ void encode_slot_int8(const T* xblk, size_t n_in,
                                                 int rows, const float* xs,
                                                 int e, int8_t* xq, float* sx,
                                                 int lane) {
  constexpr int kPer = BS / 32;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v[kPer];
    float ax = 0.f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      v[t] = r < rows ? to_f32(xblk[r * n_in + lane + 32 * t]) : 0.f;
      ax = fmaxf(ax, fabsf(v[t]));
    }
    float s;
    if (xs == nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ax = fmaxf(ax, __shfl_xor_sync(0xffffffffu, ax, off));
      s = ax == 0.f ? 1.f : __fdiv_rn(ax, 127.f);
    } else {
      s = xs[e];
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v[t], s)), -127.f), 127.f);
      xq[r * (BS + 4) + lane + 32 * t] = static_cast<int8_t>(q);
    }
    if (lane == 0) sx[r] = s;
  }
}

// d[lr][j] += the int32 dot of code row rq + 4*lr with column 4q + j of
// the slot tile wk [BS][BS] (col0 = the chunk's first column + 4q).
template <int BS>
__device__ __forceinline__ void dot_int8(const int8_t* __restrict__ wk,
                                         int col0, const int8_t* xq, int rq,
                                         int (&d)[kLaneRows][4]) {
#pragma unroll 4
  for (int i = 0; i < BS; i += 4) {
    int a[4], b[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      a[rr] = __ldg(reinterpret_cast<const int*>(wk + (size_t)(i + rr) * BS +
                                                 col0));
    transpose4x4(a, b);
#pragma unroll
    for (int lr = 0; lr < kLaneRows; ++lr) {
      const int xw =
          *reinterpret_cast<const int*>(xq + (rq + 4 * lr) * (BS + 4) + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) d[lr][j] = __dp4a(xw, b[j], d[lr][j]);
    }
  }
}

// The int8 junction; kGated: two weight streams wg (scales sg) and wi
// (si), epilogue silu(g) * u, no bias.  blockDim.x = 32 * W, W <= 8.
template <typename T, int BS, bool kGated>
__global__ void __launch_bounds__(32 * kInt8Warps)
    junction_int8_kernel(const T* __restrict__ x,
                         const int8_t* __restrict__ wg,
                         const int8_t* __restrict__ wi,
                         const int* __restrict__ idx,
                         const float* __restrict__ sg,
                         const float* __restrict__ si,
                         const float* __restrict__ bias,
                         const float* __restrict__ xs, T* __restrict__ y,
                         int M, int nib, int nob, int kb, int act) {
  constexpr int kBr = kGated ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int q = lane & 7;
  const int rq = lane >> 3;
  const int o = blockIdx.x / (BS / kCols);
  const int c0 = (blockIdx.x % (BS / kCols)) * kCols;
  const int m0 = blockIdx.y * kRows;
  const int e = blockIdx.z;
  const int rows = min(kRows, M - m0);
  const size_t n_in = (size_t)nib * BS;
  const size_t n_out = (size_t)nob * BS;

  __shared__ __align__(16) int8_t xq[kInt8Warps][kRows * (BS + 4)];
  __shared__ float sx[kInt8Warps][kRows];
  __shared__ float part[kBr][kInt8Warps][kRows][kCols];
  __shared__ float acc[kBr][kRows][kCols];
  for (int t = threadIdx.x; t < kRows * kCols; t += blockDim.x)
#pragma unroll
    for (int br = 0; br < kBr; ++br) acc[br][t / kCols][t % kCols] = 0.f;

  const T* xe = x + ((size_t)e * M + m0) * n_in;
  for (int k0 = 0; k0 < kb; k0 += nw) {
    const int k = k0 + warp;
    if (k < kb) {
      const size_t slot = ((size_t)e * nob + o) * kb + k;
      encode_slot_int8<T, BS>(xe + (size_t)idx[(size_t)o * kb + k] * BS, n_in,
                              rows, xs, e, xq[warp], sx[warp], lane);
      __syncwarp();
      const int col0 = c0 + 4 * q;
#pragma unroll
      for (int br = 0; br < kBr; ++br) {
        int d[kLaneRows][4] = {};
        dot_int8<BS>((br == 0 ? wg : wi) + slot * BS * BS, col0, xq[warp], rq,
                     d);
        const float sc = (br == 0 ? sg : si)[slot];
#pragma unroll
        for (int lr = 0; lr < kLaneRows; ++lr) {
          const int r = rq + 4 * lr;
          const float f = __fmul_rn(sx[warp][r], sc);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[br][warp][r][4 * q + j] =
                __fmul_rn(static_cast<float>(d[lr][j]), f);
        }
      }
    }
    __syncthreads();
    // the slots of this round, added in slot order
    const int nk = min(nw, kb - k0);
    for (int t = threadIdx.x; t < kRows * kCols; t += blockDim.x) {
      const int r = t / kCols, c = t % kCols;
#pragma unroll
      for (int br = 0; br < kBr; ++br) {
        float a = acc[br][r][c];
        for (int w = 0; w < nk; ++w) a = __fadd_rn(a, part[br][w][r][c]);
        acc[br][r][c] = a;
      }
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < kRows * kCols; t += blockDim.x) {
    const int r = t / kCols, c = t % kCols;
    if (r >= rows) continue;
    const size_t n = (size_t)o * BS + c0 + c;
    const size_t out = ((size_t)e * M + m0 + r) * n_out + n;
    if (kGated) {
      store(&y[out], act_fwd(acc[0][r][c], kSilu) * acc[1][r][c]);
    } else {
      const float s = __fadd_rn(acc[0][r][c], bias[(size_t)e * n_out + n]);
      store(&y[out], act_fwd(s, act));
    }
  }
}

// The fixed-point junction.  blockDim.x = 32 * W, W <= kFxpWarps; each
// warp sums its slots, the warps' sums are added in uint32.
template <typename T, int BS>
__global__ void __launch_bounds__(32 * kFxpWarps)
    junction_fxp_kernel(const T* __restrict__ x, const int* __restrict__ wq,
                        const int* __restrict__ idx,
                        const int* __restrict__ qfmt,
                        const float* __restrict__ lut,
                        const float* __restrict__ bias, T* __restrict__ y,
                        int M, int nib, int nob, int kb, int n_lut) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int q = lane & 7;
  const int rq = lane >> 3;
  const int o = blockIdx.x / (BS / kCols);
  const int c0 = (blockIdx.x % (BS / kCols)) * kCols;
  const int m0 = blockIdx.y * kRows;
  const int e = blockIdx.z;
  const int rows = min(kRows, M - m0);
  const size_t n_in = (size_t)nib * BS;
  const size_t n_out = (size_t)nob * BS;
  const int bf = qfmt[0];
  const float scale = ldexpf(1.f, bf);
  const int lim = n_lut / 2;
  const float flim = static_cast<float>(lim);
  constexpr int kPer = BS / 32;

  __shared__ __align__(16) int xq[kFxpWarps][kRows * (BS + 4)];
  __shared__ uint32_t part[kFxpWarps][kRows][kCols];

  uint32_t d[kLaneRows][4] = {};
  const T* xe = x + ((size_t)e * M + m0) * n_in;
  int* xw = xq[warp];
  for (int k = warp; k < kb; k += nw) {
    const T* xblk = xe + (size_t)idx[(size_t)o * kb + k] * BS;
    __syncwarp();  // the previous slot's codes are read by every lane
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const float v =
            r < rows ? to_f32(xblk[r * n_in + lane + 32 * t]) : 0.f;
        const float c = fminf(fmaxf(rintf(__fmul_rn(v, scale)), -flim),
                              flim - 1.f);
        xw[r * (BS + 4) + lane + 32 * t] = static_cast<int>(c);
      }
    __syncwarp();
    const int* wk = wq + (((size_t)e * nob + o) * kb + k) * BS * BS + c0 +
                    4 * q;
#pragma unroll 4
    for (int i = 0; i < BS; ++i) {
      const int4 w4 = __ldg(reinterpret_cast<const int4*>(wk + (size_t)i * BS));
      const uint32_t wv[4] = {(uint32_t)w4.x, (uint32_t)w4.y, (uint32_t)w4.z,
                              (uint32_t)w4.w};
#pragma unroll
      for (int lr = 0; lr < kLaneRows; ++lr) {
        const uint32_t xv = (uint32_t)xw[(rq + 4 * lr) * (BS + 4) + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) d[lr][j] += xv * wv[j];
      }
    }
  }
#pragma unroll
  for (int lr = 0; lr < kLaneRows; ++lr)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[warp][rq + 4 * lr][4 * q + j] = d[lr][j];
  __syncthreads();

  for (int t = threadIdx.x; t < kRows * kCols; t += blockDim.x) {
    const int r = t / kCols, c = t % kCols;
    if (r >= rows) continue;
    uint32_t a = 0;
    for (int w = 0; w < nw; ++w) a += part[w][r][c];
    // round half up: (acc + 2^(bf-1)) >> bf on the wrapped int32
    int s = static_cast<int>(a + (1u << (bf - 1))) >> bf;
    s = min(max(s, -lim), lim - 1);
    const size_t n = (size_t)o * BS + c0 + c;
    const float bv = fminf(
        fmaxf(rintf(__fmul_rn(bias[(size_t)e * n_out + n], scale)), -flim),
        flim - 1.f);
    s = min(max(s + static_cast<int>(bv), -lim), lim - 1);
    store(&y[((size_t)e * M + m0 + r) * n_out + n],
          __ldg(lut + (s & (n_lut - 1))));
  }
}

dim3 grid_of(int E, int M, int nob, int bs) {
  return dim3(nob * (bs / kCols), (M + kRows - 1) / kRows, E);
}

template <typename T, int BS, bool kGated>
int launch_int8(const void* x, const void* wg, const void* wi,
                const void* idx, const void* sg, const void* si,
                const void* bias, const void* xs, void* y, int E, int M,
                int nib, int nob, int kb, int act, cudaStream_t stream) {
  const int warps = kb < kInt8Warps ? kb : kInt8Warps;
  junction_int8_kernel<T, BS, kGated>
      <<<grid_of(E, M, nob, BS), 32 * warps, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const int8_t*>(wg),
          static_cast<const int8_t*>(wi), static_cast<const int*>(idx),
          static_cast<const float*>(sg), static_cast<const float*>(si),
          static_cast<const float*>(bias), static_cast<const float*>(xs),
          static_cast<T*>(y), M, nib, nob, kb, act);
  return (int)cudaGetLastError();
}

template <typename T, int BS>
int launch_fxp(const void* x, const void* wq, const void* idx,
               const void* qfmt, const void* lut, const void* bias, void* y,
               int E, int M, int nib, int nob, int kb, int n_lut,
               cudaStream_t stream) {
  const int warps = kb < kFxpWarps ? kb : kFxpWarps;
  junction_fxp_kernel<T, BS><<<grid_of(E, M, nob, BS), 32 * warps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(wq),
      static_cast<const int*>(idx), static_cast<const int*>(qfmt),
      static_cast<const float*>(lut), static_cast<const float*>(bias),
      static_cast<T*>(y), M, nib, nob, kb, n_lut);
  return (int)cudaGetLastError();
}

bool valid(int bs, int kb) {
  return (bs == 32 || bs == 64 || bs == 128) && kb > 0;
}

}  // namespace

#define QUANT_BS_SWITCH(CALL) \
  switch (bs) {               \
    case 32: {                \
      constexpr int BS = 32;  \
      return CALL;            \
    }                         \
    case 64: {                \
      constexpr int BS = 64;  \
      return CALL;            \
    }                         \
    default: {                \
      constexpr int BS = 128; \
      return CALL;            \
    }                         \
  }

// Each returns the cudaError_t of the launch (0 on success).  dtype: 0
// fp32, 1 bf16.  They launch on `stream`, allocate nothing and do not
// synchronise.  Weight codes must be 16-byte aligned.

// The int8 junction; x_scale null: dynamic per-row scales.
extern "C" int junction_fwd_int8(const void* x, const void* wq,
                                 const void* idx, const void* w_scale,
                                 const void* bias, const void* x_scale,
                                 void* y, int E, int M, int nib, int nob,
                                 int kb, int bs, int act, int dtype,
                                 void* stream) {
  if (!valid(bs, kb)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    QUANT_BS_SWITCH((launch_int8<float, BS, false>(
        x, wq, nullptr, idx, w_scale, nullptr, bias, x_scale, y, E, M, nib,
        nob, kb, act, s)))
  }
  if (dtype == 1) {
    QUANT_BS_SWITCH((launch_int8<__nv_bfloat16, BS, false>(
        x, wq, nullptr, idx, w_scale, nullptr, bias, x_scale, y, E, M, nib,
        nob, kb, act, s)))
  }
  return (int)cudaErrorInvalidValue;
}

// The gated int8 junction: h = silu(g) * u.
extern "C" int junction_gated_fwd_int8(const void* x, const void* wgq,
                                       const void* wiq, const void* idx,
                                       const void* wg_scale,
                                       const void* wi_scale,
                                       const void* x_scale, void* h, int E,
                                       int M, int nib, int nob, int kb, int bs,
                                       int dtype, void* stream) {
  if (!valid(bs, kb)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    QUANT_BS_SWITCH((launch_int8<float, BS, true>(
        x, wgq, wiq, idx, wg_scale, wi_scale, nullptr, x_scale, h, E, M, nib,
        nob, kb, kSilu, s)))
  }
  if (dtype == 1) {
    QUANT_BS_SWITCH((launch_int8<__nv_bfloat16, BS, true>(
        x, wgq, wiq, idx, wg_scale, wi_scale, nullptr, x_scale, h, E, M, nib,
        nob, kb, kSilu, s)))
  }
  return (int)cudaErrorInvalidValue;
}

// The fixed-point junction; n_lut a power of two >= 2, qfmt[0] >= 1.
extern "C" int junction_fwd_fxp(const void* x, const void* wq,
                                const void* idx, const void* qfmt,
                                const void* lut, const void* bias, void* y,
                                int E, int M, int nib, int nob, int kb, int bs,
                                int n_lut, int dtype, void* stream) {
  if (!valid(bs, kb) || n_lut < 2 || (n_lut & (n_lut - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    QUANT_BS_SWITCH((launch_fxp<float, BS>(x, wq, idx, qfmt, lut, bias, y, E,
                                           M, nib, nob, kb, n_lut, s)))
  }
  if (dtype == 1) {
    QUANT_BS_SWITCH((launch_fxp<__nv_bfloat16, BS>(
        x, wq, idx, qfmt, lut, bias, y, E, M, nib, nob, kb, n_lut, s)))
  }
  return (int)cudaErrorInvalidValue;
}
