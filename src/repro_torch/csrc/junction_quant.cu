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
// 127^2 * 128 < 2^24) from __dp4a or mma.sync, in any order of K, lanes
// or warps; the dequant step is __fmul_rn (no FMA contraction), and the
// fp32 parts are added by __fadd_rn in the order k = 0 .. kb-1 from 0,
// whichever block computed them, so with act "none" the result equals
// the plain PyTorch version bit for bit.  The fxp sum is
// accumulated in uint32 (wrapping, defined) and reinterpreted, so it is
// exact integer arithmetic in any order.  Built without --use_fast_math:
// x / sx must be IEEE division and rintf round half to even.
//
// What bounds it.  On the serving path M is 4 (decode) or 32 (prefill),
// so every weight byte feeds at most M multiply-adds: the kernel is bound
// by the int8 codes it streams (13.4 MB a stablelm-3b decode layer, 0.10
// GB for the two gate streams of qwen3-moe's 128 experts), a few
// microseconds of the card's 3.35 TB/s.  To reach that the card needs
// tens of KB of codes in flight on every SM, also on shapes with few
// output blocks (stablelm-3b's 6912 -> 2560 junction has 20), and a
// short chain of latencies in each block: a stablelm junction is a few
// microseconds of work, so launch, the first loads and the combine of a
// split weigh as much as the bytes (PERF.md).
//
// Design.  A block owns one unit e, one output block o, a chunk of at most
// 8 (dp4a) or 16 (mma) rows of x and a run of consecutive fan-in slots;
// `int8_plan` in block_sparse_matmul.py picks the path, the chunk and the
// run from the shapes alone, so that stablelm's junctions still give
// some 264 blocks.  The block's four warps (two on the dp4a path at
// block 32) split each slot's K rows, add their int32 sums through shared
// memory and then each own a quarter of the chunk's outputs.
// * The slot tiles wq[e, o, k] (bs x bs int8, contiguous) go by 16-byte
//   cp.async into a ring of up to kInt8Stages stages (the gate's two
//   streams as 2 x run tiles, wg first), the chunks of a row placed by
//   `swz` so that the mma path's fragment loads meet no bank conflict.
//   The ring fills while the block encodes x once a slot and row: the
//   absmax by shuffles, the codes and the scale into shared memory, four
//   rows a warp with their loads in flight together.
// * dp4a path (below INT8_MMA_MIN_M rows, and blocks 32 and 64): lane
//   (w, h) reads word w of four code rows (a warp reads whole 128-byte
//   rows), transposes the 4 x 4 bytes with __byte_perm so that each word
//   holds one column over four rows, and feeds __dp4a against the row's
//   codes; the k-groups h of a warp (blocks 32, 64) add by shuffles.
// * mma path (block 128 from INT8_MMA_MIN_M rows): mma.sync m16n8k16 s8
//   on a 16-row tile.  B must be K-major and the codes are [in, out], so
//   lane (g, t) loads 16-byte chunk g of code rows 4t .. 4t+3 of a K step
//   and transposes each word: b[q][j] is column 16g + 4q + j over those
//   four rows, the B fragment of n-tile 4q + j, whose column g stands for
//   output column 16g + 4q + j.  So sum (n-tile nt, column L) is output
//   column 16L + nt, and lane (g, t) holds rows g and g + 8 of output
//   columns 32t .. 32t+31.
// * Each slot's int32 dot is dequantized by its own (sx * scale) and
//   added to the thread's fp32 sums in slot order.  When the slots of an
//   output block are split over blocks, every block writes each slot's
//   part to scratch, in its threads' own order, and the last block of (e,
//   chunk, o) to arrive, told by a self-resetting int32 ticket, adds all
//   kb parts in slot order from 0, in the same threads, then stores.
// The fxp kernel is a product of int32 codes: on the CUDA cores it is
// bound by IMAD (at most the fp32 rate), so it runs fxp_tc.cuh's byte
// planes on the int8 tensor cores.  A block owns one unit e, one output
// block o (BN = BS columns, 2 x BS / 32 warps) and 64 rows of x, over a
// run of K tiles of 32 (the slots' code rows in order); `fxp_plan` in
// block_sparse_matmul.py splits the slots over blocks when the shapes give
// few tiles (the sweep's 512 -> 128 layer has 8), and the last block of a
// tile adds the splits' uint32 sums (exact in any order).  x is encoded
// (rint(x * 2^bf), clipped to the table's range) while staged, once a
// block, K tile and row, for all BS output columns; the code tile of a
// slot is read once a block of 64 rows.  The epilogue: the wrapped
// round-half-up shift, saturation, the bias code, the LUT (256 KiB at
// bw 16, more than a block's shared memory) through __ldg.
#include <cstdint>

#include "fxp_tc.cuh"
#include "junction_common.cuh"

namespace {

using namespace junction;

using fxp_tc::transpose4x4;

constexpr int kInt8Warps = 4;   // warps a block at most
constexpr int kInt8Stages = 3;  // ring depth in code tiles (<= 4)
constexpr int kMmaVals = 64;    // int32 sums a lane's 16-row tile holds on
                                // the mma path (16 n-tiles x 4)
constexpr int kMaxSmem = 200 * 1024;  // dynamic shared memory a block at most

// until at most n of this thread's cp.async groups are pending (n <
// kInt8Stages <= 4)
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n <= 0)
    fxp_tc::cp_wait<0>();
  else if (n == 1)
    fxp_tc::cp_wait<1>();
  else if (n == 2)
    fxp_tc::cp_wait<2>();
  else
    fxp_tc::cp_wait<3>();
}

// D += A (16 x 16, row) * B (16 x 8, col), int8 in, int32 sums: lane (g,
// t) holds A rows g and g + 8 at k = 4t .. 4t+3, B column g at the same
// k, D rows g and g + 8 at columns 2t and 2t + 1.
__device__ __forceinline__ void mma_s8(int& d0, int& d1, int& d2, int& d3,
                                       int a0, int a1, int b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3)
      : "r"(a0), "r"(a1), "r"(b));
}

// The 16-byte chunk at which chunk c of code row i is staged.  At block
// 128, c ^ 2 ((i / 4) % 4): the mma path's quarter warp (g in {2p, 2p+1},
// t = 0..3) reads chunk g of rows 4t + r, and so meets 8 distinct chunks;
// a dp4a warp reads the 32 words of one row, in another order.
template <int BS>
__device__ __forceinline__ int swz(int i, int c) {
  return BS == 128 ? c ^ (((i >> 2) & 3) << 1) : c;
}

// The code tile of one slot (bs x bs, contiguous) into a stage.
template <int BS>
__device__ __forceinline__ void stage_codes(int8_t* dst, const int8_t* src,
                                            int tid, int nthreads) {
  constexpr int kC = BS / 16;
  for (int q = tid; q < BS * kC; q += nthreads) {
    const int i = q / kC, c = q % kC;
    fxp_tc::cp_async<16>(dst + i * BS + swz<BS>(i, c) * 16,
                         src + (size_t)q * 16, true);
  }
}

// One warp: the int8 codes of kEnc rows of x at once (their loads in
// flight together) into rows of xq (BS + 16 bytes) and their scales into
// sx.  Row p of the block's list (p < n; slot p / rows_pad, row p %
// rows_pad of the chunk) reads xe's row and slot's input block; rows past
// `rows` are padding, codes 0.  Lane l owns columns l*BS/32 ...
template <typename T, int BS, int kEnc>
__device__ __forceinline__ void encode_rows(const T* xe, size_t n_in,
                                            const int* idx_o, int p0, int n,
                                            int rows_pad, int rows,
                                            const float* xs, int e,
                                            int8_t* xq, float* sx, int lane) {
  constexpr int kPer = BS / 32;
  float v[kEnc][kPer], ax[kEnc];
#pragma unroll
  for (int i = 0; i < kEnc; ++i) {
    const int p = p0 + i, r = p % rows_pad;
    const bool valid = p < n && r < rows;
    const T* xrow = xe + (size_t)(valid ? r : 0) * n_in +
                    (size_t)(valid ? idx_o[p / rows_pad] : 0) * BS;
    ax[i] = 0.f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      v[i][t] = valid ? to_f32(xrow[lane * kPer + t]) : 0.f;
      ax[i] = fmaxf(ax[i], fabsf(v[i][t]));
    }
  }
#pragma unroll
  for (int i = 0; i < kEnc; ++i) {
    const int p = p0 + i;
    if (p >= n) break;
    float s;
    if (xs == nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ax[i] = fmaxf(ax[i], __shfl_xor_sync(0xffffffffu, ax[i], off));
      s = ax[i] == 0.f ? 1.f : __fdiv_rn(ax[i], 127.f);
    } else {
      s = xs[e];
    }
    const bool valid = p % rows_pad < rows;
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const float c =
          fminf(fmaxf(rintf(__fdiv_rn(v[i][t], s)), -127.f), 127.f);
      xq[(size_t)p * (BS + 16) + lane * kPer + t] =
          valid ? static_cast<int8_t>(c) : int8_t(0);
    }
    if (lane == 0) sx[p] = s;
  }
}

// The int8 kernels' layout: one row tile a block, of kRT = 4 or 8 rows
// (dp4a) or 16 (mma), its K split over kWarps warps (2 on the dp4a path
// at block 32).  A warp's share holds kV int32 sums a lane; after the
// warps add theirs, each thread owns kVO of them.
template <int BS, bool kMma, int kRT>
struct Int8Layout {
  static constexpr int kWarps = kMma || BS != 32 ? 4 : 2;
  static constexpr int kV = kMma ? kMmaVals : kRT * 4;
  static constexpr int kVO = kV / kWarps;
};

// dp4a path: d[r][j] += the int32 dot of code row r of the tile (xq,
// rows of BS + 16 bytes) with column 4w + j of the staged tile, over K
// share ks of kKS.  Lane l: w = l % (BS/4), k-group h = l / (BS/4); the
// kKS * 32 / (BS/4) k-groups take BS / that many K rows each; the
// k-groups of a warp are added by shuffles.
template <int BS, int kRT, int kKS>
__device__ __forceinline__ void dot_dp4a(const int8_t* tile,
                                         const int8_t* xq, int lane, int ks,
                                         int (&d)[kRT * 4]) {
  constexpr int kWR = BS / 4;      // words a code row
  constexpr int kG = 32 / kWR;     // k-groups a warp
  constexpr int kKR = BS / (kG * kKS);  // K rows a k-group
  constexpr int kXL = BS + 16;
  static_assert(kKR % 4 == 0, "a k-group takes whole groups of 4 rows");
  const int w = lane % kWR, h = lane / kWR;
  const int i0 = (ks * kG + h) * kKR;
#pragma unroll
  for (int v = 0; v < kRT * 4; ++v) d[v] = 0;
#pragma unroll 4
  for (int i = i0; i < i0 + kKR; i += 4) {
    int a[4], b[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      a[rr] = *reinterpret_cast<const int*>(
          tile + (i + rr) * BS + swz<BS>(i + rr, w >> 2) * 16 + (w & 3) * 4);
    transpose4x4(a, b);
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int xw = *reinterpret_cast<const int*>(xq + r * kXL + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) d[4 * r + j] = __dp4a(xw, b[j], d[4 * r + j]);
    }
  }
#pragma unroll
  for (int off = kWR; off < 32; off <<= 1)
#pragma unroll
    for (int v = 0; v < kRT * 4; ++v)
      d[v] += __shfl_xor_sync(0xffffffffu, d[v], off);
}

// mma path (block 128): d[4 nt + c] = the int32 sums of n-tile nt (output
// columns 16L + nt, L = 0..7) over the 16 code rows of a tile, K steps
// ks * 8 / kKS .. (ks + 1) * 8 / kKS - 1 of 16 code rows.
template <int kKS>
__device__ __forceinline__ void dot_mma(const int8_t* tile, const int8_t* xq,
                                        int lane, int ks, int (&d)[64]) {
  constexpr int kXL = 128 + 16;
  constexpr int kSteps = 8 / kKS;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int v = 0; v < 64; ++v) d[v] = 0;
#pragma unroll
  for (int s = ks * kSteps; s < (ks + 1) * kSteps; ++s) {
    int raw[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 16 * s + 4 * t + r;
      const int4 v = *reinterpret_cast<const int4*>(tile + i * 128 +
                                                    swz<128>(i, g) * 16);
      raw[0][r] = v.x;
      raw[1][r] = v.y;
      raw[2][r] = v.z;
      raw[3][r] = v.w;
    }
    const int a0 = *reinterpret_cast<const int*>(xq + g * kXL + 16 * s + 4 * t);
    const int a1 =
        *reinterpret_cast<const int*>(xq + (g + 8) * kXL + 16 * s + 4 * t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int b[4];
      transpose4x4(raw[q], b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * (4 * q + j);
        mma_s8(d[n], d[n + 1], d[n + 2], d[n + 3], a0, a1, b[j]);
      }
    }
  }
}

// The int8 junction; kGated: two weight streams wg (scales sg) and wi
// (si), epilogue silu(g) * u, no bias.  kMma: the mma path (block 128).
// Int8Layout sets the warps (blockDim.x = 32 * kWarps) and who owns which
// sums; rows_blk <= kRT; grid (nob * nsplit, ceil(M / rows_blk), E).
// part / tickets: the split's scratch and tickets (nsplit > 1 only).
template <typename T, int BS, bool kGated, bool kMma, int kRT>
__global__ void __launch_bounds__(32 * kInt8Warps)
    junction_int8_kernel(const T* __restrict__ x,
                         const int8_t* __restrict__ wg,
                         const int8_t* __restrict__ wi,
                         const int* __restrict__ idx,
                         const float* __restrict__ sg,
                         const float* __restrict__ si,
                         const float* __restrict__ bias,
                         const float* __restrict__ xs, T* __restrict__ y,
                         float* __restrict__ part, int* __restrict__ tickets,
                         int M, int nib, int nob, int kb, int act,
                         int rows_blk, int run, int nsplit) {
  using L = Int8Layout<BS, kMma, kRT>;
  constexpr int kBr = kGated ? 2 : 1;
  constexpr int kW = L::kWarps, kV = L::kV, kVO = L::kVO;
  constexpr int kXL = BS + 16;  // bytes a row of xq
  constexpr int kTile = BS * BS;
  constexpr int kWR = BS / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int o = blockIdx.x / nsplit, sp = blockIdx.x % nsplit;
  const int ch = blockIdx.y, e = blockIdx.z;
  const int m0 = ch * rows_blk;
  const int rows = min(rows_blk, M - m0);
  const int k0 = sp * run;
  const int nk = min(run, kb - k0);  // this block's slots
  const int ntile = kBr * nk;        // tile j: branch j / nk, slot k0 + j % nk
  const int ns = min(kInt8Stages, kBr * run);
  const size_t n_in = (size_t)nib * BS;
  const size_t n_out = (size_t)nob * BS;

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  int* red = reinterpret_cast<int*>(smem + (size_t)ns * kTile);  // [w][v][lane]
  float* sx = reinterpret_cast<float*>(red + kW * kV * 32);
  int8_t* xq = reinterpret_cast<int8_t*>(sx + run * kRT);  // [run][kRT][kXL]
  __shared__ int s_last;

  auto tile_src = [&](int j) {
    const int br = j / nk, k = k0 + j % nk;
    return (br == 0 ? wg : wi) + (((size_t)e * nob + o) * kb + k) * kTile;
  };
  for (int j = 0; j < ns - 1; ++j) {
    if (j < ntile) stage_codes<BS>(ring + j * kTile, tile_src(j), tid, 32 * kW);
    fxp_tc::cp_commit();
  }
  // the activation codes of every slot and row, while the ring fills
  {
    constexpr int kEnc = 4;
    const T* xe = x + ((size_t)e * M + m0) * n_in;
    for (int p0 = warp * kEnc; p0 < nk * kRT; p0 += kW * kEnc)
      encode_rows<T, BS, kEnc>(xe, n_in, idx + (size_t)o * kb + k0, p0,
                               nk * kRT, kRT, rows, xs, e, xq, sx, lane);
  }

  // the value v of a warp's tile that this thread's u-th sum is (each
  // warp owns a quarter of them after the sum over warps), its row in the
  // tile and its output column
  auto val = [&](int u) { return warp * kVO + u; };
  auto row_of = [&](int v) {
    return kMma ? g + 8 * ((v & 3) >> 1) : v >> 2;
  };
  auto col_of = [&](int v) {
    return kMma ? 32 * t + 16 * (v & 1) + (v >> 2)
                : 4 * (lane % kWR) + (v & 3);
  };
  // scratch: per (branch, e, chunk, o, slot) a tile of kRT x 128 fp32
  // sums in this thread order [warp][u][lane]
  const size_t part_tile = (size_t)kRT * 128;
  auto part_at = [&](int br, int k) {
    return part +
           ((((size_t)br * gridDim.z + e) * gridDim.y + ch) * nob + o) * kb *
               part_tile +
           (size_t)k * part_tile + (size_t)warp * kVO * 32 + lane;
  };

  float acc[kVO], gacc[kVO];
#pragma unroll
  for (int u = 0; u < kVO; ++u) acc[u] = gacc[u] = 0.f;
  for (int j = 0; j < ntile; ++j) {
    const int jn = j + ns - 1;
    if (jn < ntile)
      stage_codes<BS>(ring + (jn % ns) * kTile, tile_src(jn), tid, 32 * kW);
    fxp_tc::cp_commit();
    cp_wait_n(ns - 1);
    __syncthreads();
    const int br = j / nk, jj = j % nk, k = k0 + jj;
    const int8_t* tile = ring + (j % ns) * kTile;
    const int8_t* xt = xq + (size_t)jj * kRT * kXL;
    int d[kV];
    if constexpr (kMma)
      dot_mma<kW>(tile, xt, lane, warp, d);
    else
      dot_dp4a<BS, kRT, kW>(tile, xt, lane, warp, d);
#pragma unroll
    for (int v = 0; v < kV; ++v) red[(warp * kV + v) * 32 + lane] = d[v];
    __syncthreads();
    const float sc = (br == 0 ? sg : si)[((size_t)e * nob + o) * kb + k];
    float* pw = nsplit > 1 ? part_at(br, k) : nullptr;
#pragma unroll
    for (int u = 0; u < kVO; ++u) {
      const int v = val(u);
      int dot = 0;
#pragma unroll
      for (int w = 0; w < kW; ++w) dot += red[(w * kV + v) * 32 + lane];
      const float f = __fmul_rn(static_cast<float>(dot),
                                __fmul_rn(sx[jj * kRT + row_of(v)], sc));
      if (nsplit > 1)
        pw[u * 32] = f;
      else
        acc[u] = __fadd_rn(acc[u], f);
    }
    if (kGated && nsplit == 1 && j == nk - 1) {  // wg done: keep g
#pragma unroll
      for (int u = 0; u < kVO; ++u) {
        gacc[u] = acc[u];
        acc[u] = 0.f;
      }
    }
  }

  if (nsplit > 1) {
    // the last block of (e, chunk, o) to finish adds the parts in order
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* ticket = tickets + ((size_t)e * gridDim.y + ch) * nob + o;
      const int seen = atomicAdd(ticket, 1);
      s_last = seen == nsplit - 1;
      if (s_last) *ticket = 0;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    constexpr int kKC = kVO >= 64 ? 1 : 64 / kVO;  // slots whose loads fly together
#pragma unroll
    for (int br = 0; br < kBr; ++br) {
#pragma unroll
      for (int u = 0; u < kVO; ++u) acc[u] = 0.f;
      for (int kc = 0; kc < kb; kc += kKC) {
        float pv[kKC][kVO];
#pragma unroll
        for (int c = 0; c < kKC; ++c)
#pragma unroll
          for (int u = 0; u < kVO; ++u)
            pv[c][u] = kc + c < kb ? __ldcg(part_at(br, kc + c) + u * 32) : 0.f;
#pragma unroll
        for (int c = 0; c < kKC; ++c)
          if (kc + c < kb)
#pragma unroll
            for (int u = 0; u < kVO; ++u) acc[u] = __fadd_rn(acc[u], pv[c][u]);
      }
      if (kGated && br == 0)
#pragma unroll
        for (int u = 0; u < kVO; ++u) gacc[u] = acc[u];
    }
  }

  // the epilogue: bias and act, or silu(g) * u, one store (on the dp4a
  // path the k-groups of a warp hold copies: k-group 0 stores)
  if (!kMma && lane >= kWR) return;
#pragma unroll
  for (int u = 0; u < kVO; ++u) {
    const int v = val(u);
    const int row = row_of(v);
    if (row >= rows) continue;
    const size_t n = (size_t)o * BS + col_of(v);
    const size_t out = ((size_t)e * M + m0 + row) * n_out + n;
    if (kGated) {
      store(&y[out], act_fwd(gacc[u], kSilu) * acc[u]);
    } else {
      const float s = __fadd_rn(acc[u], bias[(size_t)e * n_out + n]);
      store(&y[out], act_fwd(s, act));
    }
  }
}

// The fixed-point junction's operands for fxp_tc::plane_sums.  A: x of
// unit e, the thread's quad u of K tile t (row m0 + q / 8, 4 values from
// k = 32 (t % (BS / 32)) + 4 (q % 8) of slot t / (BS / 32)'s input block,
// q = tid + u * threads; x 16-byte aligned), encoded; rows past M are
// zero codes.
template <typename T, int BS>
struct FxpLoadX {
  static constexpr int kQuadBytes = 4 * sizeof(T);
  const T* xe;       // x[e]
  const int* idx_o;  // idx[o]
  size_t n_in;
  int M, m0;
  float scale, flim;
  __device__ void copy(int t, int u, unsigned char* dst) const {
    constexpr int kTS = BS / fxp_tc::kBK;  // K tiles a slot
    const int q = threadIdx.x + u * fxp_tc::Shape<BS>::kThreads;
    const int m = m0 + (q >> 3);
    const bool ok = m < M;
    const T* p = ok ? xe + (size_t)m * n_in +
                          (size_t)__ldg(idx_o + t / kTS) * BS +
                          (t % kTS) * fxp_tc::kBK + 4 * (q & 7)
                    : xe;
    fxp_tc::cp_async<kQuadBytes>(dst, p, ok);
  }
  __device__ int encode(float v) const {
    return static_cast<int>(
        fminf(fmaxf(rintf(__fmul_rn(v, scale)), -flim), flim - 1.f));
  }
  __device__ void codes(const unsigned char* src, int (&c)[4]) const {
    float v[4];
    if constexpr (sizeof(T) == 4) {
      const float4 r = *reinterpret_cast<const float4*>(src);
      v[0] = r.x;
      v[1] = r.y;
      v[2] = r.z;
      v[3] = r.w;
    } else {  // bf16: the high half of an fp32
      const uint2 r = *reinterpret_cast<const uint2*>(src);
      v[0] = __uint_as_float(r.x << 16);
      v[1] = __uint_as_float(r.x & 0xffff0000u);
      v[2] = __uint_as_float(r.y << 16);
      v[3] = __uint_as_float(r.y & 0xffff0000u);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = encode(v[i]);
  }
};

// B: wq[e, o] as [kb * BS, BS] row-major (16-byte aligned), code row
// 32 t + 4 kq + r of the thread's group, columns 4 nq .. 4 nq + 3.
template <int BS>
struct FxpLoadW {
  const int* wo;  // wq[e, o]
  __device__ void copy(int t, int r, unsigned char* dst) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    fxp_tc::cp_async<16>(
        dst,
        wo + (size_t)(t * fxp_tc::kBK + 4 * (lane & 7) + r) * BS +
            4 * (warp * 4 + (lane >> 3)),
        true);
  }
  __device__ void codes(const unsigned char* const (&rows)[4],
                        int (&c)[4][4]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int4 v = *reinterpret_cast<const int4*>(rows[r]);
      c[r][0] = v.x;
      c[r][1] = v.y;
      c[r][2] = v.z;
      c[r][3] = v.w;
    }
  }
};

// The fixed-point junction: grid (nob * ceil(M / 64), nsplit, E); block
// (o * ceil(M / 64) + row tile, s, e) takes K tiles s * run ..
// min(kb * BS / 32, (s + 1) * run) - 1 of output block o.
template <typename T, int BS>
__global__ void __launch_bounds__(fxp_tc::Shape<BS>::kThreads, 1)
    junction_fxp_kernel(const T* __restrict__ x, const int* __restrict__ wq,
                        const int* __restrict__ idx,
                        const int* __restrict__ qfmt,
                        const float* __restrict__ lut,
                        const float* __restrict__ bias, T* __restrict__ y,
                        uint32_t* __restrict__ part, int* __restrict__ tickets,
                        int M, int nib, int nob, int kb, int n_lut, int run,
                        int nsplit) {
  using namespace fxp_tc;
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int vote[2 * 8];
  __shared__ int s_last;
  const int mtiles = (M + kBM - 1) / kBM;
  const int tile = blockIdx.x, split = blockIdx.y, e = blockIdx.z;
  const int o = tile / mtiles, m0 = (tile % mtiles) * kBM;
  const int t0 = split * run;
  const int nt = min(run, kb * (BS / kBK) - t0);
  const size_t n_in = (size_t)nib * BS;
  const size_t n_out = (size_t)nob * BS;
  const int bf = qfmt[0];
  const float scale = ldexpf(1.f, bf);
  const int lim = n_lut / 2;
  const float flim = static_cast<float>(lim);

  uint32_t v[kVals];
  plane_sums<BS>(
      FxpLoadX<T, BS>{x + (size_t)e * M * n_in, idx + (size_t)o * kb, n_in, M,
                      m0, scale, flim},
      FxpLoadW<BS>{wq + ((size_t)e * nob + o) * kb * BS * BS}, t0, nt, sm,
      vote, v);
  const size_t tile_words = (size_t)kBM * BS;
  if (!combine_splits<BS>(
          v, part + ((size_t)e * gridDim.x + tile) * tile_words,
          (size_t)gridDim.z * gridDim.x * tile_words, split, nsplit,
          tickets + (size_t)e * gridDim.x + tile, &s_last))
    return;

#pragma unroll
  for (int u = 0; u < kVals; ++u) {
    const int m = m0 + row_of<BS>(u);
    if (m >= M) continue;
    const size_t n = (size_t)o * BS + col_of<BS>(u);
    int s = min(max(round_shift(v[u], bf), -lim), lim - 1);
    const float bv = fminf(
        fmaxf(rintf(__fmul_rn(bias[(size_t)e * n_out + n], scale)), -flim),
        flim - 1.f);
    s = min(max(s + static_cast<int>(bv), -lim), lim - 1);
    store(&y[((size_t)e * M + m) * n_out + n], __ldg(lut + (s & (n_lut - 1))));
  }
}

// Dynamic shared memory of an int8 block: the ring, the warps' int32
// sums, the scales and the codes of x.
template <int BS, bool kGated, bool kMma, int kRT>
size_t int8_smem(int run) {
  using L = Int8Layout<BS, kMma, kRT>;
  const int tiles = (kGated ? 2 : 1) * run;
  const int ns = tiles < kInt8Stages ? tiles : kInt8Stages;
  return (size_t)ns * BS * BS + (size_t)L::kWarps * L::kV * 32 * 4 +
         (size_t)run * kRT * 4 + (size_t)run * kRT * (BS + 16);
}

template <typename T, int BS, bool kGated, bool kMma, int kRT>
int launch_int8(const void* x, const void* wg, const void* wi,
                const void* idx, const void* sg, const void* si,
                const void* bias, const void* xs, void* y, void* part,
                void* tickets, int E, int M, int nib, int nob, int kb,
                int act, int rows_blk, int run, int nsplit,
                cudaStream_t stream) {
  auto kernel = junction_int8_kernel<T, BS, kGated, kMma, kRT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = int8_smem<BS, kGated, kMma, kRT>(run);
  if (rows_blk > kRT || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nob * nsplit, (M + rows_blk - 1) / rows_blk, E);
  const int threads = 32 * Int8Layout<BS, kMma, kRT>::kWarps;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wg),
      static_cast<const int8_t*>(wi), static_cast<const int*>(idx),
      static_cast<const float*>(sg), static_cast<const float*>(si),
      static_cast<const float*>(bias), static_cast<const float*>(xs),
      static_cast<T*>(y), static_cast<float*>(part),
      static_cast<int*>(tickets), M, nib, nob, kb, act, rows_blk, run,
      nsplit);
  return (int)cudaGetLastError();
}

// The path for one type, block and gate: mma (block 128 only) on a
// 16-row tile, dp4a on a 4- or 8-row tile.
template <typename T, int BS, bool kGated>
int route_int8(int mma, const void* x, const void* wg, const void* wi,
               const void* idx, const void* sg, const void* si,
               const void* bias, const void* xs, void* y, void* part,
               void* tickets, int E, int M, int nib, int nob, int kb, int act,
               int rows_blk, int run, int nsplit, cudaStream_t stream) {
#define INT8_LAUNCH(MMA, RT)                                               \
  launch_int8<T, BS, kGated, MMA, RT>(x, wg, wi, idx, sg, si, bias, xs, y, \
                                      part, tickets, E, M, nib, nob, kb,   \
                                      act, rows_blk, run, nsplit, stream)
  if (mma) {
    if constexpr (BS == 128)
      return INT8_LAUNCH(true, 16);
    return (int)cudaErrorInvalidValue;
  }
  return rows_blk <= 4 ? INT8_LAUNCH(false, 4) : INT8_LAUNCH(false, 8);
#undef INT8_LAUNCH
}

template <typename T, int BS>
int launch_fxp(const void* x, const void* wq, const void* idx,
               const void* qfmt, const void* lut, const void* bias, void* y,
               void* part, void* tickets, int E, int M, int nib, int nob,
               int kb, int n_lut, int run, int nsplit, cudaStream_t stream) {
  using S = fxp_tc::Shape<BS>;
  constexpr size_t kSmem = S::template smem<FxpLoadX<T, BS>::kQuadBytes>();
  auto kernel = junction_fxp_kernel<T, BS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles =
      (long long)nob * ((M + fxp_tc::kBM - 1) / fxp_tc::kBM);
  if (tiles > 0x7fffffffLL || nsplit > 65535 || E > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(wq) % 16)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)tiles, nsplit, E), S::kThreads, kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(wq),
      static_cast<const int*>(idx), static_cast<const int*>(qfmt),
      static_cast<const float*>(lut), static_cast<const float*>(bias),
      static_cast<T*>(y), static_cast<uint32_t*>(part),
      static_cast<int*>(tickets), M, nib, nob, kb, n_lut, run, nsplit);
  return (int)cudaGetLastError();
}

bool valid(int bs, int kb) {
  return (bs == 32 || bs == 64 || bs == 128) && kb > 0;
}

// The int8 plan of block_sparse_matmul.int8_plan: rows_blk rows a block
// (at most 8 on the dp4a path, 16 on the mma path, which takes block 128
// only), run slots a block, nsplit blocks an output block covering kb.
bool valid_plan(int bs, int kb, int M, int mma, int rows_blk, int run,
                int nsplit, const void* part, const void* tickets) {
  return M > 0 && rows_blk >= 1 && rows_blk <= (mma ? 16 : 8) &&
         (!mma || bs == 128) && run >= 1 && nsplit >= 1 &&
         (nsplit - 1) * run < kb && nsplit * run >= kb &&
         (nsplit == 1 || (part != nullptr && tickets != nullptr));
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
// synchronise.  Weight codes must be 16-byte aligned.  The int8 entry
// points take the plan of block_sparse_matmul.int8_plan (mma, rows_blk,
// run, nsplit) and, for nsplit > 1, fp32 scratch `part` of kBr * E *
// ceil(M / rows_blk) * nob * kb * rows_pad * 128 values (rows_pad =
// rows_blk rounded up to the row tile: 16 on the mma path, 4 up to 4
// rows, else 8; kBr = 2 for the gate) and int32 `tickets`, E *
// ceil(M / rows_blk) * nob of them, zero, left zero.

// The int8 junction; x_scale null: dynamic per-row scales.
extern "C" int junction_fwd_int8(const void* x, const void* wq,
                                 const void* idx, const void* w_scale,
                                 const void* bias, const void* x_scale,
                                 void* y, void* part, void* tickets, int E,
                                 int M, int nib, int nob, int kb, int bs,
                                 int act, int dtype, int mma, int rows_blk,
                                 int run, int nsplit, void* stream) {
  if (!valid(bs, kb) ||
      !valid_plan(bs, kb, M, mma, rows_blk, run, nsplit, part, tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    QUANT_BS_SWITCH((route_int8<float, BS, false>(
        mma, x, wq, nullptr, idx, w_scale, nullptr, bias, x_scale, y, part,
        tickets, E, M, nib, nob, kb, act, rows_blk, run, nsplit, s)))
  }
  if (dtype == 1) {
    QUANT_BS_SWITCH((route_int8<__nv_bfloat16, BS, false>(
        mma, x, wq, nullptr, idx, w_scale, nullptr, bias, x_scale, y, part,
        tickets, E, M, nib, nob, kb, act, rows_blk, run, nsplit, s)))
  }
  return (int)cudaErrorInvalidValue;
}

// The gated int8 junction: h = silu(g) * u.
extern "C" int junction_gated_fwd_int8(
    const void* x, const void* wgq, const void* wiq, const void* idx,
    const void* wg_scale, const void* wi_scale, const void* x_scale, void* h,
    void* part, void* tickets, int E, int M, int nib, int nob, int kb,
    int bs, int dtype, int mma, int rows_blk, int run, int nsplit,
    void* stream) {
  if (!valid(bs, kb) ||
      !valid_plan(bs, kb, M, mma, rows_blk, run, nsplit, part, tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    QUANT_BS_SWITCH((route_int8<float, BS, true>(
        mma, x, wgq, wiq, idx, wg_scale, wi_scale, nullptr, x_scale, h, part,
        tickets, E, M, nib, nob, kb, kSilu, rows_blk, run, nsplit, s)))
  }
  if (dtype == 1) {
    QUANT_BS_SWITCH((route_int8<__nv_bfloat16, BS, true>(
        mma, x, wgq, wiq, idx, wg_scale, wi_scale, nullptr, x_scale, h, part,
        tickets, E, M, nib, nob, kb, kSilu, rows_blk, run, nsplit, s)))
  }
  return (int)cudaErrorInvalidValue;
}

// The fixed-point junction; x and wq 16-byte aligned, n_lut a power of
// two >= 2, qfmt[0] >= 1; the split plan of block_sparse_matmul.fxp_plan:
// 1 <= run <= 256 K tiles of 32 a block, nsplit blocks an output tile
// covering kb * bs / 32 of them; for nsplit > 1, uint32 scratch `part` of
// nsplit * E * nob * ceil(M / 64) * 64 * bs words and int32 `tickets`,
// E * nob * ceil(M / 64) of them, zero, left zero.
extern "C" int junction_fwd_fxp(const void* x, const void* wq,
                                const void* idx, const void* qfmt,
                                const void* lut, const void* bias, void* y,
                                void* part, void* tickets, int E, int M,
                                int nib, int nob, int kb, int bs, int n_lut,
                                int dtype, int run, int nsplit, void* stream) {
  const long long kt = (long long)kb * bs / fxp_tc::kBK;
  if (!valid(bs, kb) || n_lut < 2 || (n_lut & (n_lut - 1)) || M <= 0 ||
      E <= 0 || run < 1 || run > fxp_tc::kChunkTiles || nsplit < 1 ||
      (long long)(nsplit - 1) * run >= kt || (long long)nsplit * run < kt ||
      (nsplit > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    QUANT_BS_SWITCH((launch_fxp<float, BS>(x, wq, idx, qfmt, lut, bias, y,
                                           part, tickets, E, M, nib, nob, kb,
                                           n_lut, run, nsplit, s)))
  }
  if (dtype == 1) {
    QUANT_BS_SWITCH((launch_fxp<__nv_bfloat16, BS>(
        x, wq, idx, qfmt, lut, bias, y, part, tickets, E, M, nib, nob, kb,
        n_lut, run, nsplit, s)))
  }
  return (int)cudaErrorInvalidValue;
}
