// The fixed-point kernels' integer product on Hopper's int8 tensor cores
// (fxp_qmatmul.cu, and junction_fwd_fxp in junction_quant.cu): a block's
// [64, BN] tile of sum_k a[m, k] * b[k, n] mod 2^32 for int32 codes a and
// b, from byte planes.
//
// Byte planes.  A code that fits P bytes as a signed number is the sum
// of its planes, c = sum_{i < P} 2^(8i) c_i, with c_i its byte i: u8
// below the top plane, s8 the top one (P = 1 at 8 bits, 2 at 16, 4 for
// any int32).  So a * b = sum over plane pairs (i, j) of 2^(8(i+j))
// a_i b_j, and mod 2^32 only the pairs with i + j <= 3 matter.  Each
// sum over k of a_i b_j is one mma.sync m16n8k32 .s32 with .u8 / .s8
// operands; the pairs of one shift s = i + j share an int32 accumulator
// acc[s], and the block adds acc[0] + acc[1] << 8 + acc[2] << 16 +
// acc[3] << 24 in uint32, which wraps mod 2^32 as the reference's int32
// dot does.  That equals the plain version for every int32 input: an
// integer sum, in any order of k, pairs, warps or blocks.
//
// The K chunk.  The accumulators must never overflow (what mma does with
// an s32 sum past 2^31 is not relied on).  One k adds at most 2 * 255 *
// 255 + 2 * 255 * 128 = 195330 to any acc[s] (shift 3 at P = 4 for both:
// two u8 x u8 pairs and two u8 x s8), so a block takes at most
// kChunkTiles * kBK = 8192 of K (|acc| <= 1.6e9 < 2^31): longer sums
// split over blocks (fxp_qmatmul.split_plan), whose uint32 sums add
// exactly in any order (combine_splits).
//
// Planes a vote asks for.  A vote says, per operand, whether any code
// needs more than one byte (outside [-2^7, 2^7)) or more than two
// (outside [-2^15, 2^15)); the k step runs the plane counts it gives
// (k_step<PA, PB>): 1 product at 8 bits (bw 8), 4 at 16 (bw 10 to 16), up
// to 10 beyond 16 bits.  fxp_qmatmul.cu votes once an operand, while it
// packs the planes into scratch; plane_sums below (junction_fwd_fxp)
// stages each K tile of codes itself and votes a tile.
//
// Layout.  A block has 2 x BN/32 warps, each a 32 x 32 tile of the
// output (2 m16 x 4 n8 mma tiles, four accumulators each).  plane_sums:
// K goes in tiles of kBK = 32 (one m16n8k32 step).  Each thread copies its
// share of a tile's raw codes (16-byte cp.async where the rows allow it, zero-
// filled past the edges) into a ring of kRaw stages, kRaw - 1 tiles
// ahead; it converts only what it copied itself, so its own cp.async
// wait, not a barrier, tells it the data is there.  It writes the planes
// into the other of two plane stages while the block multiplies the
// current one; every thread stages all four planes, and the block reads
// the tile's vote after the barrier that publishes it.  A plane stage
// holds, per plane, A as [64][kBK] and B transposed as [BN][kBK] bytes
// (the MMA takes B K-major), rows padded to 12 words: lane (g, t) reads
// word t (and t + 4) of rows g (and g + 8), 12 g + t mod 32, 32 distinct
// banks.  B is transposed while staging: thread (kq, nq) copies 16-byte
// chunk nq of code rows 4 kq .. 4 kq + 3 and byte-transposes each
// column's four codes into one word a plane.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace fxp_tc {

constexpr int kBM = 64;           // rows of a block tile
constexpr int kBK = 32;           // K a tile (one m16n8k32 step)
constexpr int kRowWords = 12;     // a staged row: 8 words of bytes + 4 pad
constexpr int kPlanes = 4;        // planes staged a code
constexpr int kChunkTiles = 256;  // K tiles a block at most (see above)
constexpr int kVals = 32;         // sums a thread holds (32 x 32 a warp)
constexpr int kRaw = 4;           // raw stages: tiles in flight + 1

// The shape of a block of BN output columns (32, 64 or 128).
template <int BN>
struct Shape {
  static constexpr int kWN = BN / 32;           // warps along N
  static constexpr int kWarps = 2 * kWN;        // and 2 along M
  static constexpr int kThreads = 32 * kWarps;  // = 2 BN
  static constexpr int kAWords = kPlanes * kBM * kRowWords;
  static constexpr int kBWords = kPlanes * BN * kRowWords;
  static constexpr int kStageWords = kAWords + kBWords;
  static constexpr int kAQuads = kBM * kBK / 4 / kThreads;  // A loads a thread
  static_assert(kThreads == 2 * BN, "one 4 x 4 group of B a thread");
  // a raw stage: A quads [u][tid] of QB bytes, B rows [r][tid] of 16
  template <int QB>
  __host__ __device__ static constexpr size_t raw_bytes() {
    return (size_t)kAQuads * kThreads * QB + 4 * kThreads * 16;
  }
  // dynamic shared memory: two plane stages, then the raw ring
  template <int QB>
  __host__ __device__ static constexpr size_t smem() {
    return 2 * (size_t)kStageWords * 4 + kRaw * raw_bytes<QB>();
  }
};

// cp.async of `bytes` (16 by the L2 only, 8 or 4 through L1) from src to
// shared dst; zeros when !valid (src is then not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned n = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


// Columns j of four words a[0..3] -> b[j] = byte j of a[0], a[1], a[2],
// a[3], a[0] in the low byte: with a[r] the codes of four consecutive k,
// b[p] is their plane p.
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

// c ^ (c >> 31) is c for c >= 0 and -c - 1 below: a code needs a second
// byte when that has a bit from bit 7 up, more than two bytes when it has
// one from bit 15 up; OR-ed over codes, the same holds for any of them.
__device__ __forceinline__ unsigned magnitude(int c) {
  return static_cast<unsigned>(c ^ (c >> 31));
}
// The vote bits of an OR of magnitudes: 1 when a second byte is needed,
// 2 when more than two are.
__device__ __forceinline__ int wide_bits(unsigned mag) {
  return ((mag >> 7) ? 1 : 0) | ((mag >> 15) ? 2 : 0);
}

__device__ __forceinline__ int planes_of(int bits) {
  return (bits & 2) ? 4 : ((bits & 1) ? 2 : 1);
}

// D += A (16 x 32, row) * B (32 x 8, col), 8-bit operands, s32 sums;
// kAS / kBS: the operand's plane is signed (s8) or not (u8).  Lane (g, t)
// holds A rows g, g + 8 at k 4t .. 4t+3 (a[0], a[1]) and 16 + 4t ..
// (a[2], a[3]), B column g at the same k (b[0], b[1]), D rows g, g + 8
// at columns 2t, 2t + 1.
template <bool kAS, bool kBS>
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
#define FXP_MMA(AT, BT)                                                     \
  asm("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT                    \
      ".s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"        \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))
  if constexpr (kAS && kBS)
    FXP_MMA("s8", "s8");
  else if constexpr (kAS)
    FXP_MMA("s8", "u8");
  else if constexpr (kBS)
    FXP_MMA("u8", "s8");
  else
    FXP_MMA("u8", "u8");
#undef FXP_MMA
}

// The plane pair (I, J) of a k step, then the next pair.
template <int PA, int PB, int I, int J>
__device__ __forceinline__ void pairs(int (&acc)[4][4],
                                      const uint32_t (&a)[PA][4],
                                      const uint32_t (&b)[PB][2]) {
  if constexpr (I < PA) {
    if constexpr (J < PB && I + J <= 3) {
      mma<I == PA - 1, J == PB - 1>(acc[I + J], a[I], b[J]);
      pairs<PA, PB, I, J + 1>(acc, a, b);
    } else {
      pairs<PA, PB, I + 1, 0>(acc, a, b);
    }
  }
}

// One k step of kBK over a staged tile at PA planes of A (as: [plane][64]
// rows) and PB of B (bs: [plane][BN] rows), rows RW words apart (12 g + t
// and 36 g + t mod 32 both give a warp's reads 32 banks): acc[mt][nt][s]
// += the products of shift s of the warp's m16 tile mt and n8 tile nt.
template <int BN, int PA, int PB, int RW>
__device__ __forceinline__ void k_step(const uint32_t* as, const uint32_t* bs,
                                       int (&acc)[2][4][4][4], int wm, int wn,
                                       int g, int t) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = wm * 32 + mt * 16 + g;
    uint32_t af[PA][4];
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const uint32_t* p = as + (i * kBM + r) * RW + t;
      af[i][0] = p[0];
      af[i][1] = p[8 * RW];
      af[i][2] = p[4];
      af[i][3] = p[8 * RW + 4];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = wn * 32 + nt * 8 + g;
      uint32_t bf[PB][2];
#pragma unroll
      for (int j = 0; j < PB; ++j) {
        const uint32_t* p = bs + (j * BN + n) * RW + t;
        bf[j][0] = p[0];
        bf[j][1] = p[4];
      }
      pairs<PA, PB, 0, 0>(acc[mt][nt], af, bf);
    }
  }
}

template <int BN, int RW = kRowWords>
__device__ __forceinline__ void k_step_at(int pa, int pb, const uint32_t* as,
                                          const uint32_t* bs,
                                          int (&acc)[2][4][4][4], int wm,
                                          int wn, int g, int t) {
#define FXP_STEP(PA, PB) k_step<BN, PA, PB, RW>(as, bs, acc, wm, wn, g, t)
  if (pa == 1) {
    if (pb == 1) FXP_STEP(1, 1);
    else if (pb == 2) FXP_STEP(1, 2);
    else FXP_STEP(1, 4);
  } else if (pa == 2) {
    if (pb == 1) FXP_STEP(2, 1);
    else if (pb == 2) FXP_STEP(2, 2);
    else FXP_STEP(2, 4);
  } else {
    if (pb == 1) FXP_STEP(4, 1);
    else if (pb == 2) FXP_STEP(4, 2);
    else FXP_STEP(4, 4);
  }
#undef FXP_STEP
}

__device__ __forceinline__ void zero_acc(int (&acc)[2][4][4][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][n][s][c] = 0;
}

// The shifted accumulators added mod 2^32: v[16 mt + 4 nt + c] =
// sum over s of acc[mt][nt][s][c] << 8 s, in uint32.
__device__ __forceinline__ void combine_acc(const int (&acc)[2][4][4][4],
                                            uint32_t (&v)[kVals]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[16 * m + 4 * n + c] = static_cast<uint32_t>(acc[m][n][0][c]) +
                                (static_cast<uint32_t>(acc[m][n][1][c]) << 8) +
                                (static_cast<uint32_t>(acc[m][n][2][c]) << 16) +
                                (static_cast<uint32_t>(acc[m][n][3][c]) << 24);
}

// Stage the thread's A codes (quad u: row (tid + u * threads) / 8, k
// 4 ((tid + u * threads) % 8) .. +3) and its B group (b[r][j]: code row
// 4 kq + r, column 4 nq + j; kq = lane % 8, nq = 4 warp + lane / 8) as
// planes; returns the thread's vote: A's bits, B's bits << 2.
template <int BN>
__device__ __forceinline__ int stage(uint32_t* st,
                                     const int (&a)[Shape<BN>::kAQuads][4],
                                     const int (&b)[4][4], int tid) {
  using S = Shape<BN>;
  unsigned ma = 0, mb = 0;
  uint32_t* as = st;
  uint32_t* bs = st + S::kAWords;
#pragma unroll
  for (int u = 0; u < S::kAQuads; ++u) {
    const int q = tid + u * S::kThreads;
    const int r = q >> 3, w = q & 7;
    int p[4];
    transpose4x4(a[u], p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ma |= magnitude(a[u][i]);
      as[(i * kBM + r) * kRowWords + w] = static_cast<uint32_t>(p[i]);
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  const int kq = lane & 7, nq = warp * 4 + (lane >> 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col[4] = {b[0][j], b[1][j], b[2][j], b[3][j]};
    int p[4];
    transpose4x4(col, p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mb |= magnitude(col[i]);
      bs[(i * BN + 4 * nq + j) * kRowWords + kq] = static_cast<uint32_t>(p[i]);
    }
  }
  return wide_bits(ma) | (wide_bits(mb) << 2);
}

// The block's sums over K tiles t0 .. t0 + nt - 1 (1 <= nt <=
// kChunkTiles), combined mod 2^32 into v[u] (u = 16 mt + 4 nt + c: row
// 32 wm + 16 mt + g + 8 (c / 2), column 32 wn + 8 nt + 2 t + c % 2).
// la.copy(t, u, dst) copies A quad u of K tile t (LA::kQuadBytes bytes,
// zeros past the edges) and la.codes(src, c) turns it into 4 int32
// codes; lb.copy(t, r, dst) copies row r of the thread's B group (16
// bytes), lb.codes(rows, c) gives its codes.  smem: Shape<BN>::smem of
// dynamic shared memory; vote: 2 x 8 ints of shared memory.
template <int BN, class LA, class LB>
__device__ __forceinline__ void plane_sums(const LA& la, const LB& lb, int t0,
                                           int nt, unsigned char* smem,
                                           int* vote, uint32_t (&v)[kVals]) {
  using S = Shape<BN>;
  constexpr int QB = LA::kQuadBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / S::kWN, wn = warp % S::kWN;
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem);
  unsigned char* ring = smem + 2 * (size_t)S::kStageWords * 4;
  auto raw_a = [&](int slot, int u) {
    return ring + slot * S::template raw_bytes<QB>() +
           ((size_t)u * S::kThreads + tid) * QB;
  };
  auto raw_b = [&](int slot, int r) {
    return ring + slot * S::template raw_bytes<QB>() +
           (size_t)S::kAQuads * S::kThreads * QB +
           ((size_t)r * S::kThreads + tid) * 16;
  };
  int acc[2][4][4][4];
  zero_acc(acc);

  // tile i's copies into raw slot i % kRaw, one commit group a tile
  auto copy = [&](int i) {
    if (i < nt) {
      const int slot = i % kRaw;
#pragma unroll
      for (int u = 0; u < S::kAQuads; ++u) la.copy(t0 + i, u, raw_a(slot, u));
#pragma unroll
      for (int r = 0; r < 4; ++r) lb.copy(t0 + i, r, raw_b(slot, r));
    }
    cp_commit();
  };
  // tile i (its copies complete) as planes into plane stage i & 1
  auto publish = [&](int i) {
    const int slot = i % kRaw, st = i & 1;
    int ac[S::kAQuads][4], bc[4][4];
#pragma unroll
    for (int u = 0; u < S::kAQuads; ++u) la.codes(raw_a(slot, u), ac[u]);
    const unsigned char* rows[4] = {raw_b(slot, 0), raw_b(slot, 1),
                                    raw_b(slot, 2), raw_b(slot, 3)};
    lb.codes(rows, bc);
    const unsigned bits = __reduce_or_sync(
        0xffffffffu, static_cast<unsigned>(stage<BN>(
                         planes + st * S::kStageWords, ac, bc, tid)));
    if (lane == 0) vote[st * 8 + warp] = static_cast<int>(bits);
  };
#pragma unroll
  for (int i = 0; i < kRaw - 1; ++i) copy(i);
  cp_wait<kRaw - 2>();  // tile 0's group
  publish(0);
  __syncthreads();
  for (int i = 0; i < nt; ++i) {
    const int cur = i & 1;
    int bits = 0;
#pragma unroll
    for (int w = 0; w < S::kWarps; ++w) bits |= vote[cur * 8 + w];
    // the slot of tile i - 1, converted two barriers ago
    copy(i + kRaw - 1);
    const uint32_t* st = planes + cur * S::kStageWords;
    k_step_at<BN>(planes_of(bits & 3), planes_of(bits >> 2), st,
                  st + S::kAWords, acc, wm, wn, g, t);
    if (i + 1 < nt) {
      cp_wait<kRaw - 2>();  // tile i + 1's group
      publish(i + 1);
    }
    __syncthreads();
  }
  cp_wait<0>();
  combine_acc(acc, v);
}

// Row and column in the block tile of the thread's sum u.
template <int BN>
__device__ __forceinline__ int row_of(int u) {
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) / Shape<BN>::kWN;
  return wm * 32 + 16 * (u >> 4) + (lane >> 2) + 8 * ((u >> 1) & 1);
}
template <int BN>
__device__ __forceinline__ int col_of(int u) {
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) % Shape<BN>::kWN;
  return wn * 32 + 8 * ((u >> 2) & 3) + 2 * (lane & 3) + (u & 1);
}

// A K split: every block of a tile writes its sums to part (its split's
// slice, in thread order), and the last to arrive, told by a
// self-resetting ticket, adds all nsplit slices in uint32 into v.
// Returns whether this block holds the tile's whole sums (nsplit == 1, or
// the last block); part_tile: the tile's slice of split 0, split_stride:
// the words between splits.
template <int BN>
__device__ __forceinline__ bool combine_splits(uint32_t (&v)[kVals],
                                               uint32_t* part_tile,
                                               size_t split_stride,
                                               int split, int nsplit,
                                               int* ticket, int* s_last) {
  if (nsplit == 1) return true;
  constexpr int kT = Shape<BN>::kThreads;
  const int tid = threadIdx.x;
  uint32_t* mine = part_tile + (size_t)split * split_stride + tid;
#pragma unroll
  for (int u = 0; u < kVals; ++u) mine[u * kT] = v[u];
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int seen = atomicAdd(ticket, 1);
    *s_last = seen == nsplit - 1;
    if (*s_last) *ticket = 0;
  }
  __syncthreads();
  if (!*s_last) return false;
  __threadfence();
#pragma unroll
  for (int u = 0; u < kVals; ++u) v[u] = 0u;
  for (int s = 0; s < nsplit; ++s) {
    const uint32_t* p = part_tile + (size_t)s * split_stride + tid;
#pragma unroll
    for (int u = 0; u < kVals; ++u) v[u] += __ldcg(p + u * kT);
  }
  return true;
}

// (acc + 2^(bf-1)) >> bf on the wrapped int32 sum: round half up.
__device__ __forceinline__ int round_shift(uint32_t v, int bf) {
  return static_cast<int>(v + (1u << (bf - 1))) >> bf;
}

}  // namespace fxp_tc
