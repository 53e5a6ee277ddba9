// Block-sparse junction kernels on Hopper tensor cores (sm_90a), plain C
// interface, bf16 operands with fp32 accumulation: the forward
// `junction_fwd_tc`, the backward to the input `junction_dx_tc`, the
// weight gradient `junction_dw_tc`, the fused BP+UP update
// `junction_update_dw_tc`, the gated (SwiGLU) forward
// `junction_gated_fwd_tc`, its backward to the input
// `junction_gated_dx_tc`, its weight gradients `junction_gated_dw_tc` and
// the gated fused update `junction_update_gated_dw_tc`.
//
// They compute what the SIMT entry points `junction_fwd`, `junction_dx`,
// `junction_dw`, `junction_update_dw`, `junction_gated_fwd`,
// `junction_gated_dx`, `junction_gated_dw` and `junction_update_gated_dw`
// (junction_fwd.cu, junction_dx.cu, junction_dw.cu) compute, and replace
// the same Pallas TPU kernels, `fwd`, `dx`, `dw`, `update_dw`,
// `gated_fwd`, `gated_dx`, `gated_dw` and `update_gated_dw` (fwd_kernel,
// dx_kernel, dw_kernel, fused_update_dw, gated_fwd_kernel,
// gated_dx_kernel, gated_dw_kernel, fused_update_gated_dw) of
// src/repro/kernels/block_sparse_matmul.py, for bf16; the wrappers' route
// (block_sparse_matmul.junction_variant) chooses the entry point:
//
//   y[e, m, o*bs + c] = act( sum_k sum_i x[e, m, idx[o,k]*bs + i]
//                                        * w[e, o, k, i, c]  + bias[e, o*bs + c] )
//   dx[e, m, i*bs + a] = sum_{f < rev_cnt[i]} sum_c
//       dz[e, m, rev_ob[i,f]*bs + c] * w[e, rev_ob[i,f], rev_t[i,f], a, c]
//   h = silu(g) * u, g and u the forward's sums over wg and wi
//   dw[e, o, k, a, c] = sum_m x[e, m, idx[o,k]*bs + a] * dz[e, m, o*bs + c]
//   w[e, o, k, a, c] <- step(dw[e, o, k, a, c]); the gated forms take
//       dz_g = dh * u * silu'(g) (against wg) and dz_u = dh * silu(g)
//       (against wi): dx sums both streams' products, dw and the update
//       keep one gradient a stream
//
// with the SIMT kernels' rounding points: an fp32 sum (a product of two
// bf16 values is exact in fp32, so only the order of the sum differs),
// the bias widened from bf16, the activation in fp32 and one bf16 store
// (the pre-activation too when `pre` is given; g and u too when given);
// dz = (dy * act'(res)) rounded to bf16 before the product, dz = dy for
// "none", the bias gradient summed from the fp32 dz; dz_g and dz_u
// computed in fp32 from the stored g and u and each rounded to bf16 once;
// the optimizer step of junction_update.cuh on every element (w in bf16,
// the fp32 slots in place, one health flag per (e, o) tile, whichever
// branch of a gated tile went non-finite).
//
// What bounds them: a dense training junction (M = 2048 rows, block 128,
// 2560 -> 6912 at kb 5 or 6912 -> 2560 at kb 14) is 18-19 GFLOP, about
// 19 us at the card's bf16 tensor-core rate, against 40-80 MB of operands
// and outputs (12-23 us of memory; the Adam update moves 127-155 MB,
// 38-46 us); at qwen3-moe's expert junctions (128 experts, M = 160 or
// 4) the bytes bound.  On an H100 at 700 W: fwd 13-18 % of the bf16 rate, dx
// 5-18 % (with an activation each thread recomputes act' once per reverse
// slot that reads an output block, on the path between the barrier and
// the products); gated_fwd 0.284 ms at qwen3's gate junction, M = 160
// (40 % of its bytes bound; 37.5 % of the tiled MMA work is the padding
// of a 32-row second tile), 0.102 at M = 4 (60 %); update_dw 0.21 ms a
// junction without activation (18 % of its bytes bound; 0.39 with silu,
// whose act' the five slots' blocks each recompute), 0.80 ms at qwen3's
// down junction (54 %); dw 0.15 ms a junction without activation, 0.34
// with silu, 0.29 at qwen3's down junction; update_gated_dw (Adam) 1.17
// ms at qwen3's gate junction, M = 160 (56 % of its bytes bound);
// gated_dx 0.37 ms there (31 %), gated_dw 0.42 (41 %).  The SIMT kernels
// ran fp32 FMAs at 1-3 % of the bf16 rate.
//
// Design.  fwd, dx and gated_fwd: a block of two warpgroups owns one
// (unit e, 128-row tile of M, output block o / input block i): a 128-row
// tile of the output in registers, 64 rows a warpgroup, summed by wgmma
// m64nNk16 in fp32.  It walks K in steps of 64 columns (32 at block 32):
// fwd through the kb slots of idx[o], dx through the rev_cnt[i] valid
// slots of the reverse pattern in order (a padded slot is never read, so
// an input block that feeds no output gets exact zeros whatever dy holds;
// no atomics).  Each step's operands go by cp.async into a ring of
// shared-memory stages, the next steps' copies in flight while the tensor
// cores work on this one; rows past M are zero-filled (src-size 0) and
// masked at the store.
// * fwd: A is the gathered x tile (128 rows x 64 columns from column
//   idx[o,k]*bs), K-major in 32-byte swizzled atoms; B is the weight
//   tile w[e,o,k] rows i (K) x bs columns c (N), stored with c
//   contiguous: MN-major, read with the descriptor's transpose bit.
//   The epilogue adds the bias, stores the pre-activation, applies the
//   activation and stores y, from the accumulators.
// * gated_fwd: fwd's tiles with a second weight stream; a block owns 64
//   of an output block's columns (all 32 / 64 at those blocks), so the
//   two m64n64 accumulators fit two blocks an SM, and both products of a
//   K step read the same x tile.  The whole 128 columns at one block an
//   SM were 8 % faster at M = 160 with the residuals and 8 % slower at
//   M = 4 (chip_smoke.py's shapes).
// * dx: B is the weight tile w[e,ob,t] as the forward stores it, rows a
//   (N) x columns c (K), c contiguous: K-major, never gathered or
//   transposed in memory.  A is dz: dy and res are staged as they are
//   (rows padded to 72 elements, so the fragment reads are free of bank
//   conflicts), and each thread computes exactly the dz elements of its
//   own wgmma A fragment, rounds them to bf16 and feeds them from
//   registers.
// * update_dw: a block owns one slot's weight tile (e, o, k), D = dz^T x
//   with K = M, summed in one fixed order by 64-row steps (no atomics, no
//   split of M across blocks).  A = dz^T from registers: dy and res are
//   staged as stored (rows padded by 8 elements) and read transposed by
//   ldmatrix.trans, each thread computing its fragment's dz (and, in the
//   blocks of slot 0, adding its fp32 value to the bias sums); B = the x
//   tile, rows m x columns a contiguous, MN-major.  The sums then leave
//   the registers through shared memory so that the optimizer step reads
//   and writes w and its slots in 16-byte rows, four rows' loads in
//   flight a thread.  Splitting a slot into two 64-column blocks (twice
//   the blocks, against 1.02 waves at two blocks an SM) and a 3-stage
//   ring at one block an SM were slower.
// * dw: the update's reduction (`dw_tc_tile`, the same layout and order)
//   and the same staging through shared memory, then fp32 rows of dw in
//   16-byte stores; so a fused update steps bit for bit the gradient dw
//   stores (the clip pre-pass measures the norm of what it applies).
// * update_gated_dw: two accumulators over one staged x tile; dh, g and u
//   staged as stored and each thread computing its fragments' dz_g and
//   dz_u (silu's sigmoid once for both).  Each branch's sums are staged
//   and stepped in turn.  At block 128 a block owns 64 of a slot's
//   columns in 32-row K steps (two m64n64 accumulators, 60 KB of ring),
//   two blocks an SM.
// * gated_dw: the gated update's reduction (`gated_dw_tc_tile`, at the
//   update's template arguments), so the clipped fused step measures the
//   norm of the gradients it applies; dwg and dwi stored straight from the
//   accumulators.  Bound by its fp32 stores (403 MB at qwen3-moe's gate
//   junction).
// * gated_dx: dx's kernel (`reverse_kernel`) with a second weight
//   stream and dh, g, u staged in place of dy and res; both streams'
//   products of a K step go into one accumulator.  The reverse fan-in of
//   qwen3-moe's gate junction is 1-2 slots, so a block makes only 2-8 K
//   steps, and the ring's fill and the epilogue are much of its life:
//   blocks an SM matter more than ring depth (kGatedDxKS / kGatedDxNA / kGatedDxMinB; PERF.md).
// Two blocks an SM.  A deeper ring (up to 6 stages, one block an SM), a
// wgmma group left in flight across steps, and dz of the next step
// computed under this step's products were each slower on an H100 (fwd,
// dx).  TMA, an mbarrier ring and a producer warp are later work.
#include <cstdint>

#include "junction_update.cuh"

namespace {

using namespace junction;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // rows of a block's tile, 64 a warpgroup
constexpr int kMinBlocks = 2;  // blocks an SM
constexpr int kFwdStages = 3;  // (x, w) stages in the ring of fwd
constexpr int kDxStages = 2;   // (dy, res, w) stages in the ring of dx
constexpr int kUpdStages = 2;  // (x, dy, res) stages in the ring of update

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros (rows past M)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// what this thread's cp.async wrote becomes visible to wgmma
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps reads of wgmma accumulators after the wait that completes them
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor of a tile in 32-byte swizzled atoms:
// start address, leading (lbo) and stride (sbo) byte offsets
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (3ull << 62);
}

// Element (r, d) of a tile of ROWS rows: atoms of 8 rows x 16 columns
// (32 bytes a row), the two 16-byte halves of rows 4-7 swapped (the
// 32-byte swizzle); the atoms of one 16-column block stacked by rows.
// A tile starts 256-byte aligned.
template <int ROWS>
__device__ __forceinline__ int swz(int r, int d) {
  const int c = d >> 3;
  return (c >> 1) * ROWS * 16 + r * 16 + (((c & 1) ^ ((r >> 2) & 1)) << 3) +
         (d & 7);
}

// rounds of the block's threads that copy n 16-byte chunks (the x and dy
// tiles are whole rounds; a weight tile at block 32 is half of one)
__host__ __device__ constexpr int chunk_rounds(int n) {
  return (n + kThreads - 1) / kThreads;
}

// One wgmma m64nNk16 (bf16 in, fp32 accumulate, D += A B) of a
// warpgroup: SsT<N> with A in shared memory K-major and B in shared
// memory MN-major (the transpose bit); Rs<N, TB> with A in registers and
// B in shared memory, K-major (TB 0) or MN-major (TB 1).
template <int N>
struct SsT;
template <int N, int TB>
struct Rs;

template <>
struct SsT<32> {
  __device__ static void run(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct SsT<64> {
  __device__ static void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct SsT<128> {
  __device__ static void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <int TB>
struct Rs<16, TB> {
  __device__ static void run(float (&d)[8], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
          "n"(TB));
  }
};

template <int TB>
struct Rs<32, TB> {
  __device__ static void run(float (&d)[16], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
          "n"(TB));
  }
};

template <int TB>
struct Rs<64, TB> {
  __device__ static void run(float (&d)[32], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
          "n"(TB));
  }
};

template <int TB>
struct Rs<128, TB> {
  __device__ static void run(float (&d)[64], const uint32_t (&a)[4],
                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
          "n"(TB));
  }
};

// ------------------------------------------------------------------ fwd
template <int BS>
struct FwdTile {
  static constexpr int KS = BS < 64 ? BS : 64;  // K columns a step
  static constexpr int AE = kBM * KS;           // x tile, elements
  static constexpr int BE = KS * BS;            // weight tile, elements
  static constexpr int SMEM = kFwdStages * (AE + BE) * 2;  // bytes
};

template <int BS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const int* __restrict__ idx, const bf16* __restrict__ bias,
               bf16* __restrict__ y, bf16* __restrict__ pre, int M, int nib,
               int nob, int kb, int act) {
  using L = FwdTile<BS>;
  constexpr int KS = L::KS, KK = KS / 16, SPS = BS / KS, S = kFwdStages;
  constexpr int AE = L::AE, BE = L::BE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // stage s: the x tile at s (AE + BE), the weight tile after it
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);

  const int o = blockIdx.x, m0 = blockIdx.y * kBM, e = blockIdx.z;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const size_t n_in = (size_t)nib * BS, n_out = (size_t)nob * BS;
  const bf16* xe = x + (size_t)e * M * n_in;
  const bf16* wo = w + ((size_t)e * nob + o) * kb * BS * BS;
  const int* io = idx + (size_t)o * kb;
  const int T = kb * SPS;

  // step t: K columns [j0, j0 + KS) of slot k
  auto load = [&](int t, int st) {
    const int k = t / SPS, j0 = (t % SPS) * KS;
    bf16* const a = sm + st * (AE + BE);
    bf16* const b = a + AE;
    const bf16* xs = xe + (size_t)io[k] * BS + j0;
    constexpr int AC = KS / 8;  // 16-byte chunks of an x row
#pragma unroll
    for (int u = 0; u < chunk_rounds(kBM * AC); ++u) {
      const int q = tid + u * kThreads, r = q / AC, c = q % AC;
      const bool in = m0 + r < M;
      cp_async16(smem_u32(a + swz<kBM>(r, c * 8)),
                 xs + (size_t)(in ? m0 + r : 0) * n_in + c * 8, in ? 16 : 0);
    }
    const bf16* ws = wo + ((size_t)k * BS + j0) * BS;
    constexpr int BC = BS / 8;  // 16-byte chunks of a weight row
#pragma unroll
    for (int u = 0; u < chunk_rounds(KS * BC); ++u) {
      const int q = tid + u * kThreads, r = q / BC, c = q % BC;
      if (q >= KS * BC) break;
      cp_async16(smem_u32(b + swz<KS>(r, c * 8)), ws + (size_t)r * BS + c * 8,
                 16);
    }
  };

  float acc[BS / 2];
#pragma unroll
  for (int i = 0; i < BS / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < T) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    const int st = t % S;
    cp_async_wait<S - 2>();  // this thread's copies of step t landed
    proxy_fence();
    __syncthreads();  // everyone's; and every wgmma of step t - 1 done
    // this warpgroup's 64 rows of the x tile; B's 16-row k-steps, their
    // 16-column atoms KS * 32 bytes apart
    const uint32_t a_addr = smem_u32(sm + st * (AE + BE)) + wgi * 64 * 32;
    const uint32_t b_addr = smem_u32(sm + st * (AE + BE) + AE);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      SsT<BS>::run(acc, desc(a_addr + kk * kBM * 32, 16, 256),
                   desc(b_addr + kk * 16 * 32, KS * 32, 256));
    wg_commit();
    // the stage of step t - 1 is free: fill it with step t + S - 1
    if (t + S - 1 < T) load(t + S - 1, (t + S - 1) % S);
    cp_async_commit();
    wg_wait0();
    pin(acc);
  }

  // accumulator layout: warp wi of the warpgroup holds rows 16 wi + g and
  // + 8; element 4 j + 2 h + q is column 8 j + 2 tig + q of row g + 8 h
  const int lane = tid & 31, wi = (tid >> 5) & 3, g = lane >> 2,
            tig = lane & 3;
  const bf16* be = bias + (size_t)e * n_out + (size_t)o * BS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wgi * 64 + wi * 16 + g + 8 * h;
    if (m >= M) continue;
    const size_t row = ((size_t)e * M + m) * n_out + (size_t)o * BS;
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      const float2 bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(be + c));
      const float s0 = acc[4 * j + 2 * h] + bv.x;
      const float s1 = acc[4 * j + 2 * h + 1] + bv.y;
      if (pre != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(pre + row + c) =
            __floats2bfloat162_rn(s0, s1);
      *reinterpret_cast<__nv_bfloat162*>(y + row + c) =
          __floats2bfloat162_rn(act_fwd(s0, act), act_fwd(s1, act));
    }
  }
}

// ------------------------------------------------------------------- dx
// dx's A producer (reverse_kernel with one weight stream, below): dz of
// elements (r, c) and (r, c + 1) of a stage, as a bf16 pair
__device__ __forceinline__ uint32_t dz_pair(const bf16* d, const bf16* res,
                                            int off, int act) {
  const __nv_bfloat162 dv = *reinterpret_cast<const __nv_bfloat162*>(d + off);
  if (act == kNone) return *reinterpret_cast<const uint32_t*>(&dv);
  const float2 df = __bfloat1622float2(dv);
  const float2 rf = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(res + off));
  const __nv_bfloat162 z = __floats2bfloat162_rn(df.x * act_bwd(rf.x, act),
                                                 df.y * act_bwd(rf.y, act));
  return *reinterpret_cast<const uint32_t*>(&z);
}

// A fragments of the KK k-steps of a stage: rows r0 and r0 + 8, columns
// 16 kk + 2 tig (+ 1) and + 8
template <int KK, int LD, int DE>
__device__ __forceinline__ void fragments(uint32_t (&af)[KK][4],
                                          const bf16* d, int r0, int tig,
                                          int act) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int c = 16 * kk + 2 * tig;
    af[kk][0] = dz_pair(d, d + DE, r0 * LD + c, act);
    af[kk][1] = dz_pair(d, d + DE, (r0 + 8) * LD + c, act);
    af[kk][2] = dz_pair(d, d + DE, r0 * LD + c + 8, act);
    af[kk][3] = dz_pair(d, d + DE, (r0 + 8) * LD + c + 8, act);
  }
}

// ------------------------------------------------------------ gated fwd
// A block owns NC of an output block's BS columns (a column chunk) for
// both weight streams; the x tile is the A of both products.
template <int BS, int NC>
struct GatedTile {
  static constexpr int KS = BS < 64 ? BS : 64;  // K columns a step
  static constexpr int AE = kBM * KS;           // x tile, elements
  static constexpr int BE = KS * NC;            // one stream's weight tile
  static constexpr int SE = AE + 2 * BE;        // a stage, elements
  static constexpr int SMEM = kFwdStages * SE * 2;  // bytes
};

template <int BS, int NC, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    gated_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                     const bf16* __restrict__ wi, const int* __restrict__ idx,
                     bf16* __restrict__ h, bf16* __restrict__ g,
                     bf16* __restrict__ u, int M, int nib, int nob, int kb) {
  using L = GatedTile<BS, NC>;
  constexpr int KS = L::KS, KK = KS / 16, SPS = BS / KS, S = kFwdStages;
  constexpr int AE = L::AE, BE = L::BE, SE = L::SE, CH = BS / NC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // stage s: the x tile at s SE, wg's tile after it, then wi's
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);

  const int o = blockIdx.x / CH, c0 = (blockIdx.x % CH) * NC;
  const int m0 = blockIdx.y * kBM, e = blockIdx.z;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const size_t n_in = (size_t)nib * BS, n_out = (size_t)nob * BS;
  const bf16* xe = x + (size_t)e * M * n_in;
  const size_t wo = ((size_t)e * nob + o) * kb * BS * BS + c0;
  const int* io = idx + (size_t)o * kb;
  const int T = kb * SPS;

  // step t: K columns [j0, j0 + KS) of slot k
  auto load = [&](int t, int st) {
    const int k = t / SPS, j0 = (t % SPS) * KS;
    bf16* const a = sm + st * SE;
    const bf16* xs = xe + (size_t)io[k] * BS + j0;
    constexpr int AC = KS / 8;  // 16-byte chunks of an x row
#pragma unroll
    for (int v = 0; v < chunk_rounds(kBM * AC); ++v) {
      const int q = tid + v * kThreads, r = q / AC, c = q % AC;
      const bool in = m0 + r < M;
      cp_async16(smem_u32(a + swz<kBM>(r, c * 8)),
                 xs + (size_t)(in ? m0 + r : 0) * n_in + c * 8, in ? 16 : 0);
    }
    const size_t ws = wo + ((size_t)k * BS + j0) * BS;
    constexpr int BC = NC / 8;  // 16-byte chunks of a weight row's chunk
#pragma unroll
    for (int v = 0; v < chunk_rounds(KS * BC); ++v) {
      const int q = tid + v * kThreads, r = q / BC, c = q % BC;
      if (q >= KS * BC) break;
      const int so = swz<KS>(r, c * 8);
      const size_t go = ws + (size_t)r * BS + c * 8;
      cp_async16(smem_u32(a + AE + so), wg + go, 16);
      cp_async16(smem_u32(a + AE + BE + so), wi + go, 16);
    }
  };

  float ag[NC / 2], au[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) ag[i] = au[i] = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < T) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    const int st = t % S;
    cp_async_wait<S - 2>();  // this thread's copies of step t landed
    proxy_fence();
    __syncthreads();  // everyone's; and every wgmma of step t - 1 done
    const uint32_t a_addr = smem_u32(sm + st * SE) + wgi * 64 * 32;
    const uint32_t g_addr = smem_u32(sm + st * SE + AE);
    const uint32_t i_addr = g_addr + BE * 2;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t ad = desc(a_addr + kk * kBM * 32, 16, 256);
      SsT<NC>::run(ag, ad, desc(g_addr + kk * 16 * 32, KS * 32, 256));
      SsT<NC>::run(au, ad, desc(i_addr + kk * 16 * 32, KS * 32, 256));
    }
    wg_commit();
    if (t + S - 1 < T) load(t + S - 1, (t + S - 1) % S);
    cp_async_commit();
    wg_wait0();
    pin(ag);
    pin(au);
  }

  // the accumulator layout of fwd_kernel, columns c0 + 8 j + 2 tig (+ 1)
  const int lane = tid & 31, wi4 = (tid >> 5) & 3, gr = lane >> 2,
            tig = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = m0 + wgi * 64 + wi4 * 16 + gr + 8 * hh;
    if (m >= M) continue;
    const size_t row = ((size_t)e * M + m) * n_out + (size_t)o * BS + c0;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      const float g0 = ag[4 * j + 2 * hh], g1 = ag[4 * j + 2 * hh + 1];
      const float u0 = au[4 * j + 2 * hh], u1 = au[4 * j + 2 * hh + 1];
      if (g != nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(g + row + c) =
            __floats2bfloat162_rn(g0, g1);
        *reinterpret_cast<__nv_bfloat162*>(u + row + c) =
            __floats2bfloat162_rn(u0, u1);
      }
      *reinterpret_cast<__nv_bfloat162*>(h + row + c) = __floats2bfloat162_rn(
          act_fwd(g0, kSilu) * u0, act_fwd(g1, kSilu) * u1);
    }
  }
}

// ------------------------------------------------------------ update_dw
// The weight gradient of one slot, D[c, a] = sum_m dz[m, c] x[m, a] (the
// transpose of dw[e, o, k]), as a product with K = M: A = dz^T from
// registers, B = the gathered x tile (rows m, columns a contiguous:
// MN-major).  A block owns (unit e, output block o, slot k, NA of the
// slot's BS columns a).  At block 128 warpgroup w sums rows c in
// [64 w, 64 w + 64) over the NA columns; at blocks 64 and 32 both
// warpgroups take all the block's rows (a 32-row block pads its A with
// zero rows) and half of the columns each.
template <int BS, int NA>
struct UpdTile {
  static constexpr int KM = 64;          // rows of M a step (K)
  static constexpr int LD = BS + 8;      // padded row of the dy / res tile
  static constexpr int XE = KM * NA;     // x tile, elements (swizzled)
  static constexpr int DE = KM * LD;     // dy (or res) tile, elements
  static constexpr int SE = XE + 2 * DE;  // a stage, elements
  static constexpr int SMEM = kUpdStages * SE * 2;  // bytes
  static constexpr int NW = BS == 128 ? NA : NA / 2;  // columns a warpgroup
  static constexpr int LDD = BS + 4;  // padded row of D^T: conflict-free
};

// ldmatrix of four 8 x 8 bf16 tiles, transposed: lane l gives the row
// address of tile l / 8, and receives of tile j the pair (row 2 (l % 4)
// and + 1, column l / 4) in register j
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// dz of a register's two elements (rows m and m + 1 of one column c):
// dy * act'(res) in fp32, rounded to bf16 (dy itself for "none"); with
// `add_db` the fp32 values are added to db, row m first
__device__ __forceinline__ uint32_t dz_t(uint32_t dv, uint32_t rv, int act,
                                         bool add_db, float& db) {
  const float2 df =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv));
  if (act == kNone) {
    if (add_db) {
      db += df.x;
      db += df.y;
    }
    return dv;
  }
  const float2 rf =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv));
  const float f0 = df.x * act_bwd(rf.x, act), f1 = df.y * act_bwd(rf.y, act);
  if (add_db) {
    db += f0;
    db += f1;
  }
  const __nv_bfloat162 z = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<const uint32_t*>(&z);
}

// The block's part of the weight gradient of slot k on tensor cores: the
// fp32 sum over all M rows, in order, of this warpgroup's 64 x NW tile
// D[c, a] (accumulator layout of fwd_kernel: element 4 j + 2 h + q is
// row c = cb + g + 8 h, column a = aw + 8 j + 2 tig + q, with cb and aw
// from upd_place).  With `want_db` (warp-uniform), db[h] receives the
// fp32 sum of dz over this thread's rows m of column cb + g + 8 h; the
// four threads of a quad together hold the column's sum.  `xe`, `dye`
// and `rese` point at unit e's rows; `rese` is null for "none".  The
// update and dw both take this routine, so their sums are one order.
template <int BS, int NA>
__device__ __forceinline__ void dw_tc_tile(
    const bf16* __restrict__ xe, const bf16* __restrict__ dye,
    const bf16* __restrict__ rese, int M, int nib, int nob, int o, int ib,
    int a0, int act, bool want_db, int cb, int aw, bf16* sm,
    float (&acc)[UpdTile<BS, NA>::NW / 2], float (&db)[2]) {
  using L = UpdTile<BS, NA>;
  constexpr int KM = L::KM, KK = KM / 16, LD = L::LD, XE = L::XE,
                DE = L::DE, SE = L::SE, NW = L::NW, S = kUpdStages;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t n_in = (size_t)nib * BS, n_out = (size_t)nob * BS;
  const int T = (M + KM - 1) / KM;

  // step t: rows [t KM, t KM + KM) of x (the slot's columns a0 + a), dy
  // and res (block o's columns)
  auto load = [&](int t, int st) {
    const int m0 = t * KM;
    bf16* const xs = sm + st * SE;
    constexpr int XC = NA / 8;  // 16-byte chunks of an x row
    const bf16* xc = xe + (size_t)ib * BS + a0;
#pragma unroll
    for (int v = 0; v < chunk_rounds(KM * XC); ++v) {
      const int q = tid + v * kThreads, r = q / XC, c = q % XC;
      if (q >= KM * XC) break;
      const bool in = m0 + r < M;
      cp_async16(smem_u32(xs + swz<KM>(r, c * 8)),
                 xc + (size_t)(in ? m0 + r : 0) * n_in + c * 8, in ? 16 : 0);
    }
    bf16* const d = xs + XE;
    constexpr int DC = BS / 8;  // 16-byte chunks of a dy row
#pragma unroll
    for (int v = 0; v < chunk_rounds(KM * DC); ++v) {
      const int q = tid + v * kThreads, r = q / DC, c = q % DC;
      if (q >= KM * DC) break;
      const bool in = m0 + r < M;
      const size_t off =
          (size_t)(in ? m0 + r : 0) * n_out + (size_t)o * BS + c * 8;
      cp_async16(smem_u32(d + r * LD + c * 8), dye + off, in ? 16 : 0);
      if (rese != nullptr)
        cp_async16(smem_u32(d + DE + r * LD + c * 8), rese + off,
                   in ? 16 : 0);
    }
  };

  // this lane's row address in tile j = lane / 8 of a k-step: rows m
  // 8 (j / 2) + lane % 8, columns c from cb + 8 (j % 2)
  const int j4 = lane >> 3;
  const int frag_off = ((j4 >> 1) * 8 + (lane & 7)) * LD + cb + (j4 & 1) * 8;
  const bool rows = cb < BS;  // false: the zero rows of a 32-wide block

#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  db[0] = db[1] = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < T) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    const int st = t % S;
    cp_async_wait<S - 2>();  // this thread's copies of step t landed
    proxy_fence();
    __syncthreads();  // everyone's; and every wgmma of step t - 1 done
    const bf16* d = sm + st * SE + XE;
    uint32_t af[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t dv[4] = {0u, 0u, 0u, 0u}, rv[4] = {0u, 0u, 0u, 0u};
      if (rows) {
        const uint32_t addr = smem_u32(d + kk * 16 * LD + frag_off);
        ldsm_x4_t(dv, addr);
        if (act != kNone) ldsm_x4_t(rv, addr + DE * 2);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        af[kk][q] = dz_t(dv[q], rv[q], act, want_db, db[q & 1]);
    }
    // B's 16-row k-steps; this warpgroup's columns from aw, their
    // 16-column atoms KM * 32 bytes apart
    const uint32_t b_addr = smem_u32(sm + st * SE) + (aw / 16) * KM * 32;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      Rs<NW, 1>::run(acc, af[kk], desc(b_addr + kk * 16 * 32, KM * 32, 256));
    wg_commit();
    if (t + S - 1 < T) load(t + S - 1, (t + S - 1) % S);
    cp_async_commit();
    wg_wait0();
    pin(acc);
  }
}

// this warp's first row c and this warpgroup's first column a (within
// the block's NA) of the product
template <int BS, int NA>
__device__ __forceinline__ void upd_place(int tid, int& cb, int& aw) {
  const int wgi = tid >> 7, wi = (tid >> 5) & 3;
  cb = (BS == 128 ? wgi * 64 : 0) + wi * 16;
  aw = BS == 128 ? 0 : wgi * UpdTile<BS, NA>::NW;
}

// four floats to and from 16-byte aligned memory
__device__ __forceinline__ void ld4(float (&r)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
}
__device__ __forceinline__ void st4(float* p, const float (&r)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}

// The block's sums D[c, a] (dw_tc_tile's accumulator layout) to shared
// memory as D^T [a][c], rows of LDD floats, so that an epilogue reads
// four neighbouring columns c of one row a at a time.  The caller
// synchronises before (the ring is free) and after.
template <int BS, int NA>
__device__ __forceinline__ void stage_dt(
    float* ds, const float (&acc)[UpdTile<BS, NA>::NW / 2], int cb, int aw) {
  constexpr int NW = UpdTile<BS, NA>::NW, LDD = UpdTile<BS, NA>::LDD;
  const int lane = threadIdx.x & 31, gr = lane >> 2, tig = lane & 3;
  if (cb >= BS) return;  // the zero rows of a 32-wide block
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ds[(aw + 8 * j + 2 * tig + q) * LDD + cb + gr + 8 * hh] =
            acc[4 * j + 2 * hh + q];
}

// db of dw_tc_tile summed over the four threads of a quad: each then
// holds the column's fp32 sum over all M rows
__device__ __forceinline__ void quad_sum(float (&db)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    db[hh] += __shfl_xor_sync(0xffffffffu, db[hh], 1);
    db[hh] += __shfl_xor_sync(0xffffffffu, db[hh], 2);
  }
}

// opt_step on the block's NA rows a of one weight tile, from D^T staged
// at ds: each thread steps four neighbouring elements of one row at a
// time, with 16-byte loads and stores of the slots, four such groups'
// loads issued before any of them is stepped.  `wt`, `mom` and `vel`
// point at the tile's row a0 (the slots null where absent).
template <int BS, int NA>
__device__ __forceinline__ void step_tile(const Hyp& h, const float* ds,
                                          bf16* __restrict__ wt,
                                          float* __restrict__ mom,
                                          float* __restrict__ vel,
                                          bool& ok) {
  constexpr int LDD = UpdTile<BS, NA>::LDD;
  constexpr int C4 = BS / 4;  // groups of four columns c in a row
  constexpr int IT = NA * C4 / kThreads;  // groups a thread steps
  constexpr int U = IT < 4 ? IT : 4;      // a batch, loaded before stepped
  static_assert(IT * kThreads == NA * C4 && IT % U == 0, "whole batches");
  const int tid = threadIdx.x;
  for (int i0 = 0; i0 < IT; i0 += U) {
    float g[U][4], w32[U][4], mv[U][4] = {}, vv[U][4] = {};
    size_t off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = tid + (i0 + u) * kThreads, a = i / C4, c = (i % C4) * 4;
      off[u] = (size_t)a * BS + c;
      ld4(g[u], ds + a * LDD + c);
      const uint2 wv = *reinterpret_cast<const uint2*>(wt + off[u]);
      const float2 w01 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&wv.x));
      const float2 w23 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&wv.y));
      w32[u][0] = w01.x, w32[u][1] = w01.y, w32[u][2] = w23.x,
      w32[u][3] = w23.y;
      if (mom != nullptr) ld4(mv[u], mom + off[u]);
      if (vel != nullptr) ld4(vv[u], vel + off[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w32[u][q] = opt_step(h, g[u][q], w32[u][q],
                             mom == nullptr ? nullptr : &mv[u][q],
                             vel == nullptr ? nullptr : &vv[u][q], ok);
      const __nv_bfloat162 n01 = __floats2bfloat162_rn(w32[u][0], w32[u][1]);
      const __nv_bfloat162 n23 = __floats2bfloat162_rn(w32[u][2], w32[u][3]);
      *reinterpret_cast<uint2*>(wt + off[u]) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&n01),
                     *reinterpret_cast<const uint32_t*>(&n23));
      if (mom != nullptr) st4(mom + off[u], mv[u]);
      if (vel != nullptr) st4(vel + off[u], vv[u]);
    }
  }
}

// The fused update of w [E, nob, kb, BS, BS] (bf16) with its fp32 slots
// and, from the blocks of slot 0 and column chunk 0, of b with its slots:
// opt_step on every element as it leaves the sum.  The sums leave the
// registers through shared memory (the stage ring is free by then) for
// step_tile's 16-byte rows.  One health flag per (e, o) tile.
template <int BS, int NA, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    update_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     const bf16* __restrict__ res, const int* __restrict__ idx,
                     const float* __restrict__ hyp, bf16* __restrict__ w,
                     float* __restrict__ mom, float* __restrict__ vel,
                     bf16* __restrict__ b, float* __restrict__ mom_b,
                     float* __restrict__ vel_b, int* __restrict__ bad, int M,
                     int nib, int nob, int kb, int act) {
  constexpr int NW = UpdTile<BS, NA>::NW, CH = BS / NA;
  static_assert(NA * UpdTile<BS, NA>::LDD * 4 <= UpdTile<BS, NA>::SMEM,
                "D^T fits the ring");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  const int k = blockIdx.x / CH, a0 = (blockIdx.x % CH) * NA;
  const int o = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, gr = lane >> 2,
            tig = lane & 3;
  const size_t n_out = (size_t)nob * BS;
  int cb, aw;
  upd_place<BS, NA>(tid, cb, aw);
  // one warpgroup's rows c cover the bias columns once
  const bool want_db = b != nullptr && k == 0 && a0 == 0 && cb < BS &&
                       (BS == 128 || aw == 0);
  float acc[NW / 2], db[2];
  dw_tc_tile<BS, NA>(x + (size_t)e * M * nib * BS, dy + (size_t)e * M * n_out,
                     act != kNone ? res + (size_t)e * M * n_out : nullptr, M,
                     nib, nob, o, idx[(size_t)o * kb + k], a0, act, want_db,
                     cb, aw, sm, acc, db);

  float* const ds = reinterpret_cast<float*>(smem_raw);
  __syncthreads();  // every warpgroup's last products have read the ring
  stage_dt<BS, NA>(ds, acc, cb, aw);
  __syncthreads();

  const Hyp h = hyp_row(hyp, e);
  bool ok = true;
  const size_t st = (((((size_t)e * nob + o) * kb + k) * BS + a0) * BS);
  step_tile<BS, NA>(h, ds, w + st, mom == nullptr ? nullptr : mom + st,
                    vel == nullptr ? nullptr : vel + st, ok);
  if (want_db) {
    quad_sum(db);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (tig == 0) {
        const size_t off =
            (size_t)e * n_out + (size_t)o * BS + cb + gr + 8 * hh;
        const float nb =
            opt_step(h, db[hh], __bfloat162float(b[off]),
                     mom_b == nullptr ? nullptr : mom_b + off,
                     vel_b == nullptr ? nullptr : vel_b + off, ok);
        b[off] = __float2bfloat16(nb);
      }
    }
  }
  if (__syncthreads_or(!ok) && tid == 0)
    atomicOr(&bad[(size_t)e * nob + o], 1);
}

// ------------------------------------------------------------------- dw
// The plain junction's weight gradient, dw [E, nob, kb, BS, BS] in fp32,
// and from the blocks of slot 0 db [E, nob * BS]: dw_tc_tile's sums (the
// routine, the order and the layout of update_tc_kernel, so that a fused
// update steps bit for bit the gradient this kernel stores), staged
// through shared memory and written in 16-byte rows of c.
template <int BS, int NA, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 const bf16* __restrict__ res, const int* __restrict__ idx,
                 float* __restrict__ dw, float* __restrict__ db, int M,
                 int nib, int nob, int kb, int act) {
  using L = UpdTile<BS, NA>;
  constexpr int NW = L::NW, CH = BS / NA, LDD = L::LDD;
  static_assert(NA * LDD * 4 <= L::SMEM, "D^T fits the ring");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  const int k = blockIdx.x / CH, a0 = (blockIdx.x % CH) * NA;
  const int o = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, gr = lane >> 2,
            tig = lane & 3;
  const size_t n_out = (size_t)nob * BS;
  int cb, aw;
  upd_place<BS, NA>(tid, cb, aw);
  const bool want_db = db != nullptr && k == 0 && a0 == 0 && cb < BS &&
                       (BS == 128 || aw == 0);
  float acc[NW / 2], dbs[2];
  dw_tc_tile<BS, NA>(x + (size_t)e * M * nib * BS, dy + (size_t)e * M * n_out,
                     act != kNone ? res + (size_t)e * M * n_out : nullptr, M,
                     nib, nob, o, idx[(size_t)o * kb + k], a0, act, want_db,
                     cb, aw, sm, acc, dbs);

  float* const ds = reinterpret_cast<float*>(smem_raw);
  __syncthreads();  // every warpgroup's last products have read the ring
  stage_dt<BS, NA>(ds, acc, cb, aw);
  __syncthreads();
  float* const dt = dw + ((((size_t)e * nob + o) * kb + k) * BS + a0) * BS;
  constexpr int C4 = BS / 4, IT = NA * C4 / kThreads;
  static_assert(IT * kThreads == NA * C4, "whole rounds");
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int q = tid + i * kThreads, a = q / C4, c = (q % C4) * 4;
    float v[4];
    ld4(v, ds + a * LDD + c);
    st4(dt + (size_t)a * BS + c, v);
  }
  if (want_db) {
    quad_sum(dbs);
    if (tig == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        db[(size_t)e * n_out + (size_t)o * BS + cb + gr + 8 * hh] = dbs[hh];
    }
  }
}

// ------------------------------------------------------ update_gated_dw
// The gated junction's two weight gradients of one slot side by side,
// D_g[c, a] = sum_m dz_g[m, c] x[m, a] and D_u from dz_u likewise, both
// products of a K step reading the same x tile (as gated_fwd shares its
// x tile between two weight streams).  dh, g and u are staged as stored,
// rows padded by 8 elements; each thread computes the dz_g and dz_u of
// its own A fragments.  K steps of KM rows of M; NA and the block's place
// as in update_dw (upd_place).
template <int BS, int NA, int KM>
struct GatedUpdTile {
  static constexpr int LD = BS + 8;        // padded row of dh / g / u
  static constexpr int XE = KM * NA;       // x tile, elements (swizzled)
  static constexpr int DE = KM * LD;       // dh (or g, u) tile, elements
  static constexpr int SE = XE + 3 * DE;   // a stage, elements
  static constexpr int RING = kUpdStages * SE * 2;     // bytes
  static constexpr int DT = NA * UpdTile<BS, NA>::LDD * 4;  // one D^T
  static constexpr int SMEM = RING > DT ? RING : DT;
  static constexpr int NW = UpdTile<BS, NA>::NW;
};

// dz_g and dz_u of a register's two elements (rows m and m + 1 of one
// column c in gated_dw_tc_tile, columns c and c + 1 of one row in
// reverse_kernel): dh * u * silu'(g) and dh * silu(g) in fp32 from the
// stored bf16 values, each rounded to bf16 once (junction_common.cuh's
// gated_dz), silu's sigmoid taken once for both; both backward kernels
// round dz through this one routine.  silu' rounds every step as the
// plain version does (silu_grad: no FMA), so dz_g equals the plain dz_g
// (PERF.md gives the count of elements that differed before)
__device__ __forceinline__ void gated_dz_t(uint32_t dv, uint32_t gv,
                                           uint32_t uv, uint32_t& zg,
                                           uint32_t& zu) {
  const float2 d =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dv));
  const float2 g =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv));
  const float2 u =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&uv));
  const float s0 = 1.f / (1.f + expf(-g.x)), s1 = 1.f / (1.f + expf(-g.y));
  const __nv_bfloat162 a =
      __floats2bfloat162_rn(d.x * u.x * silu_grad(g.x, s0),
                            d.y * u.y * silu_grad(g.y, s1));
  const __nv_bfloat162 b =
      __floats2bfloat162_rn(d.x * (g.x * s0), d.y * (g.y * s1));
  zg = *reinterpret_cast<const uint32_t*>(&a);
  zu = *reinterpret_cast<const uint32_t*>(&b);
}

// The block's part of both gradients of slot k: the fp32 sums over all M
// rows, in order, of this warpgroup's 64 x NW tiles of D_g and D_u (the
// accumulator layout of dw_tc_tile).  `xe`, `dhe`, `ge` and `ue` point at
// unit e's rows.
template <int BS, int NA, int KM>
__device__ __forceinline__ void gated_dw_tc_tile(
    const bf16* __restrict__ xe, const bf16* __restrict__ dhe,
    const bf16* __restrict__ ge, const bf16* __restrict__ ue, int M, int nib,
    int nob, int o, int ib, int a0, int cb, int aw, bf16* sm,
    float (&accg)[GatedUpdTile<BS, NA, KM>::NW / 2],
    float (&accu)[GatedUpdTile<BS, NA, KM>::NW / 2]) {
  using L = GatedUpdTile<BS, NA, KM>;
  constexpr int KK = KM / 16, LD = L::LD, XE = L::XE, DE = L::DE,
                SE = L::SE, NW = L::NW, S = kUpdStages;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t n_in = (size_t)nib * BS, n_out = (size_t)nob * BS;
  const int T = (M + KM - 1) / KM;

  // step t: rows [t KM, t KM + KM) of x (the slot's columns a0 + a), dh,
  // g and u (block o's columns)
  auto load = [&](int t, int st) {
    const int m0 = t * KM;
    bf16* const xs = sm + st * SE;
    constexpr int XC = NA / 8;  // 16-byte chunks of an x row
    const bf16* xc = xe + (size_t)ib * BS + a0;
#pragma unroll
    for (int v = 0; v < chunk_rounds(KM * XC); ++v) {
      const int q = tid + v * kThreads, r = q / XC, c = q % XC;
      if (q >= KM * XC) break;
      const bool in = m0 + r < M;
      cp_async16(smem_u32(xs + swz<KM>(r, c * 8)),
                 xc + (size_t)(in ? m0 + r : 0) * n_in + c * 8, in ? 16 : 0);
    }
    bf16* const d = xs + XE;
    constexpr int DC = BS / 8;  // 16-byte chunks of a dh row
#pragma unroll
    for (int v = 0; v < chunk_rounds(KM * DC); ++v) {
      const int q = tid + v * kThreads, r = q / DC, c = q % DC;
      if (q >= KM * DC) break;
      const bool in = m0 + r < M;
      const size_t off =
          (size_t)(in ? m0 + r : 0) * n_out + (size_t)o * BS + c * 8;
      const uint32_t so = smem_u32(d + r * LD + c * 8);
      cp_async16(so, dhe + off, in ? 16 : 0);
      cp_async16(so + DE * 2, ge + off, in ? 16 : 0);
      cp_async16(so + 2 * DE * 2, ue + off, in ? 16 : 0);
    }
  };

  // this lane's row address in tile j = lane / 8 of a k-step (as in
  // dw_tc_tile)
  const int j4 = lane >> 3;
  const int frag_off = ((j4 >> 1) * 8 + (lane & 7)) * LD + cb + (j4 & 1) * 8;
  const bool rows = cb < BS;  // false: the zero rows of a 32-wide block

#pragma unroll
  for (int i = 0; i < NW / 2; ++i) accg[i] = accu[i] = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < T) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    const int st = t % S;
    cp_async_wait<S - 2>();  // this thread's copies of step t landed
    proxy_fence();
    __syncthreads();  // everyone's; and every wgmma of step t - 1 done
    const bf16* d = sm + st * SE + XE;
    uint32_t ag[KK][4], au[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t dv[4] = {0u, 0u, 0u, 0u}, gv[4] = {0u, 0u, 0u, 0u},
               uv[4] = {0u, 0u, 0u, 0u};
      if (rows) {
        const uint32_t addr = smem_u32(d + kk * 16 * LD + frag_off);
        ldsm_x4_t(dv, addr);
        ldsm_x4_t(gv, addr + DE * 2);
        ldsm_x4_t(uv, addr + 2 * DE * 2);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        gated_dz_t(dv[q], gv[q], uv[q], ag[kk][q], au[kk][q]);
    }
    // B's 16-row k-steps; this warpgroup's columns from aw, their
    // 16-column atoms KM * 32 bytes apart
    const uint32_t b_addr = smem_u32(sm + st * SE) + (aw / 16) * KM * 32;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t bd = desc(b_addr + kk * 16 * 32, KM * 32, 256);
      Rs<NW, 1>::run(accg, ag[kk], bd);
      Rs<NW, 1>::run(accu, au[kk], bd);
    }
    wg_commit();
    if (t + S - 1 < T) load(t + S - 1, (t + S - 1) % S);
    cp_async_commit();
    wg_wait0();
    pin(accg);
    pin(accu);
  }
}

// The fused update of the gated junction: wg and wi [E, nob, kb, BS, BS]
// (bf16) with their fp32 slots, opt_step on every element of both; each
// branch's sums staged through shared memory in turn and stepped in
// step_tile's 16-byte rows.  One health flag per (e, o) tile, whichever
// branch went non-finite.
template <int BS, int NA, int KM, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    update_gated_tc_kernel(
        const bf16* __restrict__ x, const bf16* __restrict__ dh,
        const bf16* __restrict__ g, const bf16* __restrict__ u,
        const int* __restrict__ idx, const float* __restrict__ hyp,
        bf16* __restrict__ wg, bf16* __restrict__ wi, float* __restrict__ mg,
        float* __restrict__ mi, float* __restrict__ vg,
        float* __restrict__ vi, int* __restrict__ bad, int M, int nib,
        int nob, int kb) {
  constexpr int NW = GatedUpdTile<BS, NA, KM>::NW, CH = BS / NA;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  const int k = blockIdx.x / CH, a0 = (blockIdx.x % CH) * NA;
  const int o = blockIdx.y, e = blockIdx.z;
  const size_t ofs = (size_t)e * M * nob * BS;
  int cb, aw;
  upd_place<BS, NA>(threadIdx.x, cb, aw);
  float accg[NW / 2], accu[NW / 2];
  gated_dw_tc_tile<BS, NA, KM>(x + (size_t)e * M * nib * BS, dh + ofs,
                               g + ofs, u + ofs, M, nib, nob, o,
                               idx[(size_t)o * kb + k], a0, cb, aw, sm, accg,
                               accu);

  const Hyp h = hyp_row(hyp, e);
  bool ok = true;
  const size_t st = (((((size_t)e * nob + o) * kb + k) * BS + a0) * BS);
  float* const ds = reinterpret_cast<float*>(smem_raw);
  __syncthreads();  // every warpgroup's last products have read the ring
  stage_dt<BS, NA>(ds, accg, cb, aw);
  __syncthreads();
  step_tile<BS, NA>(h, ds, wg + st, mg == nullptr ? nullptr : mg + st,
                    vg == nullptr ? nullptr : vg + st, ok);
  __syncthreads();  // every thread's reads of D_g^T done
  stage_dt<BS, NA>(ds, accu, cb, aw);
  __syncthreads();
  step_tile<BS, NA>(h, ds, wi + st, mi == nullptr ? nullptr : mi + st,
                    vi == nullptr ? nullptr : vi + st, ok);
  if (__syncthreads_or(!ok) && threadIdx.x == 0)
    atomicOr(&bad[(size_t)e * nob + o], 1);
}

// ------------------------------------------------------------- gated_dw
// The gated junction's weight gradients, dwg and dwi [E, nob, kb, BS, BS]
// in fp32: gated_dw_tc_tile's sums (the routine, the order and the layout
// of update_gated_tc_kernel at the same template arguments, so that the
// fused gated update steps bit for bit the gradients this kernel stores),
// stored straight from the accumulators: a warp's store writes 8
// neighbouring columns c (a 32-byte sector) of 4 rows a.  Staging D^T
// through shared memory for 16-byte rows (dw's epilogue), one branch or
// both at a time, was 3-23 % slower at qwen3-moe's gate junction, M 160,
// on an H100 (PERF.md §6).
template <int BS, int NA, int KM, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    gated_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dh,
                       const bf16* __restrict__ g, const bf16* __restrict__ u,
                       const int* __restrict__ idx, float* __restrict__ dwg,
                       float* __restrict__ dwi, int M, int nib, int nob,
                       int kb) {
  constexpr int NW = GatedUpdTile<BS, NA, KM>::NW, CH = BS / NA;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  const int k = blockIdx.x / CH, a0 = (blockIdx.x % CH) * NA;
  const int o = blockIdx.y, e = blockIdx.z;
  const size_t ofs = (size_t)e * M * nob * BS;
  int cb, aw;
  upd_place<BS, NA>(threadIdx.x, cb, aw);
  float accg[NW / 2], accu[NW / 2];
  gated_dw_tc_tile<BS, NA, KM>(x + (size_t)e * M * nib * BS, dh + ofs,
                               g + ofs, u + ofs, M, nib, nob, o,
                               idx[(size_t)o * kb + k], a0, cb, aw, sm, accg,
                               accu);
  if (cb >= BS) return;  // the zero rows of a 32-wide block

  // element 4 j + 2 hh + q: row c = cb + gr + 8 hh, column a = aw + 8 j +
  // 2 tig + q of D (dw_tc_tile's layout), dw[a][c] of the tile
  const int lane = threadIdx.x & 31, gr = lane >> 2, tig = lane & 3;
  const size_t st = (((((size_t)e * nob + o) * kb + k) * BS + a0) * BS);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const size_t off =
            st + (size_t)(aw + 8 * j + 2 * tig + q) * BS + cb + gr + 8 * hh;
        dwg[off] = accg[4 * j + 2 * hh + q];
        dwi[off] = accu[4 * j + 2 * hh + q];
      }
}

// ------------------------------------------------- dx and gated_dx
// One kernel for both backward junctions to the input: a block owns
// (unit e, 128-row tile of M, NA of input block i's BS columns a) and
// sums the reverse products of every K step of its NW weight streams into
// one fp32 accumulator,
//   dx[m, a] = sum_{f < rev_cnt[i]} sum_c dz[m, c] w[ob, t][a, c]  (NW 1)
//   dx[m, a] = sum_{f < rev_cnt[i]} sum_c dz_g[m, c] wg[ob, t][a, c]
//                                       + dz_u[m, c] wi[ob, t][a, c]  (NW 2),
// walking only the valid reverse slots (an input block that feeds no
// output block gets exact zeros).  K steps of KS of an output block's
// columns c.  B is each stream's forward-layout tile rows a (N) x
// columns c (K), K-major: never transposed in memory.  A = dz from
// registers: the NW + 1 activation tiles (dy and res; dh, g and u) are
// staged as stored, rows padded to KS + 8 elements so that the fragment
// reads are free of bank conflicts, and each thread computes the dz of
// its own A fragments (dz_pair; gated_dz_t).
template <int BS, int KS, int NA, int NW>
struct RevTile {
  static constexpr int LD = KS + 8;      // padded row of an activation tile
  static constexpr int DE = kBM * LD;    // one activation tile
  static constexpr int BE = NA * KS;     // one stream's weight tile
  static constexpr int SE = (NW + 1) * DE + NW * BE;  // a stage, elements
  static constexpr int SMEM = kDxStages * SE * 2;     // bytes
};

// gated_dx's A producer: the dz_g and dz_u A fragments of the KK k-steps
// of a stage (rows r0 and r0 + 8, columns 16 kk + 2 tig (+ 1) and + 8, as
// dx's `fragments`)
template <int KK, int LD, int DE>
__device__ __forceinline__ void gated_fragments(uint32_t (&ag)[KK][4],
                                                uint32_t (&au)[KK][4],
                                                const bf16* d, int r0,
                                                int tig) {
  const auto pair = [&](int off) {
    return *reinterpret_cast<const uint32_t*>(d + off);
  };
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int c = 16 * kk + 2 * tig;
    const int off[4] = {r0 * LD + c, (r0 + 8) * LD + c, r0 * LD + c + 8,
                        (r0 + 8) * LD + c + 8};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      gated_dz_t(pair(off[q]), pair(DE + off[q]), pair(2 * DE + off[q]),
                 ag[kk][q], au[kk][q]);
  }
}

template <int BS, int KS, int NA, int NW, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    reverse_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ res,
                   const bf16* __restrict__ u, const bf16* __restrict__ w0,
                   const bf16* __restrict__ w1,
                   const int* __restrict__ rev_ob,
                   const int* __restrict__ rev_t,
                   const int* __restrict__ rev_cnt, bf16* __restrict__ dx,
                   int M, int nob, int kb, int nib, int fb, int act) {
  using L = RevTile<BS, KS, NA, NW>;
  constexpr int KK = KS / 16, SPS = BS / KS, S = kDxStages, CH = BS / NA;
  constexpr int LD = L::LD, DE = L::DE, BE = L::BE, SE = L::SE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // stage s: the activation tiles at s SE (dy, res; dh, g, u), then the
  // weight tiles (w; wg, wi)
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);

  const int i = blockIdx.x / CH, a0 = (blockIdx.x % CH) * NA;
  const int m0 = blockIdx.y * kBM, e = blockIdx.z;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const size_t n_out = (size_t)nob * BS, n_in = (size_t)nib * BS;
  const size_t ofs = (size_t)e * M * n_out;
  // unit e's activation tiles: dx stages res only for an activation
  const int NT = NW == 2 ? 3 : (act != kNone ? 2 : 1);
  const bf16* const ae[3] = {dy + ofs, NT > 1 ? res + ofs : nullptr,
                             NT > 2 ? u + ofs : nullptr};
  // unit e's weights from row a0 of a tile
  const size_t we = (size_t)e * nob * kb * BS * BS + (size_t)a0 * BS;
  const int* obs = rev_ob + (size_t)i * fb;
  const int* ts = rev_t + (size_t)i * fb;
  const int T = rev_cnt[i] * SPS;

  // step t: K columns [j0, j0 + KS) of valid reverse slot f
  auto load = [&](int t, int st) {
    const int f = t / SPS, j0 = (t % SPS) * KS;
    const int ob = obs[f];
    bf16* const d = sm + st * SE;
    constexpr int AC = KS / 8;  // 16-byte chunks of an activation row
    const size_t col = (size_t)ob * BS + j0;
#pragma unroll
    for (int v = 0; v < chunk_rounds(kBM * AC); ++v) {
      const int q = tid + v * kThreads, r = q / AC, c = q % AC;
      const bool in = m0 + r < M;
      const size_t off = (size_t)(in ? m0 + r : 0) * n_out + col + c * 8;
      const uint32_t so = smem_u32(d + r * LD + c * 8);
#pragma unroll
      for (int p = 0; p < NW + 1; ++p)
        if (p < NT) cp_async16(so + p * DE * 2, ae[p] + off, in ? 16 : 0);
    }
    bf16* const b = d + (NW + 1) * DE;
    const size_t ws = we + ((size_t)ob * kb + ts[f]) * BS * BS + j0;
#pragma unroll
    for (int v = 0; v < chunk_rounds(NA * AC); ++v) {
      const int q = tid + v * kThreads, a = q / AC, c = q % AC;
      if (q >= NA * AC) break;
      const int so = swz<NA>(a, c * 8);
      const size_t go = ws + (size_t)a * BS + c * 8;
      cp_async16(smem_u32(b + so), w0 + go, 16);
      if (NW == 2) cp_async16(smem_u32(b + BE + so), w1 + go, 16);
    }
  };

  const int lane = tid & 31, wi4 = (tid >> 5) & 3, gr = lane >> 2,
            tig = lane & 3;
  const int r0 = wgi * 64 + wi4 * 16 + gr;  // this thread's rows r0, r0 + 8

  float acc[NA / 2];
#pragma unroll
  for (int q = 0; q < NA / 2; ++q) acc[q] = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < T) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    const int st = t % S;
    cp_async_wait<S - 2>();  // this thread's copies of step t landed
    proxy_fence();
    __syncthreads();  // everyone's; and every wgmma of step t - 1 done
    const bf16* d = sm + st * SE;
    uint32_t af[NW][KK][4];
    if constexpr (NW == 1)
      fragments<KK, LD, DE>(af[0], d, r0, tig, act);
    else
      gated_fragments<KK, LD, DE>(af[0], af[1], d, r0, tig);
    // B's 16-column k-steps, NA rows of 32 bytes each, stream after stream
    const uint32_t b_addr = smem_u32(d + (NW + 1) * DE);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int w = 0; w < NW; ++w)
        Rs<NA, 0>::run(acc, af[w][kk],
                       desc(b_addr + w * BE * 2 + kk * NA * 32, 16, 256));
    wg_commit();
    if (t + S - 1 < T) load(t + S - 1, (t + S - 1) % S);
    cp_async_commit();
    wg_wait0();
    pin(acc);
  }

  bf16* const dxi = dx + (size_t)e * M * n_in + (size_t)i * BS + a0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r0 + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < NA / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dxi + (size_t)m * n_in + 8 * j +
                                         2 * tig) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BS>
int launch_fwd(const void* x, const void* w, const void* idx,
               const void* bias, void* y, void* pre, int E, int M, int nib,
               int nob, int kb, int act, cudaStream_t stream) {
  constexpr int SMEM = FwdTile<BS>::SMEM;
  const int err = set_smem(fwd_kernel<BS>, SMEM);
  if (err != 0) return err;
  const dim3 grid(nob, (M + kBM - 1) / kBM, E);
  fwd_kernel<BS><<<grid, kThreads, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(idx), static_cast<const bf16*>(bias),
      static_cast<bf16*>(y), static_cast<bf16*>(pre), M, nib, nob, kb, act);
  return (int)cudaGetLastError();
}

template <int BS, int NC, int MINB>
int launch_gated_fwd(const void* x, const void* wg, const void* wi,
                     const void* idx, void* h, void* g, void* u, int E, int M,
                     int nib, int nob, int kb, cudaStream_t stream) {
  constexpr int SMEM = GatedTile<BS, NC>::SMEM;
  const int err = set_smem(gated_fwd_kernel<BS, NC, MINB>, SMEM);
  if (err != 0) return err;
  const dim3 grid(nob * (BS / NC), (M + kBM - 1) / kBM, E);
  gated_fwd_kernel<BS, NC, MINB><<<grid, kThreads, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wi), static_cast<const int*>(idx),
      static_cast<bf16*>(h), static_cast<bf16*>(g), static_cast<bf16*>(u), M,
      nib, nob, kb);
  return (int)cudaGetLastError();
}

template <int BS, int NA, int MINB>
int launch_update(const void* x, const void* dy, const void* res,
                  const void* idx, const void* hyp, void* w, void* b,
                  void* mom, void* mom_b, void* vel, void* vel_b, void* bad,
                  void* health, int E, int M, int nib, int nob, int kb,
                  int act, cudaStream_t stream) {
  constexpr int SMEM = UpdTile<BS, NA>::SMEM;
  const int err = set_smem(update_tc_kernel<BS, NA, MINB>, SMEM);
  if (err != 0) return err;
  const dim3 grid(kb * (BS / NA), nob, E);
  update_tc_kernel<BS, NA, MINB><<<grid, kThreads, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(res), static_cast<const int*>(idx),
      static_cast<const float*>(hyp), static_cast<bf16*>(w),
      static_cast<float*>(mom), static_cast<float*>(vel),
      static_cast<bf16*>(b), static_cast<float*>(mom_b),
      static_cast<float*>(vel_b), static_cast<int*>(bad), M, nib, nob, kb,
      act);
  const int err2 = (int)cudaGetLastError();
  if (err2 != 0) return err2;
  health_kernel<<<E, 32, 0, stream>>>(static_cast<const int*>(bad),
                                      static_cast<int*>(health), nob);
  return (int)cudaGetLastError();
}

template <int BS, int NA, int MINB>
int launch_dw(const void* x, const void* dy, const void* res,
              const void* idx, void* dw, void* db, int E, int M, int nib,
              int nob, int kb, int act, cudaStream_t stream) {
  constexpr int SMEM = UpdTile<BS, NA>::SMEM;
  const int err = set_smem(dw_tc_kernel<BS, NA, MINB>, SMEM);
  if (err != 0) return err;
  const dim3 grid(kb * (BS / NA), nob, E);
  dw_tc_kernel<BS, NA, MINB><<<grid, kThreads, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(res), static_cast<const int*>(idx),
      static_cast<float*>(dw), static_cast<float*>(db), M, nib, nob, kb, act);
  return (int)cudaGetLastError();
}

template <int BS, int NA, int KM, int MINB>
int launch_update_gated(const void* x, const void* dh, const void* g,
                        const void* u, const void* idx, const void* hyp,
                        void* wg, void* wi, void* mg, void* mi, void* vg,
                        void* vi, void* bad, void* health, int E, int M,
                        int nib, int nob, int kb, cudaStream_t stream) {
  constexpr int SMEM = GatedUpdTile<BS, NA, KM>::SMEM;
  const int err = set_smem(update_gated_tc_kernel<BS, NA, KM, MINB>, SMEM);
  if (err != 0) return err;
  const dim3 grid(kb * (BS / NA), nob, E);
  update_gated_tc_kernel<BS, NA, KM, MINB><<<grid, kThreads, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dh),
      static_cast<const bf16*>(g), static_cast<const bf16*>(u),
      static_cast<const int*>(idx), static_cast<const float*>(hyp),
      static_cast<bf16*>(wg), static_cast<bf16*>(wi), static_cast<float*>(mg),
      static_cast<float*>(mi), static_cast<float*>(vg),
      static_cast<float*>(vi), static_cast<int*>(bad), M, nib, nob, kb);
  const int err2 = (int)cudaGetLastError();
  if (err2 != 0) return err2;
  health_kernel<<<E, 32, 0, stream>>>(static_cast<const int*>(bad),
                                      static_cast<int*>(health), nob);
  return (int)cudaGetLastError();
}

template <int BS, int NA, int KM, int MINB>
int launch_gated_dw(const void* x, const void* dh, const void* g,
                    const void* u, const void* idx, void* dwg, void* dwi,
                    int E, int M, int nib, int nob, int kb,
                    cudaStream_t stream) {
  constexpr int SMEM = GatedUpdTile<BS, NA, KM>::RING;
  const int err = set_smem(gated_dw_tc_kernel<BS, NA, KM, MINB>, SMEM);
  if (err != 0) return err;
  const dim3 grid(kb * (BS / NA), nob, E);
  gated_dw_tc_kernel<BS, NA, KM, MINB><<<grid, kThreads, SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dh),
      static_cast<const bf16*>(g), static_cast<const bf16*>(u),
      static_cast<const int*>(idx), static_cast<float*>(dwg),
      static_cast<float*>(dwi), M, nib, nob, kb);
  return (int)cudaGetLastError();
}

// reverse_kernel: dx (NW 1: dy, res, w; u and w1 null) or gated_dx (NW 2:
// dh, g, u, wg, wi)
template <int BS, int KS, int NA, int NW, int MINB>
int launch_reverse(const void* dy, const void* res, const void* u,
                   const void* w0, const void* w1, const void* rev_ob,
                   const void* rev_t, const void* rev_cnt, void* dx, int E,
                   int M, int nob, int kb, int nib, int fb, int act,
                   cudaStream_t stream) {
  constexpr int SMEM = RevTile<BS, KS, NA, NW>::SMEM;
  const int err = set_smem(reverse_kernel<BS, KS, NA, NW, MINB>, SMEM);
  if (err != 0) return err;
  const dim3 grid(nib * (BS / NA), (M + kBM - 1) / kBM, E);
  reverse_kernel<BS, KS, NA, NW, MINB><<<grid, kThreads, SMEM, stream>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(res),
      static_cast<const bf16*>(u), static_cast<const bf16*>(w0),
      static_cast<const bf16*>(w1), static_cast<const int*>(rev_ob),
      static_cast<const int*>(rev_t), static_cast<const int*>(rev_cnt),
      static_cast<bf16*>(dx), M, nob, kb, nib, fb, act);
  return (int)cudaGetLastError();
}

// The gated update's layout at block 128: 64-column halves of a slot in
// 32-row K steps, two blocks an SM (a block's epilogue overlaps another's
// products).  Whole slots at one block an SM (64- or 32-row steps) and
// halves in 64-row steps at one block an SM were 29-53 % slower on an
// H100 at qwen3-moe's gate junction, M 4 and 160 (PERF.md §6).  gated_dw
// launches the same layout, so that its sums are the update's.
constexpr int kGatedNA = 64, kGatedKM = 32, kGatedMinB = 2;

// The gated dx's layout at block 128: the whole input block a block, K
// steps of 32 columns (94 KB of ring), two blocks an SM.  On an H100 at
// qwen3-moe's gate junction, M 160 and 4 (PERF.md §6),
// 64-column K steps (176 KB, one block an SM) were 36-37 % slower and
// 64-column halves of the input block (dz made twice) 64-136 % slower.
constexpr int kGatedDxKS = 32, kGatedDxNA = 128, kGatedDxMinB = 2;

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

#define JUNCTION_TC_BS_SWITCH(CALL)  \
  switch (bs) {                      \
    case 32: {                       \
      constexpr int BS = 32;         \
      return CALL;                   \
    }                                \
    case 64: {                       \
      constexpr int BS = 64;         \
      return CALL;                   \
    }                                \
    case 128: {                      \
      constexpr int BS = 128;        \
      return CALL;                   \
    }                                \
    default:                         \
      return (int)cudaErrorInvalidValue; \
  }

// Each returns the cudaError_t of its launches (0 on success).  bf16 only;
// the operands that go through cp.async start 16-byte aligned.  They
// launch on `stream`, allocate nothing and do not synchronise.

// The plain junction forward; `pre` may be null.
extern "C" int junction_fwd_tc(const void* x, const void* w, const void* idx,
                               const void* bias, void* y, void* pre, int E,
                               int M, int nib, int nob, int kb, int bs,
                               int act, void* stream) {
  if (E <= 0 || M <= 0 || (M + kBM - 1) / kBM > 65535 || E > 65535 ||
      !aligned16(x) || !aligned16(w) || (uintptr_t)bias % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  JUNCTION_TC_BS_SWITCH((launch_fwd<BS>(x, w, idx, bias, y, pre, E, M, nib,
                                        nob, kb, act, s)))
}

// The plain junction's backward to the input; `res` is null for "none".
extern "C" int junction_dx_tc(const void* dy, const void* res, const void* w,
                              const void* rev_ob, const void* rev_t,
                              const void* rev_cnt, void* dx, int E, int M,
                              int nob, int kb, int nib, int fb, int bs,
                              int act, void* stream) {
  if (E <= 0 || M <= 0 || (M + kBM - 1) / kBM > 65535 || E > 65535 ||
      (act != kNone && (res == nullptr || !aligned16(res))) ||
      !aligned16(dy) || !aligned16(w))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  JUNCTION_TC_BS_SWITCH((launch_reverse<BS, (BS < 64 ? BS : 64), BS, 1,
                                        kMinBlocks>(
      dy, res, nullptr, w, nullptr, rev_ob, rev_t, rev_cnt, dx, E, M, nob, kb,
      nib, fb, act, s)))
}

// The gated junction h = silu(x @ wg) * (x @ wi); g and u (the
// residuals) are both null or both given.
extern "C" int junction_gated_fwd_tc(const void* x, const void* wg,
                                     const void* wi, const void* idx, void* h,
                                     void* g, void* u, int E, int M, int nib,
                                     int nob, int kb, int bs, void* stream) {
  if (E <= 0 || M <= 0 || (M + kBM - 1) / kBM > 65535 || E > 65535 ||
      (g == nullptr) != (u == nullptr) || !aligned16(x) || !aligned16(wg) ||
      !aligned16(wi))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  JUNCTION_TC_BS_SWITCH((launch_gated_fwd<BS, (BS < 64 ? BS : 64), 2>(
      x, wg, wi, idx, h, g, u, E, M, nib, nob, kb, s)))
}

// The fused update of the plain junction: w (bf16, 8-byte aligned), b
// (null: no bias), the fp32 slots (null where absent; vel needs mom; mom
// and vel 16-byte aligned); `bad` [E, nob] int32 zeros, `health` [E]
// int32 written; `res` is null for "none".
extern "C" int junction_update_dw_tc(const void* x, const void* dy,
                                     const void* res, const void* idx,
                                     const void* hyp, void* w, void* b,
                                     void* mom, void* mom_b, void* vel,
                                     void* vel_b, void* bad, void* health,
                                     int E, int M, int nib, int nob, int kb,
                                     int bs, int act, void* stream) {
  if (E <= 0 || M <= 0 || E > 65535 || nob > 65535 ||
      (act != kNone && (res == nullptr || !aligned16(res))) ||
      (vel != nullptr && mom == nullptr) || !aligned16(x) || !aligned16(dy) ||
      (uintptr_t)w % 8 != 0 || !aligned16(mom) || !aligned16(vel))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  JUNCTION_TC_BS_SWITCH((launch_update<BS, BS, 2>(
      x, dy, res, idx, hyp, w, b, mom, mom_b, vel, vel_b, bad, health, E, M,
      nib, nob, kb, act, s)))
}

// The plain junction's weight gradient: dw fp32 [E, nob, kb, bs, bs]
// (16-byte aligned) and, when db is not null, db fp32 [E, nob * bs];
// `res` is null for "none".
extern "C" int junction_dw_tc(const void* x, const void* dy, const void* res,
                              const void* idx, void* dw, void* db, int E,
                              int M, int nib, int nob, int kb, int bs,
                              int act, void* stream) {
  if (E <= 0 || M <= 0 || E > 65535 || nob > 65535 ||
      (act != kNone && (res == nullptr || !aligned16(res))) ||
      !aligned16(x) || !aligned16(dy) || !aligned16(dw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  JUNCTION_TC_BS_SWITCH((launch_dw<BS, BS, 2>(x, dy, res, idx, dw, db, E, M,
                                              nib, nob, kb, act, s)))
}

// The gated junction's fused update: wg and wi (bf16, 8-byte aligned)
// with their fp32 slots (16-byte aligned; mg / mi both null or both
// given, vg / vi likewise, v needs m); `bad` [E, nob] int32 zeros,
// `health` [E] int32 written.
extern "C" int junction_update_gated_dw_tc(
    const void* x, const void* dh, const void* g, const void* u,
    const void* idx, const void* hyp, void* wg, void* wi, void* mg, void* mi,
    void* vg, void* vi, void* bad, void* health, int E, int M, int nib,
    int nob, int kb, int bs, void* stream) {
  if (E <= 0 || M <= 0 || E > 65535 || nob > 65535 || g == nullptr ||
      u == nullptr || (mg == nullptr) != (mi == nullptr) ||
      (vg == nullptr) != (vi == nullptr) || (vg != nullptr && mg == nullptr) ||
      !aligned16(x) || !aligned16(dh) || !aligned16(g) || !aligned16(u) ||
      (uintptr_t)wg % 8 != 0 || (uintptr_t)wi % 8 != 0 || !aligned16(mg) ||
      !aligned16(mi) || !aligned16(vg) || !aligned16(vi))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 32:
      return launch_update_gated<32, 32, 64, 2>(x, dh, g, u, idx, hyp, wg, wi,
                                                mg, mi, vg, vi, bad, health, E,
                                                M, nib, nob, kb, s);
    case 64:
      return launch_update_gated<64, 64, 64, 2>(x, dh, g, u, idx, hyp, wg, wi,
                                                mg, mi, vg, vi, bad, health, E,
                                                M, nib, nob, kb, s);
    case 128:
      return launch_update_gated<128, kGatedNA, kGatedKM, kGatedMinB>(
          x, dh, g, u, idx, hyp, wg, wi, mg, mi, vg, vi, bad, health, E, M,
          nib, nob, kb, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The gated junction's backward to the input, from dh and the residuals
// g and u (all [E, M, nob * bs]) through the forward-layout wg and wi.
extern "C" int junction_gated_dx_tc(const void* dh, const void* g,
                                    const void* u, const void* wg,
                                    const void* wi, const void* rev_ob,
                                    const void* rev_t, const void* rev_cnt,
                                    void* dx, int E, int M, int nob, int kb,
                                    int nib, int fb, int bs, void* stream) {
  if (E <= 0 || M <= 0 || (M + kBM - 1) / kBM > 65535 || E > 65535 ||
      !aligned16(dh) || !aligned16(g) || !aligned16(u) || !aligned16(wg) ||
      !aligned16(wi))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 32:
      return launch_reverse<32, 32, 32, 2, 2>(dh, g, u, wg, wi, rev_ob, rev_t,
                                              rev_cnt, dx, E, M, nob, kb, nib,
                                              fb, kNone, s);
    case 64:
      return launch_reverse<64, 32, 64, 2, 2>(dh, g, u, wg, wi, rev_ob, rev_t,
                                              rev_cnt, dx, E, M, nob, kb, nib,
                                              fb, kNone, s);
    case 128:
      return launch_reverse<128, kGatedDxKS, kGatedDxNA, 2, kGatedDxMinB>(
          dh, g, u, wg, wi, rev_ob, rev_t, rev_cnt, dx, E, M, nob, kb, nib,
          fb, kNone, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The gated junction's weight gradients: dwg and dwi fp32 [E, nob, kb,
// bs, bs] (16-byte aligned), in the layout and order of
// junction_update_gated_dw_tc, from dh and the residuals g and u.
extern "C" int junction_gated_dw_tc(const void* x, const void* dh,
                                    const void* g, const void* u,
                                    const void* idx, void* dwg, void* dwi,
                                    int E, int M, int nib, int nob, int kb,
                                    int bs, void* stream) {
  if (E <= 0 || M <= 0 || E > 65535 || nob > 65535 || !aligned16(x) ||
      !aligned16(dh) || !aligned16(g) || !aligned16(u) || !aligned16(dwg) ||
      !aligned16(dwi))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 32:
      return launch_gated_dw<32, 32, 64, 2>(x, dh, g, u, idx, dwg, dwi, E, M,
                                            nib, nob, kb, s);
    case 64:
      return launch_gated_dw<64, 64, 64, 2>(x, dh, g, u, idx, dwg, dwi, E, M,
                                            nib, nob, kb, s);
    case 128:
      return launch_gated_dw<128, kGatedNA, kGatedKM, kGatedMinB>(
          x, dh, g, u, idx, dwg, dwi, E, M, nib, nob, kb, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
