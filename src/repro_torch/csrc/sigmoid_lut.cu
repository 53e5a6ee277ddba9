// Table lookup of fixed-point codes for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `lut_lookup` (_kernel) of
// src/repro/kernels/sigmoid_lut.py: out[i] = table[codes[i]] with the
// reference's fill rule (jnp.take's default mode): a code in [0, T)
// indexes the table, a code in [-T, 0) counts from its end, any other
// code gives NaN (0x7fc00000, the plain version's NaN).
//
// codes [n] int32, table [T] fp32, out [n] fp32 (the caller flattens
// the rows).
//
// What bounds it: the bytes of the codes and the output (8 bytes an
// element) and of the table once; no arithmetic to speak of.
//
// Design.  A grid-stride loop, each thread taking four consecutive
// elements at a time with one 16-byte code load and one 16-byte store
// (when both pointers are 16-byte aligned; a scalar loop takes the tail,
// or everything otherwise).  The table is read through __ldg, the
// read-only cache path: the paper's 4096-entry table is 16 KiB and stays
// cached, the (16, 4, 11) table is 256 KiB, more than a block's 227 KB
// of shared memory, so staging it per block is not an option; L1 and
// L2 hold it.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float look(int code, const float* __restrict__ table,
                                      int T) {
  const long long j = code < 0 ? (long long)code + T : (long long)code;
  return (j >= 0 && j < T) ? __ldg(table + j) : __int_as_float(0x7fc00000);
}

__global__ void __launch_bounds__(kThreads)
    lut_lookup_kernel(const int32_t* __restrict__ codes,
                      const float* __restrict__ table, float* __restrict__ out,
                      long long n, long long n_vec, int T) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int4* c4 = reinterpret_cast<const int4*>(codes);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < n_vec; i += stride) {
    const int4 c = c4[i];
    float4 o;
    o.x = look(c.x, table, T);
    o.y = look(c.y, table, T);
    o.z = look(c.z, table, T);
    o.w = look(c.w, table, T);
    o4[i] = o;
  }
  for (long long i = 4 * n_vec + tid; i < n; i += stride)
    out[i] = look(codes[i], table, T);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  Launches on
// `stream`, allocates nothing, does not synchronise.
extern "C" int lut_lookup(const void* codes, const void* table, void* out,
                          long long n, int T, void* stream) {
  if (n <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long n_vec = aligned ? n / 4 : 0;
  const long long work = n_vec + (n - 4 * n_vec);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;   // a full card of blocks, then stride
  lut_lookup_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), static_cast<const float*>(table),
      static_cast<float*>(out), n, n_vec, T);
  return (int)cudaGetLastError();
}
