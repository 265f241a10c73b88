// Shared helpers of the port's CUDA kernels: C export macro, error
// strings, and the key hash of the KV engine.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#define MP_EXPORT extern "C" __attribute__((visibility("default")))

// Codes above CUDA's own: a kernel refused the shape it was given.
#define MP_ERR_SHAPE 10001

MP_EXPORT const char* mp_error_string(int code) {
  if (code == MP_ERR_SHAPE) return "shape not supported by this kernel";
  return cudaGetErrorString((cudaError_t)code);
}

// Opt a kernel in to ``smem`` bytes of dynamic shared memory (above the
// default 48 KB), once per process and size: the attribute is set on
// the first launch, outside any CUDA-graph capture, and later launches
// of the same or a smaller size skip the call. ``done`` is the
// kernel's own record of the size set so far.
static inline int mp_smem_optin(const void* kernel, size_t smem, size_t* done) {
  if (smem <= 48 * 1024 || smem <= *done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *done = smem;
  return 0;
}

static inline int mp_grid(long long n, int threads) {
  long long g = (n + threads - 1) / threads;
  return (int)(g < 1 ? 1 : g);
}

// Block-wide exclusive scan of one int per thread under an associative
// ``op`` with identity ``ident`` (op(ident, x) == x). Every thread of
// the block must call it; blockDim.x is a multiple of 32, at most 1024.
// ``warp_tot`` is 32 ints of shared memory; ``total`` (may be null)
// receives the reduction over the whole block. Ends with a barrier, so
// ``warp_tot`` can be reused at once.
template <typename Op>
__device__ __forceinline__ int mp_block_excl_scan(int x, int* warp_tot,
                                                  int* total, Op op,
                                                  int ident) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (int)(blockDim.x >> 5);
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc = op(y, inc);
  }
  int exc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) exc = ident;
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    int t = lane < nw ? warp_tot[lane] : ident;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t = op(y, t);
    }
    if (lane < nw) warp_tot[lane] = t;
  }
  __syncthreads();
  const int res = w > 0 ? op(warp_tot[w - 1], exc) : exc;
  if (total) *total = warp_tot[nw - 1];
  __syncthreads();
  return res;
}

struct MpSum {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};
struct MpMax {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Floor division and modulo (Python's // and %), for a negative
// dividend as JAX and torch compute them; C's / and % truncate.
__device__ __forceinline__ int mp_floordiv(int a, int b) {
  const int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}
