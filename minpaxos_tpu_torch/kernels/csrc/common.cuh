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

static inline int mp_grid(long long n, int threads) {
  long long g = (n + threads - 1) / threads;
  return (int)(g < 1 ? 1 : g);
}
