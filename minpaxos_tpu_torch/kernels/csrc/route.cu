// K1: the pod-mode routing fabric, plan and gather in one pass.
//
// Replaces ops/segscatter.py route_plan + gather_rows as
// models/cluster.py _route_segmented calls them: per group, the R
// replicas' outbox rows are pooled (N = R * m_out rows, 12 int32
// columns); each destination's inbox receives, in pooled-row order,
// every live row from a live sender that broadcasts from another
// replica (dst -1) or unicasts to it; rows beyond `cap` are dropped,
// and unfilled inbox slots are zero.
//
// Bound: bytes (12 columns written per inbox slot; the plan reads only
// kind and dst). Design: one block per (group, destination). The block
// walks the pooled rows in chunks; a ballot/popc block scan gives each
// destined row its offset (unique by construction, so no atomics), the
// row's 12 columns go straight to that offset, and the walk stops once
// the inbox is full. The tail is zero-filled.
#include "common.cuh"

constexpr int ROUTE_NT = 512;
constexpr int NCOL = 12;

__global__ void __launch_bounds__(ROUTE_NT)
mp_route_k(const int* __restrict__ cols, const int* __restrict__ dst,
           const unsigned char* __restrict__ alive, int* __restrict__ out,
           unsigned char* __restrict__ hit, int G, int R, int m_out, int cap) {
  __shared__ int warp_cnt[ROUTE_NT / 32];
  const int g = blockIdx.x / R, d = blockIdx.x % R;
  const long long N = (long long)R * m_out;
  const long long col_stride = (long long)G * N;
  const long long out_stride = (long long)G * R * cap;
  const int* kind = cols + (long long)g * N;  // column 0 is kind
  const int* dg = dst + (long long)g * N;
  const unsigned char* al = alive + (long long)g * R;
  int* og = out + ((long long)g * R + d) * cap;
  unsigned char* hg = hit + ((long long)g * R + d) * cap;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int base = 0;
  if (al[d]) {
    for (long long c0 = 0; c0 < N && base < cap; c0 += ROUTE_NT) {
      const long long i = c0 + threadIdx.x;
      bool des = false;
      if (i < N && kind[i] != 0) {
        const int src = (int)(i / m_out);
        const int fd = dg[i];
        if (al[src])
          des = (fd == -1 && src != d) ||
                (fd >= 0 && fd < R && fd != src && fd == d);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, des);
      if (lane == 0) warp_cnt[w] = __popc(mask);
      __syncthreads();
      int wpre = 0, tot = 0;
#pragma unroll
      for (int j = 0; j < ROUTE_NT / 32; ++j) {
        const int c = warp_cnt[j];
        wpre += j < w ? c : 0;
        tot += c;
      }
      const int off = base + wpre + __popc(mask & ((1u << lane) - 1u));
      if (des && off < cap) {
#pragma unroll
        for (int c = 0; c < NCOL; ++c)
          og[c * out_stride + off] = cols[c * col_stride + (long long)g * N + i];
        hg[off] = 1;
      }
      base += tot;
      __syncthreads();
    }
  }
  const int filled = base < cap ? base : cap;
  for (int s = filled + threadIdx.x; s < cap; s += ROUTE_NT) {
#pragma unroll
    for (int c = 0; c < NCOL; ++c) og[c * out_stride + s] = 0;
    hg[s] = 0;
  }
}

MP_EXPORT int mp_route(const int* cols, const int* dst,
                       const unsigned char* alive, int* out,
                       unsigned char* hit, int G, int R, int m_out, int cap,
                       cudaStream_t s) {
  if (G > 0 && R > 0 && cap > 0)
    mp_route_k<<<G * R, ROUTE_NT, 0, s>>>(cols, dst, alive, out, hit, G, R,
                                          m_out, cap);
  return (int)cudaGetLastError();
}
