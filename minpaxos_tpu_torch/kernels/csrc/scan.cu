// K3: segmented max-scans and the commit-frontier prefix-AND.
//
// Replaces ops/scan.py: segmented_scan_max and
// exclusive_segmented_scan_max (a lax.associative_scan over the
// segmented-max monoid, used three times per KV apply on [B, E]) and
// commit_frontier (a prefix-AND over the [B, S] committed window).
//
// Bound: bytes; a scan reads each value and flag once and writes one
// value, and the frontier needs only the committed prefix of each row.
// Design: one block per batch row. The segmented scan is a warp-shuffle
// scan of (flag, value) pairs, warp totals combined in shared memory,
// and a carry across chunks of the row; the frontier is a block-wide
// min over the first uncommitted index at or after the start.
#include "common.cuh"

struct SP {
  int f;
  int v;
};

// (r_a, v_a) . (r_b, v_b) = (r_a | r_b, v_b if r_b else max(v_a, v_b))
__device__ __forceinline__ SP comb(SP a, SP b) {
  SP r;
  r.f = a.f | b.f;
  r.v = b.f ? b.v : max(a.v, b.v);
  return r;
}

__device__ __forceinline__ SP warp_scan(SP x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    SP o;
    o.f = __shfl_up_sync(0xffffffffu, x.f, d);
    o.v = __shfl_up_sync(0xffffffffu, x.v, d);
    if (lane >= d) x = comb(o, x);
  }
  return x;
}

constexpr int SCAN_NT = 512;

__global__ void __launch_bounds__(SCAN_NT)
mp_seg_scan_k(const int* __restrict__ vals, const unsigned char* __restrict__ seg,
              int* __restrict__ out, int n, int exclusive, int identity) {
  __shared__ SP warp_tot[SCAN_NT / 32];
  __shared__ int stage[SCAN_NT];
  __shared__ SP carry_s;
  const long long row = blockIdx.x;
  const int* v = vals + row * n;
  const unsigned char* f = seg + row * n;
  int* o = out + row * n;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  SP carry = {0, INT_MIN};  // two-sided identity of the monoid
  for (int base = 0; base < n; base += SCAN_NT) {
    const int i = base + threadIdx.x;
    SP x = {0, INT_MIN};
    if (i < n) {
      x.f = f[i] ? 1 : 0;
      x.v = v[i];
    }
    x = warp_scan(x, lane);
    if (lane == 31) warp_tot[w] = x;
    __syncthreads();
    if (w == 0) {
      SP t = lane < SCAN_NT / 32 ? warp_tot[lane] : SP{0, INT_MIN};
      t = warp_scan(t, lane);
      if (lane < SCAN_NT / 32) warp_tot[lane] = t;
    }
    __syncthreads();
    if (w > 0) x = comb(warp_tot[w - 1], x);
    x = comb(carry, x);
    if (exclusive) {
      stage[threadIdx.x] = x.v;
      __syncthreads();
      if (i < n) {
        const int prev = threadIdx.x > 0 ? stage[threadIdx.x - 1] : carry.v;
        o[i] = (i == 0 || f[i]) ? identity : prev;
      }
    } else if (i < n) {
      o[i] = x.v;
    }
    if (threadIdx.x == SCAN_NT - 1) carry_s = x;
    __syncthreads();
    carry = carry_s;
    __syncthreads();
  }
}

MP_EXPORT int mp_seg_scan_max(const int* vals, const unsigned char* seg,
                              int* out, long long rows, int n,
                              int exclusive, int identity, cudaStream_t s) {
  if (rows > 0 && n > 0)
    mp_seg_scan_k<<<(int)rows, SCAN_NT, 0, s>>>(vals, seg, out, n, exclusive,
                                                identity);
  return (int)cudaGetLastError();
}

__global__ void mp_commit_frontier_k(const unsigned char* __restrict__ committed,
                                     const int* __restrict__ start,
                                     int* __restrict__ out, int n) {
  __shared__ int first_s;
  const long long row = blockIdx.x;
  const unsigned char* c = committed + row * n;
  const int st = start[row];
  const int i0 = st > 0 ? st : 0;
  if (threadIdx.x == 0) first_s = n;
  __syncthreads();
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) {
    if (!c[i]) {
      atomicMin(&first_s, i);
      break;
    }
    if (i > *(volatile int*)&first_s) break;  // a smaller zero exists
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int f = first_s;
    out[row] = (i0 < n && f > i0) ? f - 1 : st - 1;
  }
}

MP_EXPORT int mp_commit_frontier(const unsigned char* committed,
                                 const int* start, int* out, long long rows,
                                 int n, cudaStream_t s) {
  if (rows > 0)
    mp_commit_frontier_k<<<(int)rows, 256, 0, s>>>(committed, start, out, n);
  return (int)cudaGetLastError();
}
