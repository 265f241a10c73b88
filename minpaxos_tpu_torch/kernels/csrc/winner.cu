// K2: keyed slot-winner scatter-max with a sink column.
//
// Replaces the `.at[tgt].max(val, mode="drop")` scatters into [S+1]
// of the JAX step (models/minpaxos.py: PIR ballot max, ACCEPT ballot
// max, fused slot writes A and B, the peer-frontier max) and
// ops/winner.py slot_winner. out[b, s] = max(fill, val[b, i] over rows
// i with ok and tgt == s); masked or out-of-range rows land in column
// `size`, the sink, which callers slice off.
//
// Bound: bytes. Each row is read once (tgt, val, ok: 9 B) and the
// [B, size+1] output written once; there is no arithmetic to speak of.
// Design: one thread per row, atomicMax into the output row; max is
// order-independent, so the result is deterministic. The fill is a
// grid-stride pass launched just before on the same stream.
#include "common.cuh"

__global__ void mp_fill_i32(int* __restrict__ out, long long n, int v) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < n; i += stride) out[i] = v;
}

__global__ void mp_scatter_max_k(const int* __restrict__ tgt,
                                 const int* __restrict__ val,
                                 const unsigned char* __restrict__ ok,
                                 int* __restrict__ out, long long n,
                                 int m, int size) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long b = i / m;
  int t = tgt[i];
  if (!ok[i] || t < 0 || t > size) t = size;
  atomicMax(out + b * (long long)(size + 1) + t, val[i]);
}

MP_EXPORT int mp_scatter_max(const int* tgt, const int* val,
                             const unsigned char* ok, int* out,
                             long long rows, int m, int size, int fill,
                             cudaStream_t s) {
  const long long n_out = rows * (long long)(size + 1);
  long long g = (n_out + 255) / 256;
  if (g > 65536) g = 65536;
  if (n_out > 0) mp_fill_i32<<<(int)g, 256, 0, s>>>(out, n_out, fill);
  const long long n_in = rows * (long long)m;
  if (n_in > 0)
    mp_scatter_max_k<<<mp_grid(n_in, 256), 256, 0, s>>>(tgt, val, ok, out,
                                                        n_in, m, size);
  return (int)cudaGetLastError();
}
