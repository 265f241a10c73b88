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
// Design: one launch that writes each output word once, coalesced.
// * Window form: one block per (batch row, slot tile). The block fills
//   its tile's accumulator in shared memory with `fill`, reads the
//   row's M entries (16-byte loads where the rows allow), takes a
//   shared-memory atomicMax for the targets inside its tile, and
//   stores the tile. The sink column, where every masked row lands,
//   is kept in a register per thread and warp-reduced into the tile
//   once, so masked rows cost no contended atomics. A tile is the
//   whole window up to 16,384 slots (64 KB of shared memory, opted in
//   at the first launch of that size); a wider window takes several
//   tiles per row, each re-reading the row's inputs.
// * Narrow form (size + 1 <= 8: the peer-frontier max into [B, R+1]):
//   one warp per batch row, every lane keeping the whole output row in
//   registers (unrolled compares, no atomics), reduced across the warp
//   at the end.
// Max is order-independent, so the result is deterministic.
#include "common.cuh"

#define SM_TILE_MAX 16385  // ints: a 16,384-slot window and its sink
#define SM_THREADS 256
#define NARROW 8  // widest output row of the narrow form
#define NARROW_WARPS 4

// the column an entry lands in: its target, or the sink
__device__ __forceinline__ int sm_col(int t, bool ok, int size) {
  return (!ok || t < 0 || t > size) ? size : t;
}

// VEC: tgt/val 16-byte aligned, ok 4-byte aligned and m % 4 == 0, so
// each thread reads four entries per load
template <bool VEC>
__global__ void __launch_bounds__(SM_THREADS)
mp_scatter_max_tile_k(const int* __restrict__ tgt, const int* __restrict__ val,
                      const unsigned char* __restrict__ ok,
                      int* __restrict__ out, int m, int size, int fill,
                      int n_tiles, int tile) {
  extern __shared__ int acc[];
  const long long b = blockIdx.x / n_tiles;
  const int t0 = (int)(blockIdx.x % n_tiles) * tile;
  const int tw = min(tile, size + 1 - t0);
  for (int j = threadIdx.x; j < tw; j += blockDim.x) acc[j] = fill;
  __syncthreads();
  const int* rt = tgt + b * m;
  const int* rv = val + b * m;
  const unsigned char* ro = ok + b * m;
  int sink = INT_MIN;
  auto put = [&](int t, int v, bool o) {
    const int c = sm_col(t, o, size);
    if (c == size) {
      sink = max(sink, v);
    } else if ((unsigned)(c - t0) < (unsigned)tw) {
      atomicMax(&acc[c - t0], v);
    }
  };
  if (VEC) {
    const int4* t4 = reinterpret_cast<const int4*>(rt);
    const int4* v4 = reinterpret_cast<const int4*>(rv);
    const unsigned* o4 = reinterpret_cast<const unsigned*>(ro);
    for (int i = threadIdx.x; i < (m >> 2); i += blockDim.x) {
      const int4 t = __ldg(t4 + i), v = __ldg(v4 + i);
      const unsigned o = __ldg(o4 + i);
      put(t.x, v.x, o & 0xFFu);
      put(t.y, v.y, (o >> 8) & 0xFFu);
      put(t.z, v.z, (o >> 16) & 0xFFu);
      put(t.w, v.w, o >> 24);
    }
  } else {
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      put(__ldg(rt + i), __ldg(rv + i), __ldg(ro + i) != 0);
  }
  const int ws = __reduce_max_sync(0xffffffffu, sink);
  if ((threadIdx.x & 31) == 0 && ws > INT_MIN && size - t0 < tw)
    atomicMax(&acc[size - t0], ws);
  __syncthreads();
  int* orow = out + b * (long long)(size + 1) + t0;
  for (int j = threadIdx.x; j < tw; j += blockDim.x) orow[j] = acc[j];
}

template <bool VEC>
__global__ void __launch_bounds__(32 * NARROW_WARPS)
mp_scatter_max_narrow_k(const int* __restrict__ tgt,
                        const int* __restrict__ val,
                        const unsigned char* __restrict__ ok,
                        int* __restrict__ out, long long rows, int m, int size,
                        int fill) {
  const long long b = (long long)blockIdx.x * NARROW_WARPS + (threadIdx.x >> 5);
  if (b >= rows) return;
  const int lane = threadIdx.x & 31;
  int acc[NARROW];
#pragma unroll
  for (int k = 0; k < NARROW; ++k) acc[k] = fill;
  auto put = [&](int t, int v, bool o) {
    const int c = sm_col(t, o, size);
#pragma unroll
    for (int k = 0; k < NARROW; ++k)
      if (c == k) acc[k] = max(acc[k], v);
  };
  const int* rt = tgt + b * m;
  const int* rv = val + b * m;
  const unsigned char* ro = ok + b * m;
  if (VEC) {
    const int4* t4 = reinterpret_cast<const int4*>(rt);
    const int4* v4 = reinterpret_cast<const int4*>(rv);
    const unsigned* o4 = reinterpret_cast<const unsigned*>(ro);
    for (int i = lane; i < (m >> 2); i += 32) {
      const int4 t = __ldg(t4 + i), v = __ldg(v4 + i);
      const unsigned o = __ldg(o4 + i);
      put(t.x, v.x, o & 0xFFu);
      put(t.y, v.y, (o >> 8) & 0xFFu);
      put(t.z, v.z, (o >> 16) & 0xFFu);
      put(t.w, v.w, o >> 24);
    }
  } else {
    for (int i = lane; i < m; i += 32)
      put(__ldg(rt + i), __ldg(rv + i), __ldg(ro + i) != 0);
  }
  int mine = fill;
#pragma unroll
  for (int k = 0; k < NARROW; ++k) {
    const int r = __reduce_max_sync(0xffffffffu, acc[k]);
    if (lane == k) mine = r;
  }
  if (lane <= size) out[b * (size + 1) + lane] = mine;
}

template <bool VEC>
static int launch_tile(const int* tgt, const int* val, const unsigned char* ok,
                       int* out, long long rows, int m, int size, int fill,
                       cudaStream_t s) {
  const int width = size + 1;
  const int n_tiles = (width + SM_TILE_MAX - 1) / SM_TILE_MAX;
  const int tile = (width + n_tiles - 1) / n_tiles;
  const size_t smem = (size_t)tile * sizeof(int);
  static size_t optin = 0;
  const int oe = mp_smem_optin((const void*)mp_scatter_max_tile_k<VEC>, smem, &optin);
  if (oe) return oe;
  const long long blocks = rows * n_tiles;
  if (blocks > INT_MAX) return MP_ERR_SHAPE;
  mp_scatter_max_tile_k<VEC><<<(int)blocks, SM_THREADS, smem, s>>>(
      tgt, val, ok, out, m, size, fill, n_tiles, tile);
  return 0;
}

MP_EXPORT int mp_scatter_max(const int* tgt, const int* val,
                             const unsigned char* ok, int* out,
                             long long rows, int m, int size, int fill,
                             cudaStream_t s) {
  if (rows <= 0 || size < 0) return (int)cudaGetLastError();
  const bool vec = m % 4 == 0 && ((uintptr_t)tgt % 16) == 0 &&
                   ((uintptr_t)val % 16) == 0 && ((uintptr_t)ok % 4) == 0;
  if (size + 1 <= NARROW) {
    const long long blocks = (rows + NARROW_WARPS - 1) / NARROW_WARPS;
    if (vec)
      mp_scatter_max_narrow_k<true><<<(int)blocks, 32 * NARROW_WARPS, 0, s>>>(
          tgt, val, ok, out, rows, m, size, fill);
    else
      mp_scatter_max_narrow_k<false><<<(int)blocks, 32 * NARROW_WARPS, 0, s>>>(
          tgt, val, ok, out, rows, m, size, fill);
  } else {
    const int rc = vec ? launch_tile<true>(tgt, val, ok, out, rows, m, size, fill, s)
                       : launch_tile<false>(tgt, val, ok, out, rows, m, size, fill, s);
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}
