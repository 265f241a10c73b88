// K3: segmented max-scans, the KV apply's segment work, and the
// commit-frontier prefix-AND.
//
// Replaces ops/scan.py: segmented_scan_max and
// exclusive_segmented_scan_max (a lax.associative_scan over the
// segmented-max monoid) and commit_frontier (a prefix-AND over the
// [B, S] committed window), and with it the frontier updates of the
// steps (models/minpaxos.py:900-904, models/mencius.py:529-533 and
// :900-903: the operand, the start and the max in the same launch);
// and, fused in one launch, the segment work
// of ops/kvstore.py kv_apply_batch_lanes (:270-308): the segment starts
// from rolled keys, the exclusive scan for each row's last earlier
// write, and the reversed scan for each key's final writer.
//
// Bound: bytes; a scan reads each value and flag once and writes one
// value, and the frontier needs only the slots from the start through
// the first gap of each row (both operands' when executed is given).
// At the apply's shapes (E <= 512 a row) every launch is near its
// launch floor, so the design cuts launches and barriers.
// Design:
// * seg_scan_max: one block per batch row, a warp-shuffle scan of
//   (flag, value) pairs, warp totals combined in shared memory, and a
//   carry across chunks of the row.
// * kv_segments: one warp per batch row, no shared memory and no
//   barrier. Each lane holds a run of V consecutive elements (V = 4, 8
//   or 16, the least with 32 V >= E; longer rows loop over chunks of
//   32 V with a carry), read with 16-byte loads where the run is whole
//   and aligned. A run becomes two bit masks, segment starts and
//   writes; the forward pass (last write before each element) and the
//   backward pass (a later write in the element's segment) are each a
//   serial pass over the lane's bits and one shuffle scan across the
//   lanes. Positions only grow along a row, so a segment's max write
//   position is its last write.
// * commit_frontier, and advance_frontier (the step's whole frontier
//   update: the operand status >= threshold [| executed], the start
//   upto + 1 - window_base, the scan and the max with upto, in one
//   launch): one warp per batch row, 8 rows a block, no shared memory,
//   no atomics and no barrier. From the 16-byte chunk that holds the
//   start, each lane takes 16 slots (16-byte loads where the row is
//   aligned), compares the bytes four at a time in registers (slots
//   before the start masked off), and one __ballot_sync finds the first
//   lane with a gap; the warp steps 512 slots a time until a gap or the
//   window's end.
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

// ------------------------------------------------------- kv_segments

constexpr int SEGS_WARPS = 4;  // batch rows (warps) per block

// V ints of a row from element i, n of them in range: one 16-byte load
// per 4 when the run is whole and aligned, else one at a time
template <int V>
__device__ __forceinline__ void seg_load_ints(const int* p, int n, int (&o)[V]) {
  if (n >= V && ((uintptr_t)p & 15) == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const int4 x = *reinterpret_cast<const int4*>(p + k);
      o[k] = x.x;
      o[k + 1] = x.y;
      o[k + 2] = x.z;
      o[k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = k < n ? p[k] : 0;
  }
}

// bit k: byte k of V bool bytes is set (0 past n); one 4-, 8- or
// 16-byte load when the run is whole and aligned
template <int V>
__device__ __forceinline__ unsigned seg_load_bits(const unsigned char* p, int n) {
  unsigned w[V / 4];
  if (n >= V && ((uintptr_t)p % V) == 0) {
    if constexpr (V == 4) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else if constexpr (V == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x;
      w[1] = x.y;
    } else {
#pragma unroll
      for (int q = 0; q < V / 4; q += 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(p + 4 * q);
        w[q] = x.x;
        w[q + 1] = x.y;
        w[q + 2] = x.z;
        w[q + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      unsigned x = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * q + k < n) x |= (unsigned)p[4 * q + k] << (8 * k);
      w[q] = x;
    }
  }
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < V / 4; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      bits |= (unsigned)(((w[q] >> (8 * k)) & 0xFFu) != 0) << (4 * q + k);
  return bits;
}

// One chunk of a row (elements [base, base + 32 V)), lane ``lane``'s run
// from i0 = base + lane * V: ``s`` bit k = element i0 + k starts a
// segment (key_hi, key_lo or valid differs from the element before, or
// it is element 0; elements past E each start one), ``w`` bit k = it
// writes. ``nxt`` (lane 31 only) = the element after the chunk starts a
// segment.
template <int V>
__device__ __forceinline__ void seg_run(const int* khi, const int* klo,
                                        const unsigned char* ok,
                                        const unsigned char* wr, int E, int base,
                                        int lane, unsigned& s, unsigned& w,
                                        unsigned& nxt) {
  const int i0 = base + lane * V;
  const int n = min(max(E - i0, 0), V);
  int hi[V], lo[V];
  seg_load_ints<V>(khi + i0, n, hi);
  seg_load_ints<V>(klo + i0, n, lo);
  const unsigned okb = seg_load_bits<V>(ok + i0, n);
  w = seg_load_bits<V>(wr + i0, n);
  // the element before the run: the lane before's last, or for lane 0
  // the element before the chunk
  int phi = __shfl_up_sync(0xffffffffu, hi[V - 1], 1);
  int plo = __shfl_up_sync(0xffffffffu, lo[V - 1], 1);
  unsigned pok = __shfl_up_sync(0xffffffffu, okb >> (V - 1), 1);
  if (lane == 0 && i0 > 0) {
    phi = khi[i0 - 1];
    plo = klo[i0 - 1];
    pok = ok[i0 - 1] != 0;
  }
  s = i0 == 0 || phi != hi[0] || plo != lo[0] || pok != (okb & 1u);
#pragma unroll
  for (int k = 1; k < V; ++k)
    s |= (unsigned)(hi[k] != hi[k - 1] || lo[k] != lo[k - 1] ||
                    ((okb >> k) & 1u) != ((okb >> (k - 1)) & 1u)) << k;
  if (n < V) s |= ((1u << V) - 1u) & (~0u << n);  // past E
  nxt = 1u;
  const int j = base + 32 * V;  // the element after the chunk
  if (lane == 31 && j < E)
    nxt = khi[j] != hi[V - 1] || klo[j] != lo[V - 1] ||
          (unsigned)(ok[j] != 0) != ((okb >> (V - 1)) & 1u);
}

// Forward, one chunk: prev_w of the lane's run. ``carry``: the last
// write of the open segment before the chunk (-1: none).
template <int V>
__device__ __forceinline__ void seg_forward(unsigned s, unsigned w, int i0,
                                            int lane, int E, int* prev,
                                            int& carry) {
  // the lane's total: it starts a segment; the last write at or after
  // its last start (the whole run when it has none)
  const unsigned wm = s ? w & ~((1u << (31 - __clz(s))) - 1u) : w;
  int f = s != 0, v = wm ? i0 + 31 - __clz(wm) : -1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int of = __shfl_up_sync(0xffffffffu, f, d);
    const int ov = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) {
      if (!f) v = max(ov, v);
      f |= of;
    }
  }
  int ef = __shfl_up_sync(0xffffffffu, f, 1);
  int ev = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) ef = 0, ev = -1;
  int cur = ef ? ev : max(carry, ev);
  int o[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if ((s >> k) & 1u) cur = -1;
    o[k] = cur;
    if ((w >> k) & 1u) cur = i0 + k;
  }
  const int n = min(max(E - i0, 0), V);
  int* p = prev + i0;
  if (n == V && ((uintptr_t)p & 15) == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<int4*>(p + k) = make_int4(o[k], o[k + 1], o[k + 2], o[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k < n) p[k] = o[k];
  }
  const int tf = __shfl_sync(0xffffffffu, f, 31);
  const int tv = __shfl_sync(0xffffffffu, v, 31);
  carry = tf ? tv : max(carry, tv);
}

// Backward, one chunk (chunks right to left): is_final_writer of the
// lane's run. ``carry``: the open segment after the chunk has a write.
template <int V>
__device__ __forceinline__ void seg_backward(unsigned s, unsigned w,
                                             unsigned nxt, int i0, int lane,
                                             int E, unsigned char* fin,
                                             int& carry) {
  // end bit k: element i0 + k is its segment's last
  const unsigned ns = __shfl_down_sync(0xffffffffu, s & 1u, 1);
  const unsigned e = (s >> 1) | ((lane == 31 ? nxt : ns) << (V - 1));
  // the lane's total, seen from the left: it ends a segment; a write at
  // or before its first end (the whole run when it has none)
  const unsigned wm = e ? w & ((2u << (__ffs(e) - 1)) - 1u) : w;
  int f = e != 0, v = wm != 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int of = __shfl_down_sync(0xffffffffu, f, d);
    const int ov = __shfl_down_sync(0xffffffffu, v, d);
    if (lane + d < 32) {
      if (!f) v |= ov;
      f |= of;
    }
  }
  int ef = __shfl_down_sync(0xffffffffu, f, 1);
  int ev = __shfl_down_sync(0xffffffffu, v, 1);
  if (lane == 31) ef = 0, ev = 0;
  int later = ef ? ev : (carry | ev);
  unsigned fb = 0;
#pragma unroll
  for (int k = V - 1; k >= 0; --k) {
    if ((e >> k) & 1u) later = 0;
    const unsigned wk = (w >> k) & 1u;
    fb |= (wk & (unsigned)!later) << k;
    later |= (int)wk;
  }
  const int n = min(max(E - i0, 0), V);
  unsigned char* p = fin + i0;
  if (n == V && ((uintptr_t)p % V) == 0) {
    unsigned q[V / 4];
#pragma unroll
    for (int a = 0; a < V / 4; ++a) {
      const unsigned b = (fb >> (4 * a)) & 0xFu;
      q[a] = (b & 1u) | ((b >> 1) & 1u) << 8 | ((b >> 2) & 1u) << 16 | (b >> 3) << 24;
    }
    if constexpr (V == 4) {
      *reinterpret_cast<unsigned*>(p) = q[0];
    } else if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(q[0], q[1]);
    } else {
#pragma unroll
      for (int a = 0; a < V / 4; a += 4)
        *reinterpret_cast<uint4*>(p + 4 * a) = make_uint4(q[a], q[a + 1], q[a + 2], q[a + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k < n) p[k] = (fb >> k) & 1u;
  }
  const int tf = __shfl_sync(0xffffffffu, f, 0);
  const int tv = __shfl_sync(0xffffffffu, v, 0);
  carry = tf ? tv : (carry | tv);
}

template <int V>
__global__ void __launch_bounds__(32 * SEGS_WARPS)
mp_kv_segments_k(const int* __restrict__ khi, const int* __restrict__ klo,
                 const unsigned char* __restrict__ ok,
                 const unsigned char* __restrict__ wr, int* __restrict__ prev,
                 unsigned char* __restrict__ fin, long long rows, int E) {
  const long long row = (long long)blockIdx.x * SEGS_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long rb = row * E;
  khi += rb;
  klo += rb;
  ok += rb;
  wr += rb;
  prev += rb;
  fin += rb;
  const int chunk = 32 * V, nch = (E + chunk - 1) / chunk;
  unsigned s, w, nxt;
  int carry = -1;
  for (int c = 0; c < nch; ++c) {
    seg_run<V>(khi, klo, ok, wr, E, c * chunk, lane, s, w, nxt);
    seg_forward<V>(s, w, c * chunk + lane * V, lane, E, prev, carry);
  }
  // the last chunk's bits are still held; earlier chunks are read again
  carry = 0;
  for (int c = nch - 1; c >= 0; --c) {
    if (c < nch - 1) seg_run<V>(khi, klo, ok, wr, E, c * chunk, lane, s, w, nxt);
    seg_backward<V>(s, w, nxt, c * chunk + lane * V, lane, E, fin, carry);
  }
}

MP_EXPORT int mp_kv_segments(const int* khi, const int* klo,
                             const unsigned char* ok, const unsigned char* wr,
                             int* prev, unsigned char* fin, long long rows,
                             int E, cudaStream_t s) {
  if (rows <= 0 || E <= 0) return (int)cudaGetLastError();
  const int grid = (int)((rows + SEGS_WARPS - 1) / SEGS_WARPS);
  if (E <= 32 * 4)
    mp_kv_segments_k<4><<<grid, 32 * SEGS_WARPS, 0, s>>>(khi, klo, ok, wr, prev, fin, rows, E);
  else if (E <= 32 * 8)
    mp_kv_segments_k<8><<<grid, 32 * SEGS_WARPS, 0, s>>>(khi, klo, ok, wr, prev, fin, rows, E);
  else
    mp_kv_segments_k<16><<<grid, 32 * SEGS_WARPS, 0, s>>>(khi, klo, ok, wr, prev, fin, rows, E);
  return (int)cudaGetLastError();
}

// --------------------------------------------------- commit_frontier

constexpr int CF_WARPS = 8;  // batch rows (warps) per block

// Four words of the 16 bytes at p, bytes [0, n) of them (n <= 16), the
// rest 0: one 16-byte load when whole and ``vec``.
__device__ __forceinline__ void cf_load16(const unsigned char* p, int n, bool vec,
                                          unsigned (&w)[4]) {
  if (vec && n == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned x = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * q + k < n) x |= (unsigned)p[4 * q + k] << (8 * k);
    w[q] = x;
  }
}

// One warp per batch row: out = the largest f with every slot of
// [start, f] done, else start - 1 (the slots before 0 not looked at).
// Done: status >= thr, or executed (when given). With ``upto`` the start
// is upto + 1 - wbase and out = max(upto, f + wbase) (int32 wrapping, as
// JAX's); else the start is ``start`` and out = f.
__global__ void __launch_bounds__(32 * CF_WARPS)
mp_frontier_k(const unsigned char* __restrict__ status,
              const unsigned char* __restrict__ executed, unsigned thr,
              const int* __restrict__ start, const int* __restrict__ upto,
              const int* __restrict__ wbase, int* __restrict__ out,
              long long rows, int S, int vec) {
  const long long row = (long long)blockIdx.x * CF_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int up = upto != nullptr ? upto[row] : 0;
  const int wb = upto != nullptr ? wbase[row] : 0;
  const int st = upto != nullptr ? (int)((unsigned)up + 1u - (unsigned)wb) : start[row];
  const int i0 = st > 0 ? st : 0;
  const unsigned char* srow = status + row * S;
  const unsigned char* erow = executed != nullptr ? executed + row * S : nullptr;
  const unsigned thr4 = thr * 0x01010101u;
  int first = S;  // the first slot at or after i0 that is not done
  for (int base = i0 & ~15; base < S; base += 512) {
    const int c = base + 16 * lane;  // the lane's 16 slots
    const int n = min(max(S - c, 0), 16), lo = min(max(i0 - c, 0), 16);
    unsigned sw[4], ew[4] = {0, 0, 0, 0};
    cf_load16(srow + c, n, vec, sw);
    if (erow != nullptr) cf_load16(erow + c, n, vec, ew);
    int pos = 16;  // the lane's first gap
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      const unsigned ix = 0x03020100u + 0x04040404u * q;  // the bytes' indices
      const unsigned live = __vcmpgeu4(ix, lo * 0x01010101u) & __vcmpltu4(ix, n * 0x01010101u);
      const unsigned gap = live & ~(__vcmpgeu4(sw[q], thr4) | __vcmpne4(ew[q], 0u));
      if (gap) pos = 4 * q + ((__ffs(gap) - 1) >> 3);
    }
    const unsigned hit = __ballot_sync(full, pos < 16);
    if (hit) {
      const int l = __ffs(hit) - 1;
      first = base + 16 * l + __shfl_sync(full, pos, l);
      break;
    }
  }
  if (lane == 0) {
    const int f = (i0 < S && first > i0) ? first - 1 : (int)((unsigned)st - 1u);
    if (upto == nullptr) {
      out[row] = f;
    } else {
      const int g = (int)((unsigned)f + (unsigned)wb);
      out[row] = g > up ? g : up;
    }
  }
}

static int cf_launch(const unsigned char* status, const unsigned char* executed,
                     unsigned thr, const int* start, const int* upto,
                     const int* wbase, int* out, long long rows, int n,
                     cudaStream_t s) {
  if (n < 0 || thr > 255) return MP_ERR_SHAPE;
  if (rows <= 0) return (int)cudaGetLastError();
  const long long grid = (rows + CF_WARPS - 1) / CF_WARPS;
  if (grid > 0x7fffffffLL) return MP_ERR_SHAPE;
  const int vec = n % 16 == 0 && (((uintptr_t)status | (uintptr_t)executed) % 16) == 0;
  mp_frontier_k<<<(int)grid, 32 * CF_WARPS, 0, s>>>(status, executed, thr, start, upto,
                                                      wbase, out, rows, n, vec);
  return (int)cudaGetLastError();
}

MP_EXPORT int mp_commit_frontier(const unsigned char* committed,
                                 const int* start, int* out, long long rows,
                                 int n, cudaStream_t s) {
  return cf_launch(committed, nullptr, 1u, start, nullptr, nullptr, out, rows, n, s);
}

MP_EXPORT int mp_advance_frontier(const unsigned char* status,
                                  const unsigned char* executed, int thr,
                                  const int* upto, const int* wbase, int* out,
                                  long long rows, int n, cudaStream_t s) {
  if (thr < 0) return MP_ERR_SHAPE;
  return cf_launch(status, executed, (unsigned)thr, nullptr, upto, wbase, out, rows, n, s);
}
