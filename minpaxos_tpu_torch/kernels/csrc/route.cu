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
// Bound: bytes (12 columns written per inbox slot, the filled slots'
// rows read; the plan reads only kind and dst). Writing the inboxes is
// most of it; the rest is instruction issue per pooled row (16,325 a
// group at the MinPaxos deployment). One block per group, two blocks an
// SM, so at the deployments' 256 groups every block is resident at once
// and nothing crosses blocks. (1) The plan columns are read coalesced,
// once, into one destination bit per row, kept in shared memory where
// the row's owner reads it: thread t owns 32 consecutive rows. (2)
// Each thread counts its rows per destination in 6-bit fields of one
// word (a per-row add, no ballots); one warp per destination scans the
// threads' counts in row order. (3) Each thread walks the set bits of
// its rows and writes each destined row's pooled index into a
// shared-memory map of the inbox slots below `cap`; a thread whose rows
// all start past `cap` skips the walk. Before (3), once the totals are
// final, the inboxes' zero tails go out, so their stores drain while
// (3) runs. (4) The quads through each inbox's last filled slot: a
// filled slot gathers its row's value, any other is zero. Every write
// goes a column at a time (the group's R inboxes of one column are one
// contiguous run, written front to back, which keeps the device
// memory's write streams few and sequential), four consecutive slots a
// thread as one 16-byte store. A broadcast row's reads after the first
// hit the cache. An outbox longer than one chunk of rows takes several
// passes of (1)-(3), each starting at the slots the last one filled.
// One launch, no global scratch.
//
// A shape whose R x cap slot map does not fit one block's shared
// memory, or with more than RT_MAXR replicas, takes mp_route_wide_k
// instead (chosen from the shape, same result): one block per (group,
// destination) walking the pooled rows in order, a ballot scan per
// 512-row chunk, each destined row's columns stored at its slot, then
// the zero tail.
#include "common.cuh"

constexpr int RT_NT = 512;
constexpr int RT_RPT = 32;  // rows per thread per chunk: one warp's worth
constexpr int RT_PAD = RT_RPT + 2;  // a thread's masks in shared memory, padded
constexpr int RT_CHUNK = RT_NT * RT_RPT;
constexpr int RT_BATCH = 8;  // rows whose plan loads a thread keeps in flight
constexpr int RT_MAXR = 16;
constexpr int NCOL = 12;

// bit d set iff the row goes to destination d (alive_bits: the group's
// live replicas)
__device__ __forceinline__ unsigned rt_mask(int kind, int fd, int src, int R,
                                            unsigned alive_bits) {
  if (kind == 0 || !((alive_bits >> src) & 1u)) return 0u;
  if (fd == -1) return alive_bits & ~(1u << src);
  if (fd >= 0 && fd < R && fd != src) return alive_bits & (1u << fd);
  return 0u;
}

// the low 5 bits of b, each in a 6-bit field of its own (a thread's
// count per destination, at most RT_RPT = 32, fits a field)
__device__ __forceinline__ unsigned rt_spread5(unsigned b) {
  return (b & 1u) | ((b & 2u) << 5) | ((b & 4u) << 10) | ((b & 8u) << 15) |
         ((b & 16u) << 20);
}

template <int W>
__device__ __forceinline__ void rt_store(int* p, const int* v) {
  if constexpr (W == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) p[j] = v[j];
  }
}

// Writes a run of four-slot quads (W slots) of every destination's
// inbox, all 12 columns and hit, a column at a time: the group's R
// inboxes of one column are one contiguous run of memory, written front
// to back by the whole block. ZERO: the quads past the last filled one
// (pre[] counts them per destination), all zero; else the quads from
// slot 0 through the last filled one, each slot its row's value
// (`map`) or zero. `tot` (ZERO only) completes the destination totals.
template <int W, bool ZERO>
__device__ __forceinline__ void rt_write_quads(const int* pre, int R, int cap, int g, int G,
                                               const int* grow, long long col_stride,
                                               const int* map, int* out, unsigned char* hit,
                                               const int* base, const int* tot) {
  const int n = pre[R];
#pragma unroll 1
  for (int c = 0; c <= NCOL; ++c) {
    for (int x = threadIdx.x; x < n; x += RT_NT) {
      int d = 0;
      while (x >= pre[d + 1]) ++d;
      const int filled = min(base[d] + (ZERO ? tot[d] : 0), cap);
      const int s0 = ZERO ? ((filled + W - 1) / W + x - pre[d]) * W : (x - pre[d]) * W;
      const long long at = ((long long)g * R + d) * cap + s0;
      int rw[W];
#pragma unroll
      for (int j = 0; j < W; ++j) rw[j] = !ZERO && s0 + j < filled ? map[d * cap + s0 + j] : -1;
      if (c < NCOL) {
        int v[W];
#pragma unroll
        for (int j = 0; j < W; ++j) v[j] = rw[j] >= 0 ? grow[c * col_stride + rw[j]] : 0;
        rt_store<W>(out + (long long)c * G * R * cap + at, v);
      } else if constexpr (W == 4) {
        *reinterpret_cast<unsigned*>(hit + at) = (rw[0] >= 0) | (rw[1] >= 0) << 8 |
                                                 (rw[2] >= 0) << 16 |
                                                 (unsigned)(rw[3] >= 0) << 24;
      } else {
#pragma unroll
        for (int j = 0; j < W; ++j) hit[at + j] = rw[j] >= 0;
      }
    }
  }
}

// W: inbox slots per thread and store (4 when cap is a multiple of 4)
template <int W>
__global__ void __launch_bounds__(RT_NT, 2)
mp_route_k(const int* __restrict__ cols, const int* __restrict__ dst,
           const unsigned char* __restrict__ alive, int* __restrict__ out,
           unsigned char* __restrict__ hit, int G, int R, int m_out, int cap) {
  extern __shared__ int rt_smem[];
  int* map = rt_smem;        // [R][cap]: pooled row of each filled slot
  int* cnt = map + R * cap;  // [R][RT_NT]: a thread's rows per destination
  unsigned short* msk = (unsigned short*)(cnt + R * RT_NT);  // [RT_NT][RT_PAD]
  __shared__ int base_s[RT_MAXR], chunk_tot[RT_MAXR];
  __shared__ int zpre[RT_MAXR + 1], fpre[RT_MAXR + 1];  // zero / filled quads, prefix over d
  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int N = R * m_out;
  const long long col_stride = (long long)G * N;
  const int* grow = cols + (long long)g * N;  // column 0 (kind) of the group
  const int* dg = dst + (long long)g * N;
  unsigned alive_bits = 0;
  for (int d = 0; d < R; ++d)
    alive_bits |= alive[(long long)g * R + d] ? (1u << d) : 0u;
  if (tid < RT_MAXR) base_s[tid] = 0;
  __syncthreads();
  for (int c0 = 0; c0 == 0 || c0 < N; c0 += RT_CHUNK) {  // one pass when N is 0
    // (1) destination bits of the chunk's rows, read coalesced (row
    // c0 + k * RT_NT + tid) and kept where the rows' owner reads them:
    // thread t owns the chunk's rows [t * RT_RPT, (t + 1) * RT_RPT)
    int src = (c0 + tid) / m_out, rem = (c0 + tid) - src * m_out;
    for (int k0 = 0; k0 < RT_RPT; k0 += RT_BATCH) {
      int kd[RT_BATCH], fd[RT_BATCH];
#pragma unroll
      for (int u = 0; u < RT_BATCH; ++u) {
        const int i = c0 + (k0 + u) * RT_NT + tid;
        kd[u] = i < N ? grow[i] : 0;
        fd[u] = i < N ? dg[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < RT_BATCH; ++u) {
        const unsigned m = kd[u] ? rt_mask(kd[u], fd[u], src, R, alive_bits) : 0u;
        msk[((k0 + u) * (RT_NT / 32) + w) * RT_PAD + lane] = (unsigned short)m;
        for (rem += RT_NT; rem >= m_out; rem -= m_out) ++src;
      }
    }
    __syncthreads();
    // (2) this thread's rows per destination, then their exclusive
    // prefix over the threads in row order, one warp per destination
    unsigned acc[4] = {0u, 0u, 0u, 0u};
    for (int k = 0; k < RT_RPT; ++k) {
      const unsigned m = msk[tid * RT_PAD + k];
      if (!m) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (5 * q < R) acc[q] += rt_spread5(m >> (5 * q));
    }
#pragma unroll
    for (int d = 0; d < RT_MAXR; ++d)
      if (d < R) cnt[d * RT_NT + tid] = (acc[d / 5] >> (6 * (d % 5))) & 63u;
    __syncthreads();
    if (w < R) {
      int* cd = cnt + w * RT_NT;
      int run = 0;
      for (int q = 0; q < RT_NT; q += 32) {
        const int c = cd[q + lane];
        int inc = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += y;
        }
        cd[q + lane] = run + inc - c;
        run += __shfl_sync(0xffffffffu, inc, 31);
      }
      if (lane == 0) chunk_tot[w] = run;
    }
    __syncthreads();
    if (c0 + RT_CHUNK >= N && tid == 0) {  // the last chunk: totals are final
      int z = 0, f = 0;
      for (int d = 0; d < R; ++d) {
        const int fq = (min(base_s[d] + chunk_tot[d], cap) + W - 1) / W;
        zpre[d] = z;
        fpre[d] = f;
        z += cap / W - fq;
        f += fq;
      }
      zpre[R] = z;
      fpre[R] = f;
    }
    __syncthreads();
    // the inboxes' zero tails go out now, so their stores drain while
    // (3) runs
    if (c0 + RT_CHUNK >= N)
      rt_write_quads<W, true>(zpre, R, cap, g, G, grow, col_stride, map, out, hit, base_s,
                              chunk_tot);
    // (3) each destined row's inbox slot, if below cap; a thread whose
    // rows all start past cap has none
    bool room = false;
#pragma unroll
    for (int d = 0; d < RT_MAXR; ++d)
      if (d < R) room |= base_s[d] + cnt[d * RT_NT + tid] < cap;
    for (int k = 0; room && k < RT_RPT; ++k) {
      unsigned m = msk[tid * RT_PAD + k];
      while (m) {
        const int d = __ffs(m) - 1;
        m &= m - 1;
        const int s = base_s[d] + cnt[d * RT_NT + tid]++;
        if (s < cap) map[d * cap + s] = c0 + tid * RT_RPT + k;
      }
    }
    __syncthreads();
    if (tid < R) base_s[tid] += chunk_tot[tid];
    __syncthreads();
  }
  // (4) the filled slots' quads: their rows' columns (zero past the
  // last filled slot)
  rt_write_quads<W, false>(fpre, R, cap, g, G, grow, col_stride, map, out, hit, base_s,
                           nullptr);
}

__global__ void __launch_bounds__(RT_NT)
mp_route_wide_k(const int* __restrict__ cols, const int* __restrict__ dst,
                const unsigned char* __restrict__ alive, int* __restrict__ out,
                unsigned char* __restrict__ hit, int G, int R, int m_out, int cap) {
  __shared__ int warp_cnt[RT_NT / 32];
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
    for (long long c0 = 0; c0 < N && base < cap; c0 += RT_NT) {
      const long long i = c0 + threadIdx.x;
      bool des = false;
      if (i < N && kind[i] != 0) {
        const int src = (int)(i / m_out);
        const int fd = dg[i];
        if (al[src])
          des = (fd == -1 && src != d) || (fd >= 0 && fd < R && fd != src && fd == d);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, des);
      if (lane == 0) warp_cnt[w] = __popc(mask);
      __syncthreads();
      int wpre = 0, tot = 0;
#pragma unroll
      for (int j = 0; j < RT_NT / 32; ++j) {
        const int c = warp_cnt[j];
        wpre += j < w ? c : 0;
        tot += c;
      }
      const int off = base + wpre + __popc(mask & ((1u << lane) - 1u));
      if (des && off < cap) {
#pragma unroll
        for (int c = 0; c < NCOL; ++c) og[c * out_stride + off] = kind[c * col_stride + i];
        hg[off] = 1;
      }
      base += tot;
      __syncthreads();
    }
  }
  for (int s = min(base, cap) + threadIdx.x; s < cap; s += RT_NT) {
#pragma unroll
    for (int c = 0; c < NCOL; ++c) og[c * out_stride + s] = 0;
    hg[s] = 0;
  }
}

MP_EXPORT int mp_route(const int* cols, const int* dst,
                       const unsigned char* alive, int* out,
                       unsigned char* hit, int G, int R, int m_out, int cap,
                       cudaStream_t s) {
  if ((long long)G * R > INT_MAX) return MP_ERR_SHAPE;  // the wide kernel's grid
  if (G <= 0 || R <= 0 || cap <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)R * cap * 4 + (size_t)R * RT_NT * 4 +
                      (size_t)RT_NT * RT_PAD * 2;
  // the slot map does not fit, or the pooled rows overflow an int
  if (R > RT_MAXR || smem > 227 * 1024 - 2 * RT_MAXR * 4 || (long long)R * m_out > INT_MAX) {
    mp_route_wide_k<<<G * R, RT_NT, 0, s>>>(cols, dst, alive, out, hit, G, R, m_out, cap);
    return (int)cudaGetLastError();
  }
  // 16-byte stores need every column's inbox rows 16-byte aligned
  const bool vec = cap % 4 == 0 && ((size_t)out | (size_t)hit) % 16 == 0;
  static size_t optin[2] = {0, 0};
  const void* k = vec ? (const void*)mp_route_k<4> : (const void*)mp_route_k<1>;
  const int oe = mp_smem_optin(k, smem, &optin[vec]);
  if (oe) return oe;
  if (vec)
    mp_route_k<4><<<G, RT_NT, smem, s>>>(cols, dst, alive, out, hit, G, R, m_out, cap);
  else
    mp_route_k<1><<<G, RT_NT, smem, s>>>(cols, dst, alive, out, hit, G, R, m_out, cap);
  return (int)cudaGetLastError();
}
