// K9: the resident loop's per-round bookkeeping, around the step.
//
// Replaces the body of parallel/sharded.py sharded_run_resident of the
// JAX package (:299-372) after and before the cluster step: the inject
// ring stamp, the latency-histogram scatter-add, the paxray telemetry
// row and the dispatch's two totals. Two entry points share one int32
// scratch per dispatch,
//   [u_prev (G) | c_prev (G) | e_prev (G) | acc (N_ACC)],
// the cursor replica's cursors at the round's start per group, and in
// acc their sums over groups, two (inbox_rows, inbox_hwm) pairs, one
// for even rounds and one for odd, and the dispatch's totals.
//
// round_open runs before a dispatch's first step and, with the ring
// armed, before each drain sub-step: with ``first`` it snapshots the
// cursors and their sums; with the ring armed it counts each replica's
// live pending rows (one warp a row, its 16-byte loads all in flight at
// once, a shuffle reduction) into round r's pair: their sum into
// inbox_rows, the max of (live + the replica's injected rows) into
// inbox_hwm, one atomic each per block.
//
// round_close runs after each round's step, once a round: the loop
// launches K9 k + 1 times per k-round dispatch. Three kinds of blocks
// work side by side, with no ordering between them:
// * group blocks, four warps per group, two groups a block: the warps
//   stamp the round on the ring positions assigned this round (slot
//   in [c_prev, c_new), position slot mod W) and sample the slots
//   committed this round, (u_prev, u_new]. A sampled position this
//   round stamped holds the round itself (a warp knows which without
//   reading it back, so no barrier orders stamps and samples); the
//   others are read, sixteen loads a lane in flight. Latencies r -
//   stamp, clipped to the bins, go into a block histogram in shared
//   memory: when all of a warp's 16 x 32 samples fall in one bin, as
//   in place, one lane adds the warp's count once (a shuffle, a vote
//   and a warp reduction), else each lane adds its own; the block adds
//   only its nonzero bins to the global histogram. With ``next``
//   (another round follows in this dispatch) the group's first lane
//   then writes its new snapshot;
// * with ``next`` and the ring armed, row blocks count the next round's
//   live pending rows into round r + 1's pair, as round_open does;
// * one tail block, with the ring armed, ``totals`` or ``next``: it sums
//   the cursors over groups and writes the round's row at (r -
//   tel_base) mod rows from those sums less the sums at the round's
//   start (integer sums: the row's terms exactly), then zeroes round
//   r's pair; with ``totals`` the dispatch's (sum of u_new + 1, sum of
//   c_new - 1 - u_new), what the JAX loop returns; with ``next`` the new
//   sums. Round r + 1's pair is not round r's, so no block waits for
//   another: no ticket, no fence.
// Every buffer equals the plain twin's bit for bit (integer atomics are
// exact in any order).
//
// Bound: bytes (the stamps written over [c_prev, c_new), the samples
// read over (u_prev, u_new], the touched bins, the cursors, and with
// ``next`` and the ring armed the [B, Mp] pending kinds, which then
// dominate).
#include "common.cuh"

#define NT 256
#define WPB (NT / 32)
#define N_TEL 9
#define WPG 4  // warps per group in round_close
#define GPB (WPB / WPG)  // groups per block
#define SAMPLES_IN_FLIGHT 16
#define LIVE_LOADS 16
#define FULL 0xffffffffu

// acc = scratch + 3G
enum {
  A_SUM_U,   // sums over groups of the snapshot: committed_upto,
  A_SUM_C,   // crt_inst,
  A_SUM_E,   // executed_upto
  A_PAIRS,   // (inbox_rows, inbox_hwm) of even rounds, then of odd rounds
  A_TOTALS = A_PAIRS + 4,  // the dispatch's totals: the last two words
  N_ACC = A_TOTALS + 2
};

__device__ __forceinline__ int fmod_pos(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// Live (kind != 0) rows of one pending row, reduced over the warp. A
// lane issues all its 16-byte loads (up to LIVE_LOADS) before it counts
// any, so a row costs one memory round trip, not one per load.
__device__ __forceinline__ int warp_live(const int* __restrict__ row, int Mp,
                                         int vec) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  if (vec) {
    const int4* v = reinterpret_cast<const int4*>(row);
    const int n4 = Mp >> 2;
    for (int base = 0; base < n4; base += 32 * LIVE_LOADS) {
      int4 x[LIVE_LOADS];
#pragma unroll
      for (int j = 0; j < LIVE_LOADS; ++j) {
        const int i = base + j * 32 + lane;
        x[j] = i < n4 ? __ldg(v + i) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < LIVE_LOADS; ++j)
        cnt += (x[j].x != 0) + (x[j].y != 0) + (x[j].z != 0) + (x[j].w != 0);
    }
  } else {
    for (int i = lane; i < Mp; i += 32) cnt += __ldg(row + i) != 0;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) cnt += __shfl_xor_sync(FULL, cnt, d);
  return cnt;
}

// The live pending rows of replica rows blk*WPB + warp, striding by
// nblk*WPB: their sum into pair[0], max(live + injected) into pair[1],
// one atomic each per block. Every thread of the block calls it.
__device__ void block_live(const int* __restrict__ kind, int B, int R, int Mp,
                           int vec, int n_ext, int leader, int* pair, int blk,
                           int nblk) {
  __shared__ int s_sum[WPB], s_hwm[WPB];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int sum = 0, hwm = -1;
  for (int row = blk * WPB + w; row < B; row += nblk * WPB) {
    const int live = warp_live(kind + (long long)row * Mp, Mp, vec);
    const int rep = row % R;
    sum += live;
    hwm = max(hwm, live + (rep == leader || leader < 0 ? n_ext : 0));
  }
  if (lane == 0) {
    s_sum[w] = sum;
    s_hwm[w] = hwm;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int i = 1; i < WPB; ++i) {
    sum += s_sum[i];
    hwm = max(hwm, s_hwm[i]);
  }
  if (hwm >= 0) {
    atomicAdd(pair, sum);
    atomicMax(pair + 1, hwm);
  }
}

// Sums over groups of the cursor replica's committed_upto, crt_inst,
// executed_upto and prepared flags (1 a group without ``prepared``),
// wrapping as int32 does; valid in thread 0. Every thread of the block
// calls it.
__device__ void block_cursor_sums(const int* __restrict__ upto,
                                  const int* __restrict__ crt,
                                  const int* __restrict__ exe,
                                  const unsigned char* __restrict__ prepared,
                                  int G, int R, int cur, unsigned s[4]) {
  __shared__ unsigned part[4][WPB];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned a[4] = {0u, 0u, 0u, 0u};
  for (int g = threadIdx.x; g < G; g += NT) {
    const int b = g * R + cur;
    a[0] += (unsigned)upto[b];
    a[1] += (unsigned)crt[b];
    a[2] += (unsigned)exe[b];
    a[3] += prepared ? (unsigned)(prepared[b] != 0) : 1u;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) a[j] += __shfl_xor_sync(FULL, a[j], d);
    if (lane == 0) part[j][w] = a[j];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int j = 0; j < 4; ++j) {
    s[j] = 0u;
    for (int i = 0; i < WPB; ++i) s[j] += part[j][i];
  }
}

__global__ void __launch_bounds__(NT)
mp_round_open_k(int* __restrict__ scratch, const int* __restrict__ upto,
                const int* __restrict__ crt, const int* __restrict__ exe,
                const int* __restrict__ kind, int G, int R, int Mp, int cur,
                int first, int tel, int n_prop, int leader, int vec, int r) {
  int* acc = scratch + 3 * G;
  if (first) {
    for (int g = blockIdx.x * NT + threadIdx.x; g < G; g += gridDim.x * NT) {
      const int b = g * R + cur;
      scratch[g] = upto[b];
      scratch[G + g] = crt[b];
      scratch[2 * G + g] = exe[b];
    }
    if (blockIdx.x == 0) {
      unsigned s[4];
      block_cursor_sums(upto, crt, exe, nullptr, G, R, cur, s);
      if (threadIdx.x == 0)
        for (int j = 0; j < 3; ++j) acc[A_SUM_U + j] = (int)s[j];
    }
  }
  if (tel)
    block_live(kind, G * R, R, Mp, vec, first ? n_prop : 0, leader,
               acc + A_PAIRS + 2 * (r & 1), blockIdx.x, gridDim.x);
}

__global__ void __launch_bounds__(NT)
mp_round_close_k(int* __restrict__ scratch, int* __restrict__ inj,
                 int* __restrict__ hist, int* __restrict__ telem,
                 const int* __restrict__ upto, const int* __restrict__ crt,
                 const int* __restrict__ exe,
                 const unsigned char* __restrict__ prepared,
                 const int* __restrict__ kind, int G, int R, int W, int bins,
                 int rows, int cur, int r, int tel_base, int injected,
                 int next, int Mp, int vec, int n_prop, int leader,
                 int totals, int n_gblk, int n_kblk) {
  extern __shared__ int sh[];
  int* acc = scratch + 3 * G;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int blk = blockIdx.x;
  if (blk >= n_gblk + n_kblk) {  // the tail block: sums, row, totals
    unsigned s[4];
    block_cursor_sums(upto, crt, exe, prepared, G, R, cur, s);
    if (threadIdx.x != 0) return;
    const unsigned su = s[0], sc = s[1], se = s[2], ug = (unsigned)G;
    if (rows > 0) {
      int* pair = acc + A_PAIRS + 2 * (r & 1);
      int* row = telem + (long long)fmod_pos(r - tel_base, rows) * N_TEL;
      row[0] = r;
      row[1] = (int)(su - (unsigned)acc[A_SUM_U]);
      row[2] = (int)(sc - ug - su);
      row[3] = (int)(sc - (unsigned)acc[A_SUM_C]);
      row[4] = injected;
      row[5] = pair[0];
      row[6] = (int)(se - (unsigned)acc[A_SUM_E]);
      row[7] = (int)s[3];
      row[8] = pair[1];
      pair[0] = 0;
      pair[1] = 0;
    }
    if (totals) {
      acc[A_TOTALS] = (int)(su + ug);
      acc[A_TOTALS + 1] = (int)(sc - ug - su);
    }
    if (next) {
      acc[A_SUM_U] = (int)su;
      acc[A_SUM_C] = (int)sc;
      acc[A_SUM_E] = (int)se;
    }
    return;
  }
  if (blk >= n_gblk) {  // the next round's live pending rows
    block_live(kind, G * R, R, Mp, vec, n_prop, leader,
               acc + A_PAIRS + 2 * ((r + 1) & 1), blk - n_gblk, n_kblk);
    return;
  }
  for (int i = threadIdx.x; i < bins; i += NT) sh[i] = 0;
  __syncthreads();
  const int g = blk * GPB + w / WPG, q = w % WPG;  // q: the warp in its group
  int un = 0, cn = 0;
  if (g < G) {
    const int b = g * R + cur;
    const int up = scratch[g], cp = scratch[G + g];
    un = upto[b];
    cn = crt[b];
    int* ring = inj + (long long)g * W;
    const int n_stamp = min(max(cn - cp, 0), W);
    const int c0 = fmod_pos(cp, W);
    for (int k = q * 32 + lane; k < n_stamp; k += 32 * WPG) {
      const int p = c0 + k;
      ring[p < W ? p : p - W] = r;
    }
    const int n_samp = min(max(un - up, 0), W);
    const int u0 = fmod_pos(up + 1, W);
    for (int k0 = 0; k0 < n_samp; k0 += 32 * WPG * SAMPLES_IN_FLIGHT) {
      int key[SAMPLES_IN_FLIGHT];  // the sample's bin, -1 for none
#pragma unroll
      for (int j = 0; j < SAMPLES_IN_FLIGHT; ++j) {
        const int k = k0 + (j * WPG + q) * 32 + lane;
        int p = u0 + k;
        p = p < W ? p : p - W;
        int d = p - c0;
        d = d < 0 ? d + W : d;
        const int v = k >= n_samp ? -1 : (d < n_stamp ? r : ring[p]);
        key[j] = v < 0 ? -1 : min(max(r - v, 0), bins - 1);
      }
      const int key0 = __shfl_sync(FULL, key[0], 0);
      bool one_bin = true;
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < SAMPLES_IN_FLIGHT; ++j) {
        one_bin &= key[j] == key0 || key[j] < 0;
        cnt += key[j] >= 0;
      }
      if (__all_sync(FULL, one_bin) && key0 >= 0) {
        cnt = __reduce_add_sync(FULL, cnt);
        if (lane == 0) atomicAdd(sh + key0, cnt);
      } else {
#pragma unroll
        for (int j = 0; j < SAMPLES_IN_FLIGHT; ++j)
          if (key[j] >= 0) atomicAdd(sh + key[j], 1);
      }
    }
  }
  __syncthreads();  // the group's warps have read the old snapshot
  if (next && g < G && q == 0 && lane == 0) {
    scratch[g] = un;
    scratch[G + g] = cn;
    scratch[2 * G + g] = exe[g * R + cur];
  }
  for (int i = threadIdx.x; i < bins; i += NT)
    if (sh[i]) atomicAdd(hist + i, sh[i]);
}

static int row_vec(const int* kind, int Mp) {
  return kind && Mp % 4 == 0 && ((uintptr_t)kind & 15) == 0;
}

MP_EXPORT int mp_round_open(int* scratch, const int* upto, const int* crt,
                            const int* exe, const int* kind, int G, int R,
                            int Mp, int cur, int first, int tel, int n_prop,
                            int leader, int r, cudaStream_t s) {
  if (G < 1 || R < 1 || cur < 0 || cur >= R || Mp < 0 || (tel && !kind))
    return MP_ERR_SHAPE;
  if (!(first || tel)) return 0;
  const int nb = tel ? mp_grid((long long)G * R, WPB) : mp_grid(G, NT);
  mp_round_open_k<<<nb, NT, 0, s>>>(scratch, upto, crt, exe, kind, G, R, Mp,
                                    cur, first, tel, n_prop, leader,
                                    row_vec(kind, Mp), r);
  return (int)cudaGetLastError();
}

MP_EXPORT int mp_round_close(int* scratch, int* inj, int* hist, int* telem,
                             const int* upto, const int* crt, const int* exe,
                             const unsigned char* prepared, const int* kind,
                             int G, int R, int W, int bins, int rows, int cur,
                             int r, int tel_base, int injected, int next,
                             int Mp, int n_prop, int leader, int totals,
                             cudaStream_t s) {
  // the block histogram within the default 48 KB beside the static
  // shared memory
  if (G < 1 || R < 1 || W < 1 || bins < 1 || cur < 0 || cur >= R ||
      bins > 12 * 1024 - 256 || Mp < 0 || (next && rows > 0 && !kind))
    return MP_ERR_SHAPE;
  const int n_gblk = mp_grid(G, GPB);
  const int n_kblk = next && rows > 0 ? mp_grid((long long)G * R, WPB) : 0;
  const int n_tail = rows > 0 || totals || next ? 1 : 0;
  mp_round_close_k<<<n_gblk + n_kblk + n_tail, NT, bins * sizeof(int), s>>>(
      scratch, inj, hist, telem, upto, crt, exe, prepared, kind, G, R, W, bins,
      rows, cur, r, tel_base, injected, next, Mp, row_vec(kind, Mp), n_prop,
      leader, totals, n_gblk, n_kblk);
  return (int)cudaGetLastError();
}
