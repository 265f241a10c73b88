// K9: the resident loop's per-round bookkeeping, around the step.
//
// Replaces the body of parallel/sharded.py sharded_run_resident of the
// JAX package (:299-372) after and before the cluster step: the inject
// ring stamp, the latency-histogram scatter-add and the paxray
// telemetry row. Two entry points share one int32 scratch per loop,
//   [u_prev (G) | c_prev (G) | e_prev (G) | acc (8)],
// acc = inbox_rows, inbox_hwm, committed, in_flight, assigned, claim,
// prepared, ticket.
//
// round_open, before the step (and, with telemetry on, before each
// drain sub-step): snapshots the cursor replica's committed_upto,
// crt_inst and executed_upto of every group, and with telemetry on
// counts each replica's live pending rows: their sum goes into
// inbox_rows, the max of (live + the replica's injected rows) into
// inbox_hwm. One block per replica row (per group with telemetry off).
//
// round_close, after the step: one block per group stamps the round on
// the ring positions assigned this round (slot < c_new, slot = c_prev +
// (pos - c_prev) mod W), samples the slots committed this round,
// (u_prev, u_new], whose updated stamp is >= 0 into a shared-memory
// histogram of clip(r - stamp, 0, bins - 1), and flushes it with
// global atomics. It walks only those positions: the
// min(c_new - c_prev, W) stamped from c_prev mod W on, then the
// min(u_new - u_prev, W) sampled from (u_prev + 1) mod W on (a slot's
// position is slot mod W), not the whole ring. With the ring armed,
// each block adds its group's telemetry terms into acc; the last block to finish (threadfence +
// ticket) writes the row at floor((r - tel_base) mod rows) and zeroes
// acc for the next round. Integer atomics are exact in any order, so
// the result is the plain twin's bit for bit.
//
// Bound: bytes (the stamps written over [c_prev, c_new) and read over
// (u_prev, u_new], the histogram, the cursors).
#include "common.cuh"

#define NT_OPEN 256
#define NT_CLOSE 512
#define N_TEL 9

__device__ __forceinline__ int fmod_pos(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(NT_OPEN)
mp_round_open_k(int* __restrict__ scratch, const int* __restrict__ upto,
                const int* __restrict__ crt, const int* __restrict__ exe,
                const int* __restrict__ kind, int G, int R, int Mp, int cur,
                int first, int tel, int n_prop, int leader) {
  __shared__ int warp_cnt[NT_OPEN / 32];
  const int b = tel ? (int)blockIdx.x : (int)blockIdx.x * R + cur;
  const int g = b / R, rep = b - g * R;
  if (first && rep == cur && threadIdx.x == 0) {
    scratch[g] = upto[b];
    scratch[G + g] = crt[b];
    scratch[2 * G + g] = exe[b];
  }
  if (!tel) return;
  int cnt = 0;
  const int* row = kind + (long long)b * Mp;
  for (int i = threadIdx.x; i < Mp; i += NT_OPEN) cnt += row[i] != 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
  if ((threadIdx.x & 31) == 0) warp_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int live = 0;
  for (int w = 0; w < NT_OPEN / 32; ++w) live += warp_cnt[w];
  const int ext = first && (rep == leader || leader < 0) ? n_prop : 0;
  int* acc = scratch + 3 * G;
  atomicAdd(acc + 0, live);
  atomicMax(acc + 1, live + ext);
}

__global__ void __launch_bounds__(NT_CLOSE)
mp_round_close_k(int* __restrict__ scratch, int* __restrict__ inj,
                 int* __restrict__ hist, int* __restrict__ telem,
                 const int* __restrict__ upto, const int* __restrict__ crt,
                 const int* __restrict__ exe,
                 const unsigned char* __restrict__ prepared, int G, int R,
                 int W, int bins, int rows, int cur, int r, int tel_base,
                 int injected) {
  extern __shared__ int sh[];
  const int g = blockIdx.x, b = g * R + cur;
  for (int i = threadIdx.x; i < bins; i += NT_CLOSE) sh[i] = 0;
  __syncthreads();
  const int cp = scratch[G + g], cn = crt[b];
  const int up1 = scratch[g] + 1, un = upto[b];
  int* ring = inj + (long long)g * W;
  const int n_stamp = min(max(cn - cp, 0), W);
  for (int k = threadIdx.x; k < n_stamp; k += NT_CLOSE)
    ring[fmod_pos(cp + k, W)] = r;
  __syncthreads();  // the block's stamps are visible to its samples
  const int n_samp = min(max(un - up1 + 1, 0), W);
  for (int k = threadIdx.x; k < n_samp; k += NT_CLOSE) {
    const int v = ring[fmod_pos(up1 + k, W)];
    if (v >= 0) {
      int bin = r - v;
      bin = bin < 0 ? 0 : (bin > bins - 1 ? bins - 1 : bin);
      atomicAdd(sh + bin, 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += NT_CLOSE)
    if (sh[i]) atomicAdd(hist + i, sh[i]);
  if (rows <= 0 || threadIdx.x != 0) return;
  int* acc = scratch + 3 * G;
  atomicAdd(acc + 2, un - scratch[g]);
  atomicAdd(acc + 3, cn - 1 - un);
  atomicAdd(acc + 4, cn - cp);
  atomicAdd(acc + 5, exe[b] - scratch[2 * G + g]);
  atomicAdd(acc + 6, prepared ? (int)(prepared[b] != 0) : 1);
  __threadfence();
  if (atomicAdd(acc + 7, 1) != G - 1) return;
  // the last block: every other block's terms are visible
  __threadfence();
  int a[7];
  for (int i = 0; i < 7; ++i) a[i] = atomicExch(acc + i, 0);
  acc[7] = 0;
  int* row = telem + (long long)fmod_pos(r - tel_base, rows) * N_TEL;
  row[0] = r;
  row[1] = a[2];
  row[2] = a[3];
  row[3] = a[4];
  row[4] = injected;
  row[5] = a[0];
  row[6] = a[5];
  row[7] = a[6];
  row[8] = a[1];
}

MP_EXPORT int mp_round_open(int* scratch, const int* upto, const int* crt,
                            const int* exe, const int* kind, int G, int R,
                            int Mp, int cur, int first, int tel, int n_prop,
                            int leader, cudaStream_t s) {
  if (G < 1 || R < 1 || cur < 0 || cur >= R || Mp < 0) return MP_ERR_SHAPE;
  if (tel)
    mp_round_open_k<<<G * R, NT_OPEN, 0, s>>>(scratch, upto, crt, exe, kind, G,
                                              R, Mp, cur, first, tel, n_prop,
                                              leader);
  else if (first)
    mp_round_open_k<<<G, 32, 0, s>>>(scratch, upto, crt, exe, kind, G, R, Mp,
                                     cur, first, tel, n_prop, leader);
  return (int)cudaGetLastError();
}

MP_EXPORT int mp_round_close(int* scratch, int* inj, int* hist, int* telem,
                             const int* upto, const int* crt, const int* exe,
                             const unsigned char* prepared, int G, int R, int W,
                             int bins, int rows, int cur, int r, int tel_base,
                             int injected, cudaStream_t s) {
  if (G < 1 || R < 1 || W < 1 || bins < 1 || cur < 0 || cur >= R ||
      bins > 12 * 1024)
    return MP_ERR_SHAPE;
  mp_round_close_k<<<G, NT_CLOSE, bins * sizeof(int), s>>>(
      scratch, inj, hist, telem, upto, crt, exe, prepared, G, R, W, bins, rows,
      cur, r, tel_base, injected);
  return (int)cudaGetLastError();
}
