// K8: one round's PROPOSE batch of the resident loop's workload.
//
// Replaces ops/workload.py workload_lanes + assemble_batch of the JAX
// package (:106 and :148; the 20-round Threefry-2x32 keyed on (seed,
// round) and countered on (shard, row), and the twelve MsgBatch
// columns of the round's [G * R, M] PROPOSE rows). A row's key is row
// 0's lane 0 of its shard plus col * 2654435761, masked to the
// power-of-two key space; with hot_pct, a second counter block at
// shard + G redirects (h0 % 100 < hot_pct) the key to h1 % hot_keys.
// Values are lane 1; cmd_id = round * M + col wraps in int32.
//
// Bound: bytes written (12 int32 columns of G * R * M); the Threefry
// arithmetic (~3 x 100 uint32 operations per (shard, row)) is far below
// the card's integer rate. Design: one thread per (shard, row), which
// recomputes its shard's row-0 lane (cheaper than sharing it through
// shared memory across blocks), then writes its row for every replica
// of the group: consecutive threads write consecutive columns, so the
// stores coalesce. The whole batch is one [12, G * R, M] buffer.
#include "common.cuh"

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1,
                                             unsigned c0, unsigned c1,
                                             unsigned& o0, unsigned& o1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  unsigned x0 = c0 + ks[0], x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

__global__ void mp_propose_rows_k(int* __restrict__ out, int G, int R, int M,
                                  int count, int leader, unsigned round,
                                  unsigned seed, unsigned key_mask,
                                  int hot_pct, unsigned hot_keys,
                                  int kind_propose, int op_put) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)G * M) return;
  const int shard = (int)(i / M), c = (int)(i - (long long)shard * M);
  unsigned b0, b1, base, unused;
  threefry2x32(seed, round, (unsigned)shard, (unsigned)c, b0, b1);
  threefry2x32(seed, round, (unsigned)shard, 0u, base, unused);
  int key = (int)((base + (unsigned)c * 2654435761u) & key_mask);
  if (hot_pct) {
    unsigned h0, h1;
    threefry2x32(seed, round, (unsigned)(shard + G), (unsigned)c, h0, h1);
    if (h0 % 100u < (unsigned)hot_pct) key = (int)(h1 % hot_keys);
  }
  const int cmd = (int)(round * (unsigned)M + (unsigned)c);
  const long long plane = (long long)G * R * M;
  for (int r = 0; r < R; ++r) {
    const bool live = c < count && (r == leader || leader < 0);
    int* o = out + ((long long)shard * R + r) * M + c;
    o[0 * plane] = live ? kind_propose : 0;   // kind
    o[1 * plane] = -1;                         // src
    o[2 * plane] = 0;                          // ballot
    o[3 * plane] = 0;                          // inst
    o[4 * plane] = 0;                          // last_committed
    o[5 * plane] = live ? op_put : 0;          // op
    o[6 * plane] = 0;                          // key_hi
    o[7 * plane] = live ? key : 0;             // key_lo
    o[8 * plane] = 0;                          // val_hi
    o[9 * plane] = live ? (int)b1 : 0;         // val_lo
    o[10 * plane] = live ? cmd : 0;            // cmd_id
    o[11 * plane] = live ? shard : 0;          // client_id
  }
}

MP_EXPORT int mp_propose_rows(int* out, int G, int R, int M, int count,
                              int leader, unsigned round, unsigned seed,
                              unsigned key_mask, int hot_pct,
                              unsigned hot_keys, int kind_propose, int op_put,
                              cudaStream_t s) {
  if (G < 0 || R < 1 || M < 0 || (hot_pct && hot_keys == 0))
    return MP_ERR_SHAPE;
  const long long n = (long long)G * M;
  if (n > 0)
    mp_propose_rows_k<<<mp_grid(n, 256), 256, 0, s>>>(
        out, G, R, M, count, leader, round, seed, key_mask, hot_pct, hot_keys,
        kind_propose, op_put);
  return (int)cudaGetLastError();
}
