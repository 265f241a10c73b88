// K10: the step's slot writes, keyed winner and every column in one pass.
//
// Replaces, of the JAX package, the keyed winner scatter-max and the
// column gathers of models/minpaxos.py fused write A (:538-575, PIR +
// ACCEPT) and fused write B (:765-800, COMMIT + PROPOSE), and the
// ops/winner.py gather_row writes of models/mencius.py (:210-216 the
// PROPOSE write, :262-270 and the other write_rows sites), which the
// port ran as K2 and then ~20 gathers and selects per write.
//
// slot_write: per replica, key = section * M + row over the rows with
// ok and a target inside the window is scatter-maxed per slot (ACCEPT
// beats PIR, PROPOSE beats COMMIT, the highest row wins inside a
// section); the winner's row fills the slot's columns, and the key
// itself stays in shared memory. gather_rows:
// the winner is given (win / hit, from slot_winner or Mencius's
// searchsorted) and the same per-slot writer runs with section 0.
// Per section, the write mode of three columns is a parameter:
//   ballot: the row's ballot, or a per-replica constant (B's PROPOSE:
//           default_ballot; Mencius's PROPOSE: 0);
//   status: ACCEPTED, or max(status, COMMITTED) (a COMMIT never
//           downgrades);
//   votes:  kept, 1 << me, or 1 << clamp(src[row], 0, R - 1).
// op is cast to uint8; the six value columns are copied.
//
// Every column is written out of place into a fresh [B, S] tensor (the
// port's step is pure but for the KV insert, and the serving runtime's
// narrow view and merge keep the old state alive): bound = the old
// columns read plus the new ones written. Design: a 2-D grid, one
// block per (window tile of TILE slots, replica). Each block scans its
// replica's rows and scatter-maxes the keys that fall in its tile into
// shared memory (a tile instead of the whole window keeps shared
// memory at 8 KB for any S), then walks its slots, one thread per
// slot: consecutive threads touch consecutive slots, so the column
// reads and writes coalesce; the winner's row is a gather from the
// replica's inbox row, which stays in cache. Columns come through a
// table of (pointer, strides, dtype) descriptors, so views (the narrow
// window of the serving path) are read in place.
#include "common.cuh"

#define SW_TILE 2048
#define SW_NT 512
#define N_IN 9
#define N_SLOT 10
#define ST_ACCEPTED 3
#define ST_COMMITTED 4

struct SwCol {
  const void* p;
  long long sb, si;  // element strides: replica, position
  int dt;            // 0: int32, 1: one byte (uint8 / bool)
};

struct SwArgs {
  // inbox: ballot, op, key_hi, key_lo, val_hi, val_lo, cmd_id, client_id, src
  SwCol in[N_IN];
  // state: ballot, status, op, key_hi, key_lo, val_hi, val_lo, cmd_id,
  // client_id, votes
  SwCol old[N_SLOT];
  void* out[N_SLOT];  // contiguous [B, S] in the old column's dtype; null: kept
  SwCol me, cball;    // [B]; cball null reads 0
  SwCol tgt, sec, ok; // slot_write: [B, M]
  SwCol win, hit;     // gather_rows: [B, S]
  int bal[2], st[2], vt[2];
  int B, M, S, R, gather;
};

__device__ __forceinline__ int ld(const SwCol& c, long long b, long long i) {
  const long long o = b * c.sb + i * c.si;
  return c.dt ? (int)((const unsigned char*)c.p)[o] : ((const int*)c.p)[o];
}

__global__ void __launch_bounds__(SW_NT) mp_slot_write_k(const SwArgs a) {
  __shared__ int skey[SW_TILE];
  const long long b = blockIdx.y;
  const int s0 = blockIdx.x * SW_TILE;
  const int n = min(SW_TILE, a.S - s0);
  if (!a.gather) {
    for (int i = threadIdx.x; i < n; i += SW_NT) skey[i] = -1;
    __syncthreads();
    for (int i = threadIdx.x; i < a.M; i += SW_NT) {
      const int t = ld(a.tgt, b, i) - s0;
      if (ld(a.ok, b, i) && t >= 0 && t < n)
        atomicMax(skey + t, ld(a.sec, b, i) ? a.M + i : i);
    }
    __syncthreads();
  }
  const int me_bit = 1 << ld(a.me, b, 0);
  const int cb = a.cball.p ? ld(a.cball, b, 0) : 0;
  for (int i = threadIdx.x; i < n; i += SW_NT) {
    const int s = s0 + i;
    bool hit;
    int row, sec = 0;
    if (a.gather) {
      hit = ld(a.hit, b, s) != 0;
      row = ld(a.win, b, s);
      row = row < 0 ? 0 : row;
    } else {
      const int k = skey[i];
      hit = k >= 0;
      sec = k >= a.M;
      row = sec ? k - a.M : k;
    }
    int v[N_SLOT];
#pragma unroll
    for (int j = 0; j < N_SLOT; ++j) v[j] = a.out[j] ? ld(a.old[j], b, s) : 0;
    if (hit) {
      v[0] = a.bal[sec] ? cb : ld(a.in[0], b, row);
      v[1] = a.st[sec] ? max(v[1], ST_COMMITTED) : ST_ACCEPTED;
      v[2] = ld(a.in[1], b, row) & 0xff;
#pragma unroll
      for (int j = 3; j < 9; ++j) v[j] = ld(a.in[j - 1], b, row);
      if (a.vt[sec] == 1) {
        v[9] = me_bit;
      } else if (a.vt[sec] == 2) {
        int src = ld(a.in[8], b, row);
        src = src < 0 ? 0 : (src > a.R - 1 ? a.R - 1 : src);
        v[9] = 1 << src;
      }
    }
#pragma unroll
    for (int j = 0; j < N_SLOT; ++j) {
      if (!a.out[j]) continue;
      const long long o = b * a.S + s;
      if (a.old[j].dt)
        ((unsigned char*)a.out[j])[o] = (unsigned char)v[j];
      else
        ((int*)a.out[j])[o] = v[j];
    }
  }
}

MP_EXPORT int mp_slot_write(const SwArgs* a, cudaStream_t s) {
  if (a->B <= 0 || a->S <= 0) return (int)cudaGetLastError();
  if (a->B > 65535 || a->M < 0 || a->R < 1 || a->R > 31) return MP_ERR_SHAPE;
  for (int j = 0; j < 9; ++j)
    if (!a->out[j]) return MP_ERR_SHAPE;  // only votes may be kept
  const dim3 grid((a->S + SW_TILE - 1) / SW_TILE, a->B);
  mp_slot_write_k<<<grid, SW_NT, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
