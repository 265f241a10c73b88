// K7: the fused per-substep output packing of the serving runtime.
//
// Replaces ops/substeps.py pack_outputs + _anchors (:61-141) of the JAX
// package: per replica and substep, the 12 outbox MsgBatch columns,
// dst and the per-inbox-row acked mask (zero-padded to the outbox
// length) as [14, Mout]; the 6 exec columns as [6, E]; the 12-entry
// scalar vector, three of whose entries are the narrow-view anchors
// and the idle fast path's work_pending bit; and (port addition) the
// replica's [R] peer_commits vector. All of it lands in one int32 row
//   [14 * Mout | 6 * E | N_SCAL | R]
// per replica, so the host reads k substeps back in one copy.
//
// Bound: bytes (each source column read once, the row written once;
// tens of KB per replica at the serving shapes, so a single launch's
// latency dominates). What the kernel saves is launches: the plain
// twin takes ~30 casts, pads, stacks and the anchor arithmetic.
// Design: the sources come in one parameter struct of (pointer,
// strides, dtype, valid length) descriptors, so any column layout the
// step produced is read in place, int32 or 1-byte (uint8/bool). A 2-D
// grid: blockIdx.y is the replica, the x blocks stride over its row;
// warp 0 of block x = 0 computes the scalars: the peer-commit minimum
// (self masked by 2^30) as a warp reduction, then the MinPaxos or
// Mencius anchors in lane 0. Mencius's `jnp.mod(me - nxt, R)` is a
// floor mod (mp_floordiv).
#include "common.cuh"

#define N_OUT 14
#define N_EX 6
#define N_SCAL 12
#define BIG (1 << 30)
#define ST_COMMITTED 4

struct MpCol {
  const void* p;
  long long sb, si;  // element strides: replica, column position
  int dt;            // 0: int32, 1: one byte (uint8 / bool)
  int len;           // valid entries along the column; later ones read 0
};

struct MpPackArgs {
  MpCol out[N_OUT];
  MpCol ex[N_EX];
  // frontier, window_base (reported), crt_inst, kv dropped, exec lo,
  // exec count, leader (null: -1), prepared (null: 1), executed_upto
  MpCol sc[9];
  MpCol me, pc, crt_inst, crt_own, commit_sent, tk_anchor, wbase, status,
      leader_id, prepared, gossip, committed, executed;
  int R, S, mencius;
};

__device__ __forceinline__ int ld(const MpCol& c, long long b, long long i) {
  if (i >= c.len) return 0;
  const long long o = b * c.sb + i * c.si;
  return c.dt ? (int)((const unsigned char*)c.p)[o] : ((const int*)c.p)[o];
}

__device__ __forceinline__ int lds(const MpCol& c, long long b, int dflt) {
  if (!c.p) return dflt;
  return c.dt ? (int)((const unsigned char*)c.p)[b * c.sb]
              : ((const int*)c.p)[b * c.sb];
}

__global__ void mp_pack_k(const MpPackArgs a, int* __restrict__ out, int Mout,
                          int E, int W) {
  const long long b = blockIdx.y;
  int* row = out + b * (long long)W;
  const int n_out = N_OUT * Mout, n_all = n_out + N_EX * E;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n_all;
       j += gridDim.x * blockDim.x) {
    int v;
    if (j < n_out) {
      const int c = j / Mout;
      v = ld(a.out[c], b, j - c * Mout);
    } else {
      const int jj = j - n_out, c = jj / E;
      v = ld(a.ex[c], b, jj - c * E);
    }
    row[j] = v;
  }
  if (blockIdx.x != 0 || threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int me = lds(a.me, b, 0);
  int pcv = BIG;
  if (lane < a.R) {
    const int v = ((const int*)a.pc.p)[b * a.pc.sb + lane * a.pc.si];
    row[n_all + N_SCAL + lane] = v;
    pcv = lane == me ? BIG : v;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int o = __shfl_xor_sync(0xffffffffu, pcv, d);
    pcv = o < pcv ? o : pcv;
  }
  if (lane != 0) return;
  const int pc_min = pcv;
  const int frontier = lds(a.committed, b, 0);
  const int executed = lds(a.executed, b, 0);
  const int crt_inst = lds(a.crt_inst, b, 0);
  int lo = executed + 1 < frontier + 1 ? executed + 1 : frontier + 1;
  const bool backlog = frontier > executed;
  const bool peer_lag = pc_min < frontier;
  const bool in_flight = crt_inst - 1 > frontier;
  int hi, pending;
  if (!a.mencius) {
    const bool is_leader = lds(a.leader_id, b, 0) == me;
    const bool prepared = lds(a.prepared, b, 0) != 0;
    if (is_leader && prepared && peer_lag && pc_min + 1 < lo) lo = pc_min + 1;
    hi = crt_inst;
    const bool behind_gossip = frontier > lds(a.gossip, b, 0);
    pending = backlog || behind_gossip ||
              (is_leader && (in_flight || !prepared || peer_lag));
  } else {
    if (peer_lag && pc_min + 1 < lo) lo = pc_min + 1;
    const int cs = lds(a.commit_sent, b, 0);
    if (cs + 1 < lo) lo = cs + 1;
    const int tk = lds(a.tk_anchor, b, 0);
    if (tk >= 0 && tk < lo) lo = tk;
    const int own = lds(a.crt_own, b, 0);
    hi = crt_inst > own ? crt_inst : own;
    int nxt = cs + 1;
    const int dif = me - nxt;
    nxt += dif - mp_floordiv(dif, a.R) * a.R;  // floor mod
    const int rel = nxt - lds(a.wbase, b, 0);
    const int relc = rel < 0 ? 0 : (rel > a.S - 1 ? a.S - 1 : rel);
    const bool pending_cb = rel >= 0 && rel < a.S &&
                            ld(a.status, b, relc) >= ST_COMMITTED;
    pending = backlog || in_flight || peer_lag || pending_cb;
  }
  int* s = row + n_all;
#pragma unroll
  for (int i = 0; i < 9; ++i)
    s[i] = lds(a.sc[i], b, i == 6 ? -1 : (i == 7 ? 1 : 0));
  s[9] = lo;
  s[10] = hi;
  s[11] = pending;
}

MP_EXPORT int mp_pack_outputs(const MpPackArgs* a, int* out, int B, int Mout,
                              int E, int W, cudaStream_t s) {
  if (B <= 0) return (int)cudaGetLastError();
  if (Mout < 1 || E < 1 || a->R < 1 || a->R > 32 || a->S < 1 ||
      W != N_OUT * Mout + N_EX * E + N_SCAL + a->R)
    return MP_ERR_SHAPE;
  if (B > 65535) return MP_ERR_SHAPE;
  const int n_all = N_OUT * Mout + N_EX * E;
  int gx = (n_all + 255) / 256;
  if (gx > 64) gx = 64;
  mp_pack_k<<<dim3(gx, B), 256, 0, s>>>(*a, out, Mout, E, W);
  return (int)cudaGetLastError();
}
