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
// Bound: at a serving shape (B = 1) a launch moves about 200 KB, tens
// of nanoseconds at the card's memory rate, so what limits it is the
// launch floor, the least time any launch takes, and the chain of
// dependent global round trips of the scalar part. At B = 1,280 it is
// bytes (each source column read once, the row written once).
// Design: the launch takes two parameter blocks, the layout (per
// source: dtype, strides, valid length; R, S, the Mencius flag; built
// once per layout on the host and cached) and the sources' data
// pointers (written per launch). A 2-D grid, blockIdx.y the replica:
// block x = 0 is the scalar block, whose first warp starts at once
// and overlaps the copy. Each of its lanes issues its independent
// loads first (one scalar source, one peer_commits entry), the warp
// reduces the peer-commit minimum (self masked by 2^30) with shuffles,
// every lane computes the MinPaxos or Mencius anchors, and Mencius's
// status[rel] is the one dependent load: at most two round trips. The
// 12 scalars and R peer commits are then written in one burst. Every
// other block copies one segment of one column (no per-element
// division): four loads a thread in flight before their stores, a
// 1-byte column read four bytes a load where it is aligned. Mencius's
// `jnp.mod(me - nxt, R)` is a floor mod (mp_floordiv); JAX's clip of
// `rel` holds (the load is masked outside [0, S)).
#include "common.cuh"

#define N_OUT 14
#define N_EX 6
#define N_SCAL 12
#define BIG (1 << 30)
#define ST_COMMITTED 4

// Source slots (ops/substeps.py pack_sources): 0..13 the outbox columns (12
// MsgBatch, dst, acked), 14..19 the exec columns; 20..28 the nine
// reported scalars (frontier, window_base (reported), crt_inst, kv
// dropped, exec lo, exec count, leader_id, prepared, executed_upto);
// then me, gossip_upto | commit_sent, tk_anchor, crt_own, the state's
// window_base, peer_commits [B, R] and status [B, S].
#define SC0 20
#define SL_ME 29
#define SL_GC 30
#define SL_TK 31
#define SL_OWN 32
#define SL_WB 33
#define SL_PC 34
#define SL_ST 35
#define N_SRC 36
#define N_LANE_SRC 14  // slots SC0 .. SL_WB, one lane each

#define PK_THREADS 256
#define PK_PER 4  // elements a thread, loads in flight before the stores
#define PK_CHUNK (PK_THREADS * PK_PER)

struct MpPackLayout {
  long long sb[N_SRC];  // element stride along the replica axis
  long long si[N_SRC];  // element stride along the column
  int len[N_SRC];       // valid entries along the column (0: no source)
  int dt[N_SRC];        // 1: one byte (uint8 / bool), 0: int32
  int B, Mout, E, W, R, S, mencius;
};

struct MpPackPtrs {
  const void* p[N_SRC];
};

__device__ __forceinline__ int ld_src(const void* p, long long o, int dt) {
  return dt ? (int)__ldg((const unsigned char*)p + o) : __ldg((const int*)p + o);
}

// The scalar warp of replica b: s[0..11], then the R peer commits.
__device__ __forceinline__ void pack_scalars(const MpPackLayout& L,
                                             const MpPackPtrs& P, long long b,
                                             int* __restrict__ s) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  // every independent load first, each lane its own
  const int slot = SC0 + (lane < N_LANE_SRC ? lane : 0);
  const bool has = lane < N_LANE_SRC && L.len[slot] > 0;
  const bool has_pc = lane < L.R;
  int v = 0, pc = 0;
  if (has) v = ld_src(P.p[slot], b * L.sb[slot], L.dt[slot]);
  if (has_pc)
    pc = ld_src(P.p[SL_PC], b * L.sb[SL_PC] + lane * L.si[SL_PC], L.dt[SL_PC]);
  // a missing leader reads -1, a missing prepared 1 (Mencius)
  if (!has) v = lane == 26 - SC0 ? -1 : (lane == 27 - SC0 ? 1 : 0);
  const int me = __shfl_sync(full, v, SL_ME - SC0);
  int pcv = has_pc && lane != me ? pc : BIG;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int o = __shfl_xor_sync(full, pcv, d);
    pcv = o < pcv ? o : pcv;
  }
  const int pc_min = pcv;
  const int frontier = __shfl_sync(full, v, 0);
  const int crt_inst = __shfl_sync(full, v, 2);
  const int leader = __shfl_sync(full, v, 6);
  const int prepared = __shfl_sync(full, v, 7);
  const int executed = __shfl_sync(full, v, 8);
  const int gc = __shfl_sync(full, v, SL_GC - SC0);
  const int tk = __shfl_sync(full, v, SL_TK - SC0);
  const int own = __shfl_sync(full, v, SL_OWN - SC0);
  const int wbase = __shfl_sync(full, v, SL_WB - SC0);
  int lo = executed + 1 < frontier + 1 ? executed + 1 : frontier + 1;
  const bool backlog = frontier > executed;
  const bool peer_lag = pc_min < frontier;
  const bool in_flight = crt_inst - 1 > frontier;
  int hi;
  bool pending;
  if (!L.mencius) {
    const bool is_leader = leader == me;
    if (is_leader && prepared && peer_lag && pc_min + 1 < lo) lo = pc_min + 1;
    hi = crt_inst;
    pending = backlog || frontier > gc ||
              (is_leader && (in_flight || !prepared || peer_lag));
  } else {
    if (peer_lag && pc_min + 1 < lo) lo = pc_min + 1;
    if (gc + 1 < lo) lo = gc + 1;
    if (tk >= 0 && tk < lo) lo = tk;
    hi = crt_inst > own ? crt_inst : own;
    int nxt = gc + 1;
    const int dif = me - nxt;
    nxt += dif - mp_floordiv(dif, L.R) * L.R;  // floor mod
    const int rel = nxt - wbase;
    // the one dependent load: status[rel] (every lane the same address)
    int st = 0;
    if (rel >= 0 && rel < L.S)
      st = ld_src(P.p[SL_ST], b * L.sb[SL_ST] + rel * L.si[SL_ST], L.dt[SL_ST]);
    pending = backlog || in_flight || peer_lag || st >= ST_COMMITTED;
  }
  // one burst: lane i writes s[i] and its peer commit
  const int sv = lane == 9 ? lo : (lane == 10 ? hi : (lane == 11 ? (int)pending : v));
  if (lane < N_SCAL) s[lane] = sv;
  if (has_pc) s[N_SCAL + lane] = pc;
}

__global__ void __launch_bounds__(PK_THREADS)
    mp_pack_k(const MpPackLayout L, const MpPackPtrs P, int* __restrict__ out) {
  const long long b = blockIdx.y;
  int* __restrict__ row = out + b * L.W;
  const int n_out = N_OUT * L.Mout;
  if (blockIdx.x == 0) {
    if (threadIdx.x < 32) pack_scalars(L, P, b, row + n_out + N_EX * L.E);
    return;
  }
  // one segment of one column: which, from the block index (one
  // division a block, none an element)
  const int co = (L.Mout + PK_CHUNK - 1) / PK_CHUNK;
  const int ce = (L.E + PK_CHUNK - 1) / PK_CHUNK;
  int x = blockIdx.x - 1, c, n;
  int* __restrict__ dst;
  if (x < N_OUT * co) {
    c = x / co;
    x -= c * co;
    n = L.Mout;
    dst = row + c * L.Mout;
  } else {
    x -= N_OUT * co;
    const int ci = x / ce;
    x -= ci * ce;
    c = N_OUT + ci;
    n = L.E;
    dst = row + n_out + ci * L.E;
  }
  const int j0 = x * PK_CHUNK;
  const int len = L.len[c] < n ? L.len[c] : n;
  const long long si = L.si[c];
  if (L.dt[c]) {
    const unsigned char* src = (const unsigned char*)P.p[c] + b * L.sb[c];
    if (si == 1 && ((size_t)src & 3) == 0) {
      // four bytes a load
      const int j = j0 + 4 * threadIdx.x;
      if (j >= n) return;
      unsigned w = 0;
      if (j + 4 <= len) {
        w = __ldg((const unsigned*)(src + j));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < len) w |= (unsigned)__ldg(src + j + q) << (8 * q);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q < n) dst[j + q] = (int)((w >> (8 * q)) & 0xffu);
      return;
    }
    int v[PK_PER];
#pragma unroll
    for (int q = 0; q < PK_PER; ++q) {
      const int j = j0 + q * PK_THREADS + threadIdx.x;
      v[q] = j < len ? (int)__ldg(src + j * si) : 0;
    }
#pragma unroll
    for (int q = 0; q < PK_PER; ++q) {
      const int j = j0 + q * PK_THREADS + threadIdx.x;
      if (j < n) dst[j] = v[q];
    }
    return;
  }
  const int* src = (const int*)P.p[c] + b * L.sb[c];
  int v[PK_PER];
#pragma unroll
  for (int q = 0; q < PK_PER; ++q) {
    const int j = j0 + q * PK_THREADS + threadIdx.x;
    v[q] = j < len ? __ldg(src + j * si) : 0;
  }
#pragma unroll
  for (int q = 0; q < PK_PER; ++q) {
    const int j = j0 + q * PK_THREADS + threadIdx.x;
    if (j < n) dst[j] = v[q];
  }
}

MP_EXPORT int mp_pack_outputs(const MpPackLayout* L, const void* const* ptrs,
                              int* out, cudaStream_t s) {
  if (L->B <= 0) return (int)cudaGetLastError();
  if (L->Mout < 1 || L->E < 1 || L->R < 1 || L->R > 32 || L->S < 1 ||
      L->B > 65535 || L->W != N_OUT * L->Mout + N_EX * L->E + N_SCAL + L->R)
    return MP_ERR_SHAPE;
  MpPackPtrs P;
  for (int i = 0; i < N_SRC; ++i) P.p[i] = ptrs[i];
  const int co = (L->Mout + PK_CHUNK - 1) / PK_CHUNK;
  const int ce = (L->E + PK_CHUNK - 1) / PK_CHUNK;
  mp_pack_k<<<dim3(1 + N_OUT * co + N_EX * ce, L->B), PK_THREADS, 0, s>>>(
      *L, P, out);
  return (int)cudaGetLastError();
}
