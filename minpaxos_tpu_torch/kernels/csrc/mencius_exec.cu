// K6: Mencius's out-of-order exec selector.
//
// Replaces the front half of models/mencius.py _exec_pipeline
// (:810-866) of the JAX package: which window slots execute this step.
// Per replica: the in-order prefix [executed_upto+1, committed_upto]
// (at most E slots), plus every committed slot above the frontier and
// below the first gap (a NONE slot) that no earlier slot of the same
// key poisons (live and not executed and not in the prefix, or an
// uncommitted PUT/DELETE); in slot order, the first E of those. Output:
// slot_of [B, E] (the window index of each rank, S past the end) and
// newly_exec [B, S] (the slots that got a rank below E).
//
// Bound: bytes (three byte columns read in full, the keys only of the
// poisoned slots at or below the row's last candidate, [B, E] and
// [B, S] written once). JAX sorts the window by key (jnp.lexsort) and
// scans it; the answer does not depend on that order. Every candidate
// (committed, not executed, not in the prefix, above the frontier,
// below the gap) is itself poisoned, so a candidate is clear exactly
// when it is the smallest poisoned slot of its key.
// Design: one block per replica, O(S) work and a fixed number of
// barriers. (1) One coalesced pass over the byte columns gives each
// slot's flags and the first gap (warp min, then a shared atomicMin).
// (2) Each thread owns a contiguous run of slots; it marks its
// candidates, and a block-wide count gives each candidate its ordinal.
// (3) A shared-memory open-addressing table keyed by the exact 64-bit
// (key_hi, key_lo) is filled with at most half its size in candidates
// at a time (load <= 0.5): each inserts its key (atomicCAS) and atomicMins its
// slot into the entry; then every poisoned slot below the chunk's last
// candidate looks its key up and atomicMins its slot into an entry it
// finds; a candidate whose entry's minimum is not its own slot is
// blocked. A window with more candidates than one chunk takes several
// fills of the same table, so the table's size never depends on S; the
// fills stop once E slots are wanted (the prefix comes first in slot
// order, and a later candidate then ranks E or more). The key reads
// are prefetched into L1 in (2), below the gap only, so the table
// phase waits on no device memory; at 30 KB of shared memory and at
// most 32 registers a thread, four blocks share an SM.
// (4) A block-wide exclusive count over slot order ranks the wanted
// slots; ranks are unique, so the compaction into slot_of needs no
// atomics. The key (-1, -1), the table's empty mark, has an entry of
// its own past the table.
#include "common.cuh"

constexpr int EX_NT = 512;
constexpr int EX_MIN_BLOCKS = 4;  // resident blocks per SM the build asks for
constexpr int EX_TCAP = 2048;    // table entries at most (a power of two)
constexpr int EX_NO_GAP = 1 << 30;
// wire/messages.py statuses and ops
constexpr int ST_NONE = 0, ST_ACCEPTED = 3, ST_COMMITTED = 4, ST_EXECUTED = 5;
constexpr int OP_PUT = 1, OP_DELETE = 3;
// per-slot flag bits in shared memory
constexpr unsigned char F_POISON = 1, F_PREFIX = 2, F_EXEC = 4,
                        F_COMMITTED = 8, F_CAND = 16, F_BLOCK = 32;
constexpr unsigned long long EX_EMPTY = ~0ull;

__device__ __forceinline__ unsigned long long ex_key(const int* __restrict__ hi,
                                                     const int* __restrict__ lo,
                                                     long long k) {
  return ((unsigned long long)(unsigned)hi[k] << 32) | (unsigned)lo[k];
}

// first probe position of a key in a table of 2^lg entries (lg >= 1)
__device__ __forceinline__ int ex_hash(unsigned long long x, int lg) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  return (int)(x >> (64 - lg));
}

__device__ __forceinline__ void ex_prefetch(const int* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// the key's entry, inserted if absent (the table never fills: at most
// half of its entries hold a key)
__device__ __forceinline__ int ex_insert(unsigned long long* tkey, unsigned long long k,
                                         int T, int lg) {
  if (k == EX_EMPTY) return T;
  for (int h = ex_hash(k, lg);; h = (h + 1) & (T - 1)) {
    const unsigned long long old = atomicCAS(&tkey[h], EX_EMPTY, k);
    if (old == EX_EMPTY || old == k) return h;
  }
}

// the key's entry, or -1 when no candidate of the chunk has this key
__device__ __forceinline__ int ex_find(const unsigned long long* tkey, unsigned long long k,
                                       int T, int lg) {
  if (k == EX_EMPTY) return T;
  for (int h = ex_hash(k, lg);; h = (h + 1) & (T - 1)) {
    const unsigned long long cur = tkey[h];
    if (cur == k) return h;
    if (cur == EX_EMPTY) return -1;
  }
}

__global__ void __launch_bounds__(EX_NT, EX_MIN_BLOCKS)
mp_exec_select_k(const int* __restrict__ key_hi, const int* __restrict__ key_lo,
                 const unsigned char* __restrict__ status,
                 const unsigned char* __restrict__ op,
                 const unsigned char* __restrict__ executed,
                 const int* __restrict__ wbase, const int* __restrict__ cupto,
                 const int* __restrict__ eupto, int* __restrict__ slot_of,
                 unsigned char* __restrict__ newly, int S, int E, int tcap) {
  extern __shared__ unsigned long long ex_smem[];
  unsigned long long* tkey = ex_smem;                              // [tcap + 1]
  int* tmin = (int*)(tkey + tcap + 1);                             // [tcap + 1]
  unsigned short* cent = (unsigned short*)(tmin + tcap + 1);       // [tcap / 2]
  unsigned char* flags = (unsigned char*)(cent + tcap / 2);        // [S]
  __shared__ int warp_tot[32];
  __shared__ int gap_s, last_s, pw_s, clear_s;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long row = blockIdx.x;
  const long long rs = row * S;
  const int wb = wbase[row], cu = cupto[row], eu = eupto[row];
  const int rel_e0 = eu + 1 - wb;
  int n_in = cu - eu;
  n_in = n_in < 0 ? 0 : (n_in > E ? E : n_in);
  if (tid == 0) {
    gap_s = EX_NO_GAP;
    pw_s = clear_s = 0;
  }
  __syncthreads();
  // (1) flags and the first gap, coalesced over the byte columns
  int my_gap = EX_NO_GAP;
  for (int i = tid; i < S; i += EX_NT) {
    const int st = status[rs + i], o = op[rs + i];
    const bool ex = executed[rs + i] != 0;
    const bool pre = i >= rel_e0 && i < rel_e0 + n_in;
    const bool live = st >= ST_ACCEPTED && st < ST_EXECUTED;
    const bool unc_write = st == ST_ACCEPTED && (o == OP_PUT || o == OP_DELETE);
    unsigned char f = 0;
    if ((live && !ex && !pre) || unc_write) f |= F_POISON;
    if (pre) f |= F_PREFIX;
    if (ex) f |= F_EXEC;
    if (st == ST_COMMITTED) f |= F_COMMITTED;
    flags[i] = f;
    const int abs_i = wb + i;
    if (abs_i > cu && st == ST_NONE && abs_i < my_gap) my_gap = abs_i;
  }
  my_gap = __reduce_min_sync(0xffffffffu, my_gap);
  if (lane == 0 && my_gap < EX_NO_GAP) atomicMin(&gap_s, my_gap);
  __syncthreads();
  // (2) candidates: each thread owns the slots [i0, i1)
  const int gap = gap_s;
  const int ipt = (S + EX_NT - 1) / EX_NT;
  const int i0 = min(S, tid * ipt), i1 = min(S, i0 + ipt);
  int n_c = 0, n_pw = 0;
  for (int i = i0; i < i1; ++i) {
    const unsigned char f = flags[i];
    const int abs_i = wb + i;
    if ((f & F_COMMITTED) && !(f & (F_EXEC | F_PREFIX)) && abs_i > cu && abs_i < gap) {
      flags[i] = f | F_CAND;
      ++n_c;
    }
    n_pw += (f & F_PREFIX) && !(f & F_EXEC);
  }
  // a key the table phase may read lies below the gap: ask for this
  // thread's key sectors now, so the reads below hit L1
  if (i0 < i1 && (long long)wb + i0 < gap) {
    ex_prefetch(key_hi + rs + i0);
    ex_prefetch(key_hi + rs + i1 - 1);
    ex_prefetch(key_lo + rs + i0);
    ex_prefetch(key_lo + rs + i1 - 1);
  }
  n_pw = __reduce_add_sync(0xffffffffu, n_pw);
  if (lane == 0 && n_pw) atomicAdd(&pw_s, n_pw);
  int n_cand;
  const int c_base = mp_block_excl_scan(n_c, warp_tot, &n_cand, MpSum(), 0);
  // (3) the smallest poisoned slot of each candidate's key, a chunk of
  // candidates per table fill, until E slots are wanted: a later
  // candidate then ranks E or more whether it is clear or not
  const int chunk = tcap / 2;
  const int n_chunks = (n_cand + chunk - 1) / chunk;
  int T = tcap;
  if (n_chunks == 1) {
    T = 64;
    while (T < 2 * n_cand) T <<= 1;
  }
  const int lg = 31 - __clz(T);
  for (int j = 0; j < n_chunks; ++j) {
    const int o_lo = j * chunk, o_hi = min(n_cand, o_lo + chunk);
    const bool mine = c_base < o_hi && c_base + n_c > o_lo;
    for (int e = tid; e <= T; e += EX_NT) {
      tkey[e] = EX_EMPTY;
      tmin[e] = INT_MAX;
    }
    __syncthreads();
    if (mine) {
      for (int i = i0, o = c_base; i < i1 && o < o_hi; ++i) {
        if (!(flags[i] & F_CAND)) continue;
        if (o >= o_lo) {
          const int e = ex_insert(tkey, ex_key(key_hi, key_lo, rs + i), T, lg);
          atomicMin(&tmin[e], i);
          cent[o - o_lo] = (unsigned short)e;
          if (o == o_hi - 1) last_s = i;
        }
        ++o;
      }
    }
    __syncthreads();
    const int last = min(i1, last_s);
    for (int i = i0; i < last; ++i) {
      if (!(flags[i] & F_POISON)) continue;
      const int e = ex_find(tkey, ex_key(key_hi, key_lo, rs + i), T, lg);
      if (e >= 0 && i < tmin[e]) atomicMin(&tmin[e], i);
    }
    __syncthreads();
    int n_clear = 0;
    if (mine) {
      for (int i = i0, o = c_base; i < i1 && o < o_hi; ++i) {
        const unsigned char f = flags[i];
        if (!(f & F_CAND)) continue;
        if (o >= o_lo) {
          if (tmin[cent[o - o_lo]] != i) flags[i] = f | F_BLOCK;
          else ++n_clear;
        }
        ++o;
      }
    }
    n_clear = __reduce_add_sync(0xffffffffu, n_clear);
    if (lane == 0 && n_clear) atomicAdd(&clear_s, n_clear);
    __syncthreads();  // the next fill clears the table
    if (pw_s + clear_s >= E) break;
  }
  // (4) slot order: want = (prefix and not executed) or a clear candidate
  int n_want = 0;
  for (int i = i0; i < i1; ++i) {
    const unsigned char f = flags[i];
    n_want += ((f & F_PREFIX) && !(f & F_EXEC)) ||
              ((f & F_CAND) && !(f & F_BLOCK));
  }
  int total;
  int rank = mp_block_excl_scan(n_want, warp_tot, &total, MpSum(), 0);
  for (int i = i0; i < i1; ++i) {
    const unsigned char f = flags[i];
    const bool want = ((f & F_PREFIX) && !(f & F_EXEC)) ||
                      ((f & F_CAND) && !(f & F_BLOCK));
    bool take = false;
    if (want) {
      if (rank < E) {
        slot_of[row * E + rank] = i;
        take = true;
      }
      ++rank;
    }
    newly[rs + i] = (unsigned char)take;
  }
  for (int r = (total < E ? total : E) + tid; r < E; r += EX_NT)
    slot_of[row * E + r] = S;
}

MP_EXPORT int mp_exec_select(const int* key_hi, const int* key_lo,
                             const unsigned char* status, const unsigned char* op,
                             const unsigned char* executed, const int* wbase,
                             const int* cupto, const int* eupto, int* slot_of,
                             unsigned char* newly, long long rows, int S, int E,
                             cudaStream_t s) {
  if (S < 1 || E < 1) return MP_ERR_SHAPE;
  if (rows <= 0) return (int)cudaGetLastError();
  // a table of at most 2S entries: one fill holds every candidate of a
  // window up to EX_TCAP / 2 slots
  int tcap = 64;
  while (tcap < 2 * S && tcap < EX_TCAP) tcap <<= 1;
  const size_t smem = (size_t)(tcap + 1) * (8 + 4) + (size_t)(tcap / 2) * 2 + (size_t)S;
  if (smem > 227 * 1024) return MP_ERR_SHAPE;  // a slot's flags byte each
  static size_t optin = 0;
  const int oe = mp_smem_optin((const void*)mp_exec_select_k, smem, &optin);
  if (oe) return oe;
  mp_exec_select_k<<<(int)rows, EX_NT, smem, s>>>(key_hi, key_lo, status, op,
                                                  executed, wbase, cupto, eupto,
                                                  slot_of, newly, S, E, tcap);
  return (int)cudaGetLastError();
}
