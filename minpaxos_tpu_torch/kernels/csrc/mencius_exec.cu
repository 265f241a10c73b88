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
// Bound: bytes (five [B, S] columns read once, [B, E] and [B, S]
// written once); the per-row sort is shared-memory work.
// Design: one block per replica. The window's (key_hi, key_lo, slot)
// triples are sorted in shared memory by a bitonic sort on the composite
// key ((hi ^ 2^31) << 32 | (lo ^ 2^31), slot): signed order of both
// halves, ties by slot — jnp.lexsort's order, total because slots are
// unique. "No poison earlier in my key's segment" is one comparison
// of two block-wide max-scans over sorted positions (the last poisoned
// position before me against the start of my segment), scattered back
// to slot order; the first gap is a shared-memory atomicMin; exec ranks
// are a block-wide exclusive count in slot order. Ranks are unique, so
// the compaction into slot_of needs no atomics.
#include "common.cuh"

constexpr int EX_NT = 1024;
constexpr int EX_MAX_S = 16384;  // 16-bit slot ids; 180 KB of shared memory
// wire/messages.py statuses and ops
constexpr int ST_NONE = 0, ST_ACCEPTED = 3, ST_COMMITTED = 4, ST_EXECUTED = 5;
constexpr int OP_PUT = 1, OP_DELETE = 3;
// per-slot flag bits in shared memory
constexpr unsigned char F_POISON = 1, F_PREFIX = 2, F_EXEC = 4,
                        F_COMMITTED = 8, F_CLEAR = 16;

__global__ void __launch_bounds__(EX_NT)
mp_exec_select_k(const int* __restrict__ key_hi, const int* __restrict__ key_lo,
                 const unsigned char* __restrict__ status,
                 const unsigned char* __restrict__ op,
                 const unsigned char* __restrict__ executed,
                 const int* __restrict__ wbase, const int* __restrict__ cupto,
                 const int* __restrict__ eupto, int* __restrict__ slot_of,
                 unsigned char* __restrict__ newly, int S, int n2, int E) {
  extern __shared__ unsigned long long ex_smem[];
  unsigned long long* skey = ex_smem;                            // [n2]
  unsigned short* sslot = (unsigned short*)(skey + n2);          // [n2]
  unsigned char* flags = (unsigned char*)(sslot + n2);           // [S]
  __shared__ int warp_tot[32];
  __shared__ int gap_s;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int wb = wbase[row], cu = cupto[row], eu = eupto[row];
  const int rel_e0 = eu + 1 - wb;
  int n_in = cu - eu;
  n_in = n_in < 0 ? 0 : (n_in > E ? E : n_in);
  if (tid == 0) gap_s = 1 << 30;
  __syncthreads();
  for (int i = tid; i < n2; i += EX_NT) {
    if (i < S) {
      const long long k = row * S + i;
      skey[i] = ((unsigned long long)((unsigned)key_hi[k] ^ 0x80000000u) << 32) |
                (unsigned long long)((unsigned)key_lo[k] ^ 0x80000000u);
      sslot[i] = (unsigned short)i;
      const int st = status[k], o = op[k];
      const bool ex = executed[k] != 0;
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
      if (abs_i > cu && st == ST_NONE) atomicMin(&gap_s, abs_i);
    } else {
      skey[i] = ~0ull;  // padding sorts after every slot
      sslot[i] = 0xFFFF;
    }
  }
  __syncthreads();
  // bitonic sort of (skey, sslot), ascending
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n2; i += EX_NT) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long ka = skey[i], kb = skey[ixj];
          const unsigned short sa = sslot[i], sb = sslot[ixj];
          const bool a_gt = ka > kb || (ka == kb && sa > sb);
          if (a_gt == ((i & k) == 0)) {
            skey[i] = kb;
            skey[ixj] = ka;
            sslot[i] = sb;
            sslot[ixj] = sa;
          }
        }
      }
      __syncthreads();
    }
  }
  // sorted positions: thread t owns [t*ipt, t*ipt + ipt)
  const int ipt = (S + EX_NT - 1) / EX_NT;
  const int p0 = tid * ipt, p1 = p0 + ipt < S ? p0 + ipt : S;
  int last_poison = -1, last_seg = -1;
  for (int p = p0; p < p1; ++p) {
    if (p == 0 || skey[p] != skey[p - 1]) last_seg = p;
    if (flags[sslot[p]] & F_POISON) last_poison = p;
  }
  const int pois_before = mp_block_excl_scan(last_poison, warp_tot, nullptr, MpMax(), -1);
  const int seg_before = mp_block_excl_scan(last_seg, warp_tot, nullptr, MpMax(), -1);
  int run_p = pois_before, run_s = seg_before;
  for (int p = p0; p < p1; ++p) {
    if (p == 0 || skey[p] != skey[p - 1]) run_s = p;
    const int slot = sslot[p];
    const unsigned char f = flags[slot];
    // clear: no poisoned position of my segment before me
    if (run_p < run_s) flags[slot] = f | F_CLEAR;
    if (f & F_POISON) run_p = p;
  }
  __syncthreads();
  // slot order: want = (prefix and not executed) or out-of-order
  const int gap = gap_s;
  const int i0 = tid * ipt, i1 = i0 + ipt < S ? i0 + ipt : S;
  int n_want = 0;
  for (int i = i0; i < i1; ++i) {
    const unsigned char f = flags[i];
    const int abs_i = wb + i;
    const bool pre = f & F_PREFIX, ex = f & F_EXEC;
    const bool ooo = (f & F_COMMITTED) && !ex && !pre && abs_i > cu &&
                     abs_i < gap && (f & F_CLEAR);
    n_want += ((pre && !ex) || ooo) ? 1 : 0;
  }
  int total;
  int rank = mp_block_excl_scan(n_want, warp_tot, &total, MpSum(), 0);
  for (int i = i0; i < i1; ++i) {
    const unsigned char f = flags[i];
    const int abs_i = wb + i;
    const bool pre = f & F_PREFIX, ex = f & F_EXEC;
    const bool ooo = (f & F_COMMITTED) && !ex && !pre && abs_i > cu &&
                     abs_i < gap && (f & F_CLEAR);
    const bool want = (pre && !ex) || ooo;
    bool take = false;
    if (want) {
      if (rank < E) {
        slot_of[row * E + rank] = i;
        take = true;
      }
      ++rank;
    }
    newly[row * S + i] = (unsigned char)take;
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
  if (S < 1 || S > EX_MAX_S || E < 1) return MP_ERR_SHAPE;
  if (rows <= 0) return (int)cudaGetLastError();
  int n2 = 1;
  while (n2 < S) n2 <<= 1;
  const size_t smem = (size_t)n2 * 8 + (size_t)n2 * 2 + (size_t)S;
  if (smem > 227 * 1024) return MP_ERR_SHAPE;
  static size_t optin = 0;
  const int oe = mp_smem_optin((const void*)mp_exec_select_k, smem, &optin);
  if (oe) return oe;
  mp_exec_select_k<<<(int)rows, EX_NT, smem, s>>>(key_hi, key_lo, status, op,
                                                  executed, wbase, cupto, eupto,
                                                  slot_of, newly, S, n2, E);
  return (int)cudaGetLastError();
}
