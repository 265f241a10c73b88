// K4: the KV engine's probe and insert.
//
// Replaces ops/kvstore.py kv_lookup_lanes and kv_insert_unique, with
// _cand_pos and ops/packed.py pair_hash. Tables are [B, C] (key_hi,
// key_lo, slot) and [B, C, L] (val) int32; queries are [B, E] rows.
// Each key has two candidate buckets of WAYS ways.
//
// Bound: bytes. A probe reads its 2 x WAYS candidate entries (12 B
// each) and, when found, one value. The tables (840 MB at the MinPaxos
// deployment) do not fit the 50 MB L2, so each probe's loads go to
// device memory a sector at a time: the lookup is held back by the
// sectors it touches, not by the bytes it needs. An insert needs less:
// both buckets of slot, key_lo of a bucket with a LIVE way and key_hi
// of a bucket whose key_lo matched; then a placed row writes its whole
// entry, a matched row only its value (and its slot on a delete), a
// delete of an absent key nothing. The claim rounds are a few hundred
// integer ops per row.
// Design:
// * lookup: one thread per query row. Each access is a 16-byte bucket
//   load (a bucket is 4 ints; a table that is not 16-byte aligned is
//   refused) into a sector of its own, so the time goes with the
//   sectors a query touches, not with its bytes. Bucket 1 first: its
//   key_lo, then, only where a way's key_lo matched, its slot and key_hi
//   together with the value of the first match (one more trip only when
//   key_hi or an EMPTY slot rejects that match); bucket 2 the same way
//   only when bucket 1 holds no live match, so the first live match in
//   probe order wins (bucket 1's ways, then bucket 2's, as argmax does
//   in the JAX engine). A hit in bucket 1 touches 4 sectors in 2 round
//   trips, a hit in bucket 2 5 in 3, a miss 2 in 2, where loading the
//   six bucket loads first touches 7 and walking the ways in order takes
//   up to 24 dependent loads. Nothing is read twice, so the loads are
//   read-only and allocate no L1 line.
// * insert: one block per batch row, so every claim contest of that
//   row's table runs inside the block; one row per thread up to 1,024
//   rows (2 or 4 above): a template, so a row's state stays in
//   registers (with four rows' arrays at every E the probe spilled and
//   ran slower than the old kernel). Only valid rows probe: each
//   candidate bucket of slot in one 16-byte load (a bucket is 4 ints;
//   a table that is not 16-byte aligned is refused), key_lo only for
//   a bucket with a LIVE way and key_hi only where key_lo matched;
//   loading all six buckets eagerly reads sectors no row needs. Each of up to WAYS claim rounds is a scatter-min of
//   the row index into a claims array (one int per bucket), then
//   __syncthreads(); the lowest contending row wins the bucket's r-th
//   free way. The rounds stop as soon as no row of the block contends
//   (__syncthreads_or): a round without contenders changes nothing, so
//   the placement is the one all WAYS rounds give. The round-r winner
//   is the row of rank r among its bucket's contenders (every contender
//   of a bucket holds the same free mask), which is JAX's claim order.
//   At E = 512 keys in 8,192 buckets a block has ~16 contended pairs,
//   so rounds 0 and 1 run and rounds 2-3 seldom. Pass A targets the
//   emptier bucket; pass B, only in a block where some row overflowed
//   pass A, retries the other bucket with the ways pass A claimed
//   masked out (a bit per position, cleared and set only then). Pass C
//   places the rows that fit in neither bucket by displacement, when
//   there are any (rare): thread 0 takes the first DISPLACE_ROUNDS
//   failing rows in row order; each moves one resident of its buckets
//   (LIVE before the batch and not written by it) to the first free way
//   of the resident's other bucket and takes its place. The plain twin
//   runs the same rounds in the same order. All table reads happen
//   before the first write; the resident moves land before the rows,
//   and no two writes share a position. A matched way rewrites only its
//   value (and its slot on a delete): its key and LIVE are there. The
//   stores dominate the kernel's time: each placed row dirties a sector
//   of each of the four tables that no other row shares.
// * insert scratch: the claims array (C/4 ints) and the taken/pinned
//   bit arrays (2 x C/32 words) live in the block's shared memory
//   while they fit in 227 KB (C <= 2^17). Above that (the serving
//   deployment runs C = 2^18) they live in a global-memory scratch of
//   [B, C/4 + C/16] ints that the wrapper allocates once per shape;
//   the kernel clears the bit arrays itself and writes every claim
//   word before reading it, so the scratch needs no reset between
//   launches. The claim order, and so the placement, is the same on
//   both paths; __syncthreads() orders the global accesses of the
//   block as it does the shared ones.
#include "common.cuh"

#define WAYS 4
#define EMPTY 0
#define LIVE 1
#define MAX_RPT 4  // rows per thread at most: E <= 4 * 1024
#define DISPLACE_ROUNDS 8  // ops/kvstore.py DISPLACE_ROUNDS

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ unsigned pair_hash(int hi, int lo) {
  unsigned h = mix32((unsigned)lo ^ 0x9E3779B9u);
  return mix32(h ^ (unsigned)hi);
}

__device__ __forceinline__ void cand_buckets(int C, int hi, int lo, int& b1,
                                             int& b2) {
  const int nb = C / WAYS;
  b1 = (int)(pair_hash(hi, lo) & (unsigned)(nb - 1));
  if (nb > 1) {
    const unsigned h2 = pair_hash(lo ^ 0x2545F491, hi ^ 0x61C88647);
    b2 = (b1 + 1 + (int)(h2 % (unsigned)(nb - 1))) % nb;
  } else {
    b2 = b1;
  }
}

// read-only loads that allocate no L1 line (nothing is read twice)
__device__ __forceinline__ int4 ld_na4(const int* p) {
  int4 r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ int2 ld_na2(const int* p) {
  int2 r;
  asm("ld.global.nc.L1::no_allocate.v2.s32 {%0, %1}, [%2];"
      : "=r"(r.x), "=r"(r.y)
      : "l"(p));
  return r;
}

__device__ __forceinline__ int ld_na(const int* p) {
  int r;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}

// bit w: way w of a bucket's 4 ints equals k
__device__ __forceinline__ int ways_eq(int4 x, int k) {
  return (x.x == k) | (x.y == k) << 1 | (x.z == k) << 2 | (x.w == k) << 3;
}

__global__ void mp_kv_lookup_k(const int* __restrict__ key_hi,
                               const int* __restrict__ key_lo,
                               const int* __restrict__ val,
                               const int* __restrict__ slot,
                               const int* __restrict__ qhi,
                               const int* __restrict__ qlo,
                               const unsigned char* __restrict__ valid,
                               int* __restrict__ out,
                               unsigned char* __restrict__ found,
                               long long n, int E, int C, int L) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long tb = (i / E) * (long long)C;
  int p = -1;
  int2 v = make_int2(0, 0);
  if (valid[i]) {
    const int hi = qhi[i], lo = qlo[i];
    int b1, b2;
    cand_buckets(C, hi, lo, b1, b2);
    // bucket 1, then bucket 2 only when bucket 1 holds no live match
    for (int q = 0; q < 2 && p < 0; ++q) {
      const int bk = q ? b2 : b1;
      if (q && b2 == b1) break;
      const long long o = tb + bk * WAYS;
      // the bucket's key_lo
      const int c = ways_eq(ld_na4(key_lo + o), lo);
      if (!c) continue;
      // then its slot and key_hi and the value of its first key_lo
      // match, in flight together
      const int p0 = bk * WAYS + __ffs(c) - 1;
      const int4 s = ld_na4(slot + o), h = ld_na4(key_hi + o);
      if (L == 2) v = ld_na2(val + (tb + p0) * 2);
      const int m = c & ways_eq(s, LIVE) & ways_eq(h, hi);
      if (m) p = bk * WAYS + __ffs(m) - 1;
      // one more trip only when that first match was not the key
      if (L == 2 && p >= 0 && p != p0) v = ld_na2(val + (tb + p) * 2);
    }
  }
  found[i] = p >= 0;
  if (L == 2) {
    // 8-byte aligned: mp_kv_lookup refuses a value table that is not
    *reinterpret_cast<int2*>(out + i * 2) = p >= 0 ? v : make_int2(0, 0);
  } else {
    for (int l = 0; l < L; ++l)
      out[i * L + l] = p >= 0 ? ld_na(val + (tb + p) * L + l) : 0;
  }
}

MP_EXPORT int mp_kv_lookup(const int* key_hi, const int* key_lo,
                           const int* val, const int* slot, const int* qhi,
                           const int* qlo, const unsigned char* valid,
                           int* out, unsigned char* found, long long rows,
                           int E, int C, int L, cudaStream_t s) {
  if (C < WAYS || (C & (C - 1))) return MP_ERR_SHAPE;
  // a bucket in one 16-byte load; a 2-lane value in one 8-byte load
  if (((uintptr_t)key_hi | (uintptr_t)key_lo | (uintptr_t)slot) % 16 ||
      (L == 2 && ((uintptr_t)val | (uintptr_t)out) % 8))
    return MP_ERR_SHAPE;
  const long long n = rows * (long long)E;
  if (n > 0)
    mp_kv_lookup_k<<<mp_grid(n, 256), 256, 0, s>>>(
        key_hi, key_lo, val, slot, qhi, qlo, valid, out, found, n, E, C, L);
  return (int)cudaGetLastError();
}

// index of the r-th set bit of a WAYS-bit free mask, -1 if none
__device__ __forceinline__ int nth_free(int fm, int r) {
#pragma unroll
  for (int w = 0; w < WAYS; ++w) {
    if ((fm >> w) & 1) {
      if (r == 0) return w;
      --r;
    }
  }
  return -1;
}

// Up to WAYS claim rounds over the block's rows: the round-r winner of
// a bucket (lowest contending row) takes the bucket's r-th free way;
// winners leave the contest placed or not. The rounds stop once no row
// of the block contends: a round without contenders changes nothing.
// Every thread must call it; the caller puts a barrier between the
// last round's claim reads and the next writes to ``claims``.
template <int RPT>
__device__ __forceinline__ void assign(const bool (&mask)[RPT],
                                       const int (&bkt)[RPT],
                                       const int (&fm)[RPT],
                                       int (&dest)[RPT], int* claims) {
  bool rem[RPT];
  bool any = false;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    rem[j] = mask[j];
    any |= rem[j];
  }
  for (int r = 0; r < WAYS; ++r) {
    if (!__syncthreads_or(any)) break;
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (rem[j]) claims[bkt[j]] = INT_MAX;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (rem[j]) atomicMin(&claims[bkt[j]], (int)(threadIdx.x + j * blockDim.x));
    __syncthreads();
    any = false;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (rem[j] && claims[bkt[j]] == (int)(threadIdx.x + j * blockDim.x)) {
        const int w = nth_free(fm[j], r);
        if (w >= 0) dest[j] = bkt[j] * WAYS + w;
        rem[j] = false;
      }
      any |= rem[j];
    }
  }
}

// one bucket's WAYS ints of a table row in one 16-byte load: a bucket
// is WAYS = 4 ints and mp_kv_insert refuses a table that is not
// 16-byte aligned
__device__ __forceinline__ void load_bucket(const int* row, int bkt,
                                            int (&o)[WAYS]) {
  const int4 x = *reinterpret_cast<const int4*>(row + bkt * WAYS);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ bool bit_at(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// the ways of ``mask`` whose entry in bucket ``bkt`` of a table row
// equals ``key``; no load when the mask is empty
__device__ __forceinline__ int ways_equal(const int* row, int bkt, int mask,
                                          int key) {
  if (!mask) return 0;
  int o[WAYS];
  load_bucket(row, bkt, o);
  int eq = 0;
#pragma unroll
  for (int w = 0; w < WAYS; ++w) eq |= (o[w] == key) << w;
  return mask & eq;
}

// Pass C, run by one thread: the first DISPLACE_ROUNDS failing rows
// (failbits, in row order) each look through their 2 x WAYS candidate
// ways for a movable resident whose other bucket has a way that is
// neither occupied before the batch nor claimed (taken); the row takes
// the resident's way and the resident moves to that free way. Fills
// moves[3 * m] = (row, from, to) and returns the number of moves.
__device__ int displace(const int* key_hi, const int* key_lo,
                        const int* slot, const int* khi, const int* klo,
                        const unsigned* failbits, int nfw, unsigned* taken,
                        unsigned* pinned, int* moves, int C) {
  int rounds = 0, nm = 0;
  for (int fw = 0; fw < nfw && rounds < DISPLACE_ROUNDS; ++fw) {
    unsigned bits = failbits[fw];
    while (bits && rounds < DISPLACE_ROUNDS) {
      const int i = fw * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      ++rounds;
      int b1, b2;
      cand_buckets(C, khi[i], klo[i], b1, b2);
      for (int w = 0; w < 2 * WAYS; ++w) {
        const int p = (w < WAYS ? b1 : b2) * WAYS + (w & (WAYS - 1));
        if (slot[p] != LIVE || bit_at(pinned, p)) continue;
        int v1, v2;
        cand_buckets(C, key_hi[p], key_lo[p], v1, v2);
        const int alt = p / WAYS == v1 ? v2 : v1;
        int t = -1;
        for (int ww = 0; ww < WAYS && t < 0; ++ww) {
          const int q = alt * WAYS + ww;
          if (slot[q] == EMPTY && !bit_at(taken, q)) t = q;
        }
        if (t < 0) continue;
        moves[3 * nm] = i;
        moves[3 * nm + 1] = p;
        moves[3 * nm + 2] = t;
        ++nm;
        pinned[p >> 5] |= 1u << (p & 31);
        taken[t >> 5] |= 1u << (t & 31);
        break;
      }
    }
  }
  return nm;
}

// G: the claim arrays live in the global scratch (else shared memory);
// a template argument, so the shared path keeps shared-memory accesses.
// RPT: rows per thread (E <= RPT * 1024), so a block of E <= 1024 rows
// holds one row's state per thread in few registers.
template <bool G, int RPT>
__global__ void __launch_bounds__(1024)
mp_kv_insert_k(int* __restrict__ key_hi, int* __restrict__ key_lo,
               int* __restrict__ val, int* __restrict__ slot,
               int* __restrict__ dropped, const int* __restrict__ khi,
               const int* __restrict__ klo, const int* __restrict__ v,
               const unsigned char* __restrict__ del,
               const unsigned char* __restrict__ valid, int E, int C, int L,
               int* gscratch, long long gstride) {
  extern __shared__ int smem[];
  const int nb = C / WAYS;
  const int ncw = (C + 31) / 32, nfw = (E + 31) / 32;
  const long long b = blockIdx.x;
  // claims [nb] and taken/pinned [ncw] each: shared, or this row's
  // slice of the global scratch; failbits [nfw] and moves [3 * DR + 1]
  // always shared
  int* claims = G ? gscratch + b * gstride : smem;
  unsigned* taken = reinterpret_cast<unsigned*>(claims + nb);
  unsigned* pinned = taken + ncw;
  unsigned* failbits = G ? reinterpret_cast<unsigned*>(smem) : pinned + ncw;
  int* moves = reinterpret_cast<int*>(failbits + nfw);
  const long long tb = b * (long long)C;
  const long long rb = b * (long long)E;

  // probe, for valid rows only: each candidate bucket of slot in one
  // load, then key_lo only for a bucket with a LIVE way and key_hi only
  // for a bucket whose key_lo matched
  bool place[RPT];
  int match[RPT], bktA[RPT], fmA[RPT], bktB[RPT], fm2[RPT], destA[RPT],
      destB[RPT], destC[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    place[j] = false;
    match[j] = destA[j] = destB[j] = destC[j] = -1;
    bktA[j] = bktB[j] = fmA[j] = fm2[j] = 0;
    if (i < E && valid[rb + i]) {
      const int hi = khi[rb + i], lo = klo[rb + i];
      int b1, b2;
      cand_buckets(C, hi, lo, b1, b2);
      int s1[WAYS], s2[WAYS];
      load_bucket(slot + tb, b1, s1);
      load_bucket(slot + tb, b2, s2);
      int f1 = 0, f2 = 0, m1 = 0, m2 = 0;
#pragma unroll
      for (int w = 0; w < WAYS; ++w) {
        f1 |= (s1[w] == EMPTY) << w;
        f2 |= (s2[w] == EMPTY) << w;
        m1 |= (s1[w] == LIVE) << w;
        m2 |= (s2[w] == LIVE) << w;
      }
      m1 = ways_equal(key_lo + tb, b1, m1, lo);
      m2 = ways_equal(key_lo + tb, b2, m2, lo);
      m1 = ways_equal(key_hi + tb, b1, m1, hi);
      m2 = ways_equal(key_hi + tb, b2, m2, hi);
      // the first live match in way order, bucket 1's ways first
      match[j] = m1 ? b1 * WAYS + __ffs(m1) - 1 : m2 ? b2 * WAYS + __ffs(m2) - 1 : -1;
      const bool pref2 = __popc(f2) > __popc(f1);
      place[j] = match[j] < 0 && !del[rb + i];
      bktA[j] = pref2 ? b2 : b1;
      fmA[j] = pref2 ? f2 : f1;
      bktB[j] = pref2 ? b1 : b2;
      fm2[j] = pref2 ? f1 : f2;
    }
  }
  // pass A: the emptier candidate bucket
  assign(place, bktA, fmA, destA, claims);
  // pass B: overflow rows retry the other bucket minus pass-A claims,
  // only in a block that has any
  bool maskB[RPT], fail[RPT];
  bool any_b = false, any_fail = false;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    maskB[j] = place[j] && destA[j] < 0;
    fail[j] = false;
    any_b |= maskB[j];
  }
  if (__syncthreads_or(any_b)) {
    for (int j = threadIdx.x; j < ncw; j += blockDim.x) taken[j] = 0u;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (destA[j] >= 0) atomicOr(&taken[destA[j] >> 5], 1u << (destA[j] & 31));
    __syncthreads();
    int fmB[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int bk = bktB[j];
      const unsigned tk = (taken[bk >> 3] >> ((bk & 7) * WAYS)) & 0xFu;
      fmB[j] = fm2[j] & ~(int)tk;
    }
    assign(maskB, bktB, fmB, destB, claims);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (destB[j] >= 0) atomicOr(&taken[destB[j] >> 5], 1u << (destB[j] & 31));
      fail[j] = maskB[j] && destB[j] < 0;
      any_fail |= fail[j];
    }
  }
  // pass C: displacement, only in a table with rows left over (taken
  // then holds every pass-A and pass-B claim)
  if (__syncthreads_or(any_fail)) {
    for (int j = threadIdx.x; j < ncw; j += blockDim.x) pinned[j] = 0u;
    for (int j = threadIdx.x; j < nfw; j += blockDim.x) failbits[j] = 0u;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (match[j] >= 0) atomicOr(&pinned[match[j] >> 5], 1u << (match[j] & 31));
      if (fail[j]) atomicOr(&failbits[i >> 5], 1u << (i & 31));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int nm = displace(key_hi + tb, key_lo + tb, slot + tb, khi + rb,
                              klo + rb, failbits, nfw, taken, pinned, moves, C);
      moves[3 * DISPLACE_ROUNDS] = nm;
      // residents move before any row lands on their old ways
      for (int m = 0; m < nm; ++m) {
        const long long p = tb + moves[3 * m + 1], t = tb + moves[3 * m + 2];
        key_hi[t] = key_hi[p];
        key_lo[t] = key_lo[p];
        for (int l = 0; l < L; ++l) val[t * L + l] = val[p * L + l];
        slot[t] = LIVE;
      }
    }
    __syncthreads();
    const int nm = moves[3 * DISPLACE_ROUNDS];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (!fail[j]) continue;
      for (int m = 0; m < nm; ++m)
        if (moves[3 * m] == i) destC[j] = moves[3 * m + 1];
    }
  }
  int lost = 0;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i >= E) continue;
    const int dest = match[j] >= 0 ? match[j]
                     : destA[j] >= 0 ? destA[j]
                     : destB[j] >= 0 ? destB[j] : destC[j];
    if (fail[j] && destC[j] < 0) ++lost;
    if (dest >= 0) {
      // a matched way already holds the key and LIVE: only its value
      // changes, and its slot when the row deletes
      if (match[j] < 0) {
        key_hi[tb + dest] = khi[rb + i];
        key_lo[tb + dest] = klo[rb + i];
      }
      for (int l = 0; l < L; ++l) val[(tb + dest) * L + l] = v[(rb + i) * L + l];
      if (match[j] < 0 || del[rb + i]) slot[tb + dest] = del[rb + i] ? EMPTY : LIVE;
    }
  }
  if (lost) atomicAdd(dropped + b, lost);
}

static size_t kv_insert_tail_bytes(int E) {
  return (size_t)((E + 31) / 32) * 4 + (size_t)(3 * DISPLACE_ROUNDS + 1) * 4;
}

static size_t kv_insert_table_bytes(int C) {
  return (size_t)(C / WAYS) * 4 + (size_t)((C + 31) / 32) * 8;
}

// Ints of global scratch per batch row that mp_kv_insert needs for a
// [*, C] table and E rows: 0 when everything fits in shared memory.
MP_EXPORT long long mp_kv_insert_scratch_ints(int E, int C) {
  if (C < WAYS || (C & (C - 1)) || E <= 0) return 0;
  if (kv_insert_table_bytes(C) + kv_insert_tail_bytes(E) <= 227 * 1024) return 0;
  return (long long)(kv_insert_table_bytes(C) / 4);
}

struct KvInsertArgs {
  int *key_hi, *key_lo, *val, *slot, *dropped;
  const int *khi, *klo, *v;
  const unsigned char *del, *valid;
  int E, C, L;
  int* scratch;
};

// The launch shape of mp_kv_insert for E rows into [*, C] tables:
// rows per thread, threads, the global scratch stride (0: shared) and
// the dynamic shared memory. Returns MP_ERR_SHAPE for a shape the
// kernel does not take.
static int kv_insert_shape(int E, int C, int& rpt, int& threads,
                           long long& gstride, size_t& smem) {
  if (C < WAYS || (C & (C - 1)) || E <= 0) return MP_ERR_SHAPE;
  rpt = E <= 1024 ? 1 : E <= 2048 ? 2 : MAX_RPT;
  threads = (((E + rpt - 1) / rpt + 31) / 32) * 32;
  if (threads > 1024) return MP_ERR_SHAPE;
  gstride = mp_kv_insert_scratch_ints(E, C);
  smem = gstride ? kv_insert_tail_bytes(E)
                 : kv_insert_table_bytes(C) + kv_insert_tail_bytes(E);
  return smem > 227 * 1024 ? MP_ERR_SHAPE : 0;
}

template <bool G, int RPT>
static int kv_insert_launch(const KvInsertArgs& a, long long rows, int threads,
                            long long gstride, size_t smem, cudaStream_t s) {
  static size_t optin = 0;
  const int oe = mp_smem_optin((const void*)mp_kv_insert_k<G, RPT>, smem, &optin);
  if (oe) return oe;
  mp_kv_insert_k<G, RPT><<<(int)rows, threads, smem, s>>>(
      a.key_hi, a.key_lo, a.val, a.slot, a.dropped, a.khi, a.klo, a.v, a.del,
      a.valid, a.E, a.C, a.L, a.scratch, gstride);
  return 0;
}

template <bool G>
static int kv_insert_rpt(const KvInsertArgs& a, long long rows, int rpt,
                         int threads, long long gstride, size_t smem,
                         cudaStream_t s) {
  if (rpt == 1) return kv_insert_launch<G, 1>(a, rows, threads, gstride, smem, s);
  if (rpt == 2) return kv_insert_launch<G, 2>(a, rows, threads, gstride, smem, s);
  return kv_insert_launch<G, MAX_RPT>(a, rows, threads, gstride, smem, s);
}

MP_EXPORT int mp_kv_insert(int* key_hi, int* key_lo, int* val, int* slot,
                           int* dropped, const int* khi, const int* klo,
                           const int* v, const unsigned char* del,
                           const unsigned char* valid, long long rows, int E,
                           int C, int L, int* scratch, cudaStream_t s) {
  if (C < WAYS || (C & (C - 1))) return MP_ERR_SHAPE;
  if (rows <= 0 || E <= 0) return (int)cudaGetLastError();
  int rpt, threads;
  long long gstride;
  size_t smem;
  if (kv_insert_shape(E, C, rpt, threads, gstride, smem)) return MP_ERR_SHAPE;
  if (gstride && !scratch) return MP_ERR_SHAPE;
  // the probe reads a bucket in one 16-byte load
  if (((uintptr_t)key_hi | (uintptr_t)key_lo | (uintptr_t)slot) % 16) return MP_ERR_SHAPE;
  const KvInsertArgs a{key_hi, key_lo, val, slot, dropped, khi, klo, v, del,
                       valid, E, C, L, gstride ? scratch : nullptr};
  const int rc = gstride ? kv_insert_rpt<true>(a, rows, rpt, threads, gstride, smem, s)
                         : kv_insert_rpt<false>(a, rows, rpt, threads, 0, smem, s);
  return rc ? rc : (int)cudaGetLastError();
}

