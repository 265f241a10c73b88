// K4: the KV engine's probe and insert.
//
// Replaces ops/kvstore.py kv_lookup_lanes and kv_insert_unique, with
// _cand_pos and ops/packed.py pair_hash. Tables are [B, C] (key_hi,
// key_lo, slot) and [B, C, L] (val) int32; queries are [B, E] rows.
// Each key has two candidate buckets of WAYS ways.
//
// Bound: bytes. A probe reads its 2 x WAYS candidate entries (12 B
// each) and, when found, one value; an insert reads the same and writes
// one entry. The claim rounds are a few hundred integer ops per row.
// Design:
// * lookup: one thread per query row, probing the eight ways in order
//   (the first live match wins, as argmax does in the JAX engine).
// * insert: one block per batch row, so every claim contest of that
//   row's table runs inside the block. Each of the WAYS claim rounds
//   is a scatter-min of the row index into a claims array (one int
//   per bucket), then __syncthreads(); the lowest
//   contending row wins the bucket's r-th free way. Pass A targets the
//   emptier bucket; pass B retries the other bucket with the ways pass
//   A claimed masked out (a bit per position). Pass C
//   places the rows that fit in neither bucket by displacement, when
//   there are any (rare): thread 0 takes the first DISPLACE_ROUNDS
//   failing rows in row order; each moves one resident of its buckets
//   (LIVE before the batch and not written by it) to the first free way
//   of the resident's other bucket and takes its place. The plain twin
//   runs the same rounds in the same order. All table reads happen
//   before the first write; the resident moves land before the rows,
//   and no two writes share a position.
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
#define MAX_RPT 4  // rows per thread: E <= 4 * 1024
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
  const int hi = qhi[i], lo = qlo[i];
  int p = -1;
  if (valid[i]) {
    int b1, b2;
    cand_buckets(C, hi, lo, b1, b2);
#pragma unroll
    for (int w = 0; w < 2 * WAYS; ++w) {
      const int pos = (w < WAYS ? b1 : b2) * WAYS + (w & (WAYS - 1));
      if (slot[tb + pos] == LIVE && key_hi[tb + pos] == hi &&
          key_lo[tb + pos] == lo) {
        p = pos;
        break;
      }
    }
  }
  found[i] = p >= 0;
  for (int l = 0; l < L; ++l)
    out[i * L + l] = p >= 0 ? val[(tb + p) * L + l] : 0;
}

MP_EXPORT int mp_kv_lookup(const int* key_hi, const int* key_lo,
                           const int* val, const int* slot, const int* qhi,
                           const int* qlo, const unsigned char* valid,
                           int* out, unsigned char* found, long long rows,
                           int E, int C, int L, cudaStream_t s) {
  if (C < WAYS || (C & (C - 1))) return MP_ERR_SHAPE;
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

// WAYS claim rounds over the block's rows: the round-r winner of a
// bucket (lowest contending row) takes the bucket's r-th free way;
// winners leave the contest placed or not. Every thread must call it.
__device__ __forceinline__ void assign(const bool (&mask)[MAX_RPT],
                                       const int (&bkt)[MAX_RPT],
                                       const int (&fm)[MAX_RPT],
                                       int (&dest)[MAX_RPT], int* claims) {
  bool rem[MAX_RPT];
#pragma unroll
  for (int j = 0; j < MAX_RPT; ++j) rem[j] = mask[j];
  for (int r = 0; r < WAYS; ++r) {
#pragma unroll
    for (int j = 0; j < MAX_RPT; ++j)
      if (rem[j]) claims[bkt[j]] = INT_MAX;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_RPT; ++j)
      if (rem[j]) atomicMin(&claims[bkt[j]], (int)(threadIdx.x + j * blockDim.x));
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_RPT; ++j) {
      if (rem[j] && claims[bkt[j]] == (int)(threadIdx.x + j * blockDim.x)) {
        const int w = nth_free(fm[j], r);
        if (w >= 0) dest[j] = bkt[j] * WAYS + w;
        rem[j] = false;
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ bool bit_at(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
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
// a template argument, so the shared path keeps shared-memory accesses
template <bool G>
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
  for (int j = threadIdx.x; j < ncw; j += blockDim.x) taken[j] = 0u;

  bool place[MAX_RPT];
  int match[MAX_RPT], bktA[MAX_RPT], fmA[MAX_RPT], bktB[MAX_RPT],
      fm2[MAX_RPT], destA[MAX_RPT], destB[MAX_RPT], destC[MAX_RPT];
#pragma unroll
  for (int j = 0; j < MAX_RPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    place[j] = false;
    match[j] = destA[j] = destB[j] = destC[j] = -1;
    bktA[j] = bktB[j] = fmA[j] = fm2[j] = 0;
    if (i < E) {
      const int hi = khi[rb + i], lo = klo[rb + i];
      int b1, b2;
      cand_buckets(C, hi, lo, b1, b2);
      int f1 = 0, f2 = 0, mp = -1;
#pragma unroll
      for (int w = 0; w < 2 * WAYS; ++w) {
        const int pos = (w < WAYS ? b1 : b2) * WAYS + (w & (WAYS - 1));
        const int s = slot[tb + pos];
        if (mp < 0 && s == LIVE && key_hi[tb + pos] == hi &&
            key_lo[tb + pos] == lo)
          mp = pos;
        if (s == EMPTY) {
          if (w < WAYS) f1 |= 1 << w;
          else f2 |= 1 << (w - WAYS);
        }
      }
      const bool vld = valid[rb + i] != 0;
      const bool pref2 = __popc(f2) > __popc(f1);
      match[j] = vld ? mp : -1;
      place[j] = vld && mp < 0 && !del[rb + i];
      bktA[j] = pref2 ? b2 : b1;
      fmA[j] = pref2 ? f2 : f1;
      bktB[j] = pref2 ? b1 : b2;
      fm2[j] = pref2 ? f1 : f2;
    }
  }
  __syncthreads();
  // pass A: the emptier candidate bucket
  assign(place, bktA, fmA, destA, claims);
#pragma unroll
  for (int j = 0; j < MAX_RPT; ++j)
    if (destA[j] >= 0) atomicOr(&taken[destA[j] >> 5], 1u << (destA[j] & 31));
  __syncthreads();
  // pass B: overflow rows retry the other bucket minus pass-A claims
  bool maskB[MAX_RPT];
  int fmB[MAX_RPT];
#pragma unroll
  for (int j = 0; j < MAX_RPT; ++j) {
    const int bk = bktB[j];
    const unsigned tk = (taken[bk >> 3] >> ((bk & 7) * WAYS)) & 0xFu;
    maskB[j] = place[j] && destA[j] < 0;
    fmB[j] = fm2[j] & ~(int)tk;
  }
  assign(maskB, bktB, fmB, destB, claims);
  bool fail[MAX_RPT];
  bool any_fail = false;
#pragma unroll
  for (int j = 0; j < MAX_RPT; ++j) {
    if (destB[j] >= 0) atomicOr(&taken[destB[j] >> 5], 1u << (destB[j] & 31));
    fail[j] = maskB[j] && destB[j] < 0;
    any_fail |= fail[j];
  }
  // pass C: displacement, only in a table with rows left over
  if (__syncthreads_or(any_fail)) {
    for (int j = threadIdx.x; j < ncw; j += blockDim.x) pinned[j] = 0u;
    for (int j = threadIdx.x; j < nfw; j += blockDim.x) failbits[j] = 0u;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_RPT; ++j) {
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
    for (int j = 0; j < MAX_RPT; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (!fail[j]) continue;
      for (int m = 0; m < nm; ++m)
        if (moves[3 * m] == i) destC[j] = moves[3 * m + 1];
    }
  }
  int lost = 0;
#pragma unroll
  for (int j = 0; j < MAX_RPT; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i >= E) continue;
    const int dest = match[j] >= 0 ? match[j]
                     : destA[j] >= 0 ? destA[j]
                     : destB[j] >= 0 ? destB[j] : destC[j];
    if (fail[j] && destC[j] < 0) ++lost;
    if (dest >= 0) {
      key_hi[tb + dest] = khi[rb + i];
      key_lo[tb + dest] = klo[rb + i];
      for (int l = 0; l < L; ++l) val[(tb + dest) * L + l] = v[(rb + i) * L + l];
      slot[tb + dest] = del[rb + i] ? EMPTY : LIVE;
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

MP_EXPORT int mp_kv_insert(int* key_hi, int* key_lo, int* val, int* slot,
                           int* dropped, const int* khi, const int* klo,
                           const int* v, const unsigned char* del,
                           const unsigned char* valid, long long rows, int E,
                           int C, int L, int* scratch, cudaStream_t s) {
  if (C < WAYS || (C & (C - 1))) return MP_ERR_SHAPE;
  if (rows <= 0 || E <= 0) return (int)cudaGetLastError();
  int threads = ((E + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if ((E + threads - 1) / threads > MAX_RPT) return MP_ERR_SHAPE;
  const long long gstride = mp_kv_insert_scratch_ints(E, C);
  if (gstride && !scratch) return MP_ERR_SHAPE;
  const size_t smem = gstride ? kv_insert_tail_bytes(E)
                              : kv_insert_table_bytes(C) + kv_insert_tail_bytes(E);
  if (smem > 227 * 1024) return MP_ERR_SHAPE;
  if (gstride) {
    mp_kv_insert_k<true><<<(int)rows, threads, smem, s>>>(
        key_hi, key_lo, val, slot, dropped, khi, klo, v, del, valid, E, C, L,
        scratch, gstride);
  } else {
    static size_t optin = 0;
    const int oe = mp_smem_optin((const void*)mp_kv_insert_k<false>, smem, &optin);
    if (oe) return oe;
    mp_kv_insert_k<false><<<(int)rows, threads, smem, s>>>(
        key_hi, key_lo, val, slot, dropped, khi, klo, v, del, valid, E, C, L,
        nullptr, 0);
  }
  return (int)cudaGetLastError();
}
