// K5: run-length ack compression and range-ack vote bits.
//
// Replaces ops/ackruns.py of the JAX package: compress_ack_runs
// (:25-61), range_vote_coverage (:64-124) fused with pack_vote_bits
// (:127-137), and scatter_vote_bits (:140-150), at stride 1 (MinPaxos,
// classic) and stride R (Mencius). Rows are [B, M] int32/bool; votes
// are int32 [B, S] bit masks (bit r = replica r).
//
// Bound: bytes. Compression reads each row's five columns once and
// writes two; coverage reads four columns and writes one int per slot;
// the vote-bit scatter reads three columns and writes [B, S] once.
// Design:
// * compress: one block per batch row. A block scan of the run-start
//   flags gives each row its run id; run lengths are shared-memory
//   atomic counts per run id, read back at every row (the JAX form
//   publishes them at every row, not only at run starts).
// * coverage: one block per (batch row, tile of the window). Each
//   (sender, phase) plane of the difference array lives in shared
//   memory, over the tile's ranks only (slots at stride 1, slot / d at
//   stride d); the window is cut into as many tiles as keep a block's
//   planes within 112 KB (one tile at S = 4096 and R = 5; three at the
//   server's S = 16384 with R = 5). Valid rows clip their rank range to
//   the tile and add +1/-1 with shared-memory atomics, each plane is
//   prefix-summed in place (per-thread chunks, then a per-plane carry),
//   and each thread packs the vote mask of its slots. The [B, S, R]
//   bool coverage of the JAX form never reaches device memory.
// * scatter_vote_bits: a memset, then one thread per row and atomicOr
//   of 1 << src into its slot: order-free, so duplicates and several
//   senders per slot give the same mask.
#include "common.cuh"

constexpr int ACK_NT = 1024;

__global__ void __launch_bounds__(ACK_NT)
mp_compress_k(const unsigned char* __restrict__ is_acc,
              const int* __restrict__ src, const int* __restrict__ inst,
              const unsigned char* __restrict__ ok,
              const int* __restrict__ ballot,
              unsigned char* __restrict__ run_start, int* __restrict__ run_len,
              int m, int stride) {
  extern __shared__ int ack_len[];  // [m + 1] rows per run id
  __shared__ int warp_tot[32];
  const long long base = (long long)blockIdx.x * m;
  for (int i = threadIdx.x; i <= m; i += blockDim.x) ack_len[i] = 0;
  __syncthreads();
  int carry = 0;
  for (int c0 = 0; c0 < m; c0 += blockDim.x) {
    const int i = c0 + threadIdx.x;
    int start = 0;
    bool acc = false;
    if (i < m) {
      const long long k = base + i;
      acc = is_acc[k] != 0;
      bool same = false;
      if (acc && i > 0) {
        same = is_acc[k - 1] != 0 && src[k - 1] == src[k] &&
               (ok[k - 1] != 0) == (ok[k] != 0) &&
               inst[k - 1] + stride == inst[k] &&
               (ballot == nullptr || ballot[k - 1] == ballot[k]);
      }
      start = acc && !same;
    }
    int tot;
    const int before = mp_block_excl_scan(start, warp_tot, &tot, MpSum(), 0);
    const int rid = carry + before + start - 1;
    if (i < m) {
      if (acc) atomicAdd(&ack_len[rid], 1);
      run_start[base + i] = (unsigned char)start;
      run_len[base + i] = rid;  // the run id, until every run is counted
    }
    carry += tot;
  }
  __syncthreads();
  // each thread rereads only the rows it wrote above
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    int rid = run_len[base + i];
    rid = rid < 0 ? 0 : (rid > m ? m : rid);
    run_len[base + i] = ack_len[rid];
  }
}

MP_EXPORT int mp_compress_ack_runs(const unsigned char* is_acc, const int* src,
                                   const int* inst, const unsigned char* ok,
                                   const int* ballot, unsigned char* run_start,
                                   int* run_len, long long rows, int m,
                                   int stride, cudaStream_t s) {
  if (rows <= 0 || m <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)(m + 1) * 4;
  if (smem > 200 * 1024) return MP_ERR_SHAPE;
  static size_t optin = 0;
  const int oe = mp_smem_optin((const void*)mp_compress_k, smem, &optin);
  if (oe) return oe;
  mp_compress_k<<<(int)rows, ACK_NT, smem, s>>>(is_acc, src, inst, ok, ballot,
                                                run_start, run_len, m, stride);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(ACK_NT)
mp_vote_bits_k(const unsigned char* __restrict__ valid,
               const int* __restrict__ src, const int* __restrict__ inst,
               const int* __restrict__ count, const int* __restrict__ wbase,
               int* __restrict__ out, int m, int S, int R, int d, int T,
               int tiles) {
  extern __shared__ int ack_vd[];  // [P][L] difference planes of one tile
  __shared__ int chunk_tot[ACK_NT];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int P = d == 1 ? R : R * d;
  const int L = T + 1;
  const long long row = blockIdx.x / tiles;
  const int k0 = (int)(blockIdx.x % tiles) * T;  // first rank of the tile
  const int k1 = k0 + T;
  for (int i = tid; i < P * L; i += nt) ack_vd[i] = 0;
  __syncthreads();
  const int wb = wbase[row];
  for (int i = tid; i < m; i += nt) {
    const long long k = row * m + i;
    if (!valid[k]) continue;
    const int cnt = count[k] < 1 ? 1 : count[k];
    const int sr = src[k] < 0 ? 0 : (src[k] > R - 1 ? R - 1 : src[k]);
    const int in = inst[k];
    int pl, lo, hi;  // plane, rank range [lo, hi) before the tile clip
    if (d == 1) {
      lo = in - wb;
      hi = in + cnt - wb;
      lo = lo < 0 ? 0 : (lo > S ? S : lo);
      hi = hi < 0 ? 0 : (hi > S ? S : hi);
      pl = sr;
    } else {
      const int rel = in - wb;
      const int j0 = rel < 0 ? (-rel + d - 1) / d : 0;  // ceil(-rel / d)
      const int lo_rel = rel + j0 * d;                  // >= 0
      const int phase = lo_rel % d;
      lo = lo_rel / d;
      const int lim = mp_floordiv(S - 1 - phase, d);
      int rank_hi = lo + (cnt - 1 - j0);
      if (lim < rank_hi) rank_hi = lim;
      if (!(cnt > j0 && lo_rel < S && rank_hi >= lo)) continue;
      hi = rank_hi + 1;
      pl = sr * d + phase;
    }
    if (lo < k0) lo = k0;
    if (hi > k1) hi = k1;
    if (hi > lo) {
      atomicAdd(&ack_vd[pl * L + lo - k0], 1);
      atomicAdd(&ack_vd[pl * L + hi - k0], -1);
    }
  }
  __syncthreads();
  // inclusive prefix sum of every plane: per-thread chunks, then a
  // per-plane scan of the chunk totals, then the chunks again
  int cpp = nt / P;
  if (cpp < 1) cpp = 1;
  const int C = (L + cpp - 1) / cpp;
  const int p = tid / cpp, c = tid % cpp;
  const int a = c * C, e = a + C < L ? a + C : L;
  int sum = 0;
  if (p < P)
    for (int i = a; i < e; ++i) sum += ack_vd[p * L + i];
  chunk_tot[tid] = sum;
  __syncthreads();
  if (tid < P) {
    int run = 0;
    for (int j = 0; j < cpp; ++j) {
      const int t = chunk_tot[tid * cpp + j];
      chunk_tot[tid * cpp + j] = run;
      run += t;
    }
  }
  __syncthreads();
  if (p < P) {
    int run = chunk_tot[tid];
    for (int i = a; i < e; ++i) {
      run += ack_vd[p * L + i];
      ack_vd[p * L + i] = run;
    }
  }
  __syncthreads();
  // the tile's slots: ranks [k0, k1) of every phase
  const int s0 = k0 * d;
  const int s1 = (long long)k1 * d < S ? k1 * d : S;
  for (int s = s0 + tid; s < s1; s += nt) {
    int mask = 0;
    for (int r = 0; r < R; ++r) {
      const int v = d == 1 ? ack_vd[r * L + s - k0]
                           : ack_vd[(r * d + s % d) * L + s / d - k0];
      if (v > 0) mask |= 1 << r;
    }
    out[row * S + s] = mask;
  }
}

// shared memory a vote-bits block may take: two blocks of 1,024 threads
// per SM (an SM holds 228 KB)
constexpr size_t VB_SMEM_BUDGET = 112 * 1024;

MP_EXPORT int mp_range_vote_bits(const unsigned char* valid, const int* src,
                                 const int* inst, const int* count,
                                 const int* wbase, int* out, long long rows,
                                 int m, int S, int R, int d, cudaStream_t s) {
  if (R < 1 || R > 16 || d < 1 || S < 1) return MP_ERR_SHAPE;
  if (rows <= 0) return (int)cudaGetLastError();
  const int P = d == 1 ? R : R * d;
  if (P > ACK_NT) return MP_ERR_SHAPE;
  // ranks per plane (slots at stride 1), tiled so one tile's planes fit
  const int NR = d == 1 ? S : S / d + 2;
  int T = (int)(VB_SMEM_BUDGET / ((size_t)P * 4)) - 1;
  if (T < 1) return MP_ERR_SHAPE;
  if (T > NR) T = NR;
  const int tiles = (NR + T - 1) / T;
  if (rows * tiles > 0x7fffffffLL) return MP_ERR_SHAPE;
  const size_t smem = (size_t)P * (T + 1) * 4;
  static size_t optin = 0;
  const int oe = mp_smem_optin((const void*)mp_vote_bits_k, smem, &optin);
  if (oe) return oe;
  mp_vote_bits_k<<<(int)(rows * tiles), ACK_NT, smem, s>>>(
      valid, src, inst, count, wbase, out, m, S, R, d, T, tiles);
  return (int)cudaGetLastError();
}

__global__ void mp_scatter_vote_bits_k(const int* __restrict__ idx,
                                       const int* __restrict__ src,
                                       const unsigned char* __restrict__ valid,
                                       int* __restrict__ out, long long n,
                                       int m, int size, int R) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int t = idx[i];
  if (t < 0 || t >= size) return;
  const int sr = src[i] < 0 ? 0 : (src[i] > R - 1 ? R - 1 : src[i]);
  atomicOr(out + (i / m) * (long long)size + t, 1 << sr);
}

MP_EXPORT int mp_scatter_vote_bits(const int* idx, const int* src,
                                   const unsigned char* valid, int* out,
                                   long long rows, int m, int size, int R,
                                   cudaStream_t s) {
  if (R < 1 || R > 16) return MP_ERR_SHAPE;
  const long long n_out = rows * (long long)size;
  if (n_out > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)n_out * 4, s);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n = rows * (long long)m;
  if (n > 0)
    mp_scatter_vote_bits_k<<<mp_grid(n, 256), 256, 0, s>>>(idx, src, valid, out,
                                                           n, m, size, R);
  return (int)cudaGetLastError();
}
