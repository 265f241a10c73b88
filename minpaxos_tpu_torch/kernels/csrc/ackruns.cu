// K5: run-length ack compression and range-ack vote bits.
//
// Replaces ops/ackruns.py of the JAX package: compress_ack_runs
// (:25-61); range_vote_coverage (:64-124) fused with pack_vote_bits
// (:127-137) and with the OR of the bits into the votes table
// (models/minpaxos.py:875, models/mencius.py:416, there under the
// driven-slot mask); and scatter_vote_bits (:140-150) fused with the OR
// of its delta into pvotes (models/minpaxos.py:493,
// models/mencius.py:498). Stride 1 for
// MinPaxos and classic, stride R for Mencius. Rows are [B, M]
// int32/bool; votes are int32 [B, S] bit masks (bit r = replica r).
//
// Bound: bytes. Compression reads the ACCEPT flags of every row, the
// run-key columns of ACCEPT rows, and writes two columns; vote bits read
// the valid flags of every row, three columns of the valid rows, and
// write one int per slot (reading the votes row and the mask too when
// fused); the pvotes scatter reads the valid flags of every row, two
// columns of the valid rows, the pvotes row, and writes one int per slot.
// Design:
// * ack_runs: one block per batch row; each thread owns C consecutive
//   rows, loaded as 16-byte vectors (a chunk with no ACCEPT row loads
//   no column). A run is a maximal stretch of ACCEPT rows that continue
//   each other, so a row's run length is end - start of its run: one
//   block scan of warp shuffles gives each row, forward, the latest run
//   start and the latest run end before it (two halfwords under one
//   per-halfword max) and, backward, the next break after it. An ACCEPT
//   row takes next break - start, a row after a run takes run end -
//   start, and the rows before the first run take run 0's length
//   (JAX's run id clipped to 0). No atomics, no run ids through memory.
// * vote_bits: one block per (batch row, tile of the window), 512
//   threads, at most 40 registers, so three blocks share an SM. The
//   block first counts its row's valid acks (16-byte loads, one
//   barrier). A row with none (4 of 5 on the MinPaxos path: only a
//   leader takes ACCEPT_REPLYs) copies its votes row, or writes zeros,
//   two 16-byte loads in flight a thread, and stops. A row with at most
//   VB_LIST acks (the main path's leader rows: one range per follower
//   and run) keeps their ranges as a list in shared memory, and each
//   slot tests it. A row with more takes the difference planes: every
//   (phase, sender) plane over the tile's ranks, two planes to a 32-bit
//   word while M < 2^15 (a plane's prefix count is at most M, so the
//   halves never carry into each other; one a word beyond); the planes lie back to back and a range that
//   reaches the tile's end puts its -1 into the next plane's first cell,
//   so every plane sums to 0 and one flat prefix sum of the whole array
//   (per-thread chunks of an odd number of 16-byte words, free of bank
//   conflicts, and one block scan) gives every plane's counts with no
//   serial carry. A row's valid acks are loaded 5 rows a thread at once,
//   their columns only for valid rows. Each thread then packs 4 slots at
//   a time and ORs them into its votes (under the mask) with 16-byte
//   loads and stores. The [B, S, R] coverage never reaches device
//   memory, nor do the unmerged bits.
// * scatter_vote_bits, fused with the OR into the pvotes table: one
//   block per (batch row, tile of 1,024 slots), no memset and no global
//   atomics. The block first asks whether its row holds any valid row
//   (16-byte loads of the flags, one __syncthreads_or), with its
//   16-byte word of the votes already in flight. A row with none (every
//   row outside an election or a takeover) copies its tile of the votes
//   (or writes zeros) and stops. A row with valid rows takes the tile
//   into shared memory and ORs 1 << clamp(src) into each slot of the
//   tile a valid row names: order-free, so duplicates and several
//   senders per slot give the same mask. An index in [-size, 0) counts
//   from the end, as JAX's scatter takes it; any other index outside
//   [0, size) is dropped.
#include <algorithm>

#include "common.cuh"

// ------------------------------------------------------------ ack_runs

constexpr int AR_MAX_NT = 1024;

// Exclusive block scans of one value per thread in both directions at
// once: ``fw`` forward under a per-halfword unsigned max (identity 0),
// ``bw`` backward under min (identity ``bw_ident``). Every thread of the
// block calls it once; blockDim.x is a multiple of 32.
__device__ __forceinline__ void ar_scan2(unsigned fw, int bw, int bw_ident,
                                         unsigned* fw_ex, int* bw_ex) {
  __shared__ unsigned warp_fw[32];
  __shared__ int warp_bw[32];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (int)(blockDim.x >> 5);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned f = __shfl_up_sync(full, fw, d);
    const int b = __shfl_down_sync(full, bw, d);
    if (lane >= d) fw = __vmaxu2(f, fw);
    if (lane + d < 32) bw = min(bw, b);
  }
  unsigned fe = __shfl_up_sync(full, fw, 1);
  int be = __shfl_down_sync(full, bw, 1);
  if (lane == 0) fe = 0u;
  if (lane == 31) {
    be = bw_ident;
    warp_fw[w] = fw;  // the warp's forward total
  }
  if (lane == 0) warp_bw[w] = bw;  // the warp's backward total
  __syncthreads();
  if (w == 0) {
    unsigned t = lane < nw ? warp_fw[lane] : 0u;
    int u = lane < nw ? warp_bw[lane] : bw_ident;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned f = __shfl_up_sync(full, t, d);
      const int b = __shfl_down_sync(full, u, d);
      if (lane >= d) t = __vmaxu2(f, t);
      if (lane + d < 32) u = min(u, b);
    }
    if (lane < nw) {
      warp_fw[lane] = t;
      warp_bw[lane] = u;
    }
  }
  __syncthreads();
  *fw_ex = w > 0 ? __vmaxu2(warp_fw[w - 1], fe) : fe;
  *bw_ex = w + 1 < nw ? min(warp_bw[w + 1], be) : be;
}

// VEC: m % C == 0 and every pointer 16-byte aligned, so each thread's
// rows are whole 16-byte words of the int columns and whole 4-byte
// words of the byte columns.
template <int C>
__global__ void __launch_bounds__(AR_MAX_NT)
mp_ack_runs_k(const unsigned char* __restrict__ is_acc,
              const int* __restrict__ src, const int* __restrict__ inst,
              const unsigned char* __restrict__ ok,
              const int* __restrict__ ballot,
              unsigned char* __restrict__ run_start, int* __restrict__ run_len,
              int m, int stride, int vec) {
  static_assert(C % 4 == 0 && C <= 32, "C rows per thread: a multiple of 4, at most 32");
  __shared__ int len0;  // run 0's length: the rows before the first run take it
  const unsigned full = 0xffffffffu;
  const long long base = (long long)blockIdx.x * m;
  const int i0 = threadIdx.x * C;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) len0 = 0;
  bool acc[C], okv[C];
  int sv[C], iv[C], bv[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    acc[j] = okv[j] = false;
    sv[j] = iv[j] = bv[j] = 0;
  }
  if (vec && i0 < m) {
    const long long k = base + i0;
    unsigned a4[C / 4];
    unsigned any = 0;
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      a4[q] = reinterpret_cast<const unsigned*>(is_acc + k)[q];
      any |= a4[q];
    }
    if (any) {  // a chunk with no ACCEPT row reads no column
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const unsigned o4 = reinterpret_cast<const unsigned*>(ok + k)[q];
        const int4 s4 = reinterpret_cast<const int4*>(src + k)[q];
        const int4 n4 = reinterpret_cast<const int4*>(inst + k)[q];
        sv[4 * q] = s4.x, sv[4 * q + 1] = s4.y, sv[4 * q + 2] = s4.z, sv[4 * q + 3] = s4.w;
        iv[4 * q] = n4.x, iv[4 * q + 1] = n4.y, iv[4 * q + 2] = n4.z, iv[4 * q + 3] = n4.w;
        if (ballot != nullptr) {
          const int4 b4 = reinterpret_cast<const int4*>(ballot + k)[q];
          bv[4 * q] = b4.x, bv[4 * q + 1] = b4.y, bv[4 * q + 2] = b4.z, bv[4 * q + 3] = b4.w;
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[4 * q + t] = (a4[q] >> (8 * t)) & 0xff;
          okv[4 * q + t] = (o4 >> (8 * t)) & 0xff;
        }
      }
    }
  } else if (!vec) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int i = i0 + j;
      if (i < m && is_acc[base + i]) {
        acc[j] = true;
        okv[j] = ok[base + i] != 0;
        sv[j] = src[base + i];
        iv[j] = inst[base + i];
        if (ballot != nullptr) bv[j] = ballot[base + i];
      }
    }
  }
  // the row before the chunk: the previous lane's last row, or memory
  bool pa = __shfl_up_sync(full, (int)acc[C - 1], 1) != 0;
  bool po = __shfl_up_sync(full, (int)okv[C - 1], 1) != 0;
  int ps = __shfl_up_sync(full, sv[C - 1], 1);
  int pi = __shfl_up_sync(full, iv[C - 1], 1);
  int pb = __shfl_up_sync(full, bv[C - 1], 1);
  if (lane == 0) {
    pa = false;
    if (i0 > 0 && i0 <= m && is_acc[base + i0 - 1]) {
      const long long k = base + i0 - 1;
      pa = true;
      po = ok[k] != 0;
      ps = src[k];
      pi = inst[k];
      pb = ballot != nullptr ? ballot[k] : 0;
    }
  }
  // bit j: row i0 + j starts a run / breaks (is no continuation) / ends
  // the run before it
  unsigned st_m = 0, br_m = 0, end_m = 0;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const bool same = pa && sv[j] == ps && okv[j] == po &&
                      (unsigned)pi + (unsigned)stride == (unsigned)iv[j] &&
                      bv[j] == pb;
    const bool st = acc[j] && !same;
    const bool br = !acc[j] || st;
    st_m |= (unsigned)st << j;
    br_m |= (unsigned)br << j;
    end_m |= (unsigned)(pa && br) << j;
    pa = acc[j], po = okv[j], ps = sv[j], pi = iv[j], pb = bv[j];
  }
  // chunk summaries: latest start + 1 and latest run end + 1 as two
  // halfwords (0: none), and the first break (m: none)
  const unsigned a_loc = st_m ? (unsigned)(i0 + 32 - __clz(st_m)) : 0u;
  const unsigned e_loc = end_m ? (unsigned)(i0 + 32 - __clz(end_m)) : 0u;
  const int br_loc = br_m ? i0 + __ffs(br_m) - 1 : m;
  unsigned fw_ex;
  int nxt;
  ar_scan2((a_loc << 16) | e_loc, br_loc, m, &fw_ex, &nxt);
  int a = (int)(fw_ex >> 16) - 1, re = (int)(fw_ex & 0xffffu) - 1;
  // next break after each row (m past the last)
  int after[C];
#pragma unroll
  for (int j = C - 1; j >= 0; --j) {
    after[j] = nxt;
    if ((br_m >> j) & 1) nxt = i0 + j;
  }
  if (a < 0 && st_m) {  // this chunk holds the row's first run start
    const int j = __ffs(st_m) - 1;
    len0 = after[j] - (i0 + j);
  }
  int len[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if ((st_m >> j) & 1) a = i0 + j;
    if ((end_m >> j) & 1) re = i0 + j;
    len[j] = a < 0 ? -1 : (acc[j] ? after[j] : re) - a;
  }
  __syncthreads();
  const int l0 = len0;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (len[j] < 0) len[j] = l0;
  if (i0 >= m) return;
  if (vec) {
    const long long k = base + i0;
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      reinterpret_cast<unsigned*>(run_start + k)[q] =
          ((st_m >> (4 * q)) & 1u) | (((st_m >> (4 * q + 1)) & 1u) << 8) |
          (((st_m >> (4 * q + 2)) & 1u) << 16) | (((st_m >> (4 * q + 3)) & 1u) << 24);
      reinterpret_cast<int4*>(run_len + k)[q] =
          make_int4(len[4 * q], len[4 * q + 1], len[4 * q + 2], len[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (i0 + j < m) {
        run_start[base + i0 + j] = (unsigned char)((st_m >> j) & 1);
        run_len[base + i0 + j] = len[j];
      }
    }
  }
}

template <int C>
static void ar_launch(long long rows, int m, cudaStream_t s,
                      const unsigned char* is_acc, const int* src,
                      const int* inst, const unsigned char* ok,
                      const int* ballot, unsigned char* run_start,
                      int* run_len, int stride) {
  const int nt = ((m + C - 1) / C + 31) / 32 * 32;
  const int vec = m % C == 0 &&
                  (((uintptr_t)is_acc | (uintptr_t)src | (uintptr_t)inst |
                    (uintptr_t)ok | (uintptr_t)ballot | (uintptr_t)run_start |
                    (uintptr_t)run_len) % 16) == 0;
  mp_ack_runs_k<C><<<(int)rows, nt, 0, s>>>(is_acc, src, inst, ok, ballot,
                                           run_start, run_len, m, stride, vec);
}

MP_EXPORT int mp_compress_ack_runs(const unsigned char* is_acc, const int* src,
                                   const int* inst, const unsigned char* ok,
                                   const int* ballot, unsigned char* run_start,
                                   int* run_len, long long rows, int m,
                                   int stride, cudaStream_t s) {
  if (rows <= 0 || m <= 0) return (int)cudaGetLastError();
  // positions + 1 ride in halfwords; at most 1,024 threads of C rows
  if (m > 32 * AR_MAX_NT || rows > 0x7fffffffLL) return MP_ERR_SHAPE;
  if (m <= 8 * AR_MAX_NT)
    ar_launch<8>(rows, m, s, is_acc, src, inst, ok, ballot, run_start, run_len, stride);
  else if (m <= 16 * AR_MAX_NT)
    ar_launch<16>(rows, m, s, is_acc, src, inst, ok, ballot, run_start, run_len, stride);
  else
    ar_launch<32>(rows, m, s, is_acc, src, inst, ok, ballot, run_start, run_len, stride);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- vote_bits

constexpr int VB_NT = 512;
// plane bytes a vote-bits block takes at most (three blocks share an SM)
constexpr int VB_SMEM_BYTES = 48 * 1024;
// blocks a launch should offer (two per SM of an H100's 132): few rows
// cut the window into more tiles
constexpr int VB_FILL_BLOCKS = 264;
constexpr int VB_MIN_TILE = 256;  // ranks a tile holds at least
// inbox rows a thread loads at once: the deployments' inboxes (at most
// 2,560 rows) in one pass, every load in flight together
constexpr int VB_ROWS = 5;
// valid rows a batch row takes as a list of ranges, tested slot by slot,
// without planes
constexpr int VB_LIST = 16;
// flags: the valid flags read as 16-byte words; the slots 4 at a time
constexpr int VB_VALID16 = 1, VB_VEC4 = 2;
constexpr int VB_MIN_BLOCKS = 3;  // resident blocks per SM the build asks for

// Calls f(plane, lo, hi) for every valid row of the block's batch row
// whose range covers ranks [lo, hi) of the tile [k0, k1); plane =
// phase * R + sender.
template <typename F>
__device__ __forceinline__ void vb_ranges(const unsigned char* __restrict__ vr,
                                          const int* __restrict__ src,
                                          const int* __restrict__ inst,
                                          const int* __restrict__ count,
                                          long long base, int m, int wb, int S,
                                          int R, int d, int k0, int k1, F f) {
  const int nt = blockDim.x;
  for (int i0 = threadIdx.x; i0 < m; i0 += nt * VB_ROWS) {
    bool v[VB_ROWS];
    int cn[VB_ROWS], sr[VB_ROWS], in[VB_ROWS];
#pragma unroll
    for (int j = 0; j < VB_ROWS; ++j) {
      const int i = i0 + j * nt;
      v[j] = i < m && vr[i];
      cn[j] = sr[j] = in[j] = 0;
    }
#pragma unroll
    for (int j = 0; j < VB_ROWS; ++j) {
      if (v[j]) {
        const long long k = base + i0 + j * nt;
        cn[j] = count[k];
        sr[j] = src[k];
        in[j] = inst[k];
      }
    }
#pragma unroll
    for (int j = 0; j < VB_ROWS; ++j) {
      if (!v[j]) continue;
      const int cnt = cn[j] < 1 ? 1 : cn[j];
      const int s_ = sr[j] < 0 ? 0 : (sr[j] > R - 1 ? R - 1 : sr[j]);
      int pl, lo, hi;  // plane, rank range [lo, hi) before the tile clip
      if (d == 1) {
        lo = in[j] - wb;
        hi = in[j] + cnt - wb;
        lo = lo < 0 ? 0 : (lo > S ? S : lo);
        hi = hi < 0 ? 0 : (hi > S ? S : hi);
        pl = s_;
      } else {
        const int rel = in[j] - wb;
        const int j0 = rel < 0 ? (-rel + d - 1) / d : 0;  // ceil(-rel / d)
        const int lo_rel = rel + j0 * d;                  // >= 0
        const int phase = lo_rel % d;
        lo = lo_rel / d;
        const int lim = mp_floordiv(S - 1 - phase, d);
        int rank_hi = lo + (cnt - 1 - j0);
        if (lim < rank_hi) rank_hi = lim;
        if (!(cnt > j0 && lo_rel < S && rank_hi >= lo)) continue;
        hi = rank_hi + 1;
        pl = phase * R + s_;
      }
      if (lo < k0) lo = k0;
      if (hi > k1) hi = k1;
      if (hi > lo) f(pl, lo, hi);
    }
  }
}

// The vote mask of slot s from the scanned planes of a tile starting at
// rank k0: bit r set where plane (phase, r) counts a range over s.
__device__ __forceinline__ int vb_slot_bits(const int* __restrict__ pl, int s,
                                            int k0, int R, int d, int T,
                                            int pk) {
  const int rank = d == 1 ? s : s / d;
  const int cell = rank - k0, p0 = (s - rank * d) * R;
  int bits = 0, w = 0;
  for (int r = 0; r < R; ++r) {
    const int p = p0 + r;
    if (pk == 1) {
      w = pl[p * T + cell];
      bits |= (w > 0) << r;
    } else {
      if (r == 0 || !(p & 1)) w = pl[(p >> 1) * T + cell];
      bits |= (((p & 1) ? (unsigned)w >> 16 : (unsigned)w & 0xffffu) != 0) << r;
    }
  }
  return bits;
}

// How a tile's slots get their bits: none, from the range list, or from
// the scanned planes.
enum VbMode { VB_NONE = 0, VB_BY_LIST = 1, VB_BY_PLANES = 2 };

__global__ void __launch_bounds__(VB_NT, VB_MIN_BLOCKS)
mp_vote_bits_k(const unsigned char* __restrict__ valid,
               const int* __restrict__ src, const int* __restrict__ inst,
               const int* __restrict__ count, const int* __restrict__ wbase,
               const int* __restrict__ into,
               const unsigned char* __restrict__ mask, int* __restrict__ out,
               int m, int S, int R, int d, int T, int tiles, int pk,
               int flags) {
  // [Q][T] difference planes of one tile, plane p = phase * R + sender
  // in word p / pk (the high half for odd p when pk == 2); or, while the
  // row has at most VB_LIST valid acks, their ranges (lo, hi, phase, bit)
  extern __shared__ __align__(16) int vb_pl[];
  __shared__ int warp_tot[32], warp_cnt[32];
  __shared__ int n_list;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long row = blockIdx.x / tiles;
  const int k0 = (int)(blockIdx.x % tiles) * T;  // first rank of the tile
  const int k1 = k0 + T;
  const int Q = (R * d + pk - 1) / pk, N = Q * T;
  const unsigned char* vr = valid + row * m;
  int4* pl4 = reinterpret_cast<int4*>(vb_pl);
  if (tid == 0) n_list = 0;
  // how many valid acks the row holds (bool bytes are 0 or 1)
  int cnt = 0;
  if (flags & VB_VALID16) {
    for (int i = tid; i < m / 16; i += nt) {
      const uint4 v = reinterpret_cast<const uint4*>(vr)[i];
      cnt += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
  } else {
    for (int i = tid; i < m; i += nt) cnt += vr[i] != 0;
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((tid & 31) == 0) warp_cnt[tid >> 5] = cnt;
  __syncthreads();
  int n_valid = 0;
  for (int w = 0; w < nt / 32; ++w) n_valid += warp_cnt[w];
  // the tile's slots: ranks [k0, k1) of every phase
  const int s0 = k0 * d;
  const int s1 = (long long)k1 * d < S ? k1 * d : S;
  int* orow = out + row * S;
  const int* irow = into != nullptr ? into + row * S : nullptr;
  const unsigned char* mrow = mask != nullptr ? mask + row * S : nullptr;
  if (n_valid == 0 && (flags & VB_VEC4)) {
    // no valid ack: copy the votes row (or write zeros), two 16-byte
    // loads in flight a thread
    for (int s = s0 + 4 * tid; s < s1; s += 8 * nt) {
      const int s2 = s + 4 * nt;
      int4 a = make_int4(0, 0, 0, 0), b = a;
      if (irow != nullptr) {
        a = *reinterpret_cast<const int4*>(irow + s);
        if (s2 < s1) b = *reinterpret_cast<const int4*>(irow + s2);
      }
      *reinterpret_cast<int4*>(orow + s) = a;
      if (s2 < s1) *reinterpret_cast<int4*>(orow + s2) = b;
    }
    return;
  }
  int mode = n_valid == 0 ? VB_NONE : n_valid <= VB_LIST ? VB_BY_LIST : VB_BY_PLANES;
  int n = 0;
  const int wb = n_valid ? wbase[row] : 0;
  if (mode == VB_BY_LIST) {
    vb_ranges(vr, src, inst, count, row * m, m, wb, S, R, d, k0, k1,
              [&](int pl, int lo, int hi) {
                const int at = atomicAdd(&n_list, 1);
                pl4[at] = make_int4(lo, hi, pl / R, 1 << (pl % R));
              });
    __syncthreads();
    n = n_list;
    if (n == 0) mode = VB_NONE;
  } else if (mode == VB_BY_PLANES) {
    for (int i = tid; i < N / 4; i += nt) pl4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    vb_ranges(vr, src, inst, count, row * m, m, wb, S, R, d, k0, k1,
              [&](int pl, int lo, int hi) {
                const int q = pk == 2 ? pl >> 1 : pl;
                const int inc = pk == 2 && (pl & 1) ? 65536 : 1;
                atomicAdd(&vb_pl[q * T + lo - k0], inc);
                // at the tile's end: the next plane's first cell (none past
                // the last)
                const int e = q * T + hi - k0;
                if (e < N) atomicAdd(&vb_pl[e], -inc);
              });
    __syncthreads();
    // one inclusive prefix sum over all N words: each thread a chunk of
    // an odd number of 16-byte words (a quarter warp's chunks then start
    // in distinct banks), one block scan of the chunk totals
    const int c4 = ((N / 4 + nt - 1) / nt) | 1;
    const int a = min(tid * c4, N / 4), e = min(a + c4, N / 4);
    int sum = 0;
    for (int i = a; i < e; ++i) {
      const int4 v = pl4[i];
      sum += v.x + v.y + v.z + v.w;
    }
    int run = mp_block_excl_scan(sum, warp_tot, nullptr, MpSum(), 0);
    for (int i = a; i < e; ++i) {
      int4 v = pl4[i];
      v.x += run;
      v.y += v.x;
      v.z += v.y;
      v.w += v.z;
      run = v.w;
      pl4[i] = v;
    }
    __syncthreads();
  }
  if (flags & VB_VEC4) {
    // slots s..s+3 from their votes o and mask bytes mk
    auto emit = [&](int s, int4 o, unsigned mk) {
      if (mode != VB_NONE) {
        int b[4] = {0, 0, 0, 0};
        if (mode == VB_BY_LIST) {
          int rk[4], ph[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            rk[t] = d == 1 ? s + t : (s + t) / d;
            ph[t] = s + t - rk[t] * d;
          }
          for (int e = 0; e < n; ++e) {
            const int4 g = pl4[e];
#pragma unroll
            for (int t = 0; t < 4; ++t)
              if (ph[t] == g.z && rk[t] >= g.x && rk[t] < g.y) b[t] |= g.w;
          }
        } else if (d == 1) {  // 4 slots: one 16-byte word of each plane word
          for (int q = 0; q * pk < R; ++q) {
            const int4 w = pl4[(q * T + s - k0) / 4];
            const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              if (pk == 1) {
                b[t] |= (ws[t] > 0) << q;
              } else {
                b[t] |= (((unsigned)ws[t] & 0xffffu) != 0) << (2 * q);
                if (2 * q + 1 < R) b[t] |= (((unsigned)ws[t] >> 16) != 0) << (2 * q + 1);
              }
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) b[t] = vb_slot_bits(vb_pl, s + t, k0, R, d, T, pk);
        }
        o.x |= mk & 0xffu ? b[0] : 0;
        o.y |= mk & 0xff00u ? b[1] : 0;
        o.z |= mk & 0xff0000u ? b[2] : 0;
        o.w |= mk & 0xff000000u ? b[3] : 0;
      }
      *reinterpret_cast<int4*>(orow + s) = o;
    };
    for (int s = s0 + 4 * tid; s < s1; s += 4 * nt)
      emit(s, irow != nullptr ? *reinterpret_cast<const int4*>(irow + s) : make_int4(0, 0, 0, 0),
           mrow != nullptr ? *reinterpret_cast<const unsigned*>(mrow + s) : ~0u);
  } else {
    for (int s = s0 + tid; s < s1; s += nt) {
      int o = irow != nullptr ? irow[s] : 0;
      if (mode != VB_NONE && (mrow == nullptr || mrow[s])) {
        if (mode == VB_BY_LIST) {
          const int rk = d == 1 ? s : s / d, ph = s - rk * d;
          for (int e = 0; e < n; ++e) {
            const int4 g = pl4[e];
            if (ph == g.z && rk >= g.x && rk < g.y) o |= g.w;
          }
        } else {
          o |= vb_slot_bits(vb_pl, s, k0, R, d, T, pk);
        }
      }
      orow[s] = o;
    }
  }
}

MP_EXPORT int mp_range_vote_bits(const unsigned char* valid, const int* src,
                                 const int* inst, const int* count,
                                 const int* wbase, const int* into,
                                 const unsigned char* mask, int* out,
                                 long long rows, int m, int S, int R, int d,
                                 cudaStream_t s) {
  if (R < 1 || R > 16 || d < 1 || S < 1 || m < 0) return MP_ERR_SHAPE;
  if (rows <= 0) return (int)cudaGetLastError();
  // two planes per word while a prefix count (at most m) fits 15 bits
  const int pk = m < 32768 ? 2 : 1;
  const int Q = (R * d + pk - 1) / pk;
  const int NR = (S + d - 1) / d;  // ranks per plane
  int T = (VB_SMEM_BYTES / (Q * 4)) & ~3;
  if (T < 4) return MP_ERR_SHAPE;
  const long long want = (VB_FILL_BLOCKS + rows - 1) / rows;  // tiles a row may take
  int fill = (int)((NR + want - 1) / want);
  fill = (fill < VB_MIN_TILE ? VB_MIN_TILE : fill + 3) & ~3;
  if (fill < T) T = fill;
  if (((NR + 3) & ~3) < T) T = (NR + 3) & ~3;
  const int tiles = (NR + T - 1) / T;
  if (rows * tiles > 0x7fffffffLL) return MP_ERR_SHAPE;
  const int flags =
      (m % 16 == 0 && (uintptr_t)valid % 16 == 0 ? VB_VALID16 : 0) |
      (S % 4 == 0 && (((uintptr_t)out | (uintptr_t)into) % 16) == 0 &&
               (uintptr_t)mask % 4 == 0
           ? VB_VEC4
           : 0);
  // the planes, or the range list in the same bytes
  const size_t smem = std::max((size_t)Q * T * 4, (size_t)VB_LIST * 16);
  // with the block's static shared memory (under 1 KB) it may pass the
  // default 48 KB
  static size_t optin = 0;
  const int oe = mp_smem_optin((const void*)mp_vote_bits_k, smem + 1024, &optin);
  if (oe) return oe;
  mp_vote_bits_k<<<(int)(rows * tiles), VB_NT, smem, s>>>(
      valid, src, inst, count, wbase, into, mask, out, m, S, R, d, T, tiles,
      pk, flags);
  return (int)cudaGetLastError();
}

// --------------------------------------------------- scatter_vote_bits

constexpr int SV_NT = 256;  // threads a block
// slots a block: one 16-byte word of int32 votes a thread, 4 KB of shared
constexpr int SV_TILE = 4 * SV_NT;
// flags: the valid flags read as 16-byte words; the slots as 16-byte words
constexpr int SV_VALID16 = 1, SV_VEC4 = 2;

__global__ void __launch_bounds__(SV_NT)
mp_scatter_vote_bits_k(const int* __restrict__ idx, const int* __restrict__ src,
                       const unsigned char* __restrict__ valid,
                       const int* __restrict__ into, int* __restrict__ out,
                       int m, int size, int R, int tiles, int flags) {
  __shared__ __align__(16) int tile[SV_TILE];
  const int tid = threadIdx.x;
  const long long row = blockIdx.x / tiles;
  const int t0 = (int)(blockIdx.x % tiles) * SV_TILE;
  const int n = min(SV_TILE, size - t0);  // slots of this tile
  const unsigned char* vr = valid + row * m;
  const int* irow = into != nullptr ? into + row * size + t0 : nullptr;
  int* orow = out + row * size + t0;
  const bool vec = flags & SV_VEC4;
  // the thread's votes, loaded before the count so both are in flight
  int4 v4 = make_int4(0, 0, 0, 0);
  if (vec && irow != nullptr && 4 * tid < n)
    v4 = reinterpret_cast<const int4*>(irow)[tid];
  // does the row hold a valid row at all (bool bytes are 0 or 1)
  unsigned any = 0;
  if (flags & SV_VALID16) {
    for (int i = tid; i < m / 16; i += SV_NT) {
      const uint4 w = reinterpret_cast<const uint4*>(vr)[i];
      any |= w.x | w.y | w.z | w.w;
    }
  } else {
    for (int i = tid; i < m; i += SV_NT) any |= vr[i];
  }
  if (!__syncthreads_or(any != 0)) {
    // the steady state: the tile of ``into`` (or zeros) copied through
    if (vec) {
      if (4 * tid < n) reinterpret_cast<int4*>(orow)[tid] = v4;
    } else {
      for (int s = tid; s < n; s += SV_NT) orow[s] = irow != nullptr ? irow[s] : 0;
    }
    return;
  }
  if (vec) {
    if (4 * tid < n) reinterpret_cast<int4*>(tile)[tid] = v4;
  } else {
    for (int s = tid; s < n; s += SV_NT) tile[s] = irow != nullptr ? irow[s] : 0;
  }
  __syncthreads();
  const long long base = row * m;
  for (int i = tid; i < m; i += SV_NT) {
    if (!vr[i]) continue;
    int t = idx[base + i];
    if (t < 0) t += size;  // a negative index counts from the end, once
    t -= t0;
    if (t < 0 || t >= n) continue;  // another tile's, or outside [0, size)
    const int sr = src[base + i];
    atomicOr(&tile[t], 1 << (sr < 0 ? 0 : (sr > R - 1 ? R - 1 : sr)));
  }
  __syncthreads();
  if (vec) {
    if (4 * tid < n) reinterpret_cast<int4*>(orow)[tid] = reinterpret_cast<const int4*>(tile)[tid];
  } else {
    for (int s = tid; s < n; s += SV_NT) orow[s] = tile[s];
  }
}

MP_EXPORT int mp_scatter_vote_bits(const int* idx, const int* src,
                                   const unsigned char* valid, const int* into,
                                   int* out, long long rows, int m, int size,
                                   int R, cudaStream_t s) {
  if (R < 1 || R > 16 || m < 0 || size < 0) return MP_ERR_SHAPE;
  if (rows <= 0 || size == 0) return (int)cudaGetLastError();
  const int tiles = (size + SV_TILE - 1) / SV_TILE;
  if (rows * tiles > 0x7fffffffLL) return MP_ERR_SHAPE;
  const int flags =
      (m % 16 == 0 && (uintptr_t)valid % 16 == 0 ? SV_VALID16 : 0) |
      (size % 4 == 0 && (((uintptr_t)out | (uintptr_t)into) % 16) == 0 ? SV_VEC4 : 0);
  mp_scatter_vote_bits_k<<<(int)(rows * tiles), SV_NT, 0, s>>>(
      idx, src, valid, into, out, m, size, R, tiles, flags);
  return (int)cudaGetLastError();
}
