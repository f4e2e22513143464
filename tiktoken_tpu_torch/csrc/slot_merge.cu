// slot_merge: greedy BPE inside each piece's 16- or 64-byte slot, the
// surviving tokens left-packed; and the per-piece token counts and combos
// that the expansion into the token stream takes.
//
// Replaces (JAX package): ops/slot_merge.py make_slot_merge_fn, at W=16
// (the short misses of B7) and W=64 (the long pieces of B8), with the B8
// glue of ops/pipeline3.py build_pipeline3_fn and ops/pipeline2.py
// build_pipeline2_fn that consumes it: the row-wise compaction of the
// alive lanes, the long whole-piece hits' lane-0 select, the routes of
// the slot counts to their pieces and the single / count / combo selects.
// Plain PyTorch versions: ops/slot_merge.py slot_merge_packed,
// ops/compaction.py piece_counts.
//
// What bounds it on the H100: the pair probes. Each reads a bucket row of
// the pair table (128 bytes, one cache line; 32 MiB of rows for a
// 100,000-rank vocabulary, in the 50 MB L2 only in part); a piece of n
// bytes needs n-1 probes up front and 2 after each merge, and each merge
// waits for the probes before it. A v3 chunk's short misses make 1.37 M
// probes: at 128 bytes each, 175 MB of row reads.
//
// Design:
// - tt_slot_merge_packed: one group of G lanes per slot, the piece held in
//   registers, each lane holding W/G consecutive positions (G per width
//   below, chosen by measurement). A position keeps the token whose first
//   byte it is and the rank of the pair that token starts; the group keeps
//   the alive positions as one bit mask, the same in every lane. The
//   first probes go out together, up to four a lane. Each round takes the
//   minimum rank (__reduce_min_sync) at its leftmost position (a second
//   reduction over the positions at the minimum: the first index wins
//   ties, the reference's rule), merges the pair into its rank, kills the
//   right partner, and probes the two pairs that changed together, so a
//   round costs one probe latency. A probe reads its bucket row's first
//   32-byte sector, and the rest of the row only where those two slots are
//   full and do not match (rank_in_row). Each alive position
//   writes its token at the popcount of the alive bits below it, so the
//   output is left-packed with no compaction pass. The grid strides over
//   the slots below the device count n_real, read on the device: no slot at
//   or past it is read or written, and nothing is zero-filled. A long slot
//   with a whole-piece hit writes that one token.
// - tt_piece_counts: one thread per catalog entry; a merged piece's count
//   is a gather from its slot's count, so nothing is routed.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using tt::RANK_MAX;
constexpr uint32_t EMPTY_KEY = 0xFFFFFFFFu;  // ops/pair_table.py EMPTY_KEY

constexpr int TPB = 256;
constexpr int SLOT = 16;       // ops/pieces.py SLOT
constexpr int LONG_SLOT = 64;  // ops/pieces.py LONG_SLOT

// Lanes per slot of the W=16 and W=64 merges, and the least resident
// blocks per SM the compiler must allow (a register cap); the script
// scripts/slot_merge_profile.py builds this source with other values to
// compare them.
#ifndef TT_SLOT_LANES
#define TT_SLOT_LANES 8
#endif
#ifndef TT_SLOT_MIN_BLOCKS
#define TT_SLOT_MIN_BLOCKS 1
#endif
#ifndef TT_LONG_SLOT_LANES
#define TT_LONG_SLOT_LANES 32
#endif

// The rank of the pair (a, b) from its bucket row, RANK_MAX if absent. A
// row holds 8 slots of (key_a, key_b, rank, pad), filled from slot 0 with
// EMPTY_KEY after the last (ops/pair_table.py build_pair_table), so the
// first empty slot ends the search and the first matching slot wins. The
// caller loaded the row's first 32-byte sector (slots 0 and 1) as q0, q1:
// it answers most probes, since the table holds at most one pair per
// bucket on average; the other six slots are loaded together only when
// both are full and neither matches.
__device__ __forceinline__ uint32_t rank_in_row(const uint4* __restrict__ row, uint4 q0, uint4 q1,
                                                uint32_t a, uint32_t b) {
  if (q0.x == a && q0.y == b) return q0.z;
  if (q0.x == EMPTY_KEY) return RANK_MAX;
  if (q1.x == a && q1.y == b) return q1.z;
  if (q1.x == EMPTY_KEY) return RANK_MAX;
  uint4 q[6];
#pragma unroll
  for (int s = 0; s < 6; ++s) q[s] = __ldg(row + 2 + s);
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    if (q[s].x == a && q[s].y == b) return q[s].z;
    if (q[s].x == EMPTY_KEY) return RANK_MAX;
  }
  return RANK_MAX;
}

// N probes at once: every first sector is loaded before any is compared,
// so the N loads wait out one latency together. A probe that is not
// needed loads nothing and gives RANK_MAX (a token is never EMPTY_KEY).
template <int N>
__device__ __forceinline__ void probe_n(const uint4* __restrict__ buckets, uint32_t mask,
                                        uint32_t seed, const uint32_t (&a)[N],
                                        const uint32_t (&b)[N], const bool (&need)[N],
                                        uint32_t (&r)[N]) {
  const uint4* row[N];
  uint4 q0[N], q1[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    row[i] = buckets + static_cast<long long>(tt::mix_pair(a[i], b[i], seed) & mask) * 8;
    q0[i] = q1[i] = make_uint4(EMPTY_KEY, 0u, 0u, 0u);
    if (need[i]) {
      q0[i] = __ldg(row[i]);
      q1[i] = __ldg(row[i] + 1);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = rank_in_row(row[i], q0[i], q1[i], a[i], b[i]);
}

// a slot's positions as one bit mask: 32 bits for W=16, 64 for W=64
template <int W>
using MaskOf = typename std::conditional<(W > 32), uint64_t, uint32_t>::type;
__device__ __forceinline__ int lowest(uint32_t x) { return __ffs(x) - 1; }  // -1 for 0
__device__ __forceinline__ int lowest(uint64_t x) { return __ffsll(static_cast<long long>(x)) - 1; }
__device__ __forceinline__ int highest(uint32_t x) { return 31 - __clz(x); }  // -1 for 0
__device__ __forceinline__ int highest(uint64_t x) {
  return 63 - __clzll(static_cast<long long>(x));
}
__device__ __forceinline__ int popc(uint32_t x) { return __popc(x); }
__device__ __forceinline__ int popc(uint64_t x) { return __popcll(static_cast<long long>(x)); }
// bits 0..i (i below the mask's width)
template <class Mask>
__device__ __forceinline__ Mask upto(int i) {
  return (Mask(2) << i) - 1;
}

// W-byte slots, G lanes per slot, P = W / G consecutive positions per lane
// (lane t holds positions t*P .. t*P+P-1).
template <int W, int G>
__global__ void __launch_bounds__(TPB, TT_SLOT_MIN_BLOCKS) slot_merge_packed_kernel(
    const uint4* __restrict__ buckets, uint32_t mask, uint32_t seed,
    const uint32_t* __restrict__ byte_to_rank, const uint8_t* __restrict__ slot_bytes,
    const int* __restrict__ lens, int M, const int* __restrict__ n_real_p,
    const int* __restrict__ hit, uint32_t* __restrict__ tok_p, int* __restrict__ count) {
  using Mask = MaskOf<W>;
  constexpr int P = W / G;
  constexpr int B = P < 4 ? P : 4;  // first probes issued together
  static_assert(32 % G == 0 && P * G == W && P <= 16, "lanes per slot");
  const int lane = threadIdx.x & 31;
  const int t = lane % G;
  const int p0 = t * P;  // this lane's first position
  const unsigned gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1) << (lane - t);
  const int n_real = min(__ldg(n_real_p), M);
  const long long n_groups = static_cast<long long>(gridDim.x) * (TPB / G);
  for (long long m = (static_cast<long long>(blockIdx.x) * TPB + threadIdx.x) / G; m < n_real;
       m += n_groups) {
    const long long base = m * W;
    if (hit != nullptr) {
      const int h = __ldg(hit + m);
      if (h != -1) {  // a whole-piece hit: its one token
        if (t == 0) {
          tok_p[base] = static_cast<uint32_t>(h);
          count[m] = 1;
        }
        continue;
      }
    }
    const int L = min(max(__ldg(lens + m), 0), W);
    uint32_t tok[P], rank[P];
#pragma unroll
    for (int q = 0; q < P; ++q)
      tok[q] = p0 + q < L ? __ldg(byte_to_rank + slot_bytes[base + p0 + q]) : 0u;
    // the first probes: each position with the token to its right (the
    // next lane's first token for this lane's last position)
    const uint32_t next0 = G > 1 ? __shfl_down_sync(gmask, tok[0], 1, G) : 0u;
#pragma unroll
    for (int q0 = 0; q0 < P; q0 += B) {
      uint32_t a[B], b[B], r[B];
      bool need[B];
#pragma unroll
      for (int i = 0; i < B; ++i) {
        a[i] = tok[q0 + i];
        b[i] = q0 + i + 1 < P ? tok[(q0 + i + 1) % P] : next0;
        need[i] = p0 + q0 + i + 1 < L;
      }
      probe_n<B>(buckets, mask, seed, a, b, need, r);
#pragma unroll
      for (int i = 0; i < B; ++i) rank[q0 + i] = r[i];
    }
    Mask alive = L == 8 * sizeof(Mask) ? ~Mask(0) : (Mask(1) << L) - 1;  // bits 0..L-1
    while (true) {
      uint32_t r_lane = rank[0];
#pragma unroll
      for (int q = 1; q < P; ++q) r_lane = min(r_lane, rank[q]);
      const uint32_t rmin = G > 1 ? __reduce_min_sync(gmask, r_lane) : r_lane;
      if (rmin == RANK_MAX) break;
      // the leftmost position at the minimum (the first index wins ties)
      unsigned first = 0xFFFFu;
#pragma unroll
      for (int q = P - 1; q >= 0; --q)
        if (rank[q] == rmin) first = p0 + q;
      const int k = static_cast<int>(G > 1 ? __reduce_min_sync(gmask, first) : first);
      const int j = lowest(alive & ~upto<Mask>(k));  // its right partner dies
      alive &= ~(Mask(1) << j);
      const int jn = lowest(alive & ~upto<Mask>(j));      // the token after, -1 if none
      const int l = highest(alive & ((Mask(1) << k) - 1));  // the token before, -1 if none
      uint32_t x_jn = tok[0], x_l = tok[0];
#pragma unroll
      for (int q = 1; q < P; ++q) {
        if ((jn & (P - 1)) == q) x_jn = tok[q];
        if ((l & (P - 1)) == q) x_l = tok[q];
      }
      const uint32_t t_jn = G > 1 ? __shfl_sync(gmask, x_jn, max(jn, 0) / P, G) : x_jn;
      // the two pairs that changed, probed together by the lanes that hold them
      const uint32_t a[2] = {rmin, x_l}, b[2] = {t_jn, rmin};
      const bool need[2] = {k / P == t && jn >= 0, l >= 0 && l / P == t};
      uint32_t r[2];
      probe_n<2>(buckets, mask, seed, a, b, need, r);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int pos = p0 + q;
        if (pos == k) {
          tok[q] = rmin;  // the merged id is the pair's rank
          rank[q] = r[0];
        }
        if (pos == j) rank[q] = RANK_MAX;
        if (pos == l) rank[q] = r[1];
      }
    }
    // left-packed: each alive position at the count of alive positions before it
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int pos = p0 + q;
      if ((alive >> pos) & 1) tok_p[base + popc(alive & ((Mask(1) << pos) - 1))] = tok[q];
    }
    if (t == 0) count[m] = popc(alive);
  }
}

template <int W, int G>
int launch_packed(const void* buckets, int n_buckets, unsigned seed, const void* byte_to_rank,
                  const void* slot_bytes, const void* lens, int M, const void* n_real,
                  const void* hit, void* tok_p, void* count, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slot_merge_packed_kernel<W, G>,
                                                      TPB, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (static_cast<long long>(M) * G + TPB - 1) / TPB;
  const int blocks = static_cast<int>(
      std::min<long long>(need, static_cast<long long>(sms) * std::max(per_sm, 1)));
  slot_merge_packed_kernel<W, G><<<blocks, TPB, 0, st>>>(
      static_cast<const uint4*>(buckets), static_cast<uint32_t>(n_buckets - 1), seed,
      static_cast<const uint32_t*>(byte_to_rank), static_cast<const uint8_t*>(slot_bytes),
      static_cast<const int*>(lens), M, static_cast<const int*>(n_real),
      static_cast<const int*>(hit), static_cast<uint32_t*>(tok_p), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

__global__ void piece_counts_kernel(int p, const int* __restrict__ n_pieces,
                                    const int* __restrict__ lens, const int* __restrict__ hit,
                                    const int* __restrict__ words,
                                    const int* __restrict__ byte_to_rank,
                                    const int* __restrict__ mslot, const int* __restrict__ lslot,
                                    const int* __restrict__ m_count, int m_cap,
                                    const int* __restrict__ l_count, int l_cap,
                                    int* __restrict__ counts, int* __restrict__ combo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  int c = 0, cb = 0;
  if (i < __ldg(n_pieces)) {
    const int L = lens[i];
    const int h = hit[i];
    if (L == 1 || (L >= 2 && L <= SLOT && h != -1)) {  // a single: its token in-band, bit 31 set
      c = 1;
      cb = (L == 1 ? __ldg(byte_to_rank + (__ldg(words + 4ll * i) & 0xFF)) : h) |
           static_cast<int>(0x80000000u);
    } else {
      const int ms = mslot[i];
      const int ls = ms >= 0 ? -1 : lslot[i];
      if (ms >= 0) {  // a short miss: its merged slot's count, tokens from slot * 16
        c = ms < m_cap ? m_count[ms] : 0;
        cb = min(ms, m_cap - 1) * SLOT;
      } else if (ls >= 0) {  // a long piece: from m_cap * 16 + slot * 64
        c = ls < l_cap ? l_count[ls] : 0;
        cb = m_cap * SLOT + min(ls, l_cap - 1) * LONG_SLOT;
      }
    }
  }
  counts[i] = c;
  combo[i] = cb;
}

}  // namespace

// slot_bytes [M, W] u8 (W 16 or 64), lens [M] i32, n_real 0-d i32, hit [M]
// i32 or null -> tok_p [M, W] u32, count [M] i32 for the slots below
// n_real (tokens left-packed, nothing written past a slot's count)
extern "C" int tt_slot_merge_packed(int W, const void* buckets, int n_buckets, unsigned seed,
                                    const void* byte_to_rank, const void* slot_bytes,
                                    const void* lens, int M, const void* n_real, const void* hit,
                                    void* tok_p, void* count, void* stream) {
  if (M <= 0 || n_buckets <= 0 || (n_buckets & (n_buckets - 1)) ||
      reinterpret_cast<uintptr_t>(buckets) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W == SLOT)
    return launch_packed<SLOT, TT_SLOT_LANES>(buckets, n_buckets, seed, byte_to_rank, slot_bytes,
                                              lens, M, n_real, hit, tok_p, count, st);
  if (W == LONG_SLOT)
    return launch_packed<LONG_SLOT, TT_LONG_SLOT_LANES>(buckets, n_buckets, seed, byte_to_rank,
                                                        slot_bytes, lens, M, n_real, hit, tok_p,
                                                        count, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the expansion's per-piece counts and combos of a catalog of p pieces
// (n_pieces 0-d; lens, hit, mslot, lslot [p] i32; words [p, 4] i32) from
// the merged slots' counts m_count [m_cap], l_count [l_cap]
extern "C" int tt_piece_counts(int p, const void* n_pieces, const void* lens, const void* hit,
                               const void* words, const void* byte_to_rank, const void* mslot,
                               const void* lslot, const void* m_count, int m_cap,
                               const void* l_count, int l_cap, void* counts, void* combo,
                               void* stream) {
  if (p <= 0 || m_cap <= 0 || l_cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  piece_counts_kernel<<<(p + TPB - 1) / TPB, TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(n_pieces), static_cast<const int*>(lens),
      static_cast<const int*>(hit), static_cast<const int*>(words),
      static_cast<const int*>(byte_to_rank), static_cast<const int*>(mslot),
      static_cast<const int*>(lslot), static_cast<const int*>(m_count), m_cap,
      static_cast<const int*>(l_count), l_cap, static_cast<int*>(counts), static_cast<int*>(combo));
  return static_cast<int>(cudaGetLastError());
}
