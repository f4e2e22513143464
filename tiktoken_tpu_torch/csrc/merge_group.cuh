// The greedy merge of one piece by a group of lanes, shared by the slot
// merges (slot_merge.cu) and the v1 grid merge (grid_merge.cu): the pair
// probes, the alive-mask helpers and the merge rounds.
//
// A group of G lanes holds a piece of at most W bytes in registers, each
// lane W/G consecutive positions. A position keeps the token whose first
// byte it is and the rank of the pair that token starts; the group keeps
// the alive positions as one bit mask, the same in every lane. The first
// probes go out together, up to four a lane. Each round takes the minimum
// rank (__reduce_min_sync) at its leftmost position (a second reduction
// over the positions at the minimum: the first index wins ties, the
// reference's rule), merges the pair into its rank, kills the right
// partner, and probes the two pairs that changed together, so a round
// costs one probe latency. A probe reads its bucket row's first 32-byte
// sector, and the rest of the row only where those two slots are full and
// do not match (rank_in_row). Each alive position writes its token at the
// popcount of the alive bits below it, so the output is left-packed.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tt {

constexpr uint32_t EMPTY_KEY = 0xFFFFFFFFu;  // ops/pair_table.py EMPTY_KEY

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

// N probes at once: every first load is issued before any is compared,
// so the N loads wait out one latency together. A probe that is not
// needed loads nothing and gives RANK_MAX (a token is never EMPTY_KEY).
// ONE_LOAD false loads the row's first 32-byte sector (slots 0 and 1) as
// two 16-byte loads; true loads slot 0 only, and slot 1 where slot 0 is
// full and does not match, then from L1, which the first load filled with
// the sector: one L2 request a probe where two loads may make two.
template <int N, bool ONE_LOAD = false>
__device__ __forceinline__ void probe_n(const uint4* __restrict__ buckets, uint32_t mask,
                                        uint32_t seed, const uint32_t (&a)[N],
                                        const uint32_t (&b)[N], const bool (&need)[N],
                                        uint32_t (&r)[N]) {
  const uint4* row[N];
  uint4 q0[N], q1[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    row[i] = buckets + static_cast<long long>(mix_pair(a[i], b[i], seed) & mask) * 8;
    q0[i] = q1[i] = make_uint4(EMPTY_KEY, 0u, 0u, 0u);
    if (need[i]) {
      q0[i] = __ldg(row[i]);
      if (!ONE_LOAD) q1[i] = __ldg(row[i] + 1);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (ONE_LOAD && q0[i].x != EMPTY_KEY && !(q0[i].x == a[i] && q0[i].y == b[i]))
      q1[i] = __ldg(row[i] + 1);
    r[i] = rank_in_row(row[i], q0[i], q1[i], a[i], b[i]);
  }
}

// a piece's positions as one bit mask: 32 bits up to W=32, 64 for W=64
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

// The greedy merge of the piece bytes[0..L) (L <= W) by a group of G lanes
// (gmask: the group's lanes; t: this lane's index in it, holding positions
// t*P .. t*P+P-1, P = W / G). Writes the surviving tokens left-packed to
// out[0..n) and returns n, in every lane of the group.
template <int W, int G>
__device__ __forceinline__ int group_merge(const uint4* __restrict__ buckets, uint32_t mask,
                                           uint32_t seed, const uint32_t* __restrict__ byte_to_rank,
                                           const uint8_t* __restrict__ bytes, int L, int t,
                                           unsigned gmask, uint32_t* __restrict__ out) {
  using Mask = MaskOf<W>;
  constexpr int P = W / G;
  constexpr int B = P < 4 ? P : 4;  // first probes issued together
  static_assert(32 % G == 0 && P * G == W && P <= 16, "lanes per piece");
  const int p0 = t * P;  // this lane's first position
  uint32_t tok[P], rank[P];
#pragma unroll
  for (int q = 0; q < P; ++q) tok[q] = p0 + q < L ? __ldg(byte_to_rank + bytes[p0 + q]) : 0u;
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
    if ((alive >> pos) & 1) out[popc(alive & ((Mask(1) << pos) - 1))] = tok[q];
  }
  return popc(alive);
}

}  // namespace tt
