// grid_merge: greedy BPE over whole rows of the v1 program, and the packing
// of each row's surviving tokens.
//
// Replaces (JAX package): ops/merge.py make_merge_fn (B13, the full-grid
// lockstep merge: every round merges the leftmost minimum-rank pair of
// every piece) and the row assembly of ops/engine.py build_pipeline_fn
// (B14: alive tokens packed to the front of each row, per-row counts).
// Plain PyTorch version: ops/merge.py grid_merge.
//
// What bounds it on the H100: the pair probes. A piece of n bytes needs
// n-1 probes up front and two per merge, each a random 32-byte sector of
// a 32 MiB bucket table, and each merge waits for the probes before it. A
// v2 chunk's rows (C=32768, K=256) hold about 1.3 M pieces and make about
// 20 M probes; random reads that many run at the L2's request rate, not
// at HBM's (scripts/v1_merge_profile.py), so each probe makes one request
// where it can. The lockstep rounds of the JAX kernel exist only because
// the TPU has no cheap per-piece control flow, and are not carried over.
//
// Design: every piece is merged from its bytes (no whole-piece shortcut),
// the pieces taken from a list of the chunk's pieces sorted by length, so
// the pieces of a warp make about as many merge rounds as each other:
//   1. list_kernel<false>: each warp walks rows right to left by ballot and
//      finds every piece (a piece starts at column 0 or at a piece start
//      and stops before the next piece start or the payload end: exactly
//      the pairs the JAX kernel forms); its length class (1..16 bytes one
//      class each, 17..64, 65 and more) is counted per block in shared
//      memory, then once per block in the chunk's class counts;
//   2. list_kernel<true>: the same walk writes each piece (flat head
//      position, length) into its class's part of the list, each block's
//      place taken with one atomic per class;
//   3. merge_wide_kernel (9-64 bytes) then merge_short_kernel (up to 8),
//      each launch with its own register budget: the grid strides over
//      warps of the classes, each warp of one class. Up to 16 bytes a lane
//      takes a piece, its tokens and ranks in the warp's shared arrays
//      (lane_merge: the pieces of a warp have the same length, so its
//      lanes run the same rounds); 17-64 bytes a group of 8 lanes holds a
//      piece in registers (tt::group_merge). Each piece's survivors go
//      over its own columns of a token scratch, with RANK_MAX after them
//      when fewer survive than the piece has bytes;
//   4. long_kernel: one warp per piece of more than 64 bytes (up to the
//      row: "x" * 9000 gives 256-byte pieces), the piece in shared memory
//      with next / previous links; each round finds the leftmost minimum
//      by two reductions over the lanes' strided positions and probes the
//      two changed pairs from two lanes;
//   5. pack_kernel: one warp per row; a column survives when no RANK_MAX
//      lies between its piece's head and it; the survivors are packed to
//      the row's front by ballot, zero after, with the row's count.
// The most merges of any piece goes to `rounds` with one atomicMax per
// warp (the JAX round count: one round per merge of the longest chain).

#include <algorithm>
#include <mutex>

#include "merge_group.cuh"

namespace {

using tt::RANK_MAX;

// The least resident blocks per SM of the two merge launches (a register
// cap).
constexpr int MINB_SHORT = 3;
constexpr int MINB_WIDE = 4;
// A one-lane piece's probes load their bucket row's slot 0 first
// (tt::probe_n's ONE_LOAD), so a probe makes one L2 request, not two.
constexpr bool ONE_LOAD = true;

constexpr unsigned FULL = 0xffffffffu;
constexpr int TPB = 256;
constexpr int WARPS = TPB / 32;
constexpr int ROWS_PER_BLOCK = 32;  // of the list passes
constexpr int NSHORT = 17;          // classes of up to 64 bytes: 1..16, 17..64
constexpr int NCLASS = NSHORT + 1;  // and the long pieces
constexpr int META = 64;            // scratch words before the list: counts, fills
constexpr int LONG_WARPS = 4;       // pieces per block of long_kernel

__host__ __device__ constexpr int class_of(int L) { return L <= 16 ? L - 1 : L <= 64 ? 16 : 17; }
__host__ __device__ constexpr int width_of(int c) { return c < 8 ? 8 : c < 16 ? 16 : 64; }
// lanes per piece: one up to 16 bytes, 8 (8 positions each) for 17-64
__host__ __device__ constexpr int lanes_of(int W) { return W == 64 ? 8 : 1; }

// The pieces of a row below its payload end nv, right to left: f(column,
// length). The piece starts of 8 chunks of 32 columns are loaded together.
template <class F>
__device__ __forceinline__ void walk_row(const uint8_t* __restrict__ ps, int nv, int lane, F f) {
  int end = nv;  // the first piece head right of the chunk in hand
  for (int g1 = (nv + 31) >> 5; g1 > 0; g1 -= 8) {
    const int g0 = max(g1 - 8, 0);
    bool head[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = (g0 + q) * 32 + lane;
      head[q] = g0 + q < g1 && k < nv && (k == 0 || ps[k]);
    }
    unsigned m[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) m[q] = __ballot_sync(FULL, head[q]);
#pragma unroll
    for (int q = 7; q >= 0; --q) {
      const int c0 = (g0 + q) * 32;
      const unsigned above = m[q] & ~((2u << lane) - 1);
      if (head[q]) f(c0 + lane, (above ? c0 + __ffs(above) - 1 : end) - (c0 + lane));
      if (m[q]) end = c0 + __ffs(m[q]) - 1;
    }
  }
}

// Pass 1 (SCATTER false): the pieces' class counts into meta[0..NCLASS),
// and `rounds` zeroed for the merges' atomicMax.
// Pass 2 (SCATTER true): each piece (flat head, length) into its class's
// part of the list, which starts at the sum of the earlier classes'
// counts; meta[NCLASS..2*NCLASS) count the entries placed so far.
template <bool SCATTER>
__global__ void __launch_bounds__(TPB) list_kernel(const uint8_t* __restrict__ piece_start,
                                                   const int* __restrict__ n_payload, int C,
                                                   int K, int* __restrict__ meta,
                                                   int2* __restrict__ list,
                                                   int* __restrict__ rounds) {
  __shared__ int s_cnt[NCLASS], s_base[NCLASS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!SCATTER && blockIdx.x == 0 && threadIdx.x == 0) *rounds = 0;
  if (threadIdx.x < NCLASS) s_cnt[threadIdx.x] = 0;
  __syncthreads();
  const int r0 = blockIdx.x * ROWS_PER_BLOCK;
  const int r1 = min(r0 + ROWS_PER_BLOCK, C);
  for (int r = r0 + warp; r < r1; r += WARPS)
    walk_row(piece_start + static_cast<long long>(r) * K, min(max(__ldg(n_payload + r), 0), K),
             lane, [&](int, int L) { atomicAdd(&s_cnt[class_of(L)], 1); });
  __syncthreads();
  if (threadIdx.x < NCLASS) {
    const int c = threadIdx.x;
    if (!SCATTER) {
      if (s_cnt[c]) atomicAdd(meta + c, s_cnt[c]);
    } else {
      int off = 0;
      for (int i = 0; i < c; ++i) off += meta[i];
      s_base[c] = off + (s_cnt[c] ? atomicAdd(meta + NCLASS + c, s_cnt[c]) : 0);
      s_cnt[c] = 0;
    }
  }
  if (!SCATTER) return;
  __syncthreads();
  for (int r = r0 + warp; r < r1; r += WARPS) {
    const long long row = static_cast<long long>(r) * K;
    walk_row(piece_start + row, min(max(__ldg(n_payload + r), 0), K), lane, [&](int k, int L) {
      const int c = class_of(L);
      list[s_base[c] + atomicAdd(&s_cnt[c], 1)] = make_int2(static_cast<int>(row + k), L);
    });
  }
}

struct MergeArgs {
  const uint4* buckets;
  uint32_t mask, seed;
  const uint32_t* byte_to_rank;
  const uint8_t* rows;
  int KL, K;
  const int2* list;
  uint32_t* tok;  // [C, K] scratch: each piece's survivors over its own columns
};

// One lane's greedy merge of a piece of L <= W bytes, its tokens and ranks
// in this warp's shared arrays at [i * 32 + lane] (a bank per lane), the
// alive positions as a mask: each round scans the ranks for the leftmost
// minimum (strict compare), merges the pair into its rank, kills the
// right partner and probes the two changed pairs together. The warp's
// pieces have the same length, so its lanes run the same rounds. Writes
// the survivors left-packed to out and returns their count.
template <int W>
__device__ __forceinline__ int lane_merge(const MergeArgs& a, const uint8_t* __restrict__ bytes,
                                          int L, uint32_t* tok, uint32_t* rank,
                                          uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < L; ++i) tok[i * 32 + lane] = __ldg(a.byte_to_rank + bytes[i]);
  for (int i0 = 0; i0 < L; i0 += 4) {  // the first probes, four at once
    uint32_t x[4], y[4], r[4];
    bool need[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = i0 + s;
      need[s] = i + 1 < L;
      x[s] = need[s] ? tok[i * 32 + lane] : 0u;
      y[s] = need[s] ? tok[(i + 1) * 32 + lane] : 0u;
    }
    tt::probe_n<4, ONE_LOAD>(a.buckets, a.mask, a.seed, x, y, need, r);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (i0 + s < L) rank[(i0 + s) * 32 + lane] = r[s];
  }
  using Mask = tt::MaskOf<W>;
  Mask alive = (Mask(1) << L) - 1;
  while (true) {
    uint32_t rmin = RANK_MAX;
    int k = 0;
    for (int i = 0; i + 1 < L; ++i) {
      const uint32_t r = rank[i * 32 + lane];
      if (r < rmin) {  // strict: the leftmost minimum wins
        rmin = r;
        k = i;
      }
    }
    if (rmin == RANK_MAX) break;
    const int j = tt::lowest(alive & ~tt::upto<Mask>(k));  // its right partner dies
    alive &= ~(Mask(1) << j);
    const int jn = tt::lowest(alive & ~tt::upto<Mask>(j));      // the token after, -1 if none
    const int l = tt::highest(alive & ((Mask(1) << k) - 1));  // the token before, -1 if none
    const uint32_t x[2] = {rmin, l >= 0 ? tok[l * 32 + lane] : 0u};
    const uint32_t y[2] = {jn >= 0 ? tok[jn * 32 + lane] : 0u, rmin};
    const bool need[2] = {jn >= 0, l >= 0};
    uint32_t r[2];
    tt::probe_n<2, ONE_LOAD>(a.buckets, a.mask, a.seed, x, y, need, r);
    tok[k * 32 + lane] = rmin;  // the merged id is the pair's rank
    rank[k * 32 + lane] = r[0];
    rank[j * 32 + lane] = RANK_MAX;
    if (l >= 0) rank[l * 32 + lane] = r[1];
  }
  int n = 0;
  for (int i = 0; i < L; ++i)
    if ((alive >> i) & 1) out[n++] = tok[i * 32 + lane];
  return n;
}

// The u-th warp of class c (padded width W): its 32 / G pieces, G lanes
// each (one lane, over shared arrays, up to 16 bytes). Returns the merges
// of this lane's piece (0 past the class).
template <int W>
__device__ __forceinline__ int merge_warp(const MergeArgs& a, int lane, long long first,
                                          long long end, long long u, uint32_t* arrays) {
  constexpr int G = lanes_of(W);
  const int t = lane % G;
  const long long i = first + u * (32 / G) + lane / G;
  if (i >= end) return 0;  // the whole group leaves together
  const int2 e = a.list[i];
  const int row = e.x / a.K;
  const uint8_t* bytes = a.rows + static_cast<long long>(row) * a.KL + (e.x - row * a.K);
  int n;
  if (G == 1) {
    n = lane_merge<W>(a, bytes, e.y, arrays, arrays + W * 32, a.tok + e.x);
  } else {
    const unsigned gmask = G == 32 ? FULL : ((1u << G) - 1) << (lane - t);
    n = tt::group_merge<W, G>(a.buckets, a.mask, a.seed, a.byte_to_rank, bytes, e.y, t, gmask,
                              a.tok + e.x);
  }
  if (t == 0 && n < e.y) a.tok[e.x + n] = RANK_MAX;
  return e.y - n;
}

// The warps of the classes [LO, HI), each of one class: pieces of up to 8
// bytes in one launch, of 9-64 bytes in another, each launch with its own
// register budget. The widest class goes first, so its longer chains of
// rounds start with the launch.
template <int LO, int HI, int WMAX>
__device__ __forceinline__ void merge_classes(const MergeArgs& a, const int* __restrict__ meta,
                                              int* __restrict__ rounds) {
  // each warp's shared token and rank arrays for its one-lane pieces
  __shared__ uint32_t s_arrays[WARPS][2 * WMAX * 32];
  uint32_t* arrays = s_arrays[threadIdx.x >> 5];
  // per class, widest first: its first list entry, its first warp
  __shared__ long long s_first[HI - LO], s_end[HI - LO], s_warp[HI - LO + 1];
  if (threadIdx.x == 0) {
    long long e = 0, w = 0;
    for (int c = 0; c < LO; ++c) e += meta[c];
    for (int c = LO; c < HI; ++c) {
      s_first[HI - 1 - c] = e;
      e += meta[c];
      s_end[HI - 1 - c] = e;
    }
    for (int x = 0; x < HI - LO; ++x) {
      s_warp[x] = w;
      w += ((s_end[x] - s_first[x]) * lanes_of(width_of(HI - 1 - x)) + 31) / 32;
    }
    s_warp[HI - LO] = w;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int most = 0;
  for (long long u = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
       u < s_warp[HI - LO]; u += static_cast<long long>(gridDim.x) * WARPS) {
    int x = 0;
    while (u >= s_warp[x + 1]) ++x;  // the same in every lane
    const long long w = u - s_warp[x];
    int m;
    switch (width_of(HI - 1 - x)) {
      case 8: m = merge_warp<8>(a, lane, s_first[x], s_end[x], w, arrays); break;
      case 16: m = merge_warp<16>(a, lane, s_first[x], s_end[x], w, arrays); break;
      default: m = merge_warp<64>(a, lane, s_first[x], s_end[x], w, arrays); break;
    }
    most = max(most, m);
  }
  most = __reduce_max_sync(FULL, most);
  if (lane == 0 && most > 0) atomicMax(rounds, most);
}

__global__ void __launch_bounds__(TPB, MINB_SHORT)
    merge_short_kernel(MergeArgs a, const int* __restrict__ meta, int* __restrict__ rounds) {
  merge_classes<0, 8, 8>(a, meta, rounds);
}

__global__ void __launch_bounds__(TPB, MINB_WIDE)
    merge_wide_kernel(MergeArgs a, const int* __restrict__ meta, int* __restrict__ rounds) {
  merge_classes<8, NSHORT, 16>(a, meta, rounds);
}

// per-warp shared memory of long_kernel: tok u32[K], rank u32[K], nxt,
// prv u16[K]
__host__ __device__ inline size_t long_smem(int K) {
  return (static_cast<size_t>(12) * K + 15) & ~static_cast<size_t>(15);
}

// One probe from this lane when `need` (RANK_MAX otherwise).
__device__ __forceinline__ uint32_t probe1(const MergeArgs& a, uint32_t x, uint32_t y, bool need) {
  const uint32_t xa[1] = {x}, ya[1] = {y};
  const bool na[1] = {need};
  uint32_t r[1];
  tt::probe_n<1>(a.buckets, a.mask, a.seed, xa, ya, na, r);
  return r[0];
}

__global__ void __launch_bounds__(LONG_WARPS * 32) long_kernel(MergeArgs a,
                                                               const int* __restrict__ meta,
                                                               int* __restrict__ rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* mine = smem + warp * long_smem(a.K);
  uint32_t* tok = reinterpret_cast<uint32_t*>(mine);
  uint32_t* rank = tok + a.K;
  uint16_t* nxt = reinterpret_cast<uint16_t*>(rank + a.K);
  uint16_t* prv = nxt + a.K;
  long long first = 0;
  for (int c = 0; c < NSHORT; ++c) first += meta[c];
  const int n_long = meta[NSHORT];
  int most = 0;
  for (int p = blockIdx.x * LONG_WARPS + warp; p < n_long; p += gridDim.x * LONG_WARPS) {
    const int2 e = a.list[first + p];
    const int L = e.y;
    const int row = e.x / a.K;
    const uint8_t* bytes = a.rows + static_cast<long long>(row) * a.KL + (e.x - row * a.K);
    for (int i = lane; i < L; i += 32) {
      tok[i] = __ldg(a.byte_to_rank + bytes[i]);
      nxt[i] = static_cast<uint16_t>(i + 1);
      prv[i] = static_cast<uint16_t>(i - 1);  // 0xFFFF for position 0
    }
    __syncwarp();
    for (int i0 = 0; i0 < L; i0 += 4 * 32) {  // the first probes, four a lane at once
      uint32_t x[4], y[4], r[4];
      bool need[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = i0 + s * 32 + lane;
        need[s] = i + 1 < L;
        x[s] = need[s] ? tok[i] : 0u;
        y[s] = need[s] ? tok[i + 1] : 0u;
      }
      tt::probe_n<4>(a.buckets, a.mask, a.seed, x, y, need, r);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (i0 + s * 32 + lane < L) rank[i0 + s * 32 + lane] = r[s];
    }
    __syncwarp();
    int merges = 0;
    while (true) {
      uint32_t r_lane = RANK_MAX;
      for (int i = lane; i < L; i += 32) r_lane = min(r_lane, rank[i]);
      const uint32_t rmin = __reduce_min_sync(FULL, r_lane);
      if (rmin == RANK_MAX) break;
      unsigned at = FULL;  // the leftmost position at the minimum
      for (int i = lane; i < L; i += 32)
        if (rank[i] == rmin) {
          at = i;
          break;
        }
      const int k = static_cast<int>(__reduce_min_sync(FULL, at));
      const int j = nxt[k];  // its right partner dies
      const int jn = nxt[j];                   // L if none
      const int l = k > 0 ? prv[k] : -1;       // position 0 never dies
      const uint32_t t_jn = jn < L ? tok[jn] : 0u, t_l = l >= 0 ? tok[l] : 0u;
      // the two pairs that changed, probed together by lanes 0 and 1
      const uint32_t r = probe1(a, lane == 0 ? rmin : t_l, lane == 0 ? t_jn : rmin,
                                lane == 0 ? jn < L : lane == 1 && l >= 0);
      __syncwarp();
      if (lane == 0) {
        tok[k] = rmin;  // the merged id is the pair's rank
        rank[k] = jn < L ? r : RANK_MAX;
        rank[j] = RANK_MAX;
        tok[j] = RANK_MAX;  // dead
        nxt[k] = static_cast<uint16_t>(jn);
        if (jn < L) prv[jn] = static_cast<uint16_t>(k);
      }
      if (lane == 1 && l >= 0) rank[l] = r;
      __syncwarp();
      ++merges;
    }
    // the survivors left-packed over the piece's own columns, RANK_MAX after
    int n = 0;
    for (int i0 = 0; i0 < L; i0 += 32) {
      const int i = i0 + lane;
      const uint32_t v = i < L ? tok[i] : RANK_MAX;
      const unsigned m = __ballot_sync(FULL, v != RANK_MAX);
      if (v != RANK_MAX) a.tok[e.x + n + __popc(m & ((1u << lane) - 1))] = v;
      n += __popc(m);
    }
    if (lane == 0 && n < L) a.tok[e.x + n] = RANK_MAX;
    most = max(most, merges);
    __syncwarp();
  }
  if (lane == 0 && most > 0) atomicMax(rounds, most);
}

// One warp per row: a valid column survives when no RANK_MAX of the token
// scratch lies between its piece's head and it.
__global__ void __launch_bounds__(TPB) pack_kernel(const uint8_t* __restrict__ piece_start,
                                                   const int* __restrict__ n_payload, int C, int K,
                                                   const uint32_t* __restrict__ tok,
                                                   uint32_t* __restrict__ packed,
                                                   int* __restrict__ counts) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= C) return;  // the whole warp leaves together
  const long long base = static_cast<long long>(row) * K;
  const int nv = min(max(__ldg(n_payload + row), 0), K);
  const unsigned upto = (2u << lane) - 1;  // lanes 0..lane
  int out = 0;
  bool dead_in = false;  // the piece open at the left edge has ended
  for (int c0 = 0; c0 < nv; c0 += 8 * 32) {  // 8 chunks of 32 columns loaded together
    uint32_t v[8];
    bool head[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = c0 + q * 32 + lane;
      v[q] = k < nv ? tok[base + k] : 0u;
      head[q] = k < nv && (k == 0 || piece_start[base + k]);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool in = c0 + q * 32 + lane < nv;
      const unsigned hm = __ballot_sync(FULL, head[q]);
      const unsigned tm = __ballot_sync(FULL, in && v[q] == RANK_MAX) & upto;
      const unsigned hb = hm & upto;
      const bool dead = hb ? (tm >> (31 - __clz(hb))) != 0 : dead_in || tm != 0;
      const unsigned vm = __ballot_sync(FULL, in && !dead);
      if (in && !dead) packed[base + out + __popc(vm & (upto >> 1))] = v[q];
      out += __popc(vm);
      dead_in = __shfl_sync(FULL, dead, 31);
    }
  }
  for (int k = out + lane; k < K; k += 32) packed[base + k] = 0;
  if (lane == 0) counts[row] = out;
}

// The SM count and the resident blocks per SM of the two merge launches on
// the current device, queried once per device.
struct Occupancy {
  int sms = 0, per_short = 0, per_wide = 0;
};
constexpr int MAX_DEVICES = 64;

cudaError_t occupancy(Occupancy* out) {
  static std::mutex mu;
  static Occupancy cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  Occupancy& c = cache[dev];
  if (c.sms == 0) {
    Occupancy q;
    e = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&q.per_short, merge_short_kernel, TPB, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&q.per_wide, merge_wide_kernel, TPB, 0);
    if (e != cudaSuccess) return e;
    c = q;
  }
  *out = c;
  return cudaSuccess;
}

// The blocks of a persistent launch: as many as can be resident, or as many
// as the most work units (warps, or long pieces) the chunk can hold, where
// that is fewer.
unsigned grid_of(long long units, int per_block, int resident) {
  const long long blocks = (units + per_block - 1) / per_block;
  return static_cast<unsigned>(std::max(1ll, std::min<long long>(blocks, resident)));
}

}  // namespace

// int32 words of scratch tt_grid_merge takes for C rows of K columns (the
// class counts, the piece list, the token scratch); -1 past 2^31
extern "C" int tt_grid_scratch_words(int C, int K) {
  const long long words = META + 3ll * C * K;
  return words < (1ll << 31) ? static_cast<int>(words) : -1;
}

// rows [C, KL] u8 (the first K columns merged), piece_start [C, K] u8,
// n_payload [C] i32 -> packed [C, K] u32, counts [C] i32, rounds i32;
// scratch: tt_grid_scratch_words(C, K) int32. K is limited by the shared
// memory of long_kernel (4 pieces of 12*K bytes a block).
extern "C" int tt_grid_merge(const void* buckets, int n_buckets, unsigned seed,
                             const void* byte_to_rank, const void* rows, int KL,
                             const void* piece_start, const void* n_payload, int C, int K,
                             void* packed, void* counts, void* rounds, void* scratch,
                             void* stream) {
  const size_t smem = LONG_WARPS * long_smem(K);
  if (C <= 0 || K <= 0 || K > KL || K > 65535 || static_cast<long long>(C) * K >= (1ll << 31) ||
      smem > 227 * 1024 || n_buckets <= 0 || (n_buckets & (n_buckets - 1)) ||
      reinterpret_cast<uintptr_t>(buckets) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* meta = static_cast<int*>(scratch);
  int2* list = reinterpret_cast<int2*>(meta + META);
  MergeArgs a{static_cast<const uint4*>(buckets), static_cast<uint32_t>(n_buckets - 1), seed,
              static_cast<const uint32_t*>(byte_to_rank), static_cast<const uint8_t*>(rows), KL,
              K, list, reinterpret_cast<uint32_t*>(list + static_cast<long long>(C) * K)};
  const uint8_t* ps = static_cast<const uint8_t*>(piece_start);
  const int* pay = static_cast<const int*>(n_payload);
  Occupancy occ;
  cudaError_t e = cudaMemsetAsync(meta, 0, sizeof(int) * META, st);
  if (e == cudaSuccess) e = occupancy(&occ);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // the most warps each launch can take: a piece of 1-8 bytes a lane; of
  // 9-16 bytes a lane, of 17-64 bytes 8 lanes; plus one part-filled warp a
  // class; and the most pieces longer than 64 bytes
  const long long cols = static_cast<long long>(C) * K;
  const long long short_warps = (cols + 31) / 32 + 8;
  const long long wide_warps = (cols / 9 + 31) / 32 + (cols / 17 * 8 + 31) / 32 + (NSHORT - 8);
  const int list_blocks = (C + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  int* r = static_cast<int*>(rounds);
  list_kernel<false><<<list_blocks, TPB, 0, st>>>(ps, pay, C, K, meta, list, r);
  list_kernel<true><<<list_blocks, TPB, 0, st>>>(ps, pay, C, K, meta, list, r);
  merge_wide_kernel<<<grid_of(wide_warps, WARPS, occ.sms * std::max(occ.per_wide, 1)), TPB, 0,
                      st>>>(a, meta, r);
  merge_short_kernel<<<grid_of(short_warps, WARPS, occ.sms * std::max(occ.per_short, 1)), TPB,
                       0, st>>>(a, meta, r);
  long_kernel<<<grid_of(cols / 65, LONG_WARPS, occ.sms * 2), LONG_WARPS * 32, smem, st>>>(
      a, meta, r);
  pack_kernel<<<(C + WARPS - 1) / WARPS, TPB, 0, st>>>(ps, pay, C, K, a.tok,
                                                      static_cast<uint32_t*>(packed),
                                                      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
