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
// - tt_slot_merge_packed: one group of G lanes per slot (G per width
//   below, chosen by measurement), merging the slot's piece in registers
//   (tt::group_merge, merge_group.cuh: the probes of a round issued
//   together, the leftmost minimum by two reductions, the tokens written
//   left-packed). The grid strides over the slots below the device count
//   n_real, read on the device: no slot at or past it is read or written,
//   and nothing is zero-filled. A long slot with a whole-piece hit writes
//   that one token.
// - tt_piece_counts: one thread per catalog entry; a merged piece's count
//   is a gather from its slot's count, so nothing is routed.

#include <algorithm>

#include "merge_group.cuh"

namespace {

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

// W-byte slots, G lanes per slot, P = W / G consecutive positions per lane
// (lane t holds positions t*P .. t*P+P-1).
template <int W, int G>
__global__ void __launch_bounds__(TPB, TT_SLOT_MIN_BLOCKS) slot_merge_packed_kernel(
    const uint4* __restrict__ buckets, uint32_t mask, uint32_t seed,
    const uint32_t* __restrict__ byte_to_rank, const uint8_t* __restrict__ slot_bytes,
    const int* __restrict__ lens, int M, const int* __restrict__ n_real_p,
    const int* __restrict__ hit, uint32_t* __restrict__ tok_p, int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const int t = lane % G;
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
    const int n = tt::group_merge<W, G>(buckets, mask, seed, byte_to_rank, slot_bytes + base, L, t,
                                        gmask, tok_p + base);
    if (t == 0) count[m] = n;
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
