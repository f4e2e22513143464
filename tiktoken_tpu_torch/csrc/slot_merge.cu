// slot_merge: greedy BPE inside each piece's 16- or 64-byte slot, the
// surviving tokens left-packed.
//
// Replaces (JAX package): ops/slot_merge.py make_slot_merge_fn, at W=16
// (the short misses of B7) and W=64 (the long pieces of B8), with the B8
// glue of ops/pipeline3.py build_pipeline3_fn and ops/pipeline2.py
// build_pipeline2_fn that consumes it: the row-wise compaction of the
// alive lanes and the long whole-piece hits' lane-0 select. (The routes
// of the slot counts to their pieces and the single / count / combo
// selects are the assembly's, csrc/compaction.cu tt_assemble.) Plain
// PyTorch version: ops/slot_merge.py slot_merge_packed.
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
