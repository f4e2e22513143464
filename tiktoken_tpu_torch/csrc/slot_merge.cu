// slot_merge: greedy BPE inside each piece's 16- or 64-byte slot.
//
// Replaces (JAX package): ops/slot_merge.py make_slot_merge_fn, at W=16
// (the short misses of B7) and W=64 (the long pieces of B8). Plain
// PyTorch version: ops/slot_merge.py slot_merge.
//
// What bounds it on the H100: dependent pair-table probes — W-1 at the
// start and then 2 per merge — each one 128-byte bucket row (one cache
// line) of a 32 MiB table that lives in L2 only in part.
//
// Design: one thread per piece, templated on W. The piece is held as a
// compact list of (token, first-byte lane, rank of the pair to its
// right); each round takes the leftmost minimum rank (the first index on
// ties, the reference's rule), merges the pair into the pair's rank,
// closes the gap, and probes only the two pairs that changed. The list
// is indexed at run time, so it sits in per-thread local memory, which
// stays in L1 for both widths. The JAX
// kernel's two-phase "midcompact" exists only for the TPU's loop cost;
// only its output contract carries over: tokens [M, W] and alive [M, W],
// each surviving token at the lane of its first byte (0 at dead lanes).

#include "common.cuh"

namespace {

using tt::pair_rank;
using tt::RANK_MAX;

template <int W>
__global__ void slot_merge_kernel(const uint32_t* __restrict__ buckets, uint32_t mask,
                                  uint32_t seed, const uint32_t* __restrict__ byte_to_rank,
                                  const uint8_t* __restrict__ slot_bytes,
                                  const int* __restrict__ lens, int M,
                                  uint32_t* __restrict__ tok_out, uint8_t* __restrict__ alive_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const long long base = static_cast<long long>(m) * W;
  const int n0 = min(max(lens[m], 0), W);
  uint32_t tok[W];
  uint32_t rank[W];
  uint8_t lane[W];
  for (int i = 0; i < n0; ++i) {
    tok[i] = __ldg(byte_to_rank + slot_bytes[base + i]);
    lane[i] = static_cast<uint8_t>(i);
  }
  for (int i = 0; i + 1 < n0; ++i) rank[i] = pair_rank(buckets, mask, seed, tok[i], tok[i + 1]);
  int n = n0;
  while (n > 1) {
    int k = 0;
    for (int i = 1; i + 1 < n; ++i)
      if (rank[i] < rank[k]) k = i;  // strict: the first minimum wins
    const uint32_t merged = rank[k];
    if (merged == RANK_MAX) break;
    tok[k] = merged;  // the merged id is the pair's rank
    for (int i = k + 1; i + 1 < n; ++i) {
      tok[i] = tok[i + 1];
      lane[i] = lane[i + 1];
      rank[i] = rank[i + 1];
    }
    --n;
    rank[k] = k + 1 < n ? pair_rank(buckets, mask, seed, merged, tok[k + 1]) : RANK_MAX;
    if (k > 0) rank[k - 1] = pair_rank(buckets, mask, seed, tok[k - 1], merged);
  }
  for (int i = 0; i < W; ++i) {
    tok_out[base + i] = 0;
    alive_out[base + i] = 0;
  }
  for (int i = 0; i < n; ++i) {
    tok_out[base + lane[i]] = tok[i];
    alive_out[base + lane[i]] = 1;
  }
}

template <int W>
int launch(const void* buckets, int n_buckets, unsigned seed, const void* byte_to_rank,
           const void* slot_bytes, const void* lens, int M, void* tok, void* alive,
           void* stream) {
  const int tpb = W == 16 ? 128 : 64;
  if (M > 0)
    slot_merge_kernel<W><<<(M + tpb - 1) / tpb, tpb, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(buckets), static_cast<uint32_t>(n_buckets - 1), seed,
        static_cast<const uint32_t*>(byte_to_rank), static_cast<const uint8_t*>(slot_bytes),
        static_cast<const int*>(lens), M, static_cast<uint32_t*>(tok),
        static_cast<uint8_t*>(alive));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// slot_bytes [M, W] u8, lens [M] i32 -> tok [M, W] u32, alive [M, W] u8
extern "C" int tt_slot_merge(int W, const void* buckets, int n_buckets, unsigned seed,
                             const void* byte_to_rank, const void* slot_bytes, const void* lens,
                             int M, void* tok, void* alive, void* stream) {
  if (W == 16)
    return launch<16>(buckets, n_buckets, seed, byte_to_rank, slot_bytes, lens, M, tok, alive,
                      stream);
  if (W == 64)
    return launch<64>(buckets, n_buckets, seed, byte_to_rank, slot_bytes, lens, M, tok, alive,
                      stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
