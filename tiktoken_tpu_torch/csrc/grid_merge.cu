// grid_merge: greedy BPE over whole rows of the v1 program, and the packing
// of each row's surviving tokens.
//
// Replaces (JAX package): ops/merge.py make_merge_fn (B13, the full-grid
// lockstep merge: every round merges the leftmost minimum-rank pair of
// every piece) and the row assembly of ops/engine.py build_pipeline_fn
// (B14: alive tokens packed to the front of each row, per-row counts).
// Plain PyTorch version: ops/merge.py grid_merge.
//
// What bounds it on the H100: dependent pair-table probes. A piece of n
// bytes needs n-1 probes up front and two per merge, each a 128-byte
// bucket row of a table that lives in L2 only in part; the lockstep
// rounds of the JAX kernel exist only because the TPU has no cheap
// per-piece control flow, and are not carried over.
//
// Design: one warp per row (4 rows per block), the row's state in shared
// memory. The row's valid bytes are its first n_payload columns (the v1
// program's valid grid). The warp finds the row's pieces with ballots (a
// piece starts at column 0 or at a piece start and stops before the next
// piece start or the payload end: exactly the pairs the JAX kernel
// forms), and each lane runs the sequential greedy loop of its pieces
// (lane, lane+32, ...) on a compact (token, rank of the pair to its right)
// list kept in place over the piece's own columns: leftmost minimum by a
// strict compare, the merged id is the pair's rank, two fresh probes per
// merge. A piece may be as long as the row. Then a warp prefix sum over
// the pieces' survivor counts places each piece's tokens in the packed
// row, and the most merges of any piece goes to `rounds` with one
// atomicMax per warp (the JAX round count: one round per merge of the
// longest chain). The per-position tok/alive grids of the JAX kernel are
// not written: nothing after the merge reads them.

#include "common.cuh"

namespace {

using tt::pair_rank;
using tt::RANK_MAX;

constexpr int WARPS = 4;  // rows per block

// per-warp shared memory: tok u32[K], rank u32[K], head u16[K], count u16[K]
__host__ __device__ inline size_t warp_smem(int K) {
  return (static_cast<size_t>(12) * K + 15) & ~static_cast<size_t>(15);
}

__global__ void __launch_bounds__(WARPS * 32) grid_merge_kernel(
    const uint32_t* __restrict__ buckets, uint32_t mask, uint32_t seed,
    const uint32_t* __restrict__ byte_to_rank, const uint8_t* __restrict__ rows, int KL,
    const uint8_t* __restrict__ piece_start, const int* __restrict__ n_payload, int C, int K,
    uint32_t* __restrict__ packed_out, int* __restrict__ counts_out, int* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= C) return;  // uniform across the warp
  unsigned char* mine = smem + warp * warp_smem(K);
  uint32_t* tok = reinterpret_cast<uint32_t*>(mine);
  uint32_t* rank = tok + K;
  uint16_t* head = reinterpret_cast<uint16_t*>(rank + K);
  uint16_t* cnt = head + K;
  const long long base = static_cast<long long>(row) * K;
  const uint8_t* ps = piece_start + base;
  const uint8_t* bytes = rows + static_cast<long long>(row) * KL;
  const int nv = min(max(n_payload[row], 0), K);  // valid columns

  // 1. piece heads, in column order
  int nh = 0;
  for (int c0 = 0; c0 < nv; c0 += 32) {
    const int k = c0 + lane;
    const bool is_head = k < nv && (k == 0 || ps[k]);
    const unsigned m = __ballot_sync(0xffffffffu, is_head);
    if (is_head) head[nh + __popc(m & ((1u << lane) - 1))] = static_cast<uint16_t>(k);
    nh += __popc(m);
  }
  __syncwarp();

  // 2. the greedy loop of each piece, in place over its columns
  int most = 0;
  for (int pi = lane; pi < nh; pi += 32) {
    const int h = head[pi];
    int e = h + 1;
    while (e < nv && !ps[e]) ++e;
    uint32_t* t = tok + h;
    uint32_t* r = rank + h;
    int n = e - h;
    for (int i = 0; i < n; ++i) t[i] = __ldg(byte_to_rank + bytes[h + i]);
    for (int i = 0; i + 1 < n; ++i) r[i] = pair_rank(buckets, mask, seed, t[i], t[i + 1]);
    int merges = 0;
    while (n > 1) {
      int k = 0;
      for (int i = 1; i + 1 < n; ++i)
        if (r[i] < r[k]) k = i;  // strict: the leftmost minimum wins
      const uint32_t merged = r[k];
      if (merged == RANK_MAX) break;
      t[k] = merged;  // the merged id is the pair's rank
      for (int i = k + 1; i + 1 < n; ++i) {
        t[i] = t[i + 1];
        r[i] = r[i + 1];
      }
      --n;
      ++merges;
      r[k] = k + 1 < n ? pair_rank(buckets, mask, seed, merged, t[k + 1]) : RANK_MAX;
      if (k > 0) r[k - 1] = pair_rank(buckets, mask, seed, t[k - 1], merged);
    }
    cnt[pi] = static_cast<uint16_t>(n);
    most = max(most, merges);
  }
  __syncwarp();

  // 3. packed row: survivors of piece pi at the prefix sum of the counts
  int carry = 0;
  for (int p0 = 0; p0 < nh; p0 += 32) {
    const int pi = p0 + lane;
    const int c = pi < nh ? cnt[pi] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (pi < nh) {
      const int h = head[pi];
      const int off = carry + incl - c;
      for (int i = 0; i < c; ++i) packed_out[base + off + i] = tok[h + i];
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  for (int k = carry + lane; k < K; k += 32) packed_out[base + k] = 0;
  if (lane == 0) counts_out[row] = carry;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) most = max(most, __shfl_xor_sync(0xffffffffu, most, o));
  if (lane == 0 && most > 0) atomicMax(rounds_out, most);
}

}  // namespace

// rows [C, KL] u8 (the first K columns merged), piece_start [C, K] u8,
// n_payload [C] i32 -> packed [C, K] u32, counts [C] i32, rounds i32.
// K is limited by the shared memory of a block (4 rows of 12*K bytes).
extern "C" int tt_grid_merge(const void* buckets, int n_buckets, unsigned seed,
                             const void* byte_to_rank, const void* rows, int KL,
                             const void* piece_start, const void* n_payload, int C, int K,
                             void* packed, void* counts, void* rounds, void* stream) {
  const size_t smem = WARPS * warp_smem(K);
  if (C <= 0 || K <= 0 || K > KL || smem > 227 * 1024 || n_buckets <= 0 ||
      (n_buckets & (n_buckets - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(rounds, 0, sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(grid_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  grid_merge_kernel<<<(C + WARPS - 1) / WARPS, WARPS * 32, smem, st>>>(
      static_cast<const uint32_t*>(buckets), static_cast<uint32_t>(n_buckets - 1), seed,
      static_cast<const uint32_t*>(byte_to_rank), static_cast<const uint8_t*>(rows), KL,
      static_cast<const uint8_t*>(piece_start), static_cast<const int*>(n_payload), C, K,
      static_cast<uint32_t*>(packed), static_cast<int*>(counts), static_cast<int*>(rounds));
  return static_cast<int>(cudaGetLastError());
}
