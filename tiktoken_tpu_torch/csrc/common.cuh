// Shared helpers of the port's CUDA kernels: the uint32 hashes of the
// JAX package's tables, the pair-table probe and a block-wide exclusive
// prefix sum.
//
// Every kernel of this directory is built by nvcc into its own shared
// library with a plain C interface (tiktoken_tpu_torch/ops/kernels.py),
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() from each entry point.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tt {

// ops/pair_table.py:_mix — the (left id, right id) pair hash.
__device__ __forceinline__ uint32_t mix_pair(uint32_t a, uint32_t b, uint32_t seed) {
  a ^= seed;
  uint32_t h = (a * 0x9E3779B1u) ^ (b + 0x85EBCA6Bu + (a << 6));
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h;
}

constexpr uint32_t RANK_MAX = 0xFFFFFFFFu;

// The rank of the pair (a, b) in the pair table ([n_buckets, 32] uint32,
// 8 slots of (key_a, key_b, rank, pad) per 128-byte bucket row; mask =
// n_buckets - 1), RANK_MAX if absent: one row read, 8 compares.
__device__ __forceinline__ uint32_t pair_rank(const uint32_t* __restrict__ buckets, uint32_t mask,
                                              uint32_t seed, uint32_t a, uint32_t b) {
  const uint32_t h = mix_pair(a, b, seed) & mask;
  const uint4* row = reinterpret_cast<const uint4*>(buckets + static_cast<long long>(h) * 32);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint4 q = __ldg(row + s);  // (key_a, key_b, rank, pad)
    if (q.x == a && q.y == b) return q.z;
  }
  return RANK_MAX;
}

// ops/pieces.py:_mix_words (NW = 4) and _mix_words16 (NW = 16).
template <int NW>
__device__ __forceinline__ uint32_t mix_words(const uint32_t* w, uint32_t len, uint32_t seed) {
  uint32_t h = (w[0] ^ seed) * 0x9E3779B1u;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    h = (h ^ w[i]) * 0x85EBCA77u;
    h ^= h >> 13;
  }
  h = (h ^ len) * 0xC2B2AE3Du;
  return h ^ (h >> 16);
}

// Exclusive prefix sum of one int per thread over a block of TPB
// threads (TPB a multiple of 32, at most 1024). Writes the block total
// to *total. Every thread of the block must call it.
template <int TPB>
__device__ __forceinline__ long long block_excl_scan(long long v, long long* total) {
  static_assert(TPB % 32 == 0 && TPB <= 1024, "block size");
  constexpr int NWARP = TPB / 32;
  __shared__ long long warp_sums[NWARP];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    long long w = lane < NWARP ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NWARP) warp_sums[lane] = w;
  }
  __syncthreads();
  const long long before = wid > 0 ? warp_sums[wid - 1] : 0;
  *total = warp_sums[NWARP - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

}  // namespace tt
