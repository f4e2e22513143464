// pair_count: the hashed pair histogram of a token grid, and the first
// argmax of a histogram: the training step of the distributed BPE
// trainer.
//
// Replaces (JAX package): parallel/train.py make_pair_count_step.per_shard
// (B15) with _pair_hash. Its psum over the mesh stays outside the kernel
// (parallel/train.py corpus_pair_counts sums the devices' histograms, then
// all-reduces over a process group). Plain PyTorch versions:
// ops/pair_count.py pair_hist, hist_argmax.
//
// What bounds it on the H100: bytes. Each position's token (4 bytes) and
// alive flag (1) are read, and piece_start (1) at each counted pair's
// right end; the histogram (2^bits int32, 4 MB at 20 bits) is written by
// atomics that stay in the 50 MB L2, and read once by the argmax. A hot
// bin (a frequent pair) serialises its atomics.
//
// Design: the JAX reverse cummin along a row becomes a tile-parallel scan,
// because the training feed can hold few rows that are very long (one
// document per row: ~70 rows of up to ~170k tokens), where a block per row
// walking it serially would leave most of the 132 SMs idle.
//   pass 1 (tile_first_kernel): per tile of TILE columns of one row, the
//     first alive column (K if none);
//   pass 2 (tile_next_kernel): one warp per row scans the tile summaries
//     from the row's end, 32 tiles at a time: for every tile, the first
//     alive column of any later tile;
//   pass 3 (pair_hist_kernel): each tile finds each position's next alive
//     column inside the tile by a block-wide suffix minimum, else takes
//     pass 2's, hashes the pair and adds one to its bin with atomicAdd.
// The histogram is zeroed on the stream first. The argmax is a two-stage
// maximum over 64-bit keys (count, ~bin): the larger count wins, then the
// smaller bin, as jnp.argmax takes the first index of the maximum.

#include "common.cuh"

namespace {

constexpr int TPB = 256;  // threads per tile block
constexpr int IPT = 8;    // columns per thread
constexpr int TILE = TPB * IPT;
constexpr int NWARP = TPB / 32;
constexpr unsigned FULL = 0xffffffffu;

int tiles_of(int K) { return (K + TILE - 1) / TILE; }

// The first alive column of this thread's IPT columns, K if none.
__device__ __forceinline__ int first_alive(const uint8_t* row, int col0, int K, uint8_t* a) {
  int first = K;
#pragma unroll
  for (int i = IPT - 1; i >= 0; --i) {
    const int c = col0 + i;
    a[i] = c < K ? row[c] : 0;
    if (a[i]) first = c;
  }
  return first;
}

__global__ void tile_first_kernel(const uint8_t* __restrict__ alive, int K, int nt,
                                  int* __restrict__ tile_first) {
  __shared__ int warp_min[NWARP];
  const long long tile = blockIdx.x;  // b * nt + t
  const long long b = tile / nt;
  const int t = static_cast<int>(tile % nt);
  uint8_t a[IPT];
  int v = first_alive(alive + b * K, t * TILE + threadIdx.x * IPT, K, a);
  v = __reduce_min_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = warp_min[0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) m = min(m, warp_min[w]);
    tile_first[tile] = m;
  }
}

// one warp per row: tile_next[t] = min(tile_first[t+1..nt-1]), K if none
__global__ void tile_next_kernel(const int* __restrict__ tile_first, int B, int K, int nt,
                                 int* __restrict__ tile_next) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // the whole warp leaves together
  const int* f = tile_first + row * nt;
  int* out = tile_next + row * nt;
  int carry = K;  // the first alive column past the tiles done so far
  for (int base = ((nt - 1) / 32) * 32; base >= 0; base -= 32) {
    const int t = base + lane;
    int v = t < nt ? f[t] : K;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // inclusive suffix minimum over the lanes
      const int y = __shfl_down_sync(FULL, v, o);
      if (lane + o < 32) v = min(v, y);
    }
    int after = __shfl_down_sync(FULL, v, 1);
    if (lane == 31) after = K;
    if (t < nt) out[t] = min(after, carry);
    carry = min(carry, __shfl_sync(FULL, v, 0));
  }
}

__global__ void pair_hist_kernel(const uint32_t* __restrict__ tokens,
                                 const uint8_t* __restrict__ alive,
                                 const uint8_t* __restrict__ piece_start, int K, int nt,
                                 const int* __restrict__ tile_next, uint32_t mask,
                                 int* __restrict__ hist) {
  __shared__ int warp_min[NWARP];
  const long long tile = blockIdx.x;
  const long long rbase = tile / nt * K;
  const int col0 = static_cast<int>(tile % nt) * TILE + threadIdx.x * IPT;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  uint8_t a[IPT];
  int v = first_alive(alive + rbase, col0, K, a);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // inclusive suffix minimum over the lanes
    const int y = __shfl_down_sync(FULL, v, o);
    if (lane + o < 32) v = min(v, y);
  }
  if (lane == 0) warp_min[wid] = v;
  int nxt = __shfl_down_sync(FULL, v, 1);
  if (lane == 31) nxt = K;
  __syncthreads();
  for (int w = wid + 1; w < NWARP; ++w) nxt = min(nxt, warp_min[w]);
  nxt = min(nxt, tile_next[tile]);
  // this thread's columns from the right: each alive one pairs with nxt
#pragma unroll
  for (int i = IPT - 1; i >= 0; --i) {
    if (!a[i]) continue;
    const int c = col0 + i;
    if (nxt < K && !piece_start[rbase + nxt]) {
      const uint32_t h = tt::mix_pair(tokens[rbase + c], tokens[rbase + nxt], 0u) & mask;
      atomicAdd(hist + h, 1);
    }
    nxt = c;
  }
}

// (count, bin) as one key whose maximum is the first bin of the largest
// count; 0 is below every key of a bin < 2^31
__device__ __forceinline__ unsigned long long arg_key(int count, unsigned bin) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(count) ^ 0x80000000u) << 32) |
         static_cast<unsigned>(~bin);
}

__device__ __forceinline__ unsigned long long block_max(unsigned long long v) {
  __shared__ unsigned long long warp_max[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) v = max(v, warp_max[w]);
  return v;  // valid in thread 0
}

__global__ void argmax_partial_kernel(const int* __restrict__ hist, int n,
                                      unsigned long long* __restrict__ partial) {
  unsigned long long best = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    best = max(best, arg_key(hist[i], static_cast<unsigned>(i)));
  best = block_max(best);
  if (threadIdx.x == 0) partial[blockIdx.x] = best;
}

__global__ void argmax_final_kernel(const unsigned long long* __restrict__ partial, int G,
                                    int* __restrict__ out) {
  unsigned long long best = 0;
  for (int i = threadIdx.x; i < G; i += blockDim.x) best = max(best, partial[i]);
  best = block_max(best);
  if (threadIdx.x == 0) {
    out[0] = static_cast<int>(~static_cast<unsigned>(best & 0xffffffffu));
    out[1] = static_cast<int>(static_cast<unsigned>(best >> 32) ^ 0x80000000u);
  }
}

}  // namespace

// tiles per row of K columns (the wrapper sizes the [2, B * tiles] scratch)
extern "C" int tt_pair_tiles(int K) { return tiles_of(K); }

// tokens [B, K] u32 (int32 bit patterns), alive and piece_start [B, K] u8
// -> hist [2^bits] i32; scratch: 2 * B * tt_pair_tiles(K) int32
extern "C" int tt_pair_hist(const void* tokens, const void* alive, const void* piece_start, int B,
                            int K, int bits, void* hist, void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(hist, 0, sizeof(int) << bits, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B > 0 && K > 1) {
    const int nt = tiles_of(K);
    const long long n_tiles = static_cast<long long>(B) * nt;
    int* tile_first = static_cast<int*>(scratch);
    int* tile_next = tile_first + n_tiles;
    const uint8_t* a = static_cast<const uint8_t*>(alive);
    tile_first_kernel<<<static_cast<unsigned>(n_tiles), TPB, 0, s>>>(a, K, nt, tile_first);
    tile_next_kernel<<<(B + 3) / 4, 128, 0, s>>>(tile_first, B, K, nt, tile_next);
    pair_hist_kernel<<<static_cast<unsigned>(n_tiles), TPB, 0, s>>>(
        static_cast<const uint32_t*>(tokens), a, static_cast<const uint8_t*>(piece_start), K, nt,
        tile_next, (1u << bits) - 1u, static_cast<int*>(hist));
  }
  return static_cast<int>(cudaGetLastError());
}

// hist [n] i32 (n >= 1) -> out [2] i32 = (first bin of the maximum, its
// count); partial: G uint64, 1 <= G <= 1024 blocks of the first stage
extern "C" int tt_hist_argmax(const void* hist, int n, int G, void* partial, void* out,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  argmax_partial_kernel<<<G, 256, 0, s>>>(static_cast<const int*>(hist), n,
                                          static_cast<unsigned long long*>(partial));
  argmax_final_kernel<<<1, 1024, 0, s>>>(static_cast<const unsigned long long*>(partial), G,
                                         static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
