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
// What bounds it on the H100: adding one to a random bin per pair. Each
// position's token (4 bytes), alive and piece_start flags (1 each) are
// read once; but one global atomicAdd per pair into the 2^20-bin table
// runs at the L2's atomic rate: on the training feed (70 x 166,794
// positions, 10.7 M pairs) 0.154 ms for the adds alone, 69 G a second,
// and 0.133 ms for as many uniform random bins (scripts/pair_hist_profile.py).
// Histograms partitioned into shared memory were built three ways and
// measured slower (PERF.md): in shared memory a frequent pair's adds run
// one after another in one block (the feed's hottest bin takes 35,779),
// and merging each tile's equal bins first costs more than it saves.
//
// Design: one pass. One block per tile of 2048 consecutive positions of
// the flat grid, taken from the grid's end (a tile counter), each thread 8
// positions read with 8- and 16-byte loads. A position's next alive column
// is found inside the tile by a block suffix minimum, past it by a
// decoupled look-back over the tiles to its right (each tile publishes its
// first alive position at once; a tile with none publishes the first one
// after it when its own look-back ends), so rows of any length take no
// per-row pass. A pair counts when the next alive position lies in the
// same row and does not start a piece; its bin of the zeroed histogram
// takes one atomicAdd.
//
// The argmax (tt_hist_argmax, jnp.argmax of parallel/train.py:82 in the
// JAX package) reads the 2^20-bin histogram once: 4 MB, 1.25 us at
// 3.35 TB/s, so a call is as long as its launch and its serial tail. One
// launch: each block reduces its span of the histogram, read as 16-byte
// vectors with four loads in flight a thread (a scalar head where the
// histogram does not start on 16 bytes, a scalar tail for the last n % 4
// bins), to one 64-bit key (count, ~bin) whose maximum is the first bin of
// the largest count, as jnp.argmax takes the first index of the maximum;
// by warp shuffles, then across the warps in shared memory. The grid is
// sized from the SM count and the kernel's occupancy, queried once per
// device. Each block folds its key into one running maximum (atomicMax)
// and takes a ticket with one acquire-release atomic; the last block to
// arrive reads and resets the maximum in one exchange, writes (bin, count)
// and sets the ticket back to 0, so no call needs a memset. That tail
// replaced a key a block that the last block reduced after two fences:
// 0.0054 -> 0.0045 ms on an H100 SXM at 700 W, where the same kernel with
// no tail at all takes 0.0038 and an empty launch 0.0017
// (scripts/argmax_times.py; PERF.md).

#include <algorithm>
#include <mutex>

#include <cuda/atomic>

#include "common.cuh"

namespace {

constexpr int TPB = 256;  // threads per tile block
constexpr int IPT = 8;    // positions per thread
constexpr int TILE = TPB * IPT;
constexpr int NWARP = TPB / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long INC = 1ull << 63, AGG = 1ull << 62, VALUE = AGG - 1;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__global__ void __launch_bounds__(TPB) scan_kernel(
    const uint32_t* __restrict__ tokens, const uint8_t* __restrict__ alive,
    const uint8_t* __restrict__ piece_start, long long N, int K, int n_tiles, uint32_t bin_mask,
    bool vec, unsigned* __restrict__ counter, unsigned long long* __restrict__ status,
    int* __restrict__ hist) {
  __shared__ int s_tile;
  __shared__ long long s_warp[NWARP], s_next;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = n_tiles - 1 - static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  const int tile = s_tile;
  const long long f0 = static_cast<long long>(tile) * TILE + threadIdx.x * IPT;

  // this thread's 8 positions
  uint32_t tk[IPT];
  uint8_t a[IPT], ps[IPT];
  if (vec && f0 + IPT <= N) {
    const uint2 va = *reinterpret_cast<const uint2*>(alive + f0);
    const uint2 vp = *reinterpret_cast<const uint2*>(piece_start + f0);
    const uint4 t0 = *reinterpret_cast<const uint4*>(tokens + f0);
    const uint4 t1 = *reinterpret_cast<const uint4*>(tokens + f0 + 4);
    const uint32_t wa[2] = {va.x, va.y}, wp[2] = {vp.x, vp.y};
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      a[i] = (wa[i / 4] >> (8 * (i % 4))) & 0xFF;
      ps[i] = (wp[i / 4] >> (8 * (i % 4))) & 0xFF;
    }
    tk[0] = t0.x, tk[1] = t0.y, tk[2] = t0.z, tk[3] = t0.w;
    tk[4] = t1.x, tk[5] = t1.y, tk[6] = t1.z, tk[7] = t1.w;
  } else {
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const bool in = f0 + i < N;
      a[i] = in ? alive[f0 + i] : 0;
      ps[i] = in ? piece_start[f0 + i] : 1;
      tk[i] = in ? tokens[f0 + i] : 0u;
    }
  }
  long long first = N;  // this thread's first alive position
#pragma unroll
  for (int i = IPT - 1; i >= 0; --i)
    if (a[i]) first = f0 + i;

  // the first alive position after this thread's: later threads of the
  // tile (a suffix minimum), then later tiles (the look-back)
  long long v = first;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_down_sync(FULL, v, o);
    if (lane + o < 32) v = min(v, y);
  }
  long long after = __shfl_down_sync(FULL, v, 1);
  if (lane == 31) after = N;
  if (lane == 0) s_warp[wid] = v;
  __syncthreads();
  for (int w = wid + 1; w < NWARP; ++w) after = min(after, s_warp[w]);
  if (threadIdx.x == 0) {
    long long tile_first = N;
    for (int w = 0; w < NWARP; ++w) tile_first = min(tile_first, s_warp[w]);
    store_status(status + tile, tile_first < N ? INC | tile_first : AGG);
    long long nx = N;
    for (int j = tile + 1; j < n_tiles; ++j) {
      unsigned long long s;
      do {
        s = load_status(status + j);
      } while (s == 0);
      if (s & INC) {
        nx = static_cast<long long>(s & VALUE);
        break;
      }
    }
    if (tile_first >= N) store_status(status + tile, INC | nx);
    s_next = nx;
  }
  __syncthreads();
  after = min(after, s_next);

  // this thread's pairs, right to left
  uint32_t ntok = 0u;
  bool nps = true;
  if (after < N) {
    ntok = tokens[after];
    nps = piece_start[after] != 0;
  }
  long long nxt = after;
  long long rs = min(f0 + IPT - 1, N - 1) / K * K;  // the row in hand: [rs, rs + K)
#pragma unroll
  for (int i = IPT - 1; i >= 0; --i) {
    if (!a[i]) continue;
    const long long f = f0 + i;
    while (f < rs) rs -= K;
    if (nxt < rs + K && !nps) atomicAdd(hist + (tt::mix_pair(tk[i], ntok, 0u) & bin_mask), 1);
    nxt = f;
    ntok = tk[i];
    nps = ps[i] != 0;
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

constexpr int ARG_TPB = 256;  // threads per argmax block
constexpr int ARG_VPT = 4;    // 16-byte loads in flight a thread

// hist [n] i32 -> out = (first bin of the maximum, its count). Bins [0,
// head) and the last (n - head) % 4 are read one by one, the rest as int4.
// best (the running maximum) and ticket: 0 at entry, 0 again at exit.
__global__ void __launch_bounds__(ARG_TPB) argmax_kernel(
    const int* __restrict__ hist, int n, int head, unsigned long long* __restrict__ best_key,
    unsigned* __restrict__ ticket, int* __restrict__ out) {
  const long long n4 = (n - head) / 4;
  const int4* h4 = reinterpret_cast<const int4*>(hist + head);
  const long long tid = static_cast<long long>(blockIdx.x) * ARG_TPB + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * ARG_TPB;
  unsigned long long best = 0;
  for (long long i = tid; i < n4; i += ARG_VPT * stride) {
    int4 q[ARG_VPT];
#pragma unroll
    for (int k = 0; k < ARG_VPT; ++k)
      q[k] = i + k * stride < n4 ? __ldcs(h4 + i + k * stride) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < ARG_VPT; ++k) {
      if (i + k * stride >= n4) break;
      const unsigned b = static_cast<unsigned>(head + 4 * (i + k * stride));
      best = max(best, max(max(arg_key(q[k].x, b), arg_key(q[k].y, b + 1)),
                           max(arg_key(q[k].z, b + 2), arg_key(q[k].w, b + 3))));
    }
  }
  const long long tail = head + 4 * n4;
  if (tid < head) best = max(best, arg_key(hist[tid], static_cast<unsigned>(tid)));
  if (tid < n - tail)
    best = max(best, arg_key(hist[tail + tid], static_cast<unsigned>(tail + tid)));
  best = block_max(best);
  if (threadIdx.x == 0) {
    atomicMax(best_key, best);
    // release: this block's atomicMax is seen by whoever takes a later
    // ticket; acquire: the last block sees every block's
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> t(*ticket);
    if (t.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1) {
      cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> k(*best_key);
      const unsigned long long b = k.exchange(0ull, cuda::memory_order_relaxed);
      out[0] = static_cast<int>(~static_cast<unsigned>(b & 0xffffffffu));
      out[1] = static_cast<int>(static_cast<unsigned>(b >> 32) ^ 0x80000000u);
      t.store(0u, cuda::memory_order_relaxed);  // for the next call on this stream
    }
  }
}

// The resident argmax blocks of the current device (SMs x blocks per SM),
// queried once per device.
constexpr int MAX_DEVICES = 64;

cudaError_t argmax_resident(int* out) {
  static std::mutex mu;
  static int cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (cache[dev] == 0) {
    int sms = 0, per = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, argmax_kernel,
                                                                          ARG_TPB, 0);
    if (e != cudaSuccess) return e;
    cache[dev] = std::max(1, sms * per);
  }
  *out = cache[dev];
  return cudaSuccess;
}

}  // namespace

static int tiles_of(int B, int K) {
  return static_cast<int>((static_cast<long long>(B) * K + TILE - 1) / TILE);
}

// int32 words of scratch tt_pair_hist takes for a [B, K] grid: the tile
// counter (padded to 16 bytes) and a 64-bit status per tile; -1 past 2^31
extern "C" int tt_pair_scratch_words(int B, int K) {
  if (B < 0 || K < 0) return -1;
  const long long words = 4 + 2ll * tiles_of(B, K);
  return words < (1ll << 31) ? static_cast<int>(words) : -1;
}

// tokens [B, K] u32 (int32 bit patterns), alive and piece_start [B, K] u8
// -> hist [2^bits] i32; scratch: tt_pair_scratch_words(B, K) int32, 16-byte
// aligned (the inputs are read with vector loads where they are 16-byte
// aligned too)
extern "C" int tt_pair_hist(const void* tokens, const void* alive, const void* piece_start, int B,
                            int K, int bits, void* hist, void* scratch, void* stream) {
  if (B < 0 || K < 0 || bits < 1 || bits > 30 || (reinterpret_cast<uintptr_t>(scratch) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = ((reinterpret_cast<uintptr_t>(tokens) | reinterpret_cast<uintptr_t>(alive) |
                     reinterpret_cast<uintptr_t>(piece_start)) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = tiles_of(B, K);
  cudaError_t e = cudaMemsetAsync(hist, 0, sizeof(int) << bits, s);
  if (e == cudaSuccess && n_tiles > 0)
    e = cudaMemsetAsync(scratch, 0, sizeof(int) * (4 + 2ll * n_tiles), s);
  if (e != cudaSuccess || n_tiles == 0) return static_cast<int>(e);
  int* words = static_cast<int*>(scratch);
  scan_kernel<<<n_tiles, TPB, 0, s>>>(
      static_cast<const uint32_t*>(tokens), static_cast<const uint8_t*>(alive),
      static_cast<const uint8_t*>(piece_start), static_cast<long long>(B) * K, K, n_tiles,
      (1u << bits) - 1u, vec, reinterpret_cast<unsigned*>(words),
      reinterpret_cast<unsigned long long*>(words + 4), static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// hist [n] i32 (n >= 1, 4-byte aligned) -> out [2] i32 = (first bin of the
// maximum, its count); scratch: 4 int32, 16-byte aligned, zero (as every
// call leaves them): the ticket (word 0) and the running maximum (words
// 2-3). One launch.
extern "C" int tt_hist_argmax(const void* hist, int n, void* scratch, void* out, void* stream) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(hist);
  if (n < 1 || (at & 3) || (reinterpret_cast<uintptr_t>(scratch) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  cudaError_t e = argmax_resident(&resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int head = std::min(n, static_cast<int>(((16 - (at & 15)) & 15) / 4));
  const long long per_block = ARG_TPB * ARG_VPT;
  const long long blocks = ((n - head) / 4 + per_block - 1) / per_block;
  const int G = static_cast<int>(std::max(1ll, std::min<long long>(blocks, resident)));
  int* words = static_cast<int*>(scratch);
  argmax_kernel<<<G, ARG_TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(hist), n, head, reinterpret_cast<unsigned long long*>(words + 2),
      reinterpret_cast<unsigned*>(words), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
