// byte_scan: the byte-level scanners of the v2 and v1 chunk programs.
//
// Replaces (JAX package): ops/window_scan.py make_seq_scan_fn (B9, the v2
// sequential maximal-munch scan of each row), and make_window_scan_fn
// (B11, the v1 match-end hop of every grid position) with make_orbit_fn
// (B12, the v1 piece starts) and the row flags of ops/engine.py
// build_pipeline_fn (:268-272). Plain PyTorch versions: ops/window_scan.py
// seq_scan, and window_orbit (window_scan, then orbit).
//
// What bounds it on the H100: latency, not bytes. Every scan step is one
// read of the packed transition table that depends on the step before
// ([S, 257] int32 indexed by byte, 1.95 MB for o200k: too big for shared
// memory, resident in the 50 MB L2 after the first touches).
//
// Design: the engine renumbers the table's states so that DEAD and the H-1
// states reachable from START on ASCII bytes come first (ops/window_scan.py
// hot_byte_scan_table; H = 18 of 1,944 for o200k). Those rows are closed
// under ASCII bytes, so ASCII text walks only them: each block copies them
// into shared memory with cp.async, and a step reads shared memory while
// the state is below H and the L2 table only inside a multi-byte
// character.
// - tt_seq_scan: one thread per row, R rows per block (the wrapper's
//   choice). The block stages its rows' bytes into shared memory with
//   coalesced word loads, at an odd-word row stride so a warp's threads at
//   one column fall on distinct banks, and zeroes a shared start mask; each
//   thread then walks its row exactly as the JAX loop body does (the class
//   is the byte, or 256 at and past n_total and at and past column KL;
//   consuming EOF ends a match; a death resolves at the last accept end; no
//   progress marks the row bad unless it is finished; a start is marked
//   only below n_payload; a row unfinished after 3*(KL+2) steps is bad),
//   and the block writes the mask out in words. The walk is a chain of
//   dependent steps per row, so a chunk's time is its longest walks times
//   one step.
// - tt_window_orbit (B11-B12 as one function): a warp takes R rows at a
//   time (R = 4 on a 32768-row chunk), blocks of up to 32 warps loop over
//   the rows (a persistent grid of at most the resident blocks, so the
//   hot rows are copied once a block; on a 128-row chunk a warp a block,
//   on 128 SMs). For each row the warp stages its bytes in shared memory
//   and each lane walks its positions l, l + 32, ... in one loop of steps
//   (a walk that ends starts the lane's next at once, so a lane waits for
//   no other lane's walk), each at most W1 = 16 bytes and stopping at the
//   first death (the JAX kernel's first phase), and keeps the hop in a
//   shared byte with a bit for "alive after W1 bytes". Then lane k follows
//   the orbit p -> p + hop[p] of row k over those bytes (R orbits side by
//   side, a step a shared load), finishing the walk to W = 48 bytes of
//   the rare start still alive after W1 (the JAX kernel's second phase,
//   run only where an orbit lands) over the row in global memory, and
//   flags the row where a start is unresolved or has no match; the lanes
//   write each row's start mask out in words. hop and unresolved never
//   leave the SM, and nothing is memset. The chunk-wide cap stays exact:
//   each block adds its positions alive after W1 bytes to a scratch
//   counter and takes a ticket with one acquire-release atomic; the last
//   block compares the sum with u_cap and, over it, flags every row with
//   a payload (every position unresolved, as the JAX program does), then
//   sets the scratch back to 0. What bounds it (scripts/redesign_times.py):
//   the walks' chains of dependent table reads, 98.6% of them from the
//   shared hot rows; a warp whose lane needs a cold row waits for L2.

#include <algorithm>
#include <cuda/atomic>

#include "common.cuh"

namespace {

constexpr int ACC_BITS = 5;
constexpr int ACC_MASK = (1 << ACC_BITS) - 1;
constexpr int START = 1;
constexpr int DEAD = 0;
constexpr int EOF_CLASS = 256;  // column 256 of the byte-indexed table
constexpr int NC = EOF_CLASS + 1;
constexpr int MAX_ROWS = 256;  // rows (threads) per sequential-scan block, at most
// warps a tt_window_orbit block holds at least 32 of per SM before a warp
// takes more than one row's orbit
constexpr int WO_WARPS_PER_SM = 32;

// tt_window_orbit's most warps a block and most rows a warp takes at a
// time (both fewer where the chunk would leave SMs short of warps)
constexpr int WO_MAX_WARPS = 32;
constexpr int WO_MAX_ROWS = 4;

__host__ __device__ int round16(int n) { return (n + 15) & ~15; }

// shared bytes of the hot rows; row stride (bytes) of the staged rows: the
// row rounded up to words, plus a word where that is an even count
__host__ __device__ int hot_bytes(int hot) { return round16(hot * NC * 4); }
__host__ __device__ int row_stride(int KL) {
  const int w = (KL + 3) / 4;
  return 4 * (w + (w % 2 == 0));
}

size_t seq_smem(int hot, int R, int KL, int K) {
  return static_cast<size_t>(hot_bytes(hot)) + static_cast<size_t>(R) * row_stride(KL) +
         static_cast<size_t>(R) * round16(K);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Starts the copy of the hot rows (hot * 257 ints; packed 16-byte aligned)
// into shared memory, the whole block taking part; the caller waits
// (cp_async_wait) and synchronises.
__device__ __forceinline__ void copy_hot(int* hot_s, const int* packed, int hot) {
  const int n = hot * NC * 4;
  for (int i = threadIdx.x; i < n / 16; i += blockDim.x)
    cp_async16(reinterpret_cast<uint8_t*>(hot_s) + 16 * i,
               reinterpret_cast<const uint8_t*>(packed) + 16 * i);
  for (int i = (n & ~15) / 4 + threadIdx.x; i < n / 4; i += blockDim.x)
    hot_s[i] = __ldg(packed + i);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// the table of state s: the shared hot rows below hot, else the L2 table;
// one generic load then reads either, with no branch
__device__ __forceinline__ const int* table_of(const int* hot_s, const int* packed, int hot,
                                               int s) {
  return s < hot ? hot_s : packed;
}

__global__ void __launch_bounds__(MAX_ROWS) seq_scan_kernel(
    const int* __restrict__ packed, int hot, const uint8_t* __restrict__ rows, int C, int KL,
    int K, const int* __restrict__ n_payload, const int* __restrict__ n_total,
    uint8_t* __restrict__ mask, uint8_t* __restrict__ row_bad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = blockDim.x;
  const int RS = row_stride(KL);
  const int KS = round16(K);
  int* hot_s = reinterpret_cast<int*>(smem);
  uint8_t* rows_s = smem + hot_bytes(hot);
  uint8_t* mask_s = rows_s + R * RS;
  copy_hot(hot_s, packed, hot);
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, C - r0);
  const long long rbase = static_cast<long long>(r0) * KL;
  if ((KL & 3) == 0 && (reinterpret_cast<uintptr_t>(rows) & 3) == 0) {
    // word loads, neighbouring threads on neighbouring words
    const int wpr = KL / 4;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(rows + rbase);
    for (int i = threadIdx.x; i < nrows * wpr; i += R) {
      const int r = i / wpr;
      reinterpret_cast<uint32_t*>(rows_s + r * RS)[i - r * wpr] = __ldg(src + i);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * KL; i += R) {
      const int r = i / KL;
      rows_s[r * RS + (i - r * KL)] = rows[rbase + i];
    }
  }
  for (int i = threadIdx.x; i < R * KS / 4; i += R) reinterpret_cast<uint32_t*>(mask_s)[i] = 0u;
  cp_async_wait();
  __syncthreads();

  const int r = threadIdx.x;
  if (r < nrows) {
    const int row = r0 + r;
    const uint8_t* rb = rows_s + r * RS;
    uint8_t* mk = mask_s + r * KS;
    const int np = n_payload[row];
    const int nt = n_total[row];
    const int end = min(nt, KL);  // the first EOF column
    int p = 0, s = START, mstart = 0, lend = -1;
    bool bad = false, done = np <= 0;
    const int max_steps = 3 * (KL + 2);
    int c = end > 0 ? rb[0] : EOF_CLASS;  // the class at p
    for (int it = 0; it < max_steps && !done; ++it) {
      const int v = table_of(hot_s, packed, hot, s)[s * NC + c];
      // the next byte, read beside the table entry: a step that does not
      // end a match takes it
      const int next = p + 1 < end ? rb[p + 1] : EOF_CLASS;
      const int s2 = v >> ACC_BITS;
      const int a = (v & ACC_MASK) - 1;
      const int lend2 = (s2 != DEAD && a >= 0) ? p + 1 - a : lend;
      if (s2 == DEAD || p >= nt) {  // death, or the EOF symbol consumed
        if (mstart < np) mk[min(max(mstart, 0), K - 1)] = 1;
        const bool no_progress = lend2 <= mstart;
        const bool finished = lend2 >= np;
        if (no_progress && !finished) bad = true;
        if (finished || no_progress) {
          done = true;
        } else {
          p = lend2;
          s = START;
          lend = -1;
          mstart = lend2;
          c = p < end ? rb[p] : EOF_CLASS;
        }
      } else {
        ++p;
        s = s2;
        lend = lend2;
        c = next;
      }
    }
    row_bad[row] = bad || !done;
  }
  __syncthreads();
  const long long mbase = static_cast<long long>(r0) * K;
  if ((K & 3) == 0 && (reinterpret_cast<uintptr_t>(mask) & 3) == 0) {
    const int wpr = K / 4;
    uint32_t* dst = reinterpret_cast<uint32_t*>(mask + mbase);
    for (int i = threadIdx.x; i < nrows * wpr; i += R) {
      const int rr = i / wpr;
      dst[i] = reinterpret_cast<const uint32_t*>(mask_s + rr * KS)[i - rr * wpr];
    }
  } else {
    for (int i = threadIdx.x; i < nrows * K; i += R) {
      const int rr = i / K;
      mask[mbase + i] = mask_s[rr * KS + (i - rr * K)];
    }
  }
}

// tt_window_orbit's shared rows: each of a warp's R rows keeps its
// positions' hops (a byte each, bit 7: still alive after W1 bytes) and its
// start bits, at strides of an odd number of words so that lanes on
// different rows fall on different banks
__host__ __device__ int hop_stride(int K) { return 4 * ((K + 3) / 4 + ((K + 3) / 4 % 2 == 0)); }
__host__ __device__ int bit_stride(int K) { return ((K + 31) / 32) | 1; }

// per-warp shared bytes of tt_window_orbit: one staged row's bytes, then
// the R rows' hops and start bits
__host__ __device__ int wo_warp_bytes(int KL, int K, int R) {
  return round16(KL) + round16(R * hop_stride(K)) + round16(4 * R * bit_stride(K));
}

size_t wo_smem(int hot, int warps, int KL, int K, int R) {
  return static_cast<size_t>(hot_bytes(hot)) + static_cast<size_t>(warps) * wo_warp_bytes(KL, K, R);
}

// The walk from START at column p of a row (bytes rb, shared or global)
// over at most `steps` bytes (the class is the byte below `end`, else
// EOF), stopping at the first death: the single-sweep maximal-munch hop
// (the last accept end, relative to p; 0 if none) and whether the match is
// still alive after them.
__device__ __forceinline__ int walk(const int* hot_s, const int* packed, int hot,
                                    const uint8_t* rb, int end, int p, int steps, bool& alive) {
  int state = START, hop = 0;
  alive = true;
  for (int o = 0; o < steps; ++o) {
    const int q = p + o;
    const int v = table_of(hot_s, packed, hot, state)[state * NC + (q < end ? rb[q] : EOF_CLASS)];
    state = v >> ACC_BITS;
    if (state == DEAD) {
      alive = false;
      break;
    }
    const int a = (v & ACC_MASK) - 1;
    if (a >= 0) hop = o + 1 - a;
  }
  return hop;
}

// A lane's walks, at most W1 bytes each, of its positions l, l + 32, ...
// below K in the staged row rb: one loop whose every turn is one step, a
// walk that ends starting the lane's next at once (no wait for the warp's
// longest walk between positions). A hot state's row is read with a
// shared-memory load, any other with a read-only global one. hop_s[p] =
// the hop, bit 7 set where the match is still alive after W1 bytes;
// returns how many are.
__device__ __forceinline__ int walk_lane(const int* hot_s, const int* __restrict__ packed,
                                         int hot, const uint8_t* rb, int end, int K, int W1,
                                         uint8_t* hop_s) {
  int n_alive = 0;
  int p = threadIdx.x & 31, o = 0, state = START, hop = 0;
  while (p < K) {
    const int q = p + o;
    const int idx = state * NC + (q < end ? rb[q] : EOF_CLASS);
    const int v = state < hot ? hot_s[idx] : __ldg(packed + idx);
    const int s2 = v >> ACC_BITS;
    const int a = (v & ACC_MASK) - 1;
    if (s2 != DEAD && a >= 0) hop = o + 1 - a;
    if (s2 == DEAD || ++o == W1) {
      const bool alive = s2 != DEAD;
      hop_s[p] = static_cast<uint8_t>(hop | (alive ? 0x80 : 0));
      n_alive += alive;
      p += 32;
      o = 0;
      state = START;
      hop = 0;
    } else {
      state = s2;
    }
  }
  return n_alive;
}

// B11-B12 in one launch (see the file's comment): a warp takes R rows at
// a time, blocks of `warps` warps looping over the rows. scratch: [0] the
// ticket, [2..3] the positions alive after W1 bytes (uint64); 0 at entry
// and at exit.
__global__ void __launch_bounds__(1024) window_orbit_kernel(
    const int* __restrict__ packed, int hot, const uint8_t* __restrict__ rows, int KL,
    const int* __restrict__ n_payload, const int* __restrict__ n_total, int C, int K, int W,
    int W1, int R, long long u_cap, uint8_t* __restrict__ mask, uint8_t* __restrict__ row_bad,
    unsigned* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long warp_alive[32];
  __shared__ int s_over;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int HS = hop_stride(K), BS = bit_stride(K), KW = (K + 31) / 32;
  int* hot_s = reinterpret_cast<int*>(smem);
  uint8_t* rb = smem + hot_bytes(hot) + warp * wo_warp_bytes(KL, K, R);
  uint8_t* hops = rb + round16(KL);
  uint32_t* bits = reinterpret_cast<uint32_t*>(hops + round16(R * HS));
  copy_hot(hot_s, packed, hot);
  cp_async_wait();
  __syncthreads();
  const bool two_phase = W1 < W;
  const bool word_rows = (KL & 3) == 0 && (reinterpret_cast<uintptr_t>(rows) & 3) == 0;
  const bool word_mask = (K & 3) == 0 && (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  unsigned long long n_alive = 0;  // this warp's positions alive after W1 bytes
  const long long stride = static_cast<long long>(gridDim.x) * warps * R;
  for (long long r0 = (static_cast<long long>(blockIdx.x) * warps + warp) * R; r0 < C;
       r0 += stride) {
    const int nr = static_cast<int>(min(static_cast<long long>(R), C - r0));
    // 1. each row's bytes into shared memory, then its walks, capped at W1
    for (int k = 0; k < nr; ++k) {
      const uint8_t* src = rows + (r0 + k) * KL;
      if (word_rows) {
        for (int i = lane; i < KL / 4; i += 32)
          reinterpret_cast<uint32_t*>(rb)[i] = __ldg(reinterpret_cast<const uint32_t*>(src) + i);
      } else {
        for (int i = lane; i < KL; i += 32) rb[i] = src[i];
      }
      for (int i = lane; i < KW; i += 32) bits[k * BS + i] = 0u;
      const int end = min(__ldg(n_total + r0 + k), KL);  // the first EOF column
      __syncwarp();
      n_alive += static_cast<unsigned>(__reduce_add_sync(
          0xffffffffu, walk_lane(hot_s, packed, hot, rb, end, K, W1, hops + k * HS)));
      __syncwarp();
    }
    // 2. the orbit of 0 of row r0 + lane over its shared hops; a start still
    // alive after W1 bytes finishes its walk to W over the row in global
    // memory
    if (lane < nr) {
      const long long r = r0 + lane;
      const uint8_t* hop_r = hops + lane * HS;
      uint32_t* bits_r = bits + lane * BS;
      const int end = min(__ldg(n_total + r), KL);
      const int vl = min(__ldg(n_payload + r), K);
      bool bad = false;
      for (int cur = 0; cur < vl;) {
        bits_r[cur >> 5] |= 1u << (cur & 31);
        int h = hop_r[cur];
        bool unresolved = false;
        if (h & 0x80) {
          if (two_phase) {
            h = walk(hot_s, packed, hot, rows + r * KL, end, cur, W, unresolved);
          } else {
            h &= 0x7F;
            unresolved = true;
          }
        }
        if (unresolved || h <= 0) bad = true;
        if (h <= 0) break;  // no match: the chain ends
        cur += h;
      }
      row_bad[r] = bad;
    }
    __syncwarp();
    // 3. the starts out as bytes, lanes on neighbouring words
    for (int k = 0; k < nr; ++k) {
      uint8_t* dst = mask + (r0 + k) * K;
      const uint32_t* bits_k = bits + k * BS;
      if (word_mask) {
        for (int i = lane; i < K / 4; i += 32) {
          const uint32_t b = (bits_k[i >> 3] >> ((4 * i) & 31)) & 0xFu;
          reinterpret_cast<uint32_t*>(dst)[i] =
              (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
        }
      } else {
        for (int i = lane; i < K; i += 32) dst[i] = (bits_k[i >> 5] >> (i & 31)) & 1u;
      }
    }
    __syncwarp();
  }
  if (!two_phase) return;
  // 4. the chunk-wide cap: the blocks' counts summed, the last block to
  // take a ticket compares the sum with u_cap
  if (lane == 0) warp_alive[warp] = n_alive;
  __syncthreads();  // the block's row_bad stores before thread 0's release
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < warps; ++w) total += warp_alive[w];
    cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> count(
        *reinterpret_cast<unsigned long long*>(scratch + 2));
    if (total) count.fetch_add(total, cuda::memory_order_relaxed);
    // release: this block's count and row flags are seen by whoever takes
    // a later ticket; acquire: the last block sees every block's
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(scratch[0]);
    int over = 0;
    if (ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1) {
      over = count.exchange(0ull, cuda::memory_order_relaxed) >
             static_cast<unsigned long long>(u_cap);
      ticket.store(0u, cuda::memory_order_relaxed);  // for the next call on this stream
    }
    s_over = over;
  }
  __syncthreads();
  if (s_over) {  // every position is unresolved: every row with a payload is bad
    __threadfence();
    for (int r = threadIdx.x; r < C; r += blockDim.x) row_bad[r] = __ldg(n_payload + r) > 0;
  }
}

// raises the kernel's dynamic shared memory limit where smem needs it
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

unsigned blocks_of(long long n, int tpb) { return static_cast<unsigned>((n + tpb - 1) / tpb); }

}  // namespace

// shared memory bytes a tt_seq_scan block of R rows takes; the device's
// per-block limit
extern "C" int tt_seq_smem(int hot, int R, int KL, int K) {
  return static_cast<int>(seq_smem(hot, R, KL, K));
}

extern "C" int tt_byte_max_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// rows [C, KL] u8, n_payload/n_total [C] i32 -> piece_start [C, K] u8,
// row_bad [C] u8; packed [S, 257] i32 (16-byte aligned), indexed by byte
// (256 = EOF), whose first `hot` rows are closed under ASCII bytes and are
// read from shared memory; R rows per block
extern "C" int tt_seq_scan(const void* packed, int S, int nc, int hot, const void* rows, int C,
                           int KL, int K, int R, const void* n_payload, const void* n_total,
                           void* piece_start, void* row_bad, void* stream) {
  if (C <= 0 || K <= 0 || K > KL || S <= 0 || nc != NC || hot < 0 || hot > S || R < 32 ||
      R > MAX_ROWS || R % 32 || reinterpret_cast<uintptr_t>(packed) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = seq_smem(hot, R, KL, K);
  cudaError_t e = allow_smem(seq_scan_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  seq_scan_kernel<<<blocks_of(C, R), R, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), hot, static_cast<const uint8_t*>(rows), C, KL, K,
      static_cast<const int*>(n_payload), static_cast<const int*>(n_total),
      static_cast<uint8_t*>(piece_start), static_cast<uint8_t*>(row_bad));
  return static_cast<int>(cudaGetLastError());
}

// tt_window_orbit's launch over C rows on the current device: R rows a
// warp at a time, enough that every SM holds WO_WARPS_PER_SM warps, at
// most WO_MAX_ROWS; WO_MAX_WARPS warps a block, fewer where the
// chunk could not fill every SM with a block of them (a 128-row chunk
// runs a warp a block on 128 SMs); the blocks, at most the resident ones.
// Returns a CUDA error.
struct WoGeometry {
  int R, warps, blocks;
  size_t smem;
};

static cudaError_t wo_geometry(int hot, int KL, int K, int C, WoGeometry& g) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  sms = std::max(sms, 1);
  g.R = std::max(1, std::min(WO_MAX_ROWS, C / (sms * WO_WARPS_PER_SM)));
  g.warps = std::max(1, std::min(WO_MAX_WARPS, C / (sms * g.R)));
  g.smem = wo_smem(hot, g.warps, KL, K, g.R);
  e = allow_smem(window_orbit_kernel, g.smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_orbit_kernel, g.warps * 32,
                                                      g.smem);
  if (e != cudaSuccess) return e;
  const long long per_block = static_cast<long long>(g.warps) * g.R;
  g.blocks = static_cast<int>(std::min<long long>(
      (C + per_block - 1) / per_block, static_cast<long long>(sms) * std::max(per_sm, 1)));
  return cudaSuccess;
}

// rows [C, KL] u8, n_payload/n_total [C] i32 -> piece_start [C, K] u8,
// row_bad [C] u8: the maximal-munch hops of positions 0..K-1 (lookahead to
// K+W-1, EOF at and past n_total and past the row), W1 bytes first, the
// orbit of 0 below n_payload and its rows' flags, every row with a payload
// bad when more than u_cap positions are alive after W1 bytes (W1 < W);
// packed [S, 257] i32 (16-byte aligned), indexed by byte (256 = EOF),
// whose first `hot` rows are closed under ASCII bytes; scratch: 4 words,
// 0 at entry and at exit
extern "C" int tt_window_orbit(const void* packed, int S, int nc, int hot, const void* rows,
                               int C, int KL, int K, const void* n_payload, const void* n_total,
                               int W, int W1, long long u_cap, void* piece_start, void* row_bad,
                               void* scratch, void* stream) {
  if (C <= 0 || K <= 0 || K > KL || W <= 0 || W1 <= 0 || W1 > W || W1 > 127 || S <= 0 ||
      nc != NC || hot < 0 || hot > S || reinterpret_cast<uintptr_t>(packed) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  WoGeometry g;
  const cudaError_t e = wo_geometry(hot, KL, K, C, g);
  if (e != cudaSuccess) return static_cast<int>(e);
  window_orbit_kernel<<<g.blocks, g.warps * 32, g.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), hot, static_cast<const uint8_t*>(rows), KL,
      static_cast<const int*>(n_payload), static_cast<const int*>(n_total), C, K, W, W1, g.R,
      u_cap,
      static_cast<uint8_t*>(piece_start), static_cast<uint8_t*>(row_bad),
      static_cast<unsigned*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
