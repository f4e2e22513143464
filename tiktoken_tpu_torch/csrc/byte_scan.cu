// byte_scan: the byte-level scanners of the v2 and v1 chunk programs.
//
// Replaces (JAX package): ops/window_scan.py make_seq_scan_fn (B9, the v2
// sequential maximal-munch scan of each row), make_window_scan_fn (B11,
// the v1 match-end hop of every grid position) and make_orbit_fn (B12,
// the v1 piece starts, with the row flags of ops/engine.py
// build_pipeline_fn). Plain PyTorch versions: ops/window_scan.py
// seq_scan, window_scan, orbit.
//
// What bounds it on the H100: latency, not bytes. Every scan step is one
// read of the packed transition table that depends on the step before
// ([S, 257] int32 indexed by byte, 1.95 MB for o200k: too big for shared
// memory, resident in the 50 MB L2 after the first touches).
//
// Design: the engine renumbers the table's states so that DEAD and the H-1
// states reachable from START on ASCII bytes come first (ops/window_scan.py
// hot_byte_scan_table; H = 18 of 1,944 for o200k). Those rows are closed
// under ASCII bytes, so ASCII text walks only them: each tt_seq_scan block
// copies them into shared memory with cp.async, and a step reads shared
// memory while the state is below H and the L2 table only inside a
// multi-byte character.
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
// - tt_window_scan: one thread per grid position, up to W steps, stopping
//   at the first death, every step from the L2 table (the hot rows in
//   shared memory gave it nothing, PERF.md); neighbouring threads read
//   neighbouring row bytes, so every step's byte read coalesces (the class
//   is the byte, or 256 at and past n_total and past the row, as in
//   tt_seq_scan). The hop is the single-sweep maximal-munch one. The
//   positions still alive after W1 steps are counted with one
//   warp-aggregated atomic; a second pass marks every position unresolved
//   when that count exceeds u_cap (the JAX kernel's phase-2 capacity), so
//   the row flags equal the JAX program's.
// - tt_orbit: one thread per row follows the chain p -> p + hop[p],
//   marking piece starts and flagging the row where a start is
//   unresolved or has no match (unchanged: it reads no table).

#include "common.cuh"

namespace {

constexpr int ACC_BITS = 5;
constexpr int ACC_MASK = (1 << ACC_BITS) - 1;
constexpr int START = 1;
constexpr int DEAD = 0;
constexpr int EOF_CLASS = 256;  // column 256 of the byte-indexed table
constexpr int NC = EOF_CLASS + 1;
constexpr int MAX_ROWS = 256;  // rows (threads) per sequential-scan block, at most

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

__global__ void __launch_bounds__(256) window_scan_kernel(
    const int* __restrict__ packed, const uint8_t* __restrict__ rows, int KL,
    const int* __restrict__ n_total, int C, int K, int W, int W1, int* __restrict__ hop_out,
    uint8_t* __restrict__ unresolved, unsigned long long* __restrict__ counter) {
  const long long N = static_cast<long long>(C) * K;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  bool alive_w1 = false;
  if (i < N) {
    const long long b = i / K;
    const int col = static_cast<int>(i - b * K);
    const uint8_t* rb = rows + b * KL;
    const int end = min(n_total[b], KL);  // the first EOF column
    int state = START, hop = 0;
    bool alive = true;
    for (int o = 0; o < W; ++o) {
      const int q = col + o;
      const int v = __ldg(packed + static_cast<long long>(state) * NC +
                          (q >= end ? EOF_CLASS : rb[q]));
      state = v >> ACC_BITS;
      if (state == DEAD) {
        alive = false;
        break;
      }
      const int a = (v & ACC_MASK) - 1;
      if (a >= 0) hop = o + 1 - a;
      if (o == W1 - 1) alive_w1 = true;
    }
    hop_out[i] = hop;
    unresolved[i] = alive;
  }
  const unsigned m = __ballot_sync(0xffffffffu, alive_w1);
  if ((threadIdx.x & 31) == 0 && m) atomicAdd(counter, static_cast<unsigned long long>(__popc(m)));
}

__global__ void unresolve_all_kernel(const unsigned long long* __restrict__ counter,
                                     long long u_cap, long long N, uint8_t* __restrict__ unresolved) {
  if (*counter <= static_cast<unsigned long long>(u_cap)) return;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < N) unresolved[i] = 1;
}

__global__ void orbit_kernel(const int* __restrict__ hop, const uint8_t* __restrict__ unresolved,
                             const int* __restrict__ valid_len, int C, int K,
                             uint8_t* __restrict__ mask, uint8_t* __restrict__ row_bad) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= C) return;
  const long long base = static_cast<long long>(row) * K;
  const int vl = valid_len[row];
  bool bad = false;
  if (vl > 0) {
    int cur = 0;
    while (true) {
      mask[base + cur] = 1;
      const int h = hop[base + cur];
      if (unresolved[base + cur] || h <= 0) bad = true;
      const int nxt = h > 0 ? cur + h : K;  // no match: the chain ends
      if (nxt >= vl) break;
      cur = nxt;
    }
  }
  row_bad[row] = bad;
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

// rows [C, KL] u8, n_total [C] i32 -> hop [C, K] i32, unresolved [C, K]
// u8 (positions 0..K-1, lookahead to K+W-1, EOF past the row); counter:
// one uint64 of scratch; packed [S, 257] i32, indexed by byte (256 = EOF)
extern "C" int tt_window_scan(const void* packed, int S, int nc, const void* rows, int KL,
                              const void* n_total, int C, int K, int W, int W1, long long u_cap,
                              void* hop, void* unresolved, void* counter, void* stream) {
  if (C <= 0 || K <= 0 || K > KL || W <= 0 || W1 <= 0 || W1 > W || S <= 0 || nc != NC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = static_cast<long long>(C) * K;
  cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(unsigned long long), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  window_scan_kernel<<<blocks_of(N, 256), 256, 0, st>>>(
      static_cast<const int*>(packed), static_cast<const uint8_t*>(rows), KL,
      static_cast<const int*>(n_total), C, K, W, W1, static_cast<int*>(hop),
      static_cast<uint8_t*>(unresolved), static_cast<unsigned long long*>(counter));
  unresolve_all_kernel<<<blocks_of(N, 256), 256, 0, st>>>(
      static_cast<const unsigned long long*>(counter), u_cap, N, static_cast<uint8_t*>(unresolved));
  return static_cast<int>(cudaGetLastError());
}

// hop [C, K] i32, unresolved [C, K] u8, valid_len [C] i32 -> piece_start
// [C, K] u8, row_bad [C] u8
extern "C" int tt_orbit(const void* hop, const void* unresolved, const void* valid_len, int C, int K,
                        void* piece_start, void* row_bad, void* stream) {
  if (C <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(piece_start, 0, static_cast<size_t>(C) * K, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  orbit_kernel<<<blocks_of(C, 128), 128, 0, st>>>(
      static_cast<const int*>(hop), static_cast<const uint8_t*>(unresolved),
      static_cast<const int*>(valid_len), C, K, static_cast<uint8_t*>(piece_start),
      static_cast<uint8_t*>(row_bad));
  return static_cast<int>(cudaGetLastError());
}
