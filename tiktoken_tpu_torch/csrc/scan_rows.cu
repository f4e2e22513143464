// scan_rows: per-byte char classes and the char-DFA scan of every row of a
// chunk: with the handshake for v3 rows, without it for v2 rows; plus the
// v3 handshake validation.
//
// Replaces (JAX package):
// - tt_scan_rows: ops/pipeline3.py build_pipeline3_fn.row_gather (B1),
//   ops/charclass.py make_byte_classes_fn (B2) and ops/sweep_scan.py
//   make_char_scan_fn(handshake=True) (B3);
// - tt_scan_validate: the handshake validation inside build_pipeline3_fn
//   (B4);
// - tt_char_scan: make_byte_classes_fn over the v2 rows and
//   make_char_scan_fn(handshake=False) (B16), as ops/pipeline2.py
//   build_pipeline2_fn(char_tables=...) runs them.
// Plain PyTorch versions: ops/sweep_scan.py scan_rows, scan_validate,
// char_scan_rows.
//
// What bounds it on the H100: each row's walk is a serial chain of up to
// 3 * (KL + 2) DFA steps, each a dependent shared-memory table read; a
// chunk moves only ~10-17 MB. One walking thread per row puts ~8 walking
// warps on each SM at C=32768, so the walk is bound by the latency of the
// slowest lane's chain in each warp, not by bandwidth; the phases before
// it are data-parallel and take four threads per row.
//
// Design: one kernel body (scan_kernel<HANDSHAKE>) serves both scans. Each
// block takes rows_per_block rows with THREADS_PER_ROW threads per row and
// 1. copies the class tables into shared memory with cp.async (the page
//    table uploaded once as uint16, ScanTables.page16), while it stages
//    its rows in shared memory with neighbouring threads on neighbouring
//    words, STAGE_BATCH loads in flight per thread: v3 gathers them from
//    the flat corpus at row_off with funnel shifts over aligned words (B1)
//    and writes `rows` out from the same registers; v2 copies them from
//    `rows`. Rows sit an odd number of words apart, so threads at one
//    column hit distinct banks. The classes of the ASCII code points are
//    then tabled once per block;
// 2. classifies data-parallel (B2): a warp takes a row, its lanes on
//    neighbouring words, CLASS_ROUNDS rounds of 32 words at once; each lane
//    holds its word and gets the three bytes before it from its neighbour
//    by a shuffle (lane 0 from the previous round) before it overwrites its
//    word with the classes. The non-ASCII cap stays exact: where a round
//    may cross it, a warp prefix count of the non-ASCII char ends, with a
//    carry across the row's rounds, gives each one its rank; past the cap
//    it reads class 0 and the row is over the cap;
// 3. walks (B3/B16): one thread per row over the shared classes (walk_row,
//    the one source of both scans), the step table read as bytes and the
//    next class loaded while the step resolves, piece starts set in a
//    per-row shared bit mask;
// 4. writes the mask out, neighbouring threads on neighbouring words;
// 5. ORs whether a row of the block is over the non-ASCII cap into the
//    launch's flag (na_flag, the JAX programs' na_overflow): one atomic OR
//    a block into a scratch word, then a ticket taken with one
//    acquire-release atomic; the last block to arrive writes the flag and
//    sets both scratch words back to 0, so no call pays a memset or a
//    reduction launch.
// B4 stays its own pass, one thread per 16 mask columns: folding it in
// would walk one more row per block (the row before the block's first,
// for its spec_f), and the pass is one small launch.

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int N_PAGES = 0x110000 >> 7;  // 8704
constexpr int MIXED_FLAG = 1 << 13;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory one block may take
constexpr int DEAD = 0;
constexpr int START = 1;
constexpr int FIRE_BIT = 1 << 5;
constexpr int REW_BIT = 1 << 6;
constexpr int THREADS_PER_ROW = 4;  // a block's threads per row it walks
constexpr int STAGE_BATCH = 8;   // row words each thread loads before it stores them
constexpr int CLASS_ROUNDS = 3;  // rounds of 32 words a warp classifies together

// The class tables in shared memory and the scan's constants. step[s *
// row_bytes + c] is the packed step value of state s on class c: the
// bytes of the [S, NW] step words.
struct ScanTab {
  const uint16_t* page;
  const uint8_t* mixed;
  const uint8_t* step;
  const uint8_t* ascii;  // the class of each ASCII code point
  int row_bytes, skip_cls, cont_cls, eof_cls, na_cap;
};

__host__ __device__ size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ size_t table_smem(int n_states, int n_words, int n_mixed) {
  return N_PAGES * 2 + round16(static_cast<size_t>(n_states) * n_words * 4) +
         static_cast<size_t>(n_mixed) * 128 + 128;
}

// Words between staged rows: at least KL / 4 + 1 (the EOF column lies in
// the last one), an odd number.
__host__ __device__ int row_words(int KL) { return (KL / 4 + 1) | 1; }

// Mask words between rows, odd.
__host__ __device__ int mask_words(int K) { return ((K + 31) / 32) | 1; }

// The tables, then per row its staged words, its mask words and its
// offset (v3).
__host__ __device__ size_t scan_smem(int KL, int K, int n_states, int n_words, int n_mixed,
                                     int rows) {
  return round16(table_smem(n_states, n_words, n_mixed)) +
         static_cast<size_t>(rows) * 4 * (row_words(KL) + mask_words(K) + 1);
}

struct Params {
  // v3: the flat corpus and each row's offset; v2: the rows [C, KL]
  const uint8_t* src;
  long long src_size;
  const int* row_off;
  const int* n_payload;
  const int* n_total;
  const uint8_t* is_doc_end;
  int C, KL, K, rows_per_block;
  const uint16_t* page;
  const uint8_t* mixed;
  int n_mixed;
  const uint32_t* consts;
  int n_states, n_words, skip_cls, cont_cls, eof_cls, na_cap;
  uint8_t* rows;  // v3: the gathered rows out
  uint8_t* mask;  // [C, K]
  int* spec_f;    // v3
  uint8_t* row_bad;
  uint8_t* na_flag;    // 0-d: some row is over the non-ASCII cap
  unsigned* scratch;   // [0] the ticket, [1] the blocks' flags: 0 at entry and at exit
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Copies n bytes (a multiple of 16, both ends 16-byte aligned) with the
// whole block taking part; completion is awaited by cp_async_wait.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int n) {
  for (int i = threadIdx.x; i < n / 16; i += blockDim.x)
    cp_async16(static_cast<uint8_t*>(dst) + 16 * i, static_cast<const uint8_t*>(src) + 16 * i);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Starts the table copies into shared memory at smem; the caller waits
// (cp_async_wait), synchronises and fills the ASCII classes (fill_ascii).
__device__ ScanTab load_tables(unsigned char* smem, const Params& a) {
  uint16_t* s_page = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s_step = smem + N_PAGES * 2;
  const int step_bytes = a.n_states * a.n_words * 4;
  uint8_t* s_mixed = s_step + round16(step_bytes);
  copy_async(s_page, a.page, N_PAGES * 2);
  copy_async(s_step, a.consts, step_bytes & ~15);
  for (int i = (step_bytes & ~15) + threadIdx.x; i < step_bytes; i += blockDim.x)
    s_step[i] = reinterpret_cast<const uint8_t*>(a.consts)[i];
  copy_async(s_mixed, a.mixed, a.n_mixed * 128);
  return ScanTab{s_page, s_mixed, s_step, s_mixed + a.n_mixed * 128, a.n_words * 4, a.skip_cls,
                 a.cont_cls, a.eof_cls, a.na_cap};
}

__device__ __forceinline__ int class_of_cp(const ScanTab& t, int cp) {
  const int e = t.page[cp >> 7];
  return (e & MIXED_FLAG) ? t.mixed[(e & (MIXED_FLAG - 1)) * 128 + (cp & 127)] : e;
}

__device__ __forceinline__ void fill_ascii(const ScanTab& t) {
  for (int i = threadIdx.x; i < 128; i += blockDim.x)
    const_cast<uint8_t*>(t.ascii)[i] = static_cast<uint8_t>(class_of_cp(t, i));
}

__device__ __forceinline__ int utf8_len_of_lead(int b) {
  if (b < 0x80) return 1;
  if (b >= 0xC2 && b <= 0xDF) return 2;
  if (b >= 0xE0 && b <= 0xEF) return 3;
  if (b >= 0xF0 && b <= 0xF4) return 4;
  return 0;
}

// B2 before the cap: the class of byte b given the three bytes before it
// (0 before the row): the char's class at a char's final byte, SKIP/CONT
// inside chars, EOF past the text. na: b ends a non-ASCII char.
__device__ __forceinline__ int char_class(const ScanTab& t, int b, int b1, int b2, int b3,
                                          bool past_end, bool& na) {
  na = false;
  if (past_end) return t.eof_cls;
  if (b < 0x80) return t.ascii[b];
  const bool cont = (b & 0xC0) == 0x80;
  const bool cont1 = (b1 & 0xC0) == 0x80;
  const bool cont2 = (b2 & 0xC0) == 0x80;
  const bool cont3 = (b3 & 0xC0) == 0x80;
  const int k = cont ? (cont1 ? (cont2 ? (cont3 ? 4 : 3) : 2) : 1) : 0;
  const int lead = k == 0 ? b : (k == 1 ? b1 : (k == 2 ? b2 : b3));
  if (!(k < 4 && utf8_len_of_lead(lead) == k + 1)) return cont ? t.cont_cls : t.skip_cls;
  if (!cont) return class_of_cp(t, b);
  int cp;
  if (k == 1) {
    cp = ((lead & 0x1F) << 6) | (b & 0x3F);
  } else if (k == 2) {
    cp = ((lead & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b & 0x3F);
  } else {
    cp = ((lead & 0x07) << 18) | ((b2 & 0x3F) << 12) | ((b1 & 0x3F) << 6) | (b & 0x3F);
  }
  na = true;
  return class_of_cp(t, min(max(cp, 0x80), 0x10FFFF));
}

// B3 / B16: the maximal-munch walk of one row from offset 0 over its
// classes cls[0..KL] (cls[KL] = EOF), as ops/sweep_scan.py walk_numpy.
// mark(m) is called for each piece start m below n_payload and K. With
// HANDSHAKE, a death on the buffer EOF of a row that does not end its
// document is bad, and f is the first boundary at or past n_payload.
// Returns row_bad (bad, or unfinished within 3 * (KL + 2) steps).
template <bool HANDSHAKE, typename Mark>
__device__ __forceinline__ bool walk_row(const ScanTab& t, const uint8_t* cls, int KL, int K,
                                         int nt, int npay, bool dend, Mark mark, int& f) {
  f = max(npay, 0);
  if (npay <= 0) return false;
  int p = 0, s = START, mstart = 0, lend = -1, cs = 0;
  int c = cls[0];
  bool bad = true;  // unless it finishes within the cap
  const int cap = 3 * (KL + 2);
  for (int it = 0; it < cap; ++it) {
    const int v = t.step[s * t.row_bytes + c];
    const int c_next = cls[min(p + 1, KL)];  // loaded while the step resolves
    const int fire_end = (v & REW_BIT) ? (c == t.eof_cls ? p : cs) : p + 1;
    lend = (v & FIRE_BIT) ? fire_end : lend;
    const bool eof_death = p >= nt;
    const bool died = (v & 31) == DEAD || eof_death || (c == t.cont_cls && p == mstart);
    if (died && mstart < npay && mstart < K) mark(mstart);
    // a death on the buffer EOF of a row that does not end its document:
    // an unresolved straddler
    const bool eof_bad = HANDSHAKE && died && eof_death && !dend;
    const bool finished = lend >= npay;
    const bool stop = died && (finished || lend <= mstart);
    if (stop || eof_bad) {
      if (!eof_bad) f = lend;
      bad = eof_bad || !finished;
      break;
    }
    // advance, or restart at the last accept end, without a branch
    cs = died ? lend : (c < t.skip_cls ? p + 1 : cs);
    mstart = died ? lend : mstart;
    s = died ? START : (v & 31);
    c = died ? cls[min(lend, KL)] : c_next;
    p = died ? lend : p + 1;
    lend = died ? -1 : lend;
  }
  return bad;
}

// the 4 bytes of flat at al (a multiple of 4), zero outside [0, size)
__device__ __forceinline__ uint32_t aligned_word(const uint8_t* __restrict__ flat, long long size,
                                                 long long al) {
  if (al >= 0 && al + 4 <= size) return __ldg(reinterpret_cast<const uint32_t*>(flat + al));
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (al + j >= 0 && al + j < size) w |= static_cast<uint32_t>(flat[al + j]) << (8 * j);
  return w;
}

template <bool HANDSHAKE>
__global__ void scan_kernel(const Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanTab t = load_tables(smem, a);
  const int R = a.rows_per_block, T = blockDim.x;
  const int KL = a.KL, K = a.K;
  const int RW = row_words(KL), MW = mask_words(K);
  uint32_t* s_rows = reinterpret_cast<uint32_t*>(
      smem + round16(table_smem(a.n_states, a.n_words, a.n_mixed)));
  uint32_t* s_mask = s_rows + R * RW;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, a.C - r0);
  const int KLW = (KL + 3) / 4;  // words holding row bytes

  // 1. stage the rows (the table copies run meanwhile), STAGE_BATCH loads
  // in flight per thread
  const int n_words = nrows * KLW;
  if (HANDSHAKE) {
    int* s_off = reinterpret_cast<int*>(s_mask + R * MW);
    if (threadIdx.x < nrows) s_off[threadIdx.x] = a.row_off[r0 + threadIdx.x];
    __syncthreads();
    for (int i0 = threadIdx.x; i0 < n_words; i0 += STAGE_BATCH * T) {
      uint32_t lo[STAGE_BATCH], hi[STAGE_BATCH];
#pragma unroll
      for (int b = 0; b < STAGE_BATCH; ++b) {
        const int i = i0 + b * T;
        if (i >= n_words) break;
        const int rr = i / KLW;
        const long long al = (static_cast<long long>(s_off[rr]) + 4 * (i - rr * KLW)) & ~3LL;
        lo[b] = aligned_word(a.src, a.src_size, al);
        hi[b] = aligned_word(a.src, a.src_size, al + 4);
      }
#pragma unroll
      for (int b = 0; b < STAGE_BATCH; ++b) {
        const int i = i0 + b * T;
        if (i >= n_words) break;
        const int rr = i / KLW;
        const int w = i - rr * KLW;
        uint32_t word = __funnelshift_r(lo[b], hi[b], 8 * (s_off[rr] & 3));
        const int left = KL - 4 * w;  // row bytes in this word
        if (left < 4) word &= (1u << (8 * left)) - 1;
        s_rows[rr * RW + w] = word;
        uint8_t* out = a.rows + static_cast<long long>(r0 + rr) * KL + 4 * w;
        if ((KL & 3) == 0) {
          *reinterpret_cast<uint32_t*>(out) = word;
        } else {
          for (int j = 0; j < min(left, 4); ++j) out[j] = static_cast<uint8_t>(word >> (8 * j));
        }
      }
    }
  } else {
    const uint8_t* src = a.src + static_cast<long long>(r0) * KL;
    if ((KL & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
      const uint32_t* src32 = reinterpret_cast<const uint32_t*>(src);
      for (int i0 = threadIdx.x; i0 < n_words; i0 += STAGE_BATCH * T) {
        uint32_t w[STAGE_BATCH];
#pragma unroll
        for (int b = 0; b < STAGE_BATCH; ++b) {
          const int i = i0 + b * T;
          if (i >= n_words) break;
          w[b] = __ldg(src32 + i);
        }
#pragma unroll
        for (int b = 0; b < STAGE_BATCH; ++b) {
          const int i = i0 + b * T;
          if (i >= n_words) break;
          const int rr = i / KLW;
          s_rows[rr * RW + (i - rr * KLW)] = w[b];
        }
      }
    } else {
      uint8_t* s8 = reinterpret_cast<uint8_t*>(s_rows);
      for (int i = threadIdx.x; i < nrows * KL; i += T) {
        const int rr = i / KL;
        s8[rr * RW * 4 + (i - rr * KL)] = src[i];
      }
    }
  }
  for (int i = threadIdx.x; i < nrows * MW; i += T) s_mask[i] = 0;
  cp_async_wait();
  __syncthreads();
  fill_ascii(t);
  __syncthreads();

  // 2. classify: a warp per row (each warp takes R / (T / 32) rows), its
  // lanes on neighbouring words, CLASS_ROUNDS rounds of 32 words read
  // before any is written, so their classes are computed side by side
  const int lane = threadIdx.x & 31;
  const int n_warps = T >> 5;
  int over = 0;  // a row of this thread's over the non-ASCII cap
  const int n_cls_words = KL / 4 + 1;  // through the EOF column
  // the text end of row warp + k * n_warps, held by lane k
  const int my_row = r0 + (threadIdx.x >> 5) + lane * n_warps;
  const int my_end = my_row < a.C ? min(a.n_total[my_row], KL) : 0;
  for (int k = 0; k < 32; ++k) {  // R / n_warps <= 32 rows
    const int rr = (threadIdx.x >> 5) + k * n_warps;
    const int end = __shfl_sync(0xffffffffu, my_end, k);  // positions at and past it read EOF
    if (rr >= nrows) break;
    uint32_t* row = s_rows + rr * RW;
    uint32_t carry_word = 0;  // the word before the next round's lane 0
    int n_na = 0;             // non-ASCII char ends in earlier rounds
    for (int base = 0; base < n_cls_words; base += 32 * CLASS_ROUNDS) {
      uint32_t word[CLASS_ROUNDS], out[CLASS_ROUNDS];
      int m[CLASS_ROUNDS];
      unsigned na_bits[CLASS_ROUNDS];
#pragma unroll
      for (int q = 0; q < CLASS_ROUNDS; ++q) {
        const int w = base + 32 * q + lane;
        word[q] = w < n_cls_words ? row[w] : 0;
      }
#pragma unroll
      for (int q = 0; q < CLASS_ROUNDS; ++q) {
        const uint32_t up = __shfl_up_sync(0xffffffffu, word[q], 1);
        const uint32_t prev = lane ? up : carry_word;
        carry_word = __shfl_sync(0xffffffffu, word[q], 31);
        const unsigned long long x = (static_cast<unsigned long long>(word[q]) << 32) | prev;
        const int w = base + 32 * q + lane;
        out[q] = 0;
        na_bits[q] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = static_cast<int>((x >> (8 * (4 + j))) & 0xFF);
          const int b1 = static_cast<int>((x >> (8 * (3 + j))) & 0xFF);
          const int b2 = static_cast<int>((x >> (8 * (2 + j))) & 0xFF);
          const int b3 = static_cast<int>((x >> (8 * (1 + j))) & 0xFF);
          bool na;
          out[q] |= static_cast<uint32_t>(char_class(t, b, b1, b2, b3, 4 * w + j >= end, na))
                    << (8 * j);
          na_bits[q] |= static_cast<unsigned>(na) << j;
        }
        m[q] = __popc(na_bits[q]);
      }
      // the non-ASCII cap: past it a char end reads class 0
#pragma unroll
      for (int q = 0; q < CLASS_ROUNDS; ++q) {
        const int total = __reduce_add_sync(0xffffffffu, m[q]);
        if (n_na + total > t.na_cap) {  // some char end of this round may be past the cap
          int incl = m[q];
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += y;
          }
          int rank = n_na + incl - m[q];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (((na_bits[q] >> j) & 1) && rank >= t.na_cap) out[q] &= ~(0xFFu << (8 * j));
            rank += (na_bits[q] >> j) & 1;
          }
        }
        n_na += total;
      }
#pragma unroll
      for (int q = 0; q < CLASS_ROUNDS; ++q) {
        const int w = base + 32 * q + lane;
        if (w < n_cls_words) row[w] = out[q];
      }
    }
    over |= lane == 0 && n_na > t.na_cap;
  }
  const int block_over = __syncthreads_or(over);

  // 3. walk: a thread per row
  if (threadIdx.x < nrows) {
    const int r = r0 + threadIdx.x;
    const int npay = a.n_payload[r];
    uint32_t* mw = s_mask + threadIdx.x * MW;
    int f;
    const bool bad = walk_row<HANDSHAKE>(
        t, reinterpret_cast<const uint8_t*>(s_rows + threadIdx.x * RW), KL, K, a.n_total[r], npay,
        HANDSHAKE && a.is_doc_end[r] != 0, [&](int m) { mw[m >> 5] |= 1u << (m & 31); }, f);
    a.row_bad[r] = bad;
    if (HANDSHAKE) a.spec_f[r] = npay <= 0 ? 0 : f;
  }
  __syncthreads();

  // 4. the mask out, neighbouring threads on neighbouring words
  uint8_t* dst = a.mask + static_cast<long long>(r0) * K;
  if ((K & 3) == 0) {
    const int KW4 = K / 4;
    for (int i = threadIdx.x; i < nrows * KW4; i += T) {
      const int rr = i / KW4;
      const int col = 4 * (i - rr * KW4);
      const uint32_t bits = (s_mask[rr * MW + (col >> 5)] >> (col & 31)) & 0xFu;
      reinterpret_cast<uint32_t*>(dst)[i] =
          (bits & 1u) | ((bits & 2u) << 7) | ((bits & 4u) << 14) | ((bits & 8u) << 21);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * K; i += T) {
      const int rr = i / K;
      const int col = i - rr * K;
      dst[i] = (s_mask[rr * MW + (col >> 5)] >> (col & 31)) & 1u;
    }
  }

  // 5. the launch's non-ASCII flag
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> flags(a.scratch[1]);
    if (block_over) flags.fetch_or(1u, cuda::memory_order_relaxed);
    // release: this block's OR is seen by whoever takes a later ticket;
    // acquire: the last block sees every block's
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(a.scratch[0]);
    if (ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1) {
      *a.na_flag = flags.exchange(0u, cuda::memory_order_relaxed) != 0;
      ticket.store(0u, cuda::memory_order_relaxed);  // for the next call on this stream
    }
  }
}

// B4: one thread per 16 mask columns of a row, read and written as one
// 16-byte vector where the row is (KP a multiple of 16), else byte by
// byte; the first thread of each row writes its row_bad.
constexpr int VAL_COLS = 16;

// the bytes of word x (columns col..col + 3) at columns >= g
__device__ __forceinline__ uint32_t keep_from(uint32_t x, int col, int g) {
  const int d = g - col;
  return d <= 0 ? x : (d >= 4 ? 0u : x & (0xFFFFFFFFu << (8 * d)));
}

__global__ void scan_validate_kernel(
    const uint8_t* __restrict__ mask, const int* __restrict__ spec_f,
    const uint8_t* __restrict__ row_bad, const int* __restrict__ n_payload,
    const uint8_t* __restrict__ prev_same_doc, const uint8_t* __restrict__ emit,
    int C, int KP, uint8_t* __restrict__ mask3, uint8_t* __restrict__ row_bad_out) {
  const int per_row = (KP + VAL_COLS - 1) / VAL_COLS;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(C) * per_row) return;
  const int r = static_cast<int>(t / per_row);
  const int col0 = static_cast<int>(t - static_cast<long long>(r) * per_row) * VAL_COLS;
  const bool prev = prev_same_doc[r] != 0;
  int g = 0;
  if (prev && r > 0) g = spec_f[r - 1] - n_payload[r - 1];
  g = min(max(g, 0), KP);
  const long long at = static_cast<long long>(r) * KP + col0;
  if (!emit[r]) g = KP;  // nothing of the row is kept
  if (KP % VAL_COLS == 0) {
    uint4 x = *reinterpret_cast<const uint4*>(mask + at);
    x.x = keep_from(x.x, col0, g);
    x.y = keep_from(x.y, col0 + 4, g);
    x.z = keep_from(x.z, col0 + 8, g);
    x.w = keep_from(x.w, col0 + 12, g);
    *reinterpret_cast<uint4*>(mask3 + at) = x;
  } else {
    for (int c = col0; c < min(col0 + VAL_COLS, KP); ++c)
      mask3[at + c - col0] = mask[at + c - col0] && c >= g;
  }
  if (col0 == 0) {
    const int gr = min(max(prev && r > 0 ? spec_f[r - 1] - n_payload[r - 1] : 0, 0), KP);
    const bool ok = mask[static_cast<long long>(r) * KP + min(gr, KP - 1)] || gr == n_payload[r];
    row_bad_out[r] = row_bad[r] || (prev && !ok);
  }
}

// rows_per_block rows per block (a multiple of 32, at most 256), with
// THREADS_PER_ROW threads for each: all stage and classify, one per row
// walks
template <bool HANDSHAKE>
int launch(const Params& a, int rows_per_block, cudaStream_t stream) {
  const size_t smem = scan_smem(a.KL, a.K, a.n_states, a.n_words, a.n_mixed, rows_per_block);
  if (a.C <= 0 || a.K <= 0 || a.K > a.KL || rows_per_block < 32 ||
      rows_per_block * THREADS_PER_ROW > 1024 || rows_per_block % 32 || smem > MAX_SMEM ||
      (reinterpret_cast<uintptr_t>(a.page) | reinterpret_cast<uintptr_t>(a.consts) |
       reinterpret_cast<uintptr_t>(a.mixed)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<HANDSHAKE>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.C + rows_per_block - 1) / rows_per_block;
  scan_kernel<HANDSHAKE><<<blocks, rows_per_block * THREADS_PER_ROW, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory either scan takes per block at this geometry; the
// wrappers refuse a geometry over tt_scan_max_smem() before any launch.
extern "C" int tt_scan_smem(int KL, int K, int n_states, int n_words, int n_mixed,
                            int rows_per_block) {
  return static_cast<int>(scan_smem(KL, K, n_states, n_words, n_mixed, rows_per_block));
}

extern "C" int tt_scan_max_smem() { return MAX_SMEM; }

// flat [S] u8 (4-byte aligned), row_off/n_payload/n_total [C] i32,
// is_doc_end [C] u8 -> rows [C, KL] u8, mask [C, KP] u8, spec_f [C] i32,
// row_bad [C] u8, na_flag 0-d u8 (some row has more non-ASCII char ends
// before n_total than na_cap); scratch: 2 words, 0 at entry and at exit
extern "C" int tt_scan_rows(
    const void* flat, long long flat_size, const void* row_off, const void* n_payload,
    const void* n_total, const void* is_doc_end, int C, int KL, int KP,
    const void* page16, const void* mixed_rows, int n_mixed, const void* consts,
    int n_states, int n_words, int skip_cls, int cont_cls, int eof_cls, int na_cap,
    int rows_per_block, void* rows, void* mask, void* spec_f, void* row_bad, void* na_flag,
    void* scratch, void* stream) {
  if (reinterpret_cast<uintptr_t>(flat) & 3) return static_cast<int>(cudaErrorInvalidValue);
  const Params a{static_cast<const uint8_t*>(flat), flat_size, static_cast<const int*>(row_off),
                 static_cast<const int*>(n_payload), static_cast<const int*>(n_total),
                 static_cast<const uint8_t*>(is_doc_end), C, KL, KP, rows_per_block,
                 static_cast<const uint16_t*>(page16), static_cast<const uint8_t*>(mixed_rows),
                 n_mixed, static_cast<const uint32_t*>(consts), n_states, n_words, skip_cls,
                 cont_cls, eof_cls, na_cap, static_cast<uint8_t*>(rows),
                 static_cast<uint8_t*>(mask), static_cast<int*>(spec_f),
                 static_cast<uint8_t*>(row_bad), static_cast<uint8_t*>(na_flag),
                 static_cast<unsigned*>(scratch)};
  return launch<true>(a, rows_per_block, static_cast<cudaStream_t>(stream));
}

extern "C" int tt_scan_validate(
    const void* mask, const void* spec_f, const void* row_bad, const void* n_payload,
    const void* prev_same_doc, const void* emit, int C, int KP, void* mask3,
    void* row_bad_out, void* stream) {
  const uintptr_t ends = reinterpret_cast<uintptr_t>(mask) | reinterpret_cast<uintptr_t>(mask3);
  if (C <= 0 || KP <= 0 || (KP % VAL_COLS == 0 && (ends & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(C) * ((KP + VAL_COLS - 1) / VAL_COLS);
  const int tpb = 256;
  const unsigned blocks = static_cast<unsigned>((n + tpb - 1) / tpb);
  scan_validate_kernel<<<blocks, tpb, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int*>(spec_f),
      static_cast<const uint8_t*>(row_bad), static_cast<const int*>(n_payload),
      static_cast<const uint8_t*>(prev_same_doc), static_cast<const uint8_t*>(emit), C, KP,
      static_cast<uint8_t*>(mask3), static_cast<uint8_t*>(row_bad_out));
  return static_cast<int>(cudaGetLastError());
}

// rows [C, KL] u8, n_payload/n_total [C] i32 -> piece_start [C, K] u8,
// row_bad [C] u8, na_flag 0-d u8 (some row has more non-ASCII char ends
// before n_total than na_cap); scratch as tt_scan_rows'
extern "C" int tt_char_scan(
    const void* rows, int C, int KL, int K, const void* n_payload, const void* n_total,
    const void* page16, const void* mixed_rows, int n_mixed, const void* consts,
    int n_states, int n_words, int skip_cls, int cont_cls, int eof_cls, int na_cap,
    int rows_per_block, void* mask, void* row_bad, void* na_flag, void* scratch,
    void* stream) {
  const Params a{static_cast<const uint8_t*>(rows), static_cast<long long>(C) * KL, nullptr,
                 static_cast<const int*>(n_payload), static_cast<const int*>(n_total), nullptr,
                 C, KL, K, rows_per_block, static_cast<const uint16_t*>(page16),
                 static_cast<const uint8_t*>(mixed_rows), n_mixed,
                 static_cast<const uint32_t*>(consts), n_states, n_words, skip_cls, cont_cls,
                 eof_cls, na_cap, nullptr, static_cast<uint8_t*>(mask), nullptr,
                 static_cast<uint8_t*>(row_bad), static_cast<uint8_t*>(na_flag),
                 static_cast<unsigned*>(scratch)};
  return launch<false>(a, rows_per_block, static_cast<cudaStream_t>(stream));
}
