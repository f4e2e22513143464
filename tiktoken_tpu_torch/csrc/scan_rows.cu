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
// What bounds it on the H100: each row is a serial chain of up to
// 3 * (KL + 2) DFA steps, each a dependent shared-memory table read, after
// a classification pass of KL dependent table reads; a chunk moves only
// ~10-17 MB. It is latency-bound, not bandwidth-bound.
//
// Design: one thread per row (32768 rows fill the card in about one
// wave). The class page table (page_entry as uint16), the mixed 128-wide
// class rows and the packed step table live in dynamic shared memory
// (47,308 bytes for o200k), so no step touches device memory. B2 is
// char_class and the walk of B3/B16 is walk_row, shared by both scans;
// both keep the JAX kernel's non-ASCII cap, so headers match.
// - tt_scan_rows: each block first copies its 64 rows from the flat
//   corpus coalesced (B1), then every thread classifies its row into a
//   local array and walks it, writing its mask bytes.
// - tt_char_scan: each block stages its 128 rows in shared memory with
//   neighbouring threads on neighbouring words (a thread reading its own
//   272-byte row from device memory would not coalesce), at a row stride
//   of an odd number of words, so threads at the same column hit distinct
//   banks. Every thread classifies its row in place, a word at a time (a
//   class replaces its byte: the walk reads classes only), walks it and
//   sets piece-start bits in a per-row shared bit mask; the block then
//   writes the mask bytes out coalesced. No per-thread local array, so the
//   row length is bounded by shared memory, not by KL_MAX.
// B4 runs one thread per mask element.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int N_PAGES = 0x110000 >> 7;  // 8704
constexpr int MIXED_FLAG = 1 << 13;
constexpr int KL_MAX = 512;  // tt_scan_rows' per-thread class array
constexpr int ROWS_PER_BLOCK = 64;  // tt_scan_rows
constexpr int CHAR_ROWS = 128;  // tt_char_scan
constexpr int MAX_SMEM = 232448;  // dynamic shared memory one block may take
constexpr int DEAD = 0;
constexpr int START = 1;
constexpr int FIRE_BIT = 1 << 5;
constexpr int REW_BIT = 1 << 6;

// The class tables in shared memory and the scan's constants.
struct ScanTab {
  const uint16_t* page;
  const uint8_t* mixed;
  const uint32_t* consts;
  int n_words, skip_cls, cont_cls, eof_cls, na_cap;
};

__host__ __device__ size_t table_smem(int n_states, int n_words, int n_mixed) {
  return N_PAGES * 2 + static_cast<size_t>(n_states) * n_words * 4 +
         static_cast<size_t>(n_mixed) * 128;
}

// Bytes between rows staged by tt_char_scan: at least KL + 1 (the EOF
// column), an odd number of words.
__host__ __device__ int row_stride(int KL) { return (((KL + 4) / 4) | 1) * 4; }

size_t char_scan_smem(int KL, int K, int n_states, int n_words, int n_mixed) {
  const size_t tables = (table_smem(n_states, n_words, n_mixed) + 15) / 16 * 16;
  return tables + static_cast<size_t>(CHAR_ROWS) * (row_stride(KL) + 4 * ((K + 31) / 32));
}

// Copies the tables into shared memory at smem (the whole block takes
// part; the caller synchronises).
__device__ ScanTab load_tables(unsigned char* smem, const int* __restrict__ page_entry,
                               const uint8_t* __restrict__ mixed_rows, int n_mixed,
                               const uint32_t* __restrict__ consts, int n_states, int n_words,
                               int skip_cls, int cont_cls, int eof_cls, int na_cap) {
  uint16_t* s_page = reinterpret_cast<uint16_t*>(smem);
  uint32_t* s_consts = reinterpret_cast<uint32_t*>(smem + N_PAGES * 2);
  uint8_t* s_mixed = reinterpret_cast<uint8_t*>(s_consts + n_states * n_words);
  for (int i = threadIdx.x; i < N_PAGES; i += blockDim.x)
    s_page[i] = static_cast<uint16_t>(page_entry[i]);
  for (int i = threadIdx.x; i < n_states * n_words; i += blockDim.x) s_consts[i] = consts[i];
  for (int i = threadIdx.x; i < n_mixed * 128; i += blockDim.x) s_mixed[i] = mixed_rows[i];
  return ScanTab{s_page, s_mixed, s_consts, n_words, skip_cls, cont_cls, eof_cls, na_cap};
}

__device__ __forceinline__ int class_of_cp(const ScanTab& t, int cp) {
  const int e = t.page[cp >> 7];
  return (e & MIXED_FLAG) ? t.mixed[(e & (MIXED_FLAG - 1)) * 128 + (cp & 127)] : e;
}

__device__ __forceinline__ int utf8_len_of_lead(int b) {
  if (b < 0x80) return 1;
  if (b >= 0xC2 && b <= 0xDF) return 2;
  if (b >= 0xE0 && b <= 0xEF) return 3;
  if (b >= 0xF0 && b <= 0xF4) return 4;
  return 0;
}

// B2: the class of byte b given the three bytes before it (0 before the
// row): the char's class at a char's final byte, SKIP/CONT inside chars,
// EOF past the text. n_na counts the non-ASCII char ends so far; past the
// cap one reads class 0, as the JAX kernel's per-row compaction leaves it.
__device__ __forceinline__ int char_class(const ScanTab& t, int b, int b1, int b2, int b3,
                                          bool past_end, int& n_na) {
  if (past_end) return t.eof_cls;
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
  cp = min(max(cp, 0x80), 0x10FFFF);
  return n_na++ < t.na_cap ? class_of_cp(t, cp) : 0;
}

// B3 / B16: the maximal-munch walk of one row from offset 0 over its
// classes cls[0..KL] (cls[KL] = EOF), as ops/sweep_scan.py _walk_numpy.
// mark(m) is called for each piece start m below n_payload and K. With
// HANDSHAKE, a death on the buffer EOF of a row that does not end its
// document is bad, and f is the first boundary at or past n_payload.
// Returns row_bad (bad, or unfinished within 3 * (KL + 2) steps).
template <bool HANDSHAKE, typename Mark>
__device__ __forceinline__ bool walk_row(const ScanTab& t, const uint8_t* cls, int KL, int K,
                                         int nt, int npay, bool dend, Mark mark, int& f) {
  f = max(npay, 0);
  bool bad = false;
  bool done = npay <= 0;
  int p = 0, s = START, mstart = 0, lend = -1, cs = 0;
  const int cap = 3 * (KL + 2);
  for (int it = 0; it < cap && !done && !bad; ++it) {
    const int c = cls[min(p, KL)];
    const int v = (t.consts[s * t.n_words + (c >> 2)] >> ((c & 3) * 8)) & 0xFF;
    const int s2 = v & 31;
    if (v & FIRE_BIT) lend = (v & REW_BIT) ? (c == t.eof_cls ? p : cs) : p + 1;
    const bool eof_death = p >= nt;
    const bool died = s2 == DEAD || eof_death || (c == t.cont_cls && p == mstart);
    if (died) {
      const bool eof_bad = HANDSHAKE && eof_death && !dend;
      if (eof_bad) bad = true;  // unresolved straddler / fake-EOF resolution
      if (mstart < npay && mstart < K) mark(mstart);
      const bool no_prog = lend <= mstart;
      const bool finished = lend >= npay;
      if (no_prog && !finished) bad = true;
      if (finished || no_prog) {
        if (!eof_bad) f = lend;
        done = true;
      } else {
        p = lend;
        s = START;
        mstart = lend;
        cs = lend;
        lend = -1;
      }
    } else {
      if (c < t.skip_cls) cs = p + 1;
      ++p;
      s = s2;
    }
  }
  return bad || !done;
}

__global__ void __launch_bounds__(ROWS_PER_BLOCK) scan_rows_kernel(
    const uint8_t* __restrict__ flat, long long flat_size,
    const int* __restrict__ row_off, const int* __restrict__ n_payload,
    const int* __restrict__ n_total, const uint8_t* __restrict__ is_doc_end,
    int C, int KL, int KP,
    const int* __restrict__ page_entry, const uint8_t* __restrict__ mixed_rows,
    int n_mixed, const uint32_t* __restrict__ consts, int n_states, int n_words,
    int skip_cls, int cont_cls, int eof_cls, int na_cap,
    uint8_t* rows, uint8_t* __restrict__ mask, int* __restrict__ spec_f,
    uint8_t* __restrict__ row_bad, uint8_t* __restrict__ na_over) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanTab t = load_tables(smem, page_entry, mixed_rows, n_mixed, consts, n_states, n_words,
                                skip_cls, cont_cls, eof_cls, na_cap);

  // B1: this block's rows, copied with neighbouring threads on
  // neighbouring bytes
  const int r0 = blockIdx.x * ROWS_PER_BLOCK;
  const int nrows = min(ROWS_PER_BLOCK, C - r0);
  for (int i = threadIdx.x; i < nrows * KL; i += blockDim.x) {
    const int rr = i / KL;
    const int col = i - rr * KL;
    const long long src = static_cast<long long>(row_off[r0 + rr]) + col;
    rows[static_cast<long long>(r0 + rr) * KL + col] =
        (src >= 0 && src < flat_size) ? flat[src] : 0;
  }
  __syncthreads();  // rows and tables visible to the whole block

  const int r = r0 + threadIdx.x;
  if (r >= C) return;
  const uint8_t* row = rows + static_cast<long long>(r) * KL;
  const int nt = n_total[r];

  // B2
  uint8_t cls[KL_MAX + 1];
  int n_na = 0;
  int b1 = 0, b2 = 0, b3 = 0;  // bytes at p-1, p-2, p-3 (0 before the row)
  for (int p = 0; p < KL; ++p) {
    const int b = row[p];
    cls[p] = static_cast<uint8_t>(char_class(t, b, b1, b2, b3, p >= nt, n_na));
    b3 = b2;
    b2 = b1;
    b1 = b;
  }
  cls[KL] = static_cast<uint8_t>(eof_cls);
  na_over[r] = n_na > na_cap;

  // B3: up to the first boundary at or past n_payload
  uint8_t* mrow = mask + static_cast<long long>(r) * KP;
  for (int i = 0; i < KP; ++i) mrow[i] = 0;
  const int npay = n_payload[r];
  int f;
  row_bad[r] = walk_row<true>(t, cls, KL, KP, nt, npay, is_doc_end[r] != 0,
                              [&](int m) { mrow[m] = 1; }, f);
  spec_f[r] = npay <= 0 ? 0 : f;
}

// B16: the v2 rows' classes and scan without the handshake.
__global__ void __launch_bounds__(CHAR_ROWS) char_scan_kernel(
    const uint8_t* __restrict__ rows, int C, int KL, int K, const int* __restrict__ n_payload,
    const int* __restrict__ n_total, const int* __restrict__ page_entry,
    const uint8_t* __restrict__ mixed_rows, int n_mixed, const uint32_t* __restrict__ consts,
    int n_states, int n_words, int skip_cls, int cont_cls, int eof_cls, int na_cap,
    uint8_t* __restrict__ mask, uint8_t* __restrict__ row_bad, uint8_t* __restrict__ na_over) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanTab t = load_tables(smem, page_entry, mixed_rows, n_mixed, consts, n_states, n_words,
                                skip_cls, cont_cls, eof_cls, na_cap);
  const int stride = row_stride(KL);
  const int KW = (K + 31) / 32;
  uint8_t* s_rows = smem + (table_smem(n_states, n_words, n_mixed) + 15) / 16 * 16;
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_rows + CHAR_ROWS * stride);

  const int r0 = blockIdx.x * CHAR_ROWS;
  const int nrows = min(CHAR_ROWS, C - r0);
  const uint8_t* src = rows + static_cast<long long>(r0) * KL;
  if ((KL & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
    const int kw = KL >> 2;
    const uint32_t* src32 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* dst32 = reinterpret_cast<uint32_t*>(s_rows);
    for (int i = threadIdx.x; i < nrows * kw; i += blockDim.x) {
      const int rr = i / kw;
      dst32[rr * (stride >> 2) + (i - rr * kw)] = src32[i];
    }
  } else {
    for (int i = threadIdx.x; i < nrows * KL; i += blockDim.x) {
      const int rr = i / KL;
      s_rows[rr * stride + (i - rr * KL)] = src[i];
    }
  }
  for (int i = threadIdx.x; i < nrows * KW; i += blockDim.x) s_mask[i] = 0;
  __syncthreads();

  if (threadIdx.x < nrows) {
    const int r = r0 + threadIdx.x;
    uint8_t* row = s_rows + threadIdx.x * stride;
    uint32_t* row32 = reinterpret_cast<uint32_t*>(row);
    const int end = min(n_total[r], KL);  // positions at and past it read EOF
    // B2 in place, a word at a time
    int n_na = 0;
    int b1 = 0, b2 = 0, b3 = 0;
    for (int w = 0; w < (KL + 3) / 4; ++w) {
      const uint32_t word = row32[w];
      uint32_t out = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = (word >> (8 * j)) & 0xFF;
        out |= static_cast<uint32_t>(char_class(t, b, b1, b2, b3, 4 * w + j >= end, n_na))
               << (8 * j);
        b3 = b2;
        b2 = b1;
        b1 = b;
      }
      row32[w] = out;
    }
    row[KL] = static_cast<uint8_t>(eof_cls);
    na_over[r] = n_na > na_cap;

    uint32_t* mw = s_mask + threadIdx.x * KW;
    int f;
    row_bad[r] = walk_row<false>(t, row, KL, K, n_total[r], n_payload[r], false,
                                 [&](int m) { mw[m >> 5] |= 1u << (m & 31); }, f);
  }
  __syncthreads();

  // the mask out, neighbouring threads on neighbouring bytes
  uint8_t* dst = mask + static_cast<long long>(r0) * K;
  for (int i = threadIdx.x; i < nrows * K; i += blockDim.x) {
    const int rr = i / K;
    const int col = i - rr * K;
    dst[i] = (s_mask[rr * KW + (col >> 5)] >> (col & 31)) & 1u;
  }
}

// B4: one thread per mask element; the column-0 thread of each row
// writes its row_bad.
__global__ void scan_validate_kernel(
    const uint8_t* __restrict__ mask, const int* __restrict__ spec_f,
    const uint8_t* __restrict__ row_bad, const int* __restrict__ n_payload,
    const uint8_t* __restrict__ prev_same_doc, const uint8_t* __restrict__ emit,
    int C, int KP, uint8_t* __restrict__ mask3, uint8_t* __restrict__ row_bad_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(C) * KP) return;
  const int r = static_cast<int>(i / KP);
  const int col = static_cast<int>(i - static_cast<long long>(r) * KP);
  const bool prev = prev_same_doc[r] != 0;
  int g = 0;
  if (prev && r > 0) g = spec_f[r - 1] - n_payload[r - 1];
  g = min(max(g, 0), KP);
  mask3[i] = mask[i] && col >= g && emit[r];
  if (col == 0) {
    const bool ok = mask[static_cast<long long>(r) * KP + min(g, KP - 1)] || g == n_payload[r];
    row_bad_out[r] = row_bad[r] || (prev && !ok);
  }
}

}  // namespace

extern "C" int tt_scan_rows(
    const void* flat, long long flat_size, const void* row_off, const void* n_payload,
    const void* n_total, const void* is_doc_end, int C, int KL, int KP,
    const void* page_entry, const void* mixed_rows, int n_mixed, const void* consts,
    int n_states, int n_words, int skip_cls, int cont_cls, int eof_cls, int na_cap,
    void* rows, void* mask, void* spec_f, void* row_bad, void* na_over, void* stream) {
  if (KL > KL_MAX || KP > KL || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = table_smem(n_states, n_words, n_mixed);
  cudaError_t err = cudaFuncSetAttribute(
      scan_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (C + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  scan_rows_kernel<<<blocks, ROWS_PER_BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flat), flat_size, static_cast<const int*>(row_off),
      static_cast<const int*>(n_payload), static_cast<const int*>(n_total),
      static_cast<const uint8_t*>(is_doc_end), C, KL, KP,
      static_cast<const int*>(page_entry), static_cast<const uint8_t*>(mixed_rows), n_mixed,
      static_cast<const uint32_t*>(consts), n_states, n_words, skip_cls, cont_cls, eof_cls,
      na_cap, static_cast<uint8_t*>(rows), static_cast<uint8_t*>(mask),
      static_cast<int*>(spec_f), static_cast<uint8_t*>(row_bad), static_cast<uint8_t*>(na_over));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tt_scan_validate(
    const void* mask, const void* spec_f, const void* row_bad, const void* n_payload,
    const void* prev_same_doc, const void* emit, int C, int KP, void* mask3,
    void* row_bad_out, void* stream) {
  const long long n = static_cast<long long>(C) * KP;
  const int tpb = 256;
  const unsigned blocks = static_cast<unsigned>((n + tpb - 1) / tpb);
  scan_validate_kernel<<<blocks, tpb, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int*>(spec_f),
      static_cast<const uint8_t*>(row_bad), static_cast<const int*>(n_payload),
      static_cast<const uint8_t*>(prev_same_doc), static_cast<const uint8_t*>(emit), C, KP,
      static_cast<uint8_t*>(mask3), static_cast<uint8_t*>(row_bad_out));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory tt_char_scan takes per block at this geometry;
// the wrapper refuses a geometry over MAX_SMEM before any launch.
extern "C" int tt_char_scan_smem(int KL, int K, int n_states, int n_words, int n_mixed) {
  return static_cast<int>(char_scan_smem(KL, K, n_states, n_words, n_mixed));
}

extern "C" int tt_char_scan_max_smem() { return MAX_SMEM; }

// rows [C, KL] u8, n_payload/n_total [C] i32 -> piece_start [C, K] u8,
// row_bad [C] u8, na_over [C] u8 (the row has more non-ASCII char ends
// before n_total than na_cap)
extern "C" int tt_char_scan(
    const void* rows, int C, int KL, int K, const void* n_payload, const void* n_total,
    const void* page_entry, const void* mixed_rows, int n_mixed, const void* consts,
    int n_states, int n_words, int skip_cls, int cont_cls, int eof_cls, int na_cap,
    void* mask, void* row_bad, void* na_over, void* stream) {
  const size_t smem = char_scan_smem(KL, K, n_states, n_words, n_mixed);
  if (C <= 0 || K <= 0 || K > KL || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      char_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (C + CHAR_ROWS - 1) / CHAR_ROWS;
  char_scan_kernel<<<blocks, CHAR_ROWS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), C, KL, K, static_cast<const int*>(n_payload),
      static_cast<const int*>(n_total), static_cast<const int*>(page_entry),
      static_cast<const uint8_t*>(mixed_rows), n_mixed, static_cast<const uint32_t*>(consts),
      n_states, n_words, skip_cls, cont_cls, eof_cls, na_cap, static_cast<uint8_t*>(mask),
      static_cast<uint8_t*>(row_bad), static_cast<uint8_t*>(na_over));
  return static_cast<int>(cudaGetLastError());
}
