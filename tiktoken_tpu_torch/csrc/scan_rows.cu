// scan_rows: row gather, per-byte char classes and the handshake char-DFA
// scan of every row of a v3 chunk, plus the handshake validation.
//
// Replaces (JAX package): ops/pipeline3.py build_pipeline3_fn.row_gather
// (B1), ops/charclass.py make_byte_classes_fn (B2), ops/sweep_scan.py
// make_char_scan_fn(handshake=True) (B3) — entry point tt_scan_rows — and
// the handshake validation inside build_pipeline3_fn (B4) — entry point
// tt_scan_validate. Plain PyTorch versions: ops/sweep_scan.py scan_rows,
// scan_validate.
//
// What bounds it on the H100: each row is a serial chain of up to
// 3 * (KL + 2) DFA steps, each a dependent shared-memory table read; a
// chunk reads only ~10 MB. It is latency-bound, not bandwidth-bound.
//
// Design: one thread per row (32768 rows fill the card in one wave of
// 64-thread blocks). The class page table (page_entry as uint16), the
// mixed 128-wide class rows and the packed step table live in dynamic
// shared memory, so no step touches device memory. Each block first
// copies its rows from the flat corpus coalesced (B1), then every thread
// classifies its row into a local array (B2, with the JAX kernel's
// non-ASCII cap so headers match) and walks the DFA over it (B3). B4
// runs one thread per mask element.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int N_PAGES = 0x110000 >> 7;  // 8704
constexpr int MIXED_FLAG = 1 << 13;
constexpr int KL_MAX = 512;
constexpr int ROWS_PER_BLOCK = 64;
constexpr int DEAD = 0;
constexpr int START = 1;
constexpr int FIRE_BIT = 1 << 5;
constexpr int REW_BIT = 1 << 6;

__device__ __forceinline__ int class_of_cp(const uint16_t* page, const uint8_t* mixed, int cp) {
  const int e = page[cp >> 7];
  return (e & MIXED_FLAG) ? mixed[(e & (MIXED_FLAG - 1)) * 128 + (cp & 127)] : e;
}

__device__ __forceinline__ int utf8_len_of_lead(int b) {
  if (b < 0x80) return 1;
  if (b >= 0xC2 && b <= 0xDF) return 2;
  if (b >= 0xE0 && b <= 0xEF) return 3;
  if (b >= 0xF0 && b <= 0xF4) return 4;
  return 0;
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
  uint16_t* s_page = reinterpret_cast<uint16_t*>(smem);
  uint32_t* s_consts = reinterpret_cast<uint32_t*>(smem + N_PAGES * 2);
  uint8_t* s_mixed = reinterpret_cast<uint8_t*>(s_consts + n_states * n_words);
  for (int i = threadIdx.x; i < N_PAGES; i += blockDim.x)
    s_page[i] = static_cast<uint16_t>(page_entry[i]);
  for (int i = threadIdx.x; i < n_states * n_words; i += blockDim.x)
    s_consts[i] = consts[i];
  for (int i = threadIdx.x; i < n_mixed * 128; i += blockDim.x)
    s_mixed[i] = mixed_rows[i];

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

  // B2: class of every position; SKIP/CONT inside chars, EOF past n_total
  uint8_t cls[KL_MAX + 1];
  int n_na = 0;
  int b1 = 0, b2 = 0, b3 = 0;  // bytes at p-1, p-2, p-3 (0 before the row)
  for (int p = 0; p < KL; ++p) {
    const int b = row[p];
    const bool cont = (b & 0xC0) == 0x80;
    const bool cont1 = (b1 & 0xC0) == 0x80;
    const bool cont2 = (b2 & 0xC0) == 0x80;
    const bool cont3 = (b3 & 0xC0) == 0x80;
    const int k = cont ? (cont1 ? (cont2 ? (cont3 ? 4 : 3) : 2) : 1) : 0;
    const int lead = k == 0 ? b : (k == 1 ? b1 : (k == 2 ? b2 : b3));
    const bool char_end = k < 4 && utf8_len_of_lead(lead) == k + 1;
    int c;
    if (p >= nt) {
      c = eof_cls;
    } else if (!char_end) {
      c = cont ? cont_cls : skip_cls;
    } else if (!cont) {
      c = class_of_cp(s_page, s_mixed, b);
    } else {
      int cp;
      if (k == 1) {
        cp = ((lead & 0x1F) << 6) | (b & 0x3F);
      } else if (k == 2) {
        cp = ((lead & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b & 0x3F);
      } else {
        cp = ((lead & 0x07) << 18) | ((b2 & 0x3F) << 12) | ((b1 & 0x3F) << 6) | (b & 0x3F);
      }
      cp = min(max(cp, 0x80), 0x10FFFF);
      // past the cap the JAX kernel's per-row compaction leaves class 0
      c = n_na < na_cap ? class_of_cp(s_page, s_mixed, cp) : 0;
      ++n_na;
    }
    cls[p] = static_cast<uint8_t>(c);
    b3 = b2;
    b2 = b1;
    b1 = b;
  }
  cls[KL] = static_cast<uint8_t>(eof_cls);
  na_over[r] = n_na > na_cap;

  // B3: maximal-munch walk from offset 0 up to the first boundary at or
  // past n_payload (ops/sweep_scan.py handshake_scan_numpy)
  uint8_t* mrow = mask + static_cast<long long>(r) * KP;
  for (int i = 0; i < KP; ++i) mrow[i] = 0;
  const int npay = n_payload[r];
  const bool dend = is_doc_end[r] != 0;
  int f = max(npay, 0);
  bool bad = false;
  bool done = npay <= 0;
  int p = 0, s = START, mstart = 0, lend = -1, cs = 0;
  const int cap = 3 * (KL + 2);
  for (int it = 0; it < cap && !done && !bad; ++it) {
    const int c = cls[min(p, KL)];
    const int v = (s_consts[s * n_words + (c >> 2)] >> ((c & 3) * 8)) & 0xFF;
    const int s2 = v & 31;
    if (v & FIRE_BIT) lend = (v & REW_BIT) ? (c == eof_cls ? p : cs) : p + 1;
    const bool eof_death = p >= nt;
    const bool died = s2 == DEAD || eof_death || (c == cont_cls && p == mstart);
    if (died) {
      const bool eof_bad = eof_death && !dend;
      if (eof_bad) bad = true;  // unresolved straddler / fake-EOF resolution
      if (mstart < npay && mstart < KP) mrow[mstart] = 1;
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
      if (c < skip_cls) cs = p + 1;
      ++p;
      s = s2;
    }
  }
  spec_f[r] = npay <= 0 ? 0 : f;
  row_bad[r] = bad || !done;
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
  const size_t smem = N_PAGES * 2 + static_cast<size_t>(n_states) * n_words * 4 +
                      static_cast<size_t>(n_mixed) * 128;
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
