// compaction: stable stream compaction, the piece catalogs, row-wise
// compaction, slot extraction, monotone routing and the expansion of
// per-piece token counts into the token stream of a v3 or v2 chunk.
//
// Replaces (JAX package): ops/compaction.py compact (the piece catalog of
// ops/pipeline3.py build_pipeline3_fn (B5) with its piece lengths,
// too-long row flags and canonical word padding, and the short-miss and
// long compactions of B7/B8 with their slot prefix sums), route_right
// (pipeline3.py) and ops/compaction.py expand with the token fetch that
// follows it (B8). Those are scatter-free radix routes, built so because
// scatters are slow on the TPU. For v2 (B10): ops/pieces.py
// make_catalog_fn and make_extract_fn with the too-long row flags of
// ops/pipeline2.py (tt_catalog2), its extract_long (tt_extract_slots),
// and its assembly, the masked scatters of singles, short-miss and long
// tokens at off + rank with the per-row token counts
// (tt_expand_tokens_rows: the v3 expansion, whose contract fits, plus
// the row counts, which it does not give). Plain PyTorch versions:
// ops/compaction.py catalog, catalog2, compact_slots, compact_rows,
// extract_slots, route_right, expand_tokens, expand_tokens_rows.
//
// What bounds it on the H100: bytes. A chunk's catalog reads ~7.3 M mask
// bytes and writes up to ~1.5 M entries of 24 bytes; the other entry
// points move less.
//
// Design: the GPU form of the monotone routes is a prefix sum plus a
// scatter. Three passes: per-tile sums of the valid flags (or counts),
// one block scanning the tile sums into tile offsets and the total, then
// each tile's block-level exclusive scan and scatter. The scatter pass
// also writes each entry's slot (its exclusive prefix), so no caller
// recomputes it. Slots past the count are zero-filled by a last pass that
// reads the count on the device, so no pass waits for the host; the
// catalog's last pass also measures each piece and pads its words.
// Row-wise compaction (16 or 64 lanes) runs one thread per row.

#include "common.cuh"

namespace {

constexpr int TPB = 256;  // threads per tile block
constexpr int IPT = 8;    // items per thread
constexpr int TILE = TPB * IPT;
constexpr int MAX_PAY = 6;
constexpr int SLOT = 16;       // ops/pieces.py SLOT
constexpr int LONG_SLOT = 64;  // ops/pieces.py LONG_SLOT

// up to MAX_PAY int32 payloads, each of width[k] ints per entry
struct Payloads {
  const int* in[MAX_PAY];
  int* out[MAX_PAY];
  int width[MAX_PAY];
  int n;
};

// item value: valid flag (compaction) or count (expansion)
struct FlagItems {
  const uint8_t* v;
  __device__ long long operator()(long long i) const { return v[i] != 0; }
};
struct CountItems {
  const int* v;
  __device__ long long operator()(long long i) const { return v[i]; }
};

template <class Items>
__global__ void __launch_bounds__(TPB) tile_sums_kernel(Items items, long long n, long long* tile_sum) {
  const long long base = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * IPT;
  long long s = 0;
#pragma unroll
  for (int j = 0; j < IPT; ++j)
    if (base + j < n) s += items(base + j);
  long long total;
  tt::block_excl_scan<TPB>(s, &total);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// one block: exclusive scan of the tile sums in place, total to *total
__global__ void __launch_bounds__(1024) scan_tiles_kernel(long long* tile_sum, int n_tiles, int* total) {
  long long carry = 0;
  for (int base = 0; base < n_tiles; base += 1024) {
    const int i = base + threadIdx.x;
    const long long v = i < n_tiles ? tile_sum[i] : 0;
    long long chunk;
    const long long excl = tt::block_excl_scan<1024>(v, &chunk);
    if (i < n_tiles) tile_sum[i] = carry + excl;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = static_cast<int>(carry);
}

// stable compaction: valid item i goes to slot (tile offset + exclusive
// prefix within the tile); only slots < out_size are written. With a
// slot array, every item gets its slot there (-1 where not valid).
template <class Emit>
__global__ void __launch_bounds__(TPB) scatter_kernel(const uint8_t* __restrict__ valid, long long n,
                                                      const long long* __restrict__ tile_off,
                                                      long long out_size, Emit emit,
                                                      int* __restrict__ slot) {
  const long long base = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * IPT;
  uint8_t v[IPT];
  long long s = 0;
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    v[j] = (base + j < n) ? (valid[base + j] != 0) : 0;
    s += v[j];
  }
  long long total;
  long long dst = tile_off[blockIdx.x] + tt::block_excl_scan<TPB>(s, &total);
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    if (slot != nullptr && base + j < n) slot[base + j] = v[j] ? static_cast<int>(dst) : -1;
    if (v[j]) {
      if (dst < out_size) emit(base + j, dst);
      ++dst;
    }
  }
}

struct FlatEmit {
  Payloads p;
  __device__ void operator()(long long i, long long dst) const {
    for (int k = 0; k < p.n; ++k) {
      const int w = p.width[k];
      for (int c = 0; c < w; ++c) p.out[k][dst * w + c] = p.in[k][i * w + c];
    }
  }
};

// the catalog: grid position i = row * KP + col of the start mask ->
// flat row index row * KL + col
struct CatalogEmit {
  int KL, KP;
  int* starts;
  __device__ void operator()(long long i, long long dst) const {
    const long long r = i / KP;
    starts[dst] = static_cast<int>(r * KL + (i - r * KP));
  }
};

// zero every output slot at or past the device-side count
__global__ void fill_tail_kernel(const int* __restrict__ count, long long out_size, Payloads p) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= out_size || j < *count) return;
  for (int k = 0; k < p.n; ++k)
    for (int w = 0; w < p.width[k]; ++w) p.out[k][j * p.width[k] + w] = 0;
}

__global__ void copy_flags_kernel(const uint8_t* __restrict__ in, int n, uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = in[i] != 0;
}

// catalog entry j: its length (to the next start in its row, else to the
// row's scan end spec_f), the too-long flag of its row, and its first
// 16 bytes as 4 little-endian words, zero past min(len, 16) and past the
// row; entries at or past the count are zero. The next start reads as 0
// past the count, as in the JAX program's zero-filled catalog.
__global__ void catalog_finish_kernel(const int* __restrict__ count, long long out_size,
                                      const uint8_t* __restrict__ rows, int C, int KL,
                                      const int* __restrict__ spec_f, int* __restrict__ starts,
                                      int* __restrict__ lens, uint32_t* __restrict__ words,
                                      uint8_t* __restrict__ row_bad) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= out_size) return;
  const long long n = *count;
  if (j >= n) {
    starts[j] = 0;
    lens[j] = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) words[j * 4 + w] = 0;
    return;
  }
  const int s = starts[j];
  const int prow = s / KL;
  int end = prow * KL + spec_f[min(max(prow, 0), C - 1)];
  if (j + 1 < out_size) {
    const int ns = j + 1 < n ? starts[j + 1] : 0;
    if (ns / KL == prow) end = ns;
  }
  const int len = end - s;
  lens[j] = len;
  if (len > LONG_SLOT) row_bad[prow] = 1;
  const int nb = min(max(len, 0), SLOT);
  const int col = s - prow * KL;
  const uint8_t* row = rows + static_cast<long long>(prow) * KL;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = 4 * w + b;
      if (c < nb && col + c < KL) word |= static_cast<uint32_t>(row[col + c]) << (8 * b);
    }
    words[j * 4 + w] = word;
  }
}

// row-wise compaction with the count of each row
__global__ void compact_rows_kernel(const uint8_t* __restrict__ valid, const int* __restrict__ vals,
                                    int M, int W, int* __restrict__ out, int* __restrict__ counts) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const long long base = static_cast<long long>(m) * W;
  int c = 0;
  for (int w = 0; w < W; ++w)
    if (valid[base + w]) out[base + c++] = vals[base + w];
  counts[m] = c;
  for (; c < W; ++c) out[base + c] = 0;
}

__global__ void route_kernel(const int* __restrict__ dst, const int* __restrict__ vals, int n,
                             int out_size, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int d = dst[i];
  if (d >= 0 && d < out_size) out[d] = vals[i];
}

// expansion: piece i writes its run [off, off + counts[i]) of tokens. A
// combo with bit 31 set carries a single piece's token; otherwise token
// k of the run is src[combo + k], src being m_tok then l_tok.
__global__ void __launch_bounds__(TPB) expand_tokens_kernel(
    const int* __restrict__ counts, const int* __restrict__ combo, long long n,
    const long long* __restrict__ tile_off, const int* __restrict__ m_tok, long long n_m,
    const int* __restrict__ l_tok, long long n_l, long long out_size, int* __restrict__ tok) {
  const long long base = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * IPT;
  int c[IPT];
  long long s = 0;
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    c[j] = (base + j < n) ? counts[base + j] : 0;
    s += c[j];
  }
  long long total;
  long long off = tile_off[blockIdx.x] + tt::block_excl_scan<TPB>(s, &total);
  const long long last = n_m + n_l - 1;
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    if (c[j] > 0) {
      const int cb = combo[base + j];
      const int low = cb & 0x7FFFFFFF;
      for (int k = 0; k < c[j] && off + k < out_size; ++k) {
        int t = low;
        if (cb >= 0) {
          const long long idx = min(static_cast<long long>(low) + k, last);
          t = idx < n_m ? m_tok[idx] : l_tok[idx - n_m];
        }
        tok[off + k] = t;
      }
    }
    off += c[j];
  }
}

__global__ void expand_tail_kernel(const int* __restrict__ total, long long out_size, int* __restrict__ tok) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= out_size || j < *total) return;
  tok[j] = 0;
}

// the v2 catalog: grid position i = row * K + col is its own flat index
struct Catalog2Emit {
  int* starts;
  __device__ void operator()(long long i, long long dst) const { starts[dst] = static_cast<int>(i); }
};

// v2 catalog entry j: C*K past the count; its length runs to the next
// start, capped at its row's payload end; its row is flagged when the
// piece is longer than LONG_SLOT; its first min(len, 16) bytes from the
// row as 4 little-endian words, zero after
__global__ void catalog2_finish_kernel(const int* __restrict__ count, long long out_size,
                                       const uint8_t* __restrict__ rows, int C, int K, int KL,
                                       const int* __restrict__ n_payload, int* __restrict__ starts,
                                       int* __restrict__ lens, uint32_t* __restrict__ words,
                                       uint8_t* __restrict__ row_bad) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= out_size) return;
  const long long N = static_cast<long long>(C) * K;
  const long long n = *count;
  if (j >= n) {
    starts[j] = static_cast<int>(N);
    lens[j] = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) words[j * 4 + w] = 0;
    return;
  }
  const int s = starts[j];
  const long long next = (j + 1 < n && j + 1 < out_size) ? starts[j + 1] : N;
  const int prow = min(s / K, C - 1);
  const long long row_end = static_cast<long long>(prow) * K + n_payload[prow];
  const long long end = min(next > s ? next : N, row_end);
  const int len = static_cast<int>(max(end - s, 0LL));
  lens[j] = len;
  if (len > LONG_SLOT) row_bad[prow] = 1;
  const int nb = min(len, SLOT);
  const int col = s - prow * K;
  const uint8_t* row = rows + static_cast<long long>(prow) * KL;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = 4 * w + b;
      if (c < nb && col + c < KL) word |= static_cast<uint32_t>(row[col + c]) << (8 * b);
    }
    words[j * 4 + w] = word;
  }
}

// slot extraction: word w of piece i = its bytes 4w..4w+3 from its row,
// zero past min(len, width) and past the row
__global__ void extract_slots_kernel(const uint8_t* __restrict__ rows, int C, int KL, int K,
                                     const int* __restrict__ starts, const int* __restrict__ lens,
                                     int n, int width, uint32_t* __restrict__ out) {
  const int wpp = width / 4;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n) * wpp) return;
  const int i = static_cast<int>(t / wpp);
  const int w = static_cast<int>(t - static_cast<long long>(i) * wpp);
  const int s = starts[i];
  const int nb = min(max(lens[i], 0), width);
  uint32_t word = 0;
  if (s >= 0 && static_cast<long long>(s) < static_cast<long long>(C) * K) {
    const int prow = s / K;
    const int col = s - prow * K;
    const uint8_t* row = rows + static_cast<long long>(prow) * KL;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = 4 * w + b;
      if (c < nb && col + c < KL) word |= static_cast<uint32_t>(row[col + c]) << (8 * b);
    }
  }
  out[t] = word;
}

// per-row token counts: piece i adds counts[i] to row min(starts[i] / K,
// n_rows - 1)
__global__ void row_counts_kernel(const int* __restrict__ counts, const int* __restrict__ starts,
                                  long long n, int K, int n_rows, int* __restrict__ row_counts) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || counts[i] == 0) return;
  atomicAdd(row_counts + min(max(starts[i], 0) / K, n_rows - 1), counts[i]);
}

int n_tiles_of(long long n) { return static_cast<int>((n + TILE - 1) / TILE); }

unsigned blocks_of(long long n, int tpb) { return static_cast<unsigned>((n + tpb - 1) / tpb); }

template <class Emit>
void compact_any(const uint8_t* valid, long long n, long long out_size, Emit emit, int* slot,
                 int* count, long long* scratch, cudaStream_t st) {
  const int nt = n_tiles_of(n);
  tile_sums_kernel<<<nt, TPB, 0, st>>>(FlagItems{valid}, n, scratch);
  scan_tiles_kernel<<<1, 1024, 0, st>>>(scratch, nt, count);
  scatter_kernel<<<nt, TPB, 0, st>>>(valid, n, scratch, out_size, emit, slot);
}

}  // namespace

// flat stable compaction of up to 6 int32 payloads of widths[k] ints per
// entry, with each entry's slot; scratch: n_tiles int64
extern "C" int tt_compact(const void* valid, long long n, int n_pay, const void* const* ins,
                          void* const* outs, const int* widths, long long out_size, void* count,
                          void* slot, void* scratch, void* stream) {
  if (n <= 0 || n_pay < 1 || n_pay > MAX_PAY) return static_cast<int>(cudaErrorInvalidValue);
  Payloads p{};
  p.n = n_pay;
  for (int k = 0; k < n_pay; ++k) {
    p.in[k] = static_cast<const int*>(ins[k]);
    p.out[k] = static_cast<int*>(outs[k]);
    p.width[k] = widths[k];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  compact_any(static_cast<const uint8_t*>(valid), n, out_size, FlatEmit{p}, static_cast<int*>(slot),
              static_cast<int*>(count), static_cast<long long*>(scratch), st);
  if (out_size > 0)
    fill_tail_kernel<<<blocks_of(out_size, 256), 256, 0, st>>>(static_cast<int*>(count), out_size, p);
  return static_cast<int>(cudaGetLastError());
}

// piece catalog over the start mask [C, KP] of rows [C, KL]: starts,
// lengths, padded words and row_bad_out = row_bad | too-long rows
extern "C" int tt_catalog(const void* mask, int C, int KP, const void* rows, int KL,
                          const void* spec_f, const void* row_bad, long long out_size,
                          void* starts, void* words, void* lens, void* row_bad_out, void* count,
                          void* scratch, void* stream) {
  const long long n = static_cast<long long>(C) * KP;
  if (n <= 0 || KP > KL || out_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  copy_flags_kernel<<<blocks_of(C, 256), 256, 0, st>>>(static_cast<const uint8_t*>(row_bad), C,
                                                      static_cast<uint8_t*>(row_bad_out));
  compact_any(static_cast<const uint8_t*>(mask), n, out_size,
              CatalogEmit{KL, KP, static_cast<int*>(starts)}, nullptr, static_cast<int*>(count),
              static_cast<long long*>(scratch), st);
  catalog_finish_kernel<<<blocks_of(out_size, 256), 256, 0, st>>>(
      static_cast<const int*>(count), out_size, static_cast<const uint8_t*>(rows), C, KL,
      static_cast<const int*>(spec_f), static_cast<int*>(starts), static_cast<int*>(lens),
      static_cast<uint32_t*>(words), static_cast<uint8_t*>(row_bad_out));
  return static_cast<int>(cudaGetLastError());
}

// row-wise compaction of vals [M, W] by valid [M, W], zero-filled, with
// the count of each row
extern "C" int tt_compact_rows(const void* valid, const void* vals, int M, int W, void* out,
                               void* counts, void* stream) {
  compact_rows_kernel<<<blocks_of(M, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), static_cast<const int*>(vals), M, W,
      static_cast<int*>(out), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// out[dst[i]] = vals[i] for 0 <= dst[i] < out_size, zero elsewhere
extern "C" int tt_route(const void* dst, const void* vals, int n, int out_size, void* out,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(out_size) * 4, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0)
    route_kernel<<<blocks_of(n, 256), 256, 0, st>>>(static_cast<const int*>(dst),
                                                    static_cast<const int*>(vals), n, out_size,
                                                    static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// the token stream of per-piece counts [n] and combos [n], fetching merged
// tokens from m_tok [n_m] then l_tok [n_l]; scratch: n_tiles int64
extern "C" int tt_expand_tokens(const void* counts, const void* combo, long long n,
                                const void* m_tok, long long n_m, const void* l_tok,
                                long long n_l, long long out_size, void* tok, void* total,
                                void* scratch, void* stream) {
  if (n <= 0 || n_m + n_l <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = n_tiles_of(n);
  long long* tile = static_cast<long long*>(scratch);
  tile_sums_kernel<<<nt, TPB, 0, st>>>(CountItems{static_cast<const int*>(counts)}, n, tile);
  scan_tiles_kernel<<<1, 1024, 0, st>>>(tile, nt, static_cast<int*>(total));
  expand_tokens_kernel<<<nt, TPB, 0, st>>>(
      static_cast<const int*>(counts), static_cast<const int*>(combo), n, tile,
      static_cast<const int*>(m_tok), n_m, static_cast<const int*>(l_tok), n_l, out_size,
      static_cast<int*>(tok));
  if (out_size > 0)
    expand_tail_kernel<<<blocks_of(out_size, 256), 256, 0, st>>>(static_cast<const int*>(total),
                                                                 out_size, static_cast<int*>(tok));
  return static_cast<int>(cudaGetLastError());
}

// v2 piece catalog over the start grid [C, K] of rows [C, KL]: starts,
// lengths, padded words and row_bad_out = row_bad | too-long rows
extern "C" int tt_catalog2(const void* mask, int C, int K, const void* n_payload, const void* rows,
                           int KL, const void* row_bad, long long out_size, void* starts,
                           void* words, void* lens, void* row_bad_out, void* count, void* scratch,
                           void* stream) {
  const long long n = static_cast<long long>(C) * K;
  if (n <= 0 || K > KL || out_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  copy_flags_kernel<<<blocks_of(C, 256), 256, 0, st>>>(static_cast<const uint8_t*>(row_bad), C,
                                                      static_cast<uint8_t*>(row_bad_out));
  compact_any(static_cast<const uint8_t*>(mask), n, out_size,
              Catalog2Emit{static_cast<int*>(starts)}, nullptr, static_cast<int*>(count),
              static_cast<long long*>(scratch), st);
  catalog2_finish_kernel<<<blocks_of(out_size, 256), 256, 0, st>>>(
      static_cast<const int*>(count), out_size, static_cast<const uint8_t*>(rows), C, K, KL,
      static_cast<const int*>(n_payload), static_cast<int*>(starts), static_cast<int*>(lens),
      static_cast<uint32_t*>(words), static_cast<uint8_t*>(row_bad_out));
  return static_cast<int>(cudaGetLastError());
}

// slots [n, width] u8 of the pieces at flat grid starts [n] with lens [n]
// from rows [C, KL] (grid rows of K columns); width a multiple of 4
extern "C" int tt_extract_slots(const void* rows, int C, int KL, int K, const void* starts,
                                const void* lens, int n, int width, void* out, void* stream) {
  if (C <= 0 || K <= 0 || width <= 0 || width % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    extract_slots_kernel<<<blocks_of(static_cast<long long>(n) * (width / 4), 256), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rows), C, KL, K, static_cast<const int*>(starts),
        static_cast<const int*>(lens), n, width, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// tt_expand_tokens plus the token count of each of n_rows rows of K grid
// columns, by the flat grid start of each piece
extern "C" int tt_expand_tokens_rows(const void* counts, const void* combo, long long n,
                                     const void* m_tok, long long n_m, const void* l_tok,
                                     long long n_l, long long out_size, const void* starts, int K,
                                     int n_rows, void* tok, void* total, void* row_counts,
                                     void* scratch, void* stream) {
  if (K <= 0 || n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(row_counts, 0, static_cast<size_t>(n_rows) * 4, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n > 0)
    row_counts_kernel<<<blocks_of(n, 256), 256, 0, st>>>(
        static_cast<const int*>(counts), static_cast<const int*>(starts), n, K, n_rows,
        static_cast<int*>(row_counts));
  return tt_expand_tokens(counts, combo, n, m_tok, n_m, l_tok, n_l, out_size, tok, total, scratch,
                          stream);
}

extern "C" int tt_tiles(long long n) { return n_tiles_of(n); }
