// compaction: the piece catalogs, the fused short-miss and long
// compactions (stable stream compaction), slot extraction and the
// assembly of a v3 or v2 chunk: its per-piece token counts, their
// expansion into the token stream, the row counts and the header.
//
// Replaces (JAX package): ops/compaction.py compact (the piece catalog of
// ops/pipeline3.py build_pipeline3_fn (B5) with its piece lengths,
// too-long row flags and canonical word padding, and the short-miss and
// long compactions of B7/B8 with their kind masks and slot prefix sums),
// and build_pipeline3_fn's assembly (B8, :584-666): route_right of the
// slot counts, the single / count / combo selects, ops/compaction.py
// expand with the token fetch that follows it, the row counts, the
// overflow rule and the header. Those are scatter-free radix routes,
// built so because scatters are slow on the TPU. For v2 (B10):
// ops/pieces.py make_catalog_fn and make_extract_fn with the too-long row
// flags of ops/pipeline2.py (tt_catalog2), its extract_long
// (tt_extract_slots, also v3's extract_long, pipeline3.py:351) and its
// assembly, the masked scatters of singles, short-miss and long tokens at
// off + rank with the per-row token counts, the overflow rule and the
// header (tt_assemble). Plain PyTorch versions: ops/compaction.py
// catalog, catalog2, compact_kinds, extract_slots, assemble.
//
// What bounds it on the H100: bytes. A chunk's catalog reads ~7.3 M mask
// bytes (v2 8.4 M) and writes its p_cap entries of 24 bytes; the other
// entry points move less.
//
// Design: the GPU form of the monotone routes is a prefix sum plus a
// scatter, done in one pass by decoupled look-back (one_pass_kernel).
// Each block claims the next tile of 4096 items (2048 for the assembly) from
// a counter and
// 1. reads the items' values, neighbouring threads on neighbouring items,
//    into shared memory;
// 2. sums each thread's run of 16 neighbouring items, scans the sums over
//    the block, publishes the tile's aggregate, then its inclusive prefix,
//    in a status word per tile; one warp looks back over its
//    predecessors' words for the tile's offset;
// 3. gives each item its offset, neighbouring threads on neighbouring
//    items: the slots of the kind compactions, the expansion's token runs
//    (each piece writes its tokens); and lists the tile's entries in
//    shared memory;
// 4. writes the tile's entries, neighbouring threads on neighbouring
//    entries: the compacted pieces; the catalogs' pieces, measured to
//    the next start in their row (the next entry of the tile, or past the
//    tile's end from the mask), flagged when too long and padded to
//    words.
// Blocks that claim a number past the last tile wait until every tile is
// done, then zero the outputs past the count (each entry keeps its
// zero-filled tail) and finish the per-row outputs (row_bad, row counts)
// from the scratch. The scratch (counters, status words, per-row flags
// and counts) is cleared by one cudaMemsetAsync per call.
// tt_compact_kinds makes the short-miss and long compactions of one
// catalog one such pass, its two counts packed in one 62-bit status.
// tt_assemble takes only the catalog's live entries (below n_pieces, read
// on the device: the tiles past them only count as finished), reads each
// one's length, hit and slots where it is loaded and makes its count and
// combo there, so neither reaches HBM; its tail writes the header.

#include "common.cuh"

namespace {

constexpr int TPB = 256;  // threads per tile block
constexpr int IPT = 16;   // items per thread (tt_assemble's tiles: ASM_IPT)
constexpr int TILE = TPB * IPT;
// items per thread of tt_assemble: smaller tiles, so a v3 chunk's few
// hundred live tiles fill more of the resident block slots
// (scripts/redesign_times.py)
constexpr int ASM_IPT = 8;
constexpr int TAIL = TPB * 16;  // output entries zeroed per tail block
constexpr int SLOT = 16;       // ops/pieces.py SLOT
constexpr int LONG_SLOT = 64;  // ops/pieces.py LONG_SLOT

// the scratch words of a one-pass launch: the tile counter, the count of
// finished tiles, the total, one catalog entry kept for the tail, one
// status word per tile, then the entry's per-row words
constexpr int SCRATCH_HEAD = 4;
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 62;
constexpr unsigned long long FLAG_PREFIX = 2ull << 62;
constexpr unsigned long long VALUE_MASK = FLAG_AGGREGATE - 1;
constexpr long long LOW31 = (1ll << 31) - 1;

__device__ __forceinline__ unsigned long long load_volatile(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_volatile(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// shared-memory index of tile item li, padded so that a thread's run of
// IPT items and a warp's 32 neighbouring items both fall on distinct banks
__device__ __forceinline__ int pad(int li) { return li + (li >> 5); }

// The exclusive prefix of tile `tile` whose items sum to `aggregate`, by
// decoupled look-back over status[0..tile). Every thread calls it.
__device__ long long tile_prefix(unsigned long long* status, int tile, long long aggregate) {
  __shared__ long long s_prefix;
  if (threadIdx.x == 0) {
    store_volatile(status + tile, (tile == 0 ? FLAG_PREFIX : FLAG_AGGREGATE) |
                                      static_cast<unsigned long long>(aggregate));
    if (tile == 0) s_prefix = 0;
  }
  if (tile > 0 && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    long long excl = 0;
    for (int look = tile - 1;; look -= 32) {
      const int idx = look - lane;
      unsigned long long st = idx >= 0 ? load_volatile(status + idx) : FLAG_PREFIX;
      while (__any_sync(0xffffffffu, (st >> 62) == 0)) {
        if ((st >> 62) == 0) st = load_volatile(status + idx);
      }
      const unsigned prefix_lanes = __ballot_sync(0xffffffffu, (st >> 62) == 2);
      const int stop = prefix_lanes ? __ffs(prefix_lanes) - 1 : 31;  // the nearest prefix
      long long v = lane <= stop ? static_cast<long long>(st & VALUE_MASK) : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      excl += v;
      if (prefix_lanes) break;
    }
    if (lane == 0) {
      store_volatile(status + tile,
                     FLAG_PREFIX | static_cast<unsigned long long>(excl + aggregate));
      s_prefix = excl;
    }
  }
  __syncthreads();
  return s_prefix;
}

__host__ __device__ int n_tiles_of(long long n, int tile) {
  return static_cast<int>((n + tile - 1) / tile);
}

// The tile's shared memory: each item's value, then its offset in the
// tile; the item of each of the tile's entries; and, for an op that makes
// them in its values pass (AUX), a word per item for its emit.
template <bool AUX, int T>
struct TileSmemT {
  uint32_t val[T + T / 32];
  uint16_t idx[T];
  uint32_t aux[AUX ? T : 1];
};
using TileSmem = TileSmemT<false, TILE>;

// Defaults of a one-pass op. An op gives the items it takes (live: the
// first live(n) of the n a launch is sized for, read on the device; the
// tiles past them only count as finished), each item's value (value), its
// tile-local sums widened to the status format (widen), sees each
// thread's run of items (run), gives each item its offset (emit), writes
// the tile's entries (entries), receives the total (total) and finishes
// tail block k once every tile is done (tail). An op with AUX makes a
// thread's values together (values: its loads issued side by side, not
// one item's after another's) and keeps a word per item for its emit. A
// tile holds TPB * ITEMS items.
struct OpBase {
  static constexpr bool AUX = false;
  static constexpr int ITEMS = IPT;  // items per thread of a tile
  __device__ long long live(long long n) const { return n; }
  __device__ long long widen(long long local) const { return local; }
  __device__ void run(long long, const uint32_t*, long long) const {}
  template <class S>
  __device__ void entries(long long, long long, uint32_t, const S&, long long) const {}
};

// One pass of a stable prefix sum with its scatter (see the file's
// comment). Launch n_tiles + n_tail blocks of TPB; at least four blocks
// stay resident per SM (at most 64 registers a thread), so a launch's
// first wave covers ~530 tiles.
template <class Op>
__global__ void __launch_bounds__(TPB, 4) one_pass_kernel(Op op, long long n, int n_tiles,
                                                         unsigned long long* scratch) {
  constexpr int ipt = Op::ITEMS;
  constexpr int tile_items = TPB * ipt;
  __shared__ TileSmemT<Op::AUX, tile_items> sm;
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(scratch, 1ull));
  __syncthreads();
  const int tile = s_tile;
  if (tile >= n_tiles) {  // claimed after every tile: they all run or ran
    if (threadIdx.x == 0)
      while (load_volatile(scratch + 1) < static_cast<unsigned long long>(n_tiles)) __nanosleep(64);
    __syncthreads();
    __threadfence();
    op.tail(tile - n_tiles, static_cast<long long>(load_volatile(scratch + 2)));
    return;
  }
  n = op.live(n);
  const int last = max(n_tiles_of(n, tile_items), 1) - 1;  // the last tile with items (or 0)
  if (tile > last) {
    if (threadIdx.x == 0) atomicAdd(scratch + 1, 1ull);
    return;
  }
  const long long base = static_cast<long long>(tile) * tile_items;
  // 1. values, neighbouring threads on neighbouring items
  uint32_t v[ipt];
  if constexpr (Op::AUX) {
    op.values(base, n, v, sm.aux);
  } else {
#pragma unroll
    for (int j = 0; j < ipt; ++j) {
      const int li = j * TPB + threadIdx.x;
      v[j] = base + li < n ? op.value(base + li) : 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < ipt; ++j) sm.val[pad(j * TPB + threadIdx.x)] = v[j];
  __syncthreads();
  // 2. each thread's run, scanned over the block and the tiles before
  const int r0 = threadIdx.x * ipt;
  uint32_t run[ipt];
  long long sum = 0;
#pragma unroll
  for (int j = 0; j < ipt; ++j) {
    run[j] = sm.val[pad(r0 + j)];
    sum += run[j];
  }
  op.run(base + r0, run, n);
  long long aggregate;
  const long long excl = tt::block_excl_scan<TPB>(sum, &aggregate);
  const long long prefix = tile_prefix(scratch + SCRATCH_HEAD, tile, op.widen(aggregate));
  uint32_t off = static_cast<uint32_t>(excl);
#pragma unroll
  for (int j = 0; j < ipt; ++j) {
    sm.val[pad(r0 + j)] = off;
    off += run[j];
  }
  __syncthreads();
  // 3. each item at its offset, neighbouring threads on neighbouring items
#pragma unroll
  for (int j = 0; j < ipt; ++j) {
    const int li = j * TPB + threadIdx.x;
    if (base + li < n) op.emit(base + li, li, sm.val[pad(li)], v[j], prefix, sm);
  }
  __syncthreads();
  // 4. the tile's entries, neighbouring threads on neighbouring entries
  op.entries(base, prefix, static_cast<uint32_t>(aggregate), sm, n);
  __threadfence();  // this tile's writes before its count of finished tiles
  __syncthreads();
  if (threadIdx.x == 0) {
    if (tile == last) {
      const long long total = prefix + op.widen(aggregate);
      store_volatile(scratch + 2, static_cast<unsigned long long>(total));
      op.total(total);
      __threadfence();
    }
    atomicAdd(scratch + 1, 1ull);
  }
}

// [lo, hi) of tail chunk k over out_size entries past the total
__device__ __forceinline__ void tail_range(int k, long long total, long long out_size,
                                           long long& lo, long long& hi) {
  lo = max(static_cast<long long>(k) * TAIL, total);
  hi = min(static_cast<long long>(k + 1) * TAIL, out_size);
}

__host__ __device__ int tail_blocks(long long out_size) {
  return static_cast<int>((out_size + TAIL - 1) / TAIL);
}


unsigned blocks_of(long long n, int tpb) { return static_cast<unsigned>((n + tpb - 1) / tpb); }

// status words for n items: one a tile of the smallest tiles an op takes
int status_words(long long n) { return n_tiles_of(n, TPB * ASM_IPT); }

long long scratch_words(long long n, long long row_bytes) {
  return SCRATCH_HEAD + status_words(n) + (row_bytes + 7) / 8;
}

// the entry's per-row words in the scratch, past the status words
void* row_scratch(void* scratch, long long n) {
  return static_cast<unsigned long long*>(scratch) + SCRATCH_HEAD + status_words(n);
}

// clears the scratch and launches the pass over n items
template <class Op>
int one_pass(const Op& op, long long n, long long row_bytes, int n_tail, void* scratch,
             cudaStream_t st) {
  const int nt = n_tiles_of(n, TPB * Op::ITEMS);
  cudaError_t e = cudaMemsetAsync(scratch, 0, scratch_words(n, row_bytes) * 8, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  one_pass_kernel<<<nt + n_tail, TPB, 0, st>>>(op, n, nt,
                                               static_cast<unsigned long long*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// The first min(len, 16) bytes of the piece at column col of a row of KL
// bytes at byte offset row_at of rows (C * KL bytes), as 4 little-endian
// words, zero after them and past the row: five aligned word loads and
// funnel shifts where rows are 4-byte aligned and KL a multiple of 4,
// else byte loads.
__device__ __forceinline__ uint4 piece_words(const uint8_t* __restrict__ rows, long long n_bytes,
                                             long long row_at, int col, int KL, int len) {
  const int nb = min(min(max(len, 0), SLOT), KL - col);  // bytes kept
  if (nb <= 0) return make_uint4(0, 0, 0, 0);
  const long long at = row_at + col;
  if ((KL & 3) | (reinterpret_cast<uintptr_t>(rows) & 3)) {
    uint32_t b[4] = {0, 0, 0, 0};
    for (int c = 0; c < nb; ++c) b[c >> 2] |= static_cast<uint32_t>(rows[at + c]) << (8 * (c & 3));
    return make_uint4(b[0], b[1], b[2], b[3]);
  }
  const long long al = at & ~3ll;
  const int sh = static_cast<int>(at - al) * 8;
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(rows);
  const long long n_words = n_bytes / 4;
  uint32_t a[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const long long wi = al / 4 + k;
    a[k] = wi < n_words ? __ldg(w32 + wi) : 0u;
  }
  uint32_t out[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t word = __funnelshift_r(a[w], a[w + 1], sh);
    const int keep = min(max(nb - 4 * w, 0), 4);  // bytes of this word kept
    out[w] = keep == 4 ? word : word & ((1u << (8 * keep)) - 1);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// the first set flag of mask in [from, to), -1 if none
__device__ __forceinline__ long long next_set(const uint8_t* mask, long long from, long long to) {
  for (long long c = from; c < to; ++c)
    if (mask[c]) return c;
  return -1;
}

// The item after entry k of a catalog tile: the tile's next entry, else
// the next set flag of the mask before `row_end` past the tile; -1 if
// none before row_end.
__device__ __forceinline__ long long next_item(const uint8_t* mask, long long base, long long i,
                                               int k, uint32_t agg, const TileSmem& sm,
                                               long long row_end) {
  const long long ni = k + 1 < static_cast<int>(agg)
                           ? base + sm.idx[k + 1]
                           : next_set(mask, max(i + 1, base + TILE), row_end);
  return ni < row_end ? ni : -1;
}

// row_bad_out = row_bad | flags for the rows of tail block k
__device__ __forceinline__ void finish_rows(int k, int C, const uint8_t* row_bad,
                                            const uint8_t* flags, uint8_t* row_bad_out) {
  const int hi = min((k + 1) * TAIL, C);
  for (int r = k * TAIL + threadIdx.x; r < hi; r += TPB) row_bad_out[r] = row_bad[r] | flags[r];
}

// v3 catalog over mask [C, KP] of rows [C, KL]: entry j = start r * KL +
// col, its length to the next start of its row, else to the row's scan
// end spec_f; as in the JAX program's zero-filled catalog, the next start
// reads as 0 past the count, which the last entry of row 0 can see: that
// entry waits for the tail. Too-long pieces flag their rows in flags
// (scratch); the tail ORs them into row_bad.
struct CatalogOp : OpBase {
  const uint8_t* mask;
  int C, KP, KL;
  const uint8_t* rows;
  const int* spec_f;
  const uint8_t* row_bad;
  long long out_size;
  int *starts, *lens;
  uint4* words;
  uint8_t *flags, *row_bad_out;
  unsigned long long* keep;  // the kept entry of row 0
  int* count;
  __device__ uint32_t value(long long i) const { return mask[i] != 0; }
  __device__ void emit(long long, int li, uint32_t off, uint32_t v, long long, TileSmem& sm) const {
    if (v) sm.idx[off] = static_cast<uint16_t>(li);
  }
  __device__ void finish(long long d, int r, int col, int end) const {
    const int len = end - (r * KL + col);
    lens[d] = len;
    if (len > LONG_SLOT) flags[r] = 1;
    words[d] = piece_words(rows, static_cast<long long>(C) * KL, static_cast<long long>(r) * KL,
                           col, KL, len);
  }
  __device__ void entries(long long base, long long prefix, uint32_t agg, const TileSmem& sm,
                          long long) const {
    for (int k = threadIdx.x; k < static_cast<int>(agg); k += TPB) {
      const long long d = prefix + k;
      if (d >= out_size) break;
      const long long i = base + sm.idx[k];
      const int r = static_cast<int>(i / KP);
      const int col = static_cast<int>(i - static_cast<long long>(r) * KP);
      starts[d] = r * KL + col;
      const long long ni = next_item(mask, base, i, k, agg, sm, static_cast<long long>(r + 1) * KP);
      if (d + 1 < out_size && ni >= 0) {
        finish(d, r, col, r * KL + static_cast<int>(ni - static_cast<long long>(r) * KP));
      } else if (d + 1 < out_size && r == 0) {
        store_volatile(keep, (static_cast<unsigned long long>(d + 1) << 32) | col);
      } else {
        finish(d, r, col, r * KL + spec_f[r]);
      }
    }
  }
  __device__ void total(long long t) const { *count = static_cast<int>(t); }
  __device__ void tail(int k, long long total) const {
    if (k == 0) {
      if (threadIdx.x == 0) {
        const unsigned long long kept = load_volatile(keep);
        if (kept) {  // the last entry of row 0, with no next start in its row
          const long long d = static_cast<long long>(kept >> 32) - 1;
          const int col = static_cast<int>(kept & 0xFFFFFFFFu);
          finish(d, 0, col, d + 1 < total ? spec_f[0] : 0);
        }
      }
      __syncthreads();
    }
    finish_rows(k, C, row_bad, flags, row_bad_out);
    long long lo, hi;
    tail_range(k, total, out_size, lo, hi);
    for (long long j = lo + threadIdx.x; j < hi; j += TPB) {
      starts[j] = 0;
      lens[j] = 0;
      words[j] = make_uint4(0, 0, 0, 0);
    }
  }
};

// v2 catalog over the start grid [C, K] of rows [C, KL]: entry j = flat
// grid index i, its length to the next start of its row, capped at the
// row's payload end; C*K past the count. Too-long pieces flag their rows
// as in CatalogOp.
struct Catalog2Op : OpBase {
  const uint8_t* mask;
  int C, K, KL;
  const uint8_t* rows;
  const int* n_payload;
  const uint8_t* row_bad;
  long long out_size;
  int *starts, *lens;
  uint4* words;
  uint8_t *flags, *row_bad_out;
  int* count;
  __device__ uint32_t value(long long i) const { return mask[i] != 0; }
  __device__ void emit(long long, int li, uint32_t off, uint32_t v, long long, TileSmem& sm) const {
    if (v) sm.idx[off] = static_cast<uint16_t>(li);
  }
  __device__ void entries(long long base, long long prefix, uint32_t agg, const TileSmem& sm,
                          long long) const {
    for (int k = threadIdx.x; k < static_cast<int>(agg); k += TPB) {
      const long long d = prefix + k;
      if (d >= out_size) break;
      const long long i = base + sm.idx[k];
      const int r = static_cast<int>(i / K);
      const int col = static_cast<int>(i - static_cast<long long>(r) * K);
      starts[d] = static_cast<int>(i);
      const long long ni = next_item(mask, base, i, k, agg, sm, static_cast<long long>(r + 1) * K);
      const int row_end = n_payload[r];
      const int end = (d + 1 < out_size && ni >= 0)
                          ? min(static_cast<int>(ni - static_cast<long long>(r) * K), row_end)
                          : row_end;
      const int len = max(end - col, 0);
      lens[d] = len;
      if (len > LONG_SLOT) flags[r] = 1;
      words[d] = piece_words(rows, static_cast<long long>(C) * KL, static_cast<long long>(r) * KL,
                             col, KL, len);
    }
  }
  __device__ void total(long long t) const { *count = static_cast<int>(t); }
  __device__ void tail(int k, long long total) const {
    finish_rows(k, C, row_bad, flags, row_bad_out);
    long long lo, hi;
    tail_range(k, total, out_size, lo, hi);
    const int N = C * K;
    for (long long j = lo + threadIdx.x; j < hi; j += TPB) {
      starts[j] = N;
      lens[j] = 0;
      words[j] = make_uint4(0, 0, 0, 0);
    }
  }
};

// The short-miss and long compactions of one catalog: item i (live below
// n_pieces) is a short miss (2 <= len <= 16, no whole-piece hit) or long
// (16 < len <= 64). A tile's value is miss << 16 | long; the status
// packs the counts as miss << 31 | long. The tile lists its misses from
// the front of its entry list and its long pieces from the back.
struct KindsOp : OpBase {
  const int *lens, *hit, *n_pieces;
  const uint4* words;
  const int* starts;
  long long m_cap, l_cap;
  uint4* m_words;
  int *m_lens, *m_pid, *l_starts, *l_lens, *l_pid, *mslot, *lslot, *n_miss, *n_long;
  __device__ uint32_t value(long long i) const {
    if (i >= __ldg(n_pieces)) return 0u;
    const int L = lens[i];
    const bool miss = L >= 2 && L <= SLOT && hit[i] == -1;
    const bool lng = L > SLOT && L <= LONG_SLOT;
    return (static_cast<uint32_t>(miss) << 16) | lng;
  }
  __device__ long long widen(long long local) const {
    return ((local >> 16) << 31) | (local & 0xFFFF);
  }
  __device__ void emit(long long i, int li, uint32_t off, uint32_t v, long long prefix,
                       TileSmem& sm) const {
    const uint32_t om = off >> 16, ol = off & 0xFFFF;
    mslot[i] = (v >> 16) ? static_cast<int>((prefix >> 31) + om) : -1;
    lslot[i] = (v & 1) ? static_cast<int>((prefix & LOW31) + ol) : -1;
    if (v >> 16) sm.idx[om] = static_cast<uint16_t>(li);
    if (v & 1) sm.idx[TILE - 1 - ol] = static_cast<uint16_t>(li);
  }
  __device__ void entries(long long base, long long prefix, uint32_t agg, const TileSmem& sm,
                          long long) const {
    const int am = static_cast<int>(agg >> 16), al = static_cast<int>(agg & 0xFFFF);
    for (int k = threadIdx.x; k < am + al; k += TPB) {
      if (k < am) {
        const long long mo = (prefix >> 31) + k;
        if (mo >= m_cap) continue;
        const long long i = base + sm.idx[k];
        m_words[mo] = words[i];
        m_lens[mo] = lens[i];
        m_pid[mo] = static_cast<int>(i);
      } else {
        const long long lo = (prefix & LOW31) + (k - am);
        if (lo >= l_cap) continue;
        const long long i = base + sm.idx[TILE - 1 - (k - am)];
        l_starts[lo] = starts[i];
        l_lens[lo] = lens[i];
        l_pid[lo] = static_cast<int>(i);
      }
    }
  }
  __device__ void total(long long t) const {
    *n_miss = static_cast<int>(t >> 31);
    *n_long = static_cast<int>(t & LOW31);
  }
  __device__ void tail(int k, long long total) const {
    const int km = tail_blocks(m_cap);
    long long lo, hi;
    if (k < km) {
      tail_range(k, total >> 31, m_cap, lo, hi);
      for (long long j = lo + threadIdx.x; j < hi; j += TPB) {
        m_words[j] = make_uint4(0, 0, 0, 0);
        m_lens[j] = 0;
        m_pid[j] = 0;
      }
    } else {
      tail_range(k - km, total & LOW31, l_cap, lo, hi);
      for (long long j = lo + threadIdx.x; j < hi; j += TPB) {
        l_starts[j] = 0;
        l_lens[j] = 0;
        l_pid[j] = 0;
      }
    }
  }
};

// The assembly of a chunk: each live piece's token count and combo (the
// single / count / combo selects of build_pipeline3_fn), made where the
// piece is read, and their expansion into the token stream. Piece i (below
// n_pieces) of one byte, or of 2..16 bytes with a whole-piece hit, is a
// single: one token, byte_to_rank of its first byte or the hit; a short
// miss (mslot >= 0) counts m_count[mslot] tokens from m_tok at mslot * 16,
// a long piece (lslot >= 0) l_count[lslot] from l_tok at lslot * 64 (a
// slot past its cap counts 0). Piece i owns the run [off, off + count) of
// the stream, written where the piece gets its offset, neighbouring
// threads on neighbouring pieces. Each row's token count: piece i adds its
// count to row min(starts[i] / K, n_rows - 1), summed over each thread's
// run of items of one row (the catalog is row-ordered), one atomicAdd per
// run into the scratch. The tail copies the row counts and row_bad into
// the header, zeroes the stream past the total and writes the header's
// counts and overflow flag.
struct AssembleOp : OpBase {
  static constexpr bool AUX = true;  // aux: each item's combo
  static constexpr int ITEMS = ASM_IPT;
  const int* n_pieces;
  const int *lens, *hit, *words, *byte_to_rank, *mslot, *lslot, *m_count, *l_count;
  int m_cap, l_cap;
  const int *m_tok, *l_tok;
  long long out_size;
  int* tok;
  const int* starts;
  int K, n_rows;
  int* row_sums;  // scratch
  const uint8_t* row_bad;
  const int *n_miss, *n_long;
  const uint8_t* na_flag;  // or null
  long long p_limit, t_limit;
  int full;  // the v3 header (n_pieces, n_miss, n_long too)
  int* header;
  __device__ long long live(long long n) const { return min(n, max(__ldg(n_pieces), 0) * 1ll); }
  // What an item still needs after its slots are read: nothing, its first
  // byte's token, or its merged slot's count (2 bits an item).
  enum Need : unsigned { DONE = 0, BYTE, MCOUNT, LCOUNT };
  // The counts (v) and combos (aux[j * TPB + t]) of this thread's items
  // i = base + j * TPB + t below n, in three rounds of loads, each round's
  // issued together: the lengths and hits; the first words of the one-byte
  // pieces and both slots of the pieces that are not singles; the first
  // bytes' tokens and the merged slots' counts. Combos as
  // build_pipeline3_fn's: a single's token with bit 31 set, else the
  // slot's base in m_tok then l_tok.
  __device__ void values(long long base, long long n, uint32_t* v, uint32_t* aux) const {
    unsigned need = 0;  // 2 bits an item
    unsigned slots = 0;  // the items that read their slots
    int x[ITEMS], y[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = base + j * TPB + threadIdx.x;
      x[j] = i < n ? __ldg(lens + i) : 0;
      y[j] = i < n ? __ldg(hit + i) : -1;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = base + j * TPB + threadIdx.x;
      const int L = x[j];
      v[j] = 0;
      uint32_t cb = 0;
      if (L == 1) {
        need |= BYTE << (2 * j);
      } else if (L >= 2 && L <= SLOT && y[j] != -1) {  // a single: its hit
        v[j] = 1;
        cb = static_cast<uint32_t>(y[j]) | 0x80000000u;
      } else if (i < n) {
        slots |= 1u << j;
      }
      aux[j * TPB + threadIdx.x] = cb;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = base + j * TPB + threadIdx.x;
      const bool s = (slots >> j) & 1;
      x[j] = s ? __ldg(mslot + i) : ((need >> (2 * j)) & 3) == BYTE ? __ldg(words + 4 * i) : 0;
      y[j] = s ? __ldg(lslot + i) : -1;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (((need >> (2 * j)) & 3) == BYTE) {
        aux[j * TPB + threadIdx.x] = x[j] & 0xFF;
      } else if ((slots >> j) & 1) {
        const int ms = x[j], ls = y[j];
        if (ms >= 0) {  // a short miss
          aux[j * TPB + threadIdx.x] = min(ms, m_cap - 1) * SLOT;
          if (ms < m_cap) need |= MCOUNT << (2 * j);
        } else if (ls >= 0) {  // a long piece
          aux[j * TPB + threadIdx.x] = m_cap * SLOT + min(ls, l_cap - 1) * LONG_SLOT;
          if (ls < l_cap) need |= LCOUNT << (2 * j);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const unsigned w = (need >> (2 * j)) & 3;
      const uint32_t a = aux[j * TPB + threadIdx.x];
      x[j] = w == BYTE     ? __ldg(byte_to_rank + a)
             : w == MCOUNT ? __ldg(m_count + a / SLOT)
             : w == LCOUNT ? __ldg(l_count + (a - m_cap * SLOT) / LONG_SLOT)
                           : 0;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const unsigned w = (need >> (2 * j)) & 3;
      if (w == BYTE) {
        v[j] = 1;
        aux[j * TPB + threadIdx.x] = static_cast<uint32_t>(x[j]) | 0x80000000u;
      } else if (w != DONE) {
        v[j] = static_cast<uint32_t>(x[j]);
      }
    }
  }
  __device__ void run(long long first, const uint32_t* v, long long n) const {
    int row = -1;
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (first + j >= n || v[j] == 0) continue;
      const int r = min(max(starts[first + j], 0) / K, n_rows - 1);
      if (r != row) {
        if (sum) atomicAdd(row_sums + row, static_cast<int>(sum));
        sum = 0;
        row = r;
      }
      sum += v[j];
    }
    if (sum) atomicAdd(row_sums + row, static_cast<int>(sum));
  }
  __device__ void emit(long long, int li, uint32_t off, uint32_t v, long long prefix,
                       TileSmemT<true, TPB * ITEMS>& sm) const {
    if (v == 0) return;
    const int cb = static_cast<int>(sm.aux[li]);
    const int low = cb & 0x7FFFFFFF;
    const long long n_m = static_cast<long long>(m_cap) * SLOT;
    const long long last = n_m + static_cast<long long>(l_cap) * LONG_SLOT - 1;
    const long long o = prefix + off;
    for (uint32_t k = 0; k < v && o + k < out_size; ++k) {
      int t = low;
      if (cb >= 0) {
        const long long idx = min(static_cast<long long>(low) + k, last);
        t = idx < n_m ? m_tok[idx] : l_tok[idx - n_m];
      }
      tok[o + k] = t;
    }
  }
  __device__ void total(long long) const {}
  __device__ void tail(int k, long long total) const {
    const int hi = min((k + 1) * TAIL, n_rows);
    for (int r = k * TAIL + threadIdx.x; r < hi; r += TPB) {
      header[r] = row_sums[r];
      header[n_rows + r] = row_bad[r];
    }
    if (k == 0 && threadIdx.x == 0) {
      const int np = __ldg(n_pieces), nm = __ldg(n_miss), nl = __ldg(n_long);
      const bool over = np > p_limit || nm > m_cap || nl > l_cap || total > t_limit ||
                        (na_flag != nullptr && *na_flag);
      int* h = header + 2 * n_rows;
      if (full) {
        h[0] = np;
        h[1] = nm;
        h[2] = nl;
        h += 3;
      }
      h[0] = static_cast<int>(total);
      h[1] = over;
    }
    long long lo, hi_t;
    tail_range(k, total, out_size, lo, hi_t);
    for (long long j = lo + threadIdx.x; j < hi_t; j += TPB) tok[j] = 0;
  }
};

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

}  // namespace

// scratch words (int64) a one-pass entry takes over n items with
// row_bytes bytes of per-row words (tt_catalog, tt_catalog2: C;
// tt_assemble: 4 * n_rows; the others 0)
extern "C" int tt_scratch_words(long long n, long long row_bytes) {
  return static_cast<int>(scratch_words(n, row_bytes));
}

// piece catalog over the start mask [C, KP] of rows [C, KL]: starts,
// lengths, padded words (16-byte aligned) and
// row_bad_out = row_bad | too-long rows
extern "C" int tt_catalog(const void* mask, int C, int KP, const void* rows, int KL,
                          const void* spec_f, const void* row_bad, long long out_size,
                          void* starts, void* words, void* lens, void* row_bad_out, void* count,
                          void* scratch, void* stream) {
  const long long n = static_cast<long long>(C) * KP;
  if (n <= 0 || KP > KL || out_size <= 0 || reinterpret_cast<uintptr_t>(words) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const CatalogOp op{{}, static_cast<const uint8_t*>(mask), C, KP, KL,
                     static_cast<const uint8_t*>(rows), static_cast<const int*>(spec_f),
                     static_cast<const uint8_t*>(row_bad), out_size, static_cast<int*>(starts),
                     static_cast<int*>(lens), static_cast<uint4*>(words),
                     static_cast<uint8_t*>(row_scratch(scratch, n)),
                     static_cast<uint8_t*>(row_bad_out),
                     static_cast<unsigned long long*>(scratch) + 3, static_cast<int*>(count)};
  return one_pass(op, n, C, max(tail_blocks(out_size), tail_blocks(C)), scratch,
                  static_cast<cudaStream_t>(stream));
}

// the short-miss and long compactions of one catalog (lens, hit [p] i32,
// n_pieces 0-d i32, words [p, 4] i32, starts [p] i32) in one pass ->
// (m_words [m_cap, 4], m_lens, m_pid [m_cap], n_miss, mslot [p];
// l_starts, l_lens, l_pid [l_cap], n_long, lslot [p]), zero past the
// counts, slots -1 where the piece is not of the kind
extern "C" int tt_compact_kinds(const void* lens, const void* hit, const void* n_pieces,
                                const void* words, const void* starts, long long p,
                                long long m_cap, long long l_cap, void* m_words, void* m_lens,
                                void* m_pid, void* n_miss, void* mslot, void* l_starts,
                                void* l_lens, void* l_pid, void* n_long, void* lslot,
                                void* scratch, void* stream) {
  if (p <= 0 || p > LOW31 || m_cap <= 0 || l_cap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const KindsOp op{{}, static_cast<const int*>(lens), static_cast<const int*>(hit),
                   static_cast<const int*>(n_pieces), static_cast<const uint4*>(words),
                   static_cast<const int*>(starts), m_cap, l_cap, static_cast<uint4*>(m_words),
                   static_cast<int*>(m_lens), static_cast<int*>(m_pid),
                   static_cast<int*>(l_starts), static_cast<int*>(l_lens),
                   static_cast<int*>(l_pid), static_cast<int*>(mslot), static_cast<int*>(lslot),
                   static_cast<int*>(n_miss), static_cast<int*>(n_long)};
  return one_pass(op, p, 0, tail_blocks(m_cap) + tail_blocks(l_cap), scratch,
                  static_cast<cudaStream_t>(stream));
}

// v2 piece catalog over the start grid [C, K] of rows [C, KL]: starts,
// lengths, padded words (16-byte aligned) and
// row_bad_out = row_bad | too-long rows
extern "C" int tt_catalog2(const void* mask, int C, int K, const void* n_payload, const void* rows,
                           int KL, const void* row_bad, long long out_size, void* starts,
                           void* words, void* lens, void* row_bad_out, void* count, void* scratch,
                           void* stream) {
  const long long n = static_cast<long long>(C) * K;
  if (n <= 0 || K > KL || out_size <= 0 || reinterpret_cast<uintptr_t>(words) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const Catalog2Op op{{}, static_cast<const uint8_t*>(mask), C, K, KL,
                      static_cast<const uint8_t*>(rows), static_cast<const int*>(n_payload),
                      static_cast<const uint8_t*>(row_bad), out_size, static_cast<int*>(starts),
                      static_cast<int*>(lens), static_cast<uint4*>(words),
                      static_cast<uint8_t*>(row_scratch(scratch, n)),
                      static_cast<uint8_t*>(row_bad_out), static_cast<int*>(count)};
  return one_pass(op, n, C, max(tail_blocks(out_size), tail_blocks(C)), scratch,
                  static_cast<cudaStream_t>(stream));
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

// the assembly of a chunk whose catalog holds p entries (n_pieces 0-d;
// lens, hit, mslot, lslot, starts [p] i32; words [p, 4] i32) from the
// merged slots (m_count [m_cap], m_tok [m_cap, 16]; l_count [l_cap], l_tok
// [l_cap, 64]): tok [out_size] i32, zero past the total; header [2 *
// n_rows + 5] (full: row counts, row_bad, n_pieces, n_miss, n_long,
// n_tokens, overflow) or [2 * n_rows + 2] (row counts, row_bad, n_tokens,
// overflow), overflow = n_pieces > p_limit | n_miss > m_cap | n_long >
// l_cap | n_tokens > t_limit | na_flag (null: false); starts index rows of
// K columns
extern "C" int tt_assemble(const void* n_pieces, const void* lens, const void* hit,
                           const void* words, const void* byte_to_rank, const void* mslot,
                           const void* lslot, long long p, const void* m_count, int m_cap,
                           const void* l_count, int l_cap, const void* m_tok, const void* l_tok,
                           long long out_size, const void* starts, int K, const void* row_bad,
                           int n_rows, const void* n_miss, const void* n_long, const void* na_flag,
                           long long p_limit, long long t_limit, int full, void* tok,
                           void* header, void* scratch, void* stream) {
  if (p <= 0 || m_cap <= 0 || l_cap <= 0 || out_size <= 0 || K <= 0 || n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const AssembleOp op{{}, static_cast<const int*>(n_pieces), static_cast<const int*>(lens),
                      static_cast<const int*>(hit), static_cast<const int*>(words),
                      static_cast<const int*>(byte_to_rank), static_cast<const int*>(mslot),
                      static_cast<const int*>(lslot), static_cast<const int*>(m_count),
                      static_cast<const int*>(l_count), m_cap, l_cap,
                      static_cast<const int*>(m_tok), static_cast<const int*>(l_tok), out_size,
                      static_cast<int*>(tok), static_cast<const int*>(starts), K, n_rows,
                      static_cast<int*>(row_scratch(scratch, p)),
                      static_cast<const uint8_t*>(row_bad), static_cast<const int*>(n_miss),
                      static_cast<const int*>(n_long), static_cast<const uint8_t*>(na_flag),
                      p_limit, t_limit, full, static_cast<int*>(header)};
  return one_pass(op, p, 4ll * n_rows, max(tail_blocks(out_size), tail_blocks(n_rows)), scratch,
                  static_cast<cudaStream_t>(stream));
}
