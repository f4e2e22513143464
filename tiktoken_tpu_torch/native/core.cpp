// Native host BPE core of tiktoken_tpu_torch: the C++ counterpart of the
// reference's Rust core (reference: src/lib.rs), reimplemented from the
// semantics of the pure-Python spec in tiktoken_tpu_torch/_pybpe.py, which
// the tests hold it against. The same source as the JAX package's
// tiktoken_tpu/native/core.cpp; this package builds and loads its own copy
// (tiktoken_tpu_torch/native/__init__.py).
//
// The pre-tokenizer runs the byte-level scanner DFA of
// tiktoken_tpu_torch/ops/regex_compiler.py (packed via
// ops/window_scan.pack_trans_accept), the table the byte scanner and the v1
// program use on the device, so host and device splits are identical by
// construction, including the Unicode-version corrections baked into the
// tables. Merging is greedy lowest-rank-first with leftmost tie-break;
// whole-piece vocabulary hits short-circuit (the vocab is the cache).
//
// Exposed as a plain C ABI for ctypes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <vector>
#include <queue>

#if defined(__SSE4_2__)
#include <nmmintrin.h>  // _mm_crc32_u64 (compiled with -msse4.2 on x86)
#include <xmmintrin.h>  // _mm_prefetch
#define TTPU_PREFETCH(p) _mm_prefetch((p), _MM_HINT_T0)
static inline uint64_t ttpu_hash64(uint64_t k) {
    return _mm_crc32_u64(0, k);
}
#else
#define TTPU_PREFETCH(p) __builtin_prefetch(p)
static inline uint64_t ttpu_hash64(uint64_t k) {
    // murmur-style finalizer: same role as the crc path (portable builds)
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdull;
    k ^= k >> 33;
    return k;
}
#endif

namespace {

constexpr uint32_t RANK_MAX = 0xFFFFFFFFu;
constexpr int ACC_BITS = 5;
constexpr int DEAD = 0;
constexpr int START = 1;

// Allocation-free token-bytes -> rank table: open addressing with the
// first 8 key bytes stored INLINE in the slot. Tokens are zipf-short
// (~6.4 B mean on real vocabs), so almost every probe — whole-piece hits
// and the 2 pair probes per merge round alike — resolves with one slot
// read and zero decoder-blob touches; only keys longer than 8 bytes
// memcmp their tail against the stable blob. Exact: length + prefix
// (+ tail for long keys) are all confirmed.
struct RankTable {
    struct Entry {
        uint64_t prefix;    // exact little-endian encoding of key[:8]
        const char* ptr;    // full key bytes (tail compare for len > 8)
        uint32_t len;       // 0 = empty slot (tokens are nonempty)
        uint32_t val;
    };
    std::vector<Entry> slots;
    size_t mask = 0;

    // Exact value of the first min(n,8) bytes: overlapped unaligned
    // loads OR together to the contiguous little-endian integer, and the
    // encoding is injective per length (length is compared separately).
    // Never reads past p + n.
    static inline uint64_t load_prefix(const char* p, size_t n) {
        if (n >= 8) {
            uint64_t x;
            std::memcpy(&x, p, 8);
            return x;
        }
        if (n >= 4) {
            uint32_t lo, hi;
            std::memcpy(&lo, p, 4);
            std::memcpy(&hi, p + n - 4, 4);
            return (uint64_t)lo | ((uint64_t)hi << (8 * (n - 4)));
        }
        uint64_t x = (unsigned char)p[0];
        if (n > 1) x |= (uint64_t)(unsigned char)p[1] << 8;
        if (n > 2) x |= (uint64_t)(unsigned char)p[2] << 16;
        return x;
    }

    static inline uint64_t mix(uint64_t x) {
        x ^= x >> 33;
        x *= 0xff51afd7ed558ccdull;
        x ^= x >> 33;
        x *= 0xc4ceb9fe1a85ec53ull;
        x ^= x >> 33;
        return x;
    }

    static inline uint64_t hash(uint64_t prefix, const char* p, size_t n) {
#if defined(__SSE4_2__)
        // crc32c chain: 3-cycle latency per 8 bytes vs ~10 for the
        // multiply mix — the probe's hash cost drops below the load cost
        uint64_t h = _mm_crc32_u64(_mm_crc32_u64(0x9E3779B9u, prefix), n);
        for (size_t i = 8; i < n; i += 8) {
            uint64_t w = 0;
            size_t r = n - i < 8 ? n - i : 8;
            std::memcpy(&w, p + i, r);
            h = _mm_crc32_u64(h, w);
        }
        return h;
#else
        uint64_t h = mix(prefix ^ (n * 0x9E3779B97F4A7C15ull));
        for (size_t i = 8; i < n; i += 8) {
            uint64_t w = 0;
            size_t r = n - i < 8 ? n - i : 8;
            std::memcpy(&w, p + i, r);
            h = mix(h ^ w);
        }
        return h;
#endif
    }

    void init(size_t n_keys) {
        size_t size = 16;
        while (size < n_keys * 2) size <<= 1;
        slots.assign(size, Entry{0, nullptr, 0, RANK_MAX});
        mask = size - 1;
    }

    void insert(const char* p, size_t n, uint32_t v) {
        uint64_t pre = load_prefix(p, n);
        size_t i = hash(pre, p, n) & mask;
        while (slots[i].len) {
            if (slots[i].len == n && slots[i].prefix == pre &&
                (n <= 8 || std::memcmp(slots[i].ptr + 8, p + 8, n - 8) == 0)) {
                slots[i].val = v;
                return;
            }
            i = (i + 1) & mask;
        }
        slots[i] = Entry{pre, p, (uint32_t)n, v};
    }

    inline uint32_t find(const char* p, size_t n) const {
        uint64_t pre = load_prefix(p, n);
        return find_prehashed(p, n, pre, hash(pre, p, n));
    }

    // probe with a caller-computed (prefix, hash): the scan loop computes
    // these as soon as a piece boundary is known and prefetches the slot,
    // so by resolve time the line is usually already in cache
    inline uint32_t find_prehashed(const char* p, size_t n, uint64_t pre,
                                   uint64_t h) const {
        size_t i = h & mask;
        for (;;) {
            const Entry& e = slots[i];
            if (!e.len) return RANK_MAX;
            if (e.len == n && e.prefix == pre &&
                (n <= 8 || std::memcmp(e.ptr + 8, p + 8, n - 8) == 0))
                return e.val;
            i = (i + 1) & mask;
        }
    }

    inline const char* slot_addr(uint64_t h) const {
        return (const char*)&slots[h & mask];
    }
};

// (left_rank, right_rank) -> rank of the concatenated bytes. During a
// merge every part is a vocab token (parts start as single-byte tokens
// and a merge only fires when the concatenation is itself in the vocab),
// so pair candidates can be probed by TOKEN-ID PAIR instead of by byte
// span: one 8-byte key, one crc32 hash, one slot load — no byte compare,
// no decoder-blob chase. Built at load time from every two-token split of
// every vocab token, which is exactly the set {(a, b) in VxV :
// bytes(a)+bytes(b) in V} (same table the device merge kernel uses,
// ops/pair_table.py). Byte-exact with the byte-keyed probe by
// construction; the byte-keyed path remains for vocabularies missing
// single-byte tokens (reference semantics: src/lib.rs:140-196 keys by
// concatenated bytes — rank order is identical).
struct PairTable {
    struct E {
        uint64_t key;
        uint32_t val;
        uint32_t pad;
    };
    static constexpr uint64_t EMPTY = ~0ull;  // (RANK_MAX<<32|RANK_MAX): no
                                              // real pair — both sides are
                                              // valid ranks < RANK_MAX
    std::vector<E> slots;
    size_t mask = 0;

    static inline size_t hash(uint64_t k) { return (size_t)ttpu_hash64(k); }
    void init(size_t n) {
        size_t s = 16;
        while (s < n * 2) s <<= 1;
        slots.assign(s, E{EMPTY, RANK_MAX, 0});
        mask = s - 1;
    }
    void insert(uint64_t k, uint32_t v) {
        size_t i = hash(k) & mask;
        while (slots[i].key != EMPTY) {
            if (slots[i].key == k) { slots[i].val = v; return; }
            i = (i + 1) & mask;
        }
        slots[i].key = k;
        slots[i].val = v;
    }
    inline uint32_t find(uint64_t k) const {
        size_t i = hash(k) & mask;
        for (;;) {
            const E& e = slots[i];
            if (e.key == k) return e.val;
            if (e.key == EMPTY) return RANK_MAX;
            i = (i + 1) & mask;
        }
    }
    inline const char* slot_addr(uint64_t k) const {
        return (const char*)&slots[hash(k) & mask];
    }
};

struct Core {
    // scanner tables
    std::vector<int32_t> packed;   // [n_states * n_classes]
    std::vector<uint16_t> class_of; // [257]
    int n_classes = 0;

    // vocabulary
    RankTable ranks;                 // token bytes -> rank
    PairTable pairs;                 // (rank, rank) -> merged rank
    uint32_t byte_rank[256];         // single-byte token ranks (RANK_MAX gaps)
    bool pairs_ok = false;
    std::string decoder_blob;        // all token bytes (key storage)
    std::vector<int64_t> decoder_off;  // [max_rank+1], -1 gaps
    std::vector<int32_t> decoder_len;  // [max_rank+1]
};

// Greedy BPE over one piece; returns token ids. Semantics identical to
// _pybpe.byte_pair_merge_boundaries: repeatedly merge the adjacent pair
// whose concatenated bytes have the lowest rank, leftmost on ties.
static void byte_pair_encode(const Core& c, const char* piece, size_t n,
                             std::vector<uint32_t>& out) {
    if (n == 1) {
        out.push_back(c.ranks.find(piece, 1));
        return;
    }
    // boundary offsets 0..n; pair_rank[i] = rank of merging token at
    // parts[i] with token at parts[i+1]
    std::vector<uint32_t> parts(n + 1);
    for (size_t i = 0; i <= n; ++i) parts[i] = (uint32_t)i;
    auto get_rank = [&](uint32_t lo, uint32_t hi) -> uint32_t {
        return c.ranks.find(piece + lo, hi - lo);
    };
    std::vector<uint32_t> pr(n + 1, RANK_MAX);
    for (size_t i = 0; i + 2 <= n; ++i) pr[i] = get_rank(i, (uint32_t)(i + 2));

    size_t nparts = n + 1;
    while (true) {
        uint32_t best = RANK_MAX;
        size_t bi = 0;
        for (size_t i = 0; i + 1 < nparts; ++i) {
            if (pr[i] < best) { best = pr[i]; bi = i; }
        }
        if (best == RANK_MAX) break;
        // merge at bi: remove boundary bi+1
        parts.erase(parts.begin() + (long)(bi + 1));
        pr.erase(pr.begin() + (long)(bi + 1));
        nparts -= 1;
        // recompute ranks at bi-1 and bi
        if (bi > 0)
            pr[bi - 1] = (bi + 1 < nparts)
                ? get_rank(parts[bi - 1], parts[bi + 1]) : RANK_MAX;
        pr[bi] = (bi + 2 < nparts)
            ? get_rank(parts[bi], parts[bi + 2]) : RANK_MAX;
        if (bi + 1 < nparts) {
            // pair starting at bi+1 unchanged unless it was the erased one
        }
    }
    for (size_t i = 0; i + 1 < nparts; ++i) {
        out.push_back(c.ranks.find(piece + parts[i], parts[i + 1] - parts[i]));
    }
}

// Rank-keyed variant of byte_pair_encode: same greedy lowest-rank-first /
// leftmost-tie-break order, but pair candidates are probed in the
// PairTable by token-id pair (see PairTable docs for the equivalence
// argument). Thread-local scratch: no allocation per piece. Returns false
// (caller falls back to the byte-keyed path) when some input byte has no
// single-byte token.
static bool byte_pair_encode_ranks(const Core& c, const char* piece,
                                   size_t n, std::vector<uint32_t>& out) {
    static thread_local std::vector<uint32_t> rk_buf, pr_buf;
    if (rk_buf.size() < n + 1) { rk_buf.resize(n + 1); pr_buf.resize(n + 1); }
    uint32_t* rk = rk_buf.data();
    uint32_t* pr = pr_buf.data();
    for (size_t i = 0; i < n; ++i) {
        uint32_t r = c.byte_rank[(unsigned char)piece[i]];
        if (r == RANK_MAX) return false;
        rk[i] = r;
    }
    // all n-1 initial pair keys are known up front: issue the slot
    // prefetches first so the probes overlap (the table is L3-resident;
    // serial probes would pay ~70 cycles each)
    for (size_t i = 0; i + 1 < n; ++i)
        TTPU_PREFETCH(c.pairs.slot_addr(((uint64_t)rk[i] << 32) | rk[i + 1]));
    for (size_t i = 0; i + 1 < n; ++i)
        pr[i] = c.pairs.find(((uint64_t)rk[i] << 32) | rk[i + 1]);
    pr[n - 1] = RANK_MAX;  // sentinel: shifts left on merges, stays last
    size_t m = n;
    while (true) {
        uint32_t best = RANK_MAX;
        size_t bi = 0;
        for (size_t i = 0; i + 1 < m; ++i)
            if (pr[i] < best) { best = pr[i]; bi = i; }
        if (best == RANK_MAX) break;
        // merge parts (bi, bi+1): the pair value IS the merged token rank
        rk[bi] = best;
        std::memmove(rk + bi + 1, rk + bi + 2, (m - bi - 2) * 4);
        std::memmove(pr + bi + 1, pr + bi + 2, (m - bi - 2) * 4);
        m -= 1;
        if (bi > 0)
            pr[bi - 1] = c.pairs.find(((uint64_t)rk[bi - 1] << 32) | rk[bi]);
        pr[bi] = (bi + 1 < m)
            ? c.pairs.find(((uint64_t)rk[bi] << 32) | rk[bi + 1]) : RANK_MAX;
    }
    out.insert(out.end(), rk, rk + m);
    return true;
}

// Heap variant for large pieces: O(m log m) merges with lazy invalidation
// (same semantics: lowest rank first, leftmost on ties — the min-heap
// orders by (rank, position)). Mirrors _pybpe._byte_pair_merge_heap.
static void byte_pair_encode_large(const Core& c, const char* piece, size_t n,
                                   std::vector<uint32_t>& out) {
    std::vector<uint32_t> nxt(n + 1), prv(n + 1);
    std::vector<uint8_t> alive(n + 1, 1);
    for (size_t i = 0; i <= n; ++i) {
        nxt[i] = (uint32_t)(i + 1);
        prv[i] = (uint32_t)(i == 0 ? 0 : i - 1);
    }
    auto get_rank = [&](uint32_t lo, uint32_t hi) -> uint32_t {
        if (hi > n) return RANK_MAX;
        return c.ranks.find(piece + lo, hi - lo);
    };
    using Ent = std::pair<uint32_t, uint32_t>;  // (rank, start boundary)
    std::priority_queue<Ent, std::vector<Ent>, std::greater<Ent>> heap;
    for (size_t i = 0; i + 2 <= n; ++i) {
        uint32_t r = get_rank((uint32_t)i, (uint32_t)(i + 2));
        if (r != RANK_MAX) heap.push({r, (uint32_t)i});
    }
    while (!heap.empty()) {
        auto [r, i] = heap.top();
        heap.pop();
        if (!alive[i]) continue;
        uint32_t j = nxt[i];          // boundary being removed
        if (j > n || !alive[j]) continue;
        uint32_t k = nxt[j];          // end of the pair
        if (k > n) continue;
        if (get_rank(i, k) != r) continue;  // stale entry
        // merge: remove boundary j
        alive[j] = 0;
        nxt[i] = k;
        prv[k] = i;
        // new pair to the left: (prv[i], i, k)
        if (i > 0) {
            uint32_t l = prv[i];
            uint32_t nr = get_rank(l, k);
            if (nr != RANK_MAX) heap.push({nr, l});
        }
        // new pair to the right: (i, k, nxt[k])
        if (k < n) {
            uint32_t m = nxt[k];
            uint32_t nr = (m <= n) ? get_rank(i, m) : RANK_MAX;
            if (nr != RANK_MAX) heap.push({nr, i});
        }
    }
    uint32_t i = 0;
    while (i < n) {
        uint32_t j = nxt[i];
        out.push_back(c.ranks.find(piece + i, j - i));
        i = j;
    }
}

// Maximal-munch scan + encode of one UTF-8 document. Returns the token
// count of the final piece (the reference's last_piece_token_len,
// reference: src/lib.rs:439-441).
static int64_t encode_doc(const Core& c, const char* data, size_t n,
                          std::vector<uint32_t>& out) {
    size_t last_piece_tokens_before = 0;
    const int32_t* T = c.packed.data();
    size_t i = 0;
    // one-deep find pipeline: the whole-piece probe of piece k resolves
    // only after piece k+1 has been scanned — its hash is computed and
    // the slot prefetched the moment the boundary is known, so the
    // rank-table load (L3-resident table, ~70 cycles) overlaps the next
    // piece's DFA scan instead of stalling after it
    bool have_pending = false;
    size_t pen_i = 0, pen_end = 0;
    uint64_t pen_pre = 0, pen_h = 0;
    auto resolve = [&](size_t pi, size_t pend, uint64_t pre, uint64_t h) {
        last_piece_tokens_before = out.size();
        // whole-piece vocabulary hit short-circuits the merge
        uint32_t hit = c.ranks.find_prehashed(data + pi, pend - pi, pre, h);
        if (hit != RANK_MAX) {
            out.push_back(hit);
        } else if (pend - pi >= 512) {
            byte_pair_encode_large(c, data + pi, pend - pi, out);
        } else if (!c.pairs_ok ||
                   !byte_pair_encode_ranks(c, data + pi, pend - pi, out)) {
            byte_pair_encode(c, data + pi, pend - pi, out);
        }
    };
    while (i < n) {
        // table entries are (next_state * 512) << ACC_BITS | (accept+1),
        // so a step is one AND-OR index and one load: idx = base | byte
        int32_t base = START * 512;
        long last_end = -1;
        size_t p = i;
        while (true) {
            unsigned b = (p < n) ? (unsigned char)data[p] : 256u;
            int32_t v = T[(size_t)base | b];
            base = (v >> ACC_BITS);
            int a = (v & ((1 << ACC_BITS) - 1)) - 1;
            // branchless accept tracking (cmov): the accept pattern is
            // data-dependent and mispredicts enough to cost ~12% of
            // whole-corpus throughput as a branch
            long cand = (long)(p + 1) - a;
            last_end = (base != 0 && a >= 0) ? cand : last_end;
            if (__builtin_expect(base == 0 || p >= n, 0)) break;
            ++p;
        }
        if (last_end <= (long)i) {
            // no progress: invalid input for this scanner (caller verified
            // UTF-8, so this should not happen); bail out defensively
            out.push_back(RANK_MAX);
            return 0;
        }
        size_t end = (size_t)last_end;
        // masked full-width prefix load: identical to load_prefix's
        // contiguous little-endian encoding whenever 8 bytes are in
        // bounds (everything but the last pieces of a document), without
        // its length branches
        size_t plen = end - i;
        uint64_t pre;
        if (i + 8 <= n) {
            std::memcpy(&pre, data + i, 8);
            if (plen < 8) pre &= (~0ull) >> (8 * (8 - plen));
        } else {
            pre = RankTable::load_prefix(data + i, plen);
        }
        uint64_t h = RankTable::hash(pre, data + i, plen);
        TTPU_PREFETCH(c.ranks.slot_addr(h));
        if (have_pending) resolve(pen_i, pen_end, pen_pre, pen_h);
        have_pending = true;
        pen_i = i; pen_end = end; pen_pre = pre; pen_h = h;
        i = end;
    }
    if (have_pending) resolve(pen_i, pen_end, pen_pre, pen_h);
    return (int64_t)(out.size() - last_piece_tokens_before);
}

}  // namespace

extern "C" {

void* ttpu_new(const int32_t* packed, int n_states, int n_classes,
               const uint16_t* class_of,
               const uint8_t* token_blob, const int64_t* token_offsets,
               const uint32_t* token_ranks, int64_t n_tokens) {
    Core* c = new Core();
    c->packed.assign(packed, packed + (size_t)n_states * n_classes);
    c->class_of.assign(class_of, class_of + 257);
    c->n_classes = n_classes;
    uint32_t max_rank = 0;
    for (int64_t t = 0; t < n_tokens; ++t)
        if (token_ranks[t] > max_rank) max_rank = token_ranks[t];
    // decoder blob doubles as the rank table's stable key storage
    if (n_tokens > 0) {
        c->decoder_blob.assign((const char*)token_blob,
                               (size_t)token_offsets[n_tokens]);
        c->ranks.init((size_t)n_tokens);
        for (int64_t t = 0; t < n_tokens; ++t) {
            c->ranks.insert(
                c->decoder_blob.data() + token_offsets[t],
                (size_t)(token_offsets[t + 1] - token_offsets[t]),
                token_ranks[t]);
        }
        c->decoder_off.assign((size_t)max_rank + 1, -1);
        c->decoder_len.assign((size_t)max_rank + 1, 0);
        for (int64_t t = 0; t < n_tokens; ++t) {
            c->decoder_off[token_ranks[t]] = token_offsets[t];
            c->decoder_len[token_ranks[t]] =
                (int32_t)(token_offsets[t + 1] - token_offsets[t]);
        }
        for (unsigned b = 0; b < 256; ++b) {
            char ch = (char)b;
            c->byte_rank[b] = c->ranks.find(&ch, 1);
        }
        // pair table: every two-token split of every vocab token
        // (count pass first so the table is sized to the real pair count)
        size_t n_pairs = 0;
        for (int pass = 0; pass < 2; ++pass) {
            if (pass == 1) c->pairs.init(n_pairs ? n_pairs : 1);
            for (int64_t t = 0; t < n_tokens; ++t) {
                const char* w = c->decoder_blob.data() + token_offsets[t];
                size_t len = (size_t)(token_offsets[t + 1] - token_offsets[t]);
                for (size_t i = 1; i < len; ++i) {
                    uint32_t a = c->ranks.find(w, i);
                    if (a == RANK_MAX) continue;
                    uint32_t b = c->ranks.find(w + i, len - i);
                    if (b == RANK_MAX) continue;
                    if (pass == 0)
                        ++n_pairs;
                    else
                        c->pairs.insert(((uint64_t)a << 32) | b,
                                        token_ranks[t]);
                }
            }
        }
        c->pairs_ok = true;
    } else {
        for (unsigned b = 0; b < 256; ++b) c->byte_rank[b] = RANK_MAX;
    }
    return c;
}

void ttpu_free(void* h) { delete (Core*)h; }

// Encode one document. Returns the token count; writes at most cap tokens
// into out (cap >= n+1 always suffices: one token per byte max).
// last_piece_len (may be null) receives the final piece's token count.
int64_t ttpu_encode(void* h, const char* data, int64_t n,
                    uint32_t* out, int64_t cap, int64_t* last_piece_len) {
    Core* c = (Core*)h;
    std::vector<uint32_t> toks;
    toks.reserve((size_t)(n / 3 + 8));
    int64_t lptl = encode_doc(*c, data, (size_t)n, toks);
    if (last_piece_len) *last_piece_len = lptl;
    int64_t m = (int64_t)toks.size();
    if (m > cap) m = cap;
    std::memcpy(out, toks.data(), (size_t)m * 4);
    return (int64_t)toks.size();
}

// Encode a single piece with BPE only (no regex split, no special tokens):
// the native form of _encode_single_piece's merge loop.
int64_t ttpu_encode_piece(void* h, const char* data, int64_t n,
                          uint32_t* out, int64_t cap) {
    Core* c = (Core*)h;
    std::vector<uint32_t> toks;
    uint32_t hit = c->ranks.find(data, (size_t)n);
    if (hit != RANK_MAX) toks.push_back(hit);
    else if ((size_t)n >= 512) byte_pair_encode_large(*c, data, (size_t)n, toks);
    else if (!c->pairs_ok || !byte_pair_encode_ranks(*c, data, (size_t)n, toks))
        byte_pair_encode(*c, data, (size_t)n, toks);
    int64_t m = (int64_t)toks.size();
    if (m > cap) m = cap;
    std::memcpy(out, toks.data(), (size_t)m * 4);
    return (int64_t)toks.size();
}

// Natively threaded batch encode (the reference's scaling story is
// GIL-released threads, reference: tiktoken/core.py:164-206 + src/py.rs:31;
// here the pool lives below the language boundary). Documents are
// concatenated in `data` with `doc_offsets` [n_docs+1]; each document's
// tokens are written at out + out_offsets[d] (caller sizes regions as
// doc_len + 2). Returns 0; counts[d] receives each document's token count.
int64_t ttpu_encode_batch(void* h, const char* data,
                          const int64_t* doc_offsets, int64_t n_docs,
                          uint32_t* out, const int64_t* out_offsets,
                          int64_t* counts, int n_threads) {
    Core* c = (Core*)h;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<uint32_t> toks;
        for (;;) {
            int64_t d = next.fetch_add(1);
            if (d >= n_docs) return;
            toks.clear();
            const char* p = data + doc_offsets[d];
            size_t n = (size_t)(doc_offsets[d + 1] - doc_offsets[d]);
            encode_doc(*c, p, n, toks);
            int64_t cap = out_offsets[d + 1] - out_offsets[d];
            int64_t m = (int64_t)toks.size();
            if (m > cap) m = cap;  // cannot happen: cap = n + 2
            std::memcpy(out + out_offsets[d], toks.data(), (size_t)m * 4);
            counts[d] = (int64_t)toks.size();
        }
    };
    if (n_threads <= 1) {
        worker();
        return 0;
    }
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    return 0;
}

// Handshake-row cut positions for one document (the native form of
// ops/pipeline3.pack_corpus3's per-document cut computation, bit-exact
// on valid UTF-8). For each grid position g = K, 2K, ... < n the cut is
// the last position <= g that starts a character and does not fall
// inside an ASCII digit run; if backing out of a digit run would move
// the cut more than min(backup, K/2) bytes, the raw character cut is
// kept instead (the handshake flags the phase-locked run and the
// document falls back). Cuts are written strictly increasing, in (0, n).
// Returns the cut count (callers size `out` as (n-1)/K + 1).
int64_t ttpu_pack_cuts3(const uint8_t* data, int64_t n, int64_t K,
                        int64_t backup, int64_t* out, int64_t cap) {
    if (n <= K || K <= 0) return 0;
    int64_t B = backup < K / 2 ? backup : K / 2;
    int64_t n_out = 0;
    int64_t prev_cut = 0;
    for (int64_t g = K; g < n; g += K) {
        // window of B+5 positions decides exactly: if no eligible cut
        // lies inside it, the true cut is > B behind the raw char cut
        // (which is always within 3 bytes), so raw wins either way
        int64_t lo = g - (B + 4);
        if (lo < 0) lo = 0;
        int64_t raw = -1, cut = -1;
        for (int64_t p = g; p >= lo; --p) {
            uint8_t b = data[p];
            if ((b & 0xC0) == 0x80) continue;  // UTF-8 continuation
            if (raw < 0) raw = p;
            bool in_run = p > 0 && b >= '0' && b <= '9' &&
                          data[p - 1] >= '0' && data[p - 1] <= '9';
            if (!in_run) { cut = p; break; }
        }
        if (raw < 0) raw = g;  // invalid UTF-8: no char start in window
        if (cut < 0 || raw - cut > B) cut = raw;
        if (cut > prev_cut && cut < n) {
            if (n_out >= cap) return -1;
            out[n_out++] = cut;
            prev_cut = cut;
        }
    }
    return n_out;
}

// Decode token ids to bytes. Returns the byte count written, the required
// size if cap is too small (call again with a bigger buffer), or -1-i when
// tokens[i] is not an ordinary token (special/unknown: the caller handles
// those exactly, reference: src/lib.rs:342-358).
int64_t ttpu_decode(void* h, const uint32_t* tokens, int64_t n,
                    char* out, int64_t cap) {
    Core* c = (Core*)h;
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t t = tokens[i];
        if (t >= c->decoder_off.size() || c->decoder_off[t] < 0) return -1 - i;
        total += c->decoder_len[t];
    }
    if (total > cap) return total;
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t t = tokens[i];
        std::memcpy(p, c->decoder_blob.data() + c->decoder_off[t],
                    (size_t)c->decoder_len[t]);
        p += c->decoder_len[t];
    }
    return total;
}

}  // extern "C"
