// vocab_hit: whole-piece vocabulary hits, short (<= 16-byte) and long
// (17..64-byte) tables.
//
// Replaces (JAX package): ops/pieces.py make_vocab_hit_fn (B6) and
// make_long_vocab_hit_fn (the long hit of B8). Plain PyTorch versions:
// ops/pieces.py vocab_hit, long_vocab_hit.
//
// What bounds it on the H100: one random bucket-row read per piece —
// 256 bytes (short table, 64 lanes) or 512 bytes (long table, 128 lanes)
// — for up to p_cap pieces per chunk; the hash and the slot compares are
// a few dozen integer operations.
//
// Design: one thread per piece, templated on the slot width. The hash
// (_mix_words / _mix_words16) runs in native uint32. The thread walks the
// bucket's slots and stops at the first whose length and words match, so
// most misses read only the length lanes. A length outside the table's
// range never hits and reads no bucket: len == 0 (dead lanes) and len > 16
// for the short table (the chunk programs' long pieces, which JAX masks to
// 0 before the call: no short entry has such a length, so the ids are the
// same), len <= 16 for the long table; MISS = 0xFFFFFFFF, exactly like the
// JAX functions.

#include "common.cuh"

namespace {

constexpr uint32_t MISS = 0xFFFFFFFFu;

// NW words per key; SLOTS slots of (NW words, len, id) per WIDTH-lane row;
// keys of MIN_LEN < len <= MAX_LEN bytes
template <int NW, int SLOTS, int WIDTH, int MIN_LEN, int MAX_LEN>
__global__ void vocab_hit_kernel(const uint32_t* __restrict__ buckets, uint32_t mask,
                                 const uint32_t* __restrict__ words, const int* __restrict__ lens,
                                 int P, uint32_t seed, uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const int len = lens[i];
  if (len <= MIN_LEN || len > MAX_LEN) {
    out[i] = MISS;
    return;
  }
  uint32_t w[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) w[k] = words[static_cast<long long>(i) * NW + k];
  const uint32_t l = static_cast<uint32_t>(len);
  const uint32_t h = tt::mix_words<NW>(w, l, seed) & mask;
  const uint32_t* row = buckets + static_cast<long long>(h) * WIDTH;
  uint32_t id = MISS;
  for (int s = 0; s < SLOTS; ++s) {
    const uint32_t* slot = row + s * (NW + 2);
    if (__ldg(slot + NW) != l) continue;
    bool eq = true;
#pragma unroll
    for (int k = 0; k < NW; ++k) eq &= __ldg(slot + k) == w[k];
    if (eq) {
      id = __ldg(slot + NW + 1);
      break;
    }
  }
  out[i] = id;
}

}  // namespace

// short table: words [P, 4] u32, lens [P] i32 (over 16: a miss), buckets
// [nb, 64] u32
extern "C" int tt_vocab_hit(const void* buckets, int n_buckets, const void* words,
                            const void* lens, int P, unsigned seed, void* out, void* stream) {
  if (P > 0)
    vocab_hit_kernel<4, 10, 64, 0, 16><<<(P + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(buckets), static_cast<uint32_t>(n_buckets - 1),
        static_cast<const uint32_t*>(words), static_cast<const int*>(lens), P, seed,
        static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// long table: slot bytes [M, 64] u8 read as [M, 16] little-endian u32,
// lens [M] i32, buckets [nb, 128] u32
extern "C" int tt_long_vocab_hit(const void* buckets, int n_buckets, const void* slot_bytes,
                                 const void* lens, int M, unsigned seed, void* out,
                                 void* stream) {
  if (M > 0)
    vocab_hit_kernel<16, 7, 128, 16, 64><<<(M + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(buckets), static_cast<uint32_t>(n_buckets - 1),
        static_cast<const uint32_t*>(slot_bytes), static_cast<const int*>(lens), M, seed,
        static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
