"""Whole-piece vocabulary hits (the ``vocab_hit`` kernel).

The reference's hot loop short-circuits BPE whenever a regex piece is
itself a vocabulary token — "the vocab is the cache" (reference:
src/lib.rs:247-254, 367-369). Pieces are probed against a bucketized
vocabulary table with one bucket-row read per piece, and only the misses
enter the merge loop.

Vocabulary table layout: bucket = 64 uint32 lanes = 10 slots of
(b0,b1,b2,b3,len,id) — token bytes little-endian, zero-padded past len,
so equality is 5 lane compares. Tokens longer than 16 bytes never hit the
short table; their pieces probe the long table (128 lanes = 7 slots of
16 words + len + id). Builds reseed until no bucket overflows.

The plain PyTorch versions ``vocab_hit`` / ``long_vocab_hit`` hash in
int64 masked to 32 bits; the kernel is csrc/vocab_hit.cu.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tiktoken_tpu_torch.ops.pair_table import M32, mul32

SLOT = 16  # short-piece slot bytes; pieces longer go to the long path
LONG_SLOT = 64
VOCAB_BUCKET_SLOTS = 10
VOCAB_BUCKET_WIDTH = 64
LONG_BUCKET_SLOTS = 7  # 7 x (16 words + len + id) = 126 of 128 lanes
LONG_BUCKET_WIDTH = 128
MISS = np.uint32(0xFFFFFFFF)


def _mix_words(words: np.ndarray, length: np.ndarray, seed: int):
    """uint32 hash of (4 packed words, len) (numpy)."""
    h = (words[..., 0] ^ np.uint32(seed)) * np.uint32(0x9E3779B1)
    for i in (1, 2, 3):
        h = (h ^ words[..., i]) * np.uint32(0x85EBCA77)
        h = h ^ (h >> np.uint32(13))
    h = (h ^ length.astype(np.uint32)) * np.uint32(0xC2B2AE3D)
    h = h ^ (h >> np.uint32(16))
    return h


@dataclass
class VocabTable:
    buckets: np.ndarray  # [n_buckets, 64] uint32
    n_buckets: int
    seed: int
    n_short: int  # tokens with len <= SLOT


def pack_token(token: bytes) -> np.ndarray:
    w = np.zeros(4, dtype=np.uint32)
    padded = token + b"\0" * (SLOT - len(token))
    w[:] = np.frombuffer(padded, dtype=np.uint32)
    return w


def build_vocab_table(mergeable_ranks: dict[bytes, int]) -> VocabTable:
    toks = [(t, r) for t, r in mergeable_ranks.items() if 2 <= len(t) <= SLOT]
    n = len(toks)
    n_buckets = 1
    while n_buckets < max(64, n):
        n_buckets *= 2
    words = np.stack([pack_token(t) for t, _ in toks]) if n else np.zeros((0, 4), np.uint32)
    lens = np.asarray([len(t) for t, _ in toks], dtype=np.uint32)
    ids = np.asarray([r for _, r in toks], dtype=np.uint32)

    for attempt in range(64):
        seed = 0xF00D0000 + attempt
        h = (_mix_words(words, lens, seed) & np.uint32(n_buckets - 1)).astype(np.int64)
        counts = np.bincount(h, minlength=n_buckets)
        if counts.max(initial=0) <= VOCAB_BUCKET_SLOTS:
            break
    else:
        raise RuntimeError("could not bucket vocab table without overflow")

    buckets = np.zeros((n_buckets, VOCAB_BUCKET_WIDTH), dtype=np.uint32)
    order = np.argsort(h, kind="stable")
    hs = h[order]
    first = np.ones(n, dtype=bool)
    first[1:] = hs[1:] != hs[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    slot = np.arange(n) - run_start
    cols = slot * 6
    for i in range(4):
        buckets[hs, cols + i] = words[order, i]
    buckets[hs, cols + 4] = lens[order]
    buckets[hs, cols + 5] = ids[order]
    # len == 0 marks an empty slot; real entries have len >= 2, and query
    # pieces have len >= 1, so empty slots can never match.
    return VocabTable(buckets=buckets, n_buckets=n_buckets, seed=seed, n_short=n)


@dataclass
class LongVocabTable:
    """Whole-piece hits for 17..64-byte tokens.

    The reference's hot loop short-circuits on ANY whole-piece vocabulary
    hit regardless of length (reference: src/lib.rs:367-369) — that is
    semantics, not just caching: for an adversarial vocabulary, BPE of a
    vocab token's bytes need not reproduce the token. The short table
    (VocabTable) covers <= 16-byte keys; this one covers the long-slot
    range, so the device path matches the reference for every piece it
    handles. Bucket row = 128 uint32 lanes = 7 slots of
    (16 packed words, len, id); len == 0 marks empty (real entries have
    len >= 17)."""

    buckets: np.ndarray  # [n_buckets, 128] uint32
    n_buckets: int
    seed: int
    n_long: int  # tokens with SLOT < len <= LONG_SLOT


def _mix_words16(words: np.ndarray, length, seed: int):
    """uint32 hash of (16 packed words, len) (numpy). Mixes every word so
    adversarial keys differing only in their tail still spread."""
    h = (words[..., 0] ^ np.uint32(seed)) * np.uint32(0x9E3779B1)
    for i in range(1, 16):
        h = (h ^ words[..., i]) * np.uint32(0x85EBCA77)
        h = h ^ (h >> np.uint32(13))
    h = (h ^ length.astype(np.uint32)) * np.uint32(0xC2B2AE3D)
    h = h ^ (h >> np.uint32(16))
    return h


def pack_token_long(token: bytes) -> np.ndarray:
    padded = token + b"\0" * (LONG_SLOT - len(token))
    return np.frombuffer(padded, dtype=np.uint32).copy()


def build_long_vocab_table(mergeable_ranks: dict[bytes, int]) -> LongVocabTable:
    toks = [(t, r) for t, r in mergeable_ranks.items() if SLOT < len(t) <= LONG_SLOT]
    n = len(toks)
    n_buckets = 1
    while n_buckets < max(8, n):
        n_buckets *= 2
    words = (
        np.stack([pack_token_long(t) for t, _ in toks])
        if n
        else np.zeros((0, 16), np.uint32)
    )
    lens = np.asarray([len(t) for t, _ in toks], dtype=np.uint32)
    ids = np.asarray([r for _, r in toks], dtype=np.uint32)

    for attempt in range(64):
        seed = 0xBEEF0000 + attempt
        h = (_mix_words16(words, lens, seed) & np.uint32(n_buckets - 1)).astype(
            np.int64
        )
        counts = np.bincount(h, minlength=n_buckets)
        if counts.max(initial=0) <= LONG_BUCKET_SLOTS:
            break
    else:
        raise RuntimeError("could not bucket long vocab table without overflow")

    buckets = np.zeros((n_buckets, LONG_BUCKET_WIDTH), dtype=np.uint32)
    order = np.argsort(h, kind="stable")
    hs = h[order]
    first = np.ones(n, dtype=bool)
    first[1:] = hs[1:] != hs[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    slot = np.arange(n) - run_start
    cols = slot * 18
    for i in range(16):
        buckets[hs, cols + i] = words[order, i]
    buckets[hs, cols + 16] = lens[order]
    buckets[hs, cols + 17] = ids[order]
    return LongVocabTable(buckets=buckets, n_buckets=n_buckets, seed=seed, n_long=n)


def long_vocab_hit_numpy(table: LongVocabTable, slot_bytes: np.ndarray, lens: np.ndarray):
    """slot_bytes [M, 64] u8 zero-padded past len -> hit id or MISS."""
    words = slot_bytes.reshape(-1, 16, 4).astype(np.uint32)
    words = (
        words[:, :, 0]
        | (words[:, :, 1] << 8)
        | (words[:, :, 2] << 16)
        | (words[:, :, 3] << 24)
    )
    l = lens.astype(np.uint32)
    h = (_mix_words16(words, l, table.seed) & np.uint32(table.n_buckets - 1)).astype(
        np.int64
    )
    rows = table.buckets[h]
    out = np.full(len(lens), MISS, dtype=np.uint32)
    for s in range(LONG_BUCKET_SLOTS):
        c = 18 * s
        hit = (rows[:, c + 16] == l) & (l > SLOT)
        for i in range(16):
            hit &= rows[:, c + i] == words[:, i]
        out = np.where(hit & (out == MISS), rows[:, c + 17], out)
    return out


def vocab_hit_numpy(table: VocabTable, words: np.ndarray, lens: np.ndarray):
    h = (_mix_words(words, lens.astype(np.uint32), table.seed)
         & np.uint32(table.n_buckets - 1)).astype(np.int64)
    rows = table.buckets[h]
    out = np.full(len(words), MISS, dtype=np.uint32)
    for s in range(VOCAB_BUCKET_SLOTS):
        c = 6 * s
        hit = (rows[:, c + 4] == lens) & (lens > 0)
        for i in range(4):
            hit &= rows[:, c + i] == words[:, i]
        out = np.where(hit & (out == MISS), rows[:, c + 5], out)
    return out

# ---------------------------------------------------------------------------
# plain PyTorch versions (int64 holding uint32 values)
# ---------------------------------------------------------------------------


def mix_words(words: torch.Tensor, length: torch.Tensor, seed: int) -> torch.Tensor:
    """``_mix_words`` / ``_mix_words16`` on int64 tensors: words [..., n]
    (n = 4 or 16), length [...]."""
    h = mul32((words[..., 0] ^ seed) & M32, 0x9E3779B1)
    for i in range(1, words.shape[-1]):
        h = mul32(h ^ words[..., i], 0x85EBCA77)
        h = h ^ (h >> 13)
    h = mul32(h ^ length, 0xC2B2AE3D)
    return h ^ (h >> 16)


def _probe(buckets: torch.Tensor, words: torch.Tensor, lens: torch.Tensor,
           seed: int, n_slots: int, min_len: int, max_len: int) -> torch.Tensor:
    nw = words.shape[1]
    stride = nw + 2  # (words, len, id) per slot
    w = words.to(torch.int64) & M32
    l = lens.to(torch.int64)
    h = mix_words(w, l, seed) & (buckets.shape[0] - 1)
    rows = buckets[h].to(torch.int64) & M32  # [P, width]
    out = torch.full(l.shape, int(MISS), dtype=torch.int64, device=words.device)
    for s in range(n_slots - 1, -1, -1):  # first matching slot wins
        c = stride * s
        ok = (rows[:, c + nw] == l) & (l > min_len) & (l <= max_len)
        ok &= (rows[:, c : c + nw] == w).all(dim=1)
        out = torch.where(ok, rows[:, c + nw + 1], out)
    return out.to(torch.int32)


def vocab_hit(buckets: torch.Tensor, words: torch.Tensor, lens: torch.Tensor,
              seed: int) -> torch.Tensor:
    """(buckets [nb, 64] i32, words [P, 4] i32, lens [P] i32) -> hit ids
    [P] i32 (uint32 bit patterns; MISS if none, and for len == 0 and len >
    SLOT: the chunk programs pass every piece's length, JAX's the lengths
    over SLOT masked to 0, and no short entry has such a length)."""
    return _probe(buckets, words, lens, seed, VOCAB_BUCKET_SLOTS, 0, SLOT)


def long_vocab_hit(buckets: torch.Tensor, slot_bytes: torch.Tensor,
                   lens: torch.Tensor, seed: int) -> torch.Tensor:
    """(buckets [nb, 128] i32, slot_bytes [M, 64] u8 zero-padded past len,
    lens [M] i32) -> hit ids [M] i32 (MISS unless SLOT < len <= LONG_SLOT
    and the bytes are a vocabulary token)."""
    words = slot_bytes.contiguous().view(torch.int32)  # [M, 16] little-endian
    return _probe(buckets, words, lens, seed, LONG_BUCKET_SLOTS, SLOT, LONG_SLOT)


# ---------------------------------------------------------------------------
# the v2 piece catalog and slot extraction (part of B10; the kernel is the
# ``compaction`` entry tt_catalog2)
# ---------------------------------------------------------------------------


def catalog_numpy(piece_start: np.ndarray, n_payload: np.ndarray, p_cap: int):
    """(starts [p_cap], lens [p_cap], n_pieces). Positions are flat indices
    into the [B, K] grid; padding entries have start B*K and len 0."""
    B, K = piece_start.shape
    starts_list = []
    lens_list = []
    for b in range(B):
        row_starts = np.nonzero(piece_start[b])[0]
        for i, s in enumerate(row_starts):
            e = row_starts[i + 1] if i + 1 < len(row_starts) else n_payload[b]
            starts_list.append(b * K + s)
            lens_list.append(int(e) - int(s))
    n = len(starts_list)
    starts = np.full(p_cap, B * K, dtype=np.int32)
    lens = np.zeros(p_cap, dtype=np.int32)
    starts[:n] = starts_list[:p_cap]
    lens[:n] = lens_list[:p_cap]
    return starts, lens, n


def extract_numpy(rows: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """slots [p_cap, 4] uint32 little-endian, zero-padded past len."""
    flat = rows.reshape(-1)
    out = np.zeros((len(starts), SLOT), dtype=np.uint8)
    N = len(flat)
    for p, (s, l) in enumerate(zip(starts, lens)):
        l = min(int(l), SLOT)
        if l > 0 and s < N:
            out[p, :l] = flat[s : s + l]
    return out.view(np.uint32).reshape(len(starts), 4)


def catalog(piece_start: torch.Tensor, n_payload: torch.Tensor, p_cap: int):
    """(piece_start [B, K] bool, n_payload [B] i32) -> (starts [p_cap] i32
    flat indices into the grid, B*K past the count; lens [p_cap] i32, to
    the next start capped at the row's payload end, 0 past the count;
    n_pieces i32 scalar, not clamped)."""
    B, K = piece_start.shape
    N = B * K
    dev = piece_start.device
    flat = piece_start.reshape(-1)
    vi = flat.to(torch.int64)
    pid = torch.cumsum(vi, 0) - vi
    n_pieces = vi.sum().to(torch.int32)
    tgt = torch.where(flat & (pid < p_cap), pid, p_cap)
    starts = torch.full((p_cap + 1,), N, dtype=torch.int32, device=dev)
    starts.scatter_(0, tgt, torch.where(flat, torch.arange(N, dtype=torch.int32, device=dev), N))
    starts = starts[:p_cap]
    next_start = torch.cat([starts[1:], starts.new_full((1,), N)])
    row = (starts // K).clamp(max=B - 1)
    row_end = row * K + n_payload[row.to(torch.int64)]
    ends = torch.minimum(torch.where(next_start > starts, next_start, N), row_end)
    lens = torch.where(starts >= N, 0, (ends - starts).clamp(min=0)).to(torch.int32)
    return starts, lens, n_pieces


def extract(rows: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(rows [B, K] u8, starts, lens [P] i32) -> words [P, 4] i32: each
    piece's first 16 bytes from the flat grid, little-endian, zero past
    min(len, 16) and past the grid."""
    flat = rows.reshape(-1)
    b = torch.arange(SLOT, device=rows.device)[None, :]
    idx = starts.to(torch.int64)[:, None] + b
    keep = (idx < flat.numel()) & (b < lens.clamp(0, SLOT)[:, None])
    byts = torch.where(keep, flat[idx.clamp(max=flat.numel() - 1)], 0).to(torch.uint8)
    return byts.contiguous().view(torch.int32)
