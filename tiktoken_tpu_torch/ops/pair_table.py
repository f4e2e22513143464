"""Vocabulary compilation: the (left, right) -> rank pair table.

The reference looks up candidate merges by hashing the *concatenated
bytes* of the pair (reference: src/lib.rs:145-150), valid because rank
order equals merge priority. On device, byte-string keys are awkward; we
exploit the same invariant differently: every token the merge loop ever
holds is itself a vocabulary token, so a pair is fully identified by its
two token ids. The table enumerates, offline, every (a, b) id pair whose
concatenated bytes form a vocabulary token, mapping it to that token's
rank — which is simultaneously the merge priority AND the merged token id.

Layout (the same as the JAX package's, so the tables carry over
unchanged): one bucket = one 32-lane uint32 row holding 8 slots of
(key_a, key_b, value, pad) — 128 bytes, one cache line on the GPU. A query
is one row read plus 8 compares. The build rehashes with fresh seeds until
no bucket exceeds 8 entries.

The plain PyTorch hash ``mix`` works in int64 masked to 32 bits
(``mul32``): PyTorch's uint32 arithmetic is not relied on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

RANK_MAX = np.uint32(0xFFFFFFFF)
EMPTY_KEY = np.uint32(0xFFFFFFFF)

BUCKET_SLOTS = 8
BUCKET_WIDTH = BUCKET_SLOTS * 4  # (key_a, key_b, val, pad) per slot


def _mix(a: np.ndarray, b: np.ndarray, seed: int) -> np.ndarray:
    """Cheap uint32 pair hash (numpy); ``mix`` is its PyTorch twin."""
    a = np.uint32(seed) ^ a.astype(np.uint32)
    b = b.astype(np.uint32)
    h = a * np.uint32(0x9E3779B1) ^ (b + np.uint32(0x85EBCA6B) + (a << np.uint32(6)))
    h ^= h >> np.uint32(15)
    h *= np.uint32(0x2C1B3C6D)
    h ^= h >> np.uint32(12)
    return h


@dataclass
class PairTable:
    buckets: np.ndarray  # [n_buckets, 32] uint32: 8 slots of (a, b, val, pad)
    n_buckets: int  # power of two
    seed: int  # hash seed that avoids bucket overflow
    n_pairs: int
    byte_to_rank: np.ndarray  # [256] uint32: rank of each single-byte token
    n_vocab: int


M32 = 0xFFFFFFFF


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 tensors holding uint32 values, without
    overflowing int64 (the constant is split into 16-bit halves)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix(a: torch.Tensor, b: torch.Tensor, seed: int) -> torch.Tensor:
    """``_mix`` on int64 tensors holding uint32 values."""
    a = (a ^ seed) & M32
    h = mul32(a, 0x9E3779B1) ^ ((b + 0x85EBCA6B + (a << 6)) & M32)
    h = h ^ (h >> 15)
    h = mul32(h, 0x2C1B3C6D)
    return h ^ (h >> 12)


def enumerate_pairs(mergeable_ranks: dict[bytes, int]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (a, b) token-id pairs whose concatenation is a vocab token."""
    get = mergeable_ranks.get
    la: list[int] = []
    lb: list[int] = []
    lv: list[int] = []
    for token, rank in mergeable_ranks.items():
        n = len(token)
        if n < 2:
            continue
        for i in range(1, n):
            left = get(token[:i])
            if left is None:
                continue
            right = get(token[i:])
            if right is None:
                continue
            la.append(left)
            lb.append(right)
            lv.append(rank)
    return (
        np.asarray(la, dtype=np.uint32),
        np.asarray(lb, dtype=np.uint32),
        np.asarray(lv, dtype=np.uint32),
    )


def build_pair_table(mergeable_ranks: dict[bytes, int]) -> PairTable:
    byte_to_rank = np.full(256, RANK_MAX, dtype=np.uint32)
    for b in range(256):
        rank = mergeable_ranks.get(bytes([b]))
        if rank is None:
            raise ValueError(
                f"vocabulary is missing single-byte token {b:#04x}; the device "
                "merge path requires all 256 byte tokens"
            )
        byte_to_rank[b] = rank

    ka, kb, kv = enumerate_pairs(mergeable_ranks)
    n = len(ka)
    n_buckets = 1
    while n_buckets < max(64, n):
        n_buckets *= 2

    # Reseed until no bucket holds more than BUCKET_SLOTS pairs; at mean
    # load <= 1 over 8-slot buckets, P(overflow) per bucket ~ 1e-6, so a
    # couple of tries always suffice.
    for attempt in range(64):
        seed = 0x5EED0000 + attempt
        h = (_mix(ka, kb, seed) & np.uint32(n_buckets - 1)).astype(np.int64)
        counts = np.bincount(h, minlength=n_buckets)
        if counts.max(initial=0) <= BUCKET_SLOTS:
            break
    else:
        raise RuntimeError("could not bucket pair table without overflow")

    buckets = np.full((n_buckets, BUCKET_WIDTH), EMPTY_KEY, dtype=np.uint32)
    order = np.argsort(h, kind="stable")
    slot_in_bucket = np.zeros(n, dtype=np.int64)
    hs = h[order]
    first = np.ones(n, dtype=bool)
    first[1:] = hs[1:] != hs[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    slot_in_bucket = np.arange(n) - run_start
    cols = slot_in_bucket * 4
    buckets[hs, cols] = ka[order]
    buckets[hs, cols + 1] = kb[order]
    buckets[hs, cols + 2] = kv[order]

    return PairTable(
        buckets=buckets,
        n_buckets=n_buckets,
        seed=seed,
        n_pairs=n,
        byte_to_rank=byte_to_rank,
        n_vocab=len(mergeable_ranks),
    )


def lookup_numpy(table: PairTable, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Reference lookup (numpy): rank of concat(bytes(a), bytes(b)) or
    RANK_MAX."""
    h = (_mix(np.asarray(a), np.asarray(b), table.seed)
         & np.uint32(table.n_buckets - 1)).astype(np.int64)
    rows = table.buckets[h]  # [..., 32]
    out = np.full(np.shape(a), RANK_MAX, dtype=np.uint32)
    for s in range(BUCKET_SLOTS):
        hit = (rows[..., 4 * s] == a) & (rows[..., 4 * s + 1] == b)
        out = np.where(hit & (out == RANK_MAX), rows[..., 4 * s + 2], out)
    return out
