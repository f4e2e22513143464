"""Lane-aligned per-piece BPE merge (the ``slot_merge`` kernel).

Pieces live one per row in fixed W-lane slots (W=16 short / W=64 long).
Greedy BPE repeatedly merges the leftmost minimum-rank adjacent pair
(argmin returns the FIRST minimum — exactly the reference's leftmost
tie-break, reference: src/lib.rs:148-153) until no adjacent pair is in
the pair table. The merged token id is the pair's rank.

``slot_merge`` keeps the output contract of the JAX
``make_slot_merge_fn``: ``(tokens [M, W], alive [M, W])``, each surviving
token at the lane of its first byte. Tokens at dead lanes are unspecified
in JAX; the port writes 0 there. It runs the JAX kernel's lockstep rounds
(W-1 pair lookups up front, then 2 per merge).

The chunk programs take ``slot_merge_packed``: the same merge over the
slots below a device count ``n_real``, each slot's surviving tokens
left-packed in order with their count (``slot_merge`` then the row-wise
``compact_rows``), and, for the long slots, a whole-piece hit taking the
place of the merge. It is the plain version of the CUDA kernel
(csrc/slot_merge.cu), which merges each piece in a group of lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from tiktoken_tpu_torch.ops.compaction import compact_rows
from tiktoken_tpu_torch.ops.pair_table import (
    BUCKET_SLOTS,
    M32,
    RANK_MAX,
    PairTable,
    lookup_numpy,
    mix,
)

INT_RANK_MAX = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# numpy reference
# ---------------------------------------------------------------------------


def slot_merge_numpy(
    table: PairTable, slot_bytes: np.ndarray, lens: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """slot_bytes [M, W] uint8 (zero-padded), lens [M] -> (tokens [M, W]
    uint32 at surviving lanes, alive [M, W] bool)."""
    M, W = slot_bytes.shape
    toks = np.zeros((M, W), dtype=np.uint32)
    alive = np.zeros((M, W), dtype=bool)
    for m in range(M):
        L = int(lens[m])
        cur = [int(table.byte_to_rank[b]) for b in slot_bytes[m, :L]]
        pos = list(range(L))
        while len(cur) > 1:
            ranks = lookup_numpy(
                table, np.asarray(cur[:-1], np.uint32), np.asarray(cur[1:], np.uint32)
            )
            k = int(np.argmin(ranks))
            if ranks[k] == RANK_MAX:
                break
            cur[k : k + 2] = [int(ranks[k])]
            pos[k + 1 : k + 2] = []
        for t, p in zip(cur, pos):
            toks[m, p] = t
            alive[m, p] = True
    return toks, alive


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def pair_ranks(buckets: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            ok: torch.Tensor, seed: int) -> torch.Tensor:
    """Pair rank of (a, b) (int64 holding uint32), RANK_MAX where not ok
    or absent."""
    h = mix(a, b, seed) & (buckets.shape[0] - 1)
    rows = buckets[torch.where(ok, h, 0)].to(torch.int64) & M32  # [..., 32]
    out = torch.full(a.shape, INT_RANK_MAX, dtype=torch.int64, device=a.device)
    for s in range(BUCKET_SLOTS - 1, -1, -1):  # first matching slot wins
        hit = (rows[..., 4 * s] == a) & (rows[..., 4 * s + 1] == b)
        out = torch.where(hit, rows[..., 4 * s + 2], out)
    return torch.where(ok, out, INT_RANK_MAX)


def _take(arr: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return arr.gather(1, pos[:, None])[:, 0]


def _put(arr: torch.Tensor, pos: torch.Tensor, val: torch.Tensor,
         enable: torch.Tensor) -> torch.Tensor:
    cur = _take(arr, pos)
    return arr.scatter(1, pos[:, None], torch.where(enable, val, cur)[:, None])


def slot_merge(buckets: torch.Tensor, byte_to_rank: torch.Tensor,
               slot_bytes: torch.Tensor, lens: torch.Tensor, seed: int):
    """(buckets [nb, 32] i32, byte_to_rank [256] i32, slot_bytes [M, W]
    u8, lens [M] i32) -> (tokens [M, W] i32 (uint32 bit patterns, 0 at
    dead lanes), alive [M, W] bool)."""
    M, W = slot_bytes.shape
    dev = slot_bytes.device
    cols = torch.arange(W, device=dev)[None, :]
    L = lens.to(torch.int64).clamp(0, W)[:, None]
    tok = (byte_to_rank.to(torch.int64) & M32)[slot_bytes.to(torch.int64)]
    alive = cols < L
    nxt = (cols + 1).expand(M, W).contiguous()
    right0 = torch.cat([tok[:, 1:], torch.zeros((M, 1), dtype=tok.dtype, device=dev)], 1)
    r = pair_ranks(buckets, tok, right0, alive & (cols + 1 < L), seed)
    while True:
        k = torch.argmin(r, dim=1)  # leftmost minimum
        rmin = _take(r, k)
        act = rmin != INT_RANK_MAX
        if not bool(act.any()):
            break
        j = _take(nxt, k)  # right partner position
        jc = j.clamp(max=W - 1)
        jn = _take(nxt, jc)  # partner's next
        tok = _put(tok, k, rmin, act)
        alive = alive & ~((cols == j[:, None]) & act[:, None])
        nxt = _put(nxt, k, jn, act)
        r = _put(r, jc, torch.full_like(rmin, INT_RANK_MAX), act)
        # left alive neighbour l: the position with nxt[l] == k
        is_l = alive & (nxt == k[:, None]) & act[:, None] & (cols != k[:, None])
        has_l = is_l.any(dim=1)
        l = torch.argmax(is_l.to(torch.int8), dim=1)
        right_tok = _take(tok, jn.clamp(max=W - 1))
        r_k = pair_ranks(buckets, rmin, right_tok, act & (jn < L[:, 0]), seed)
        r_l = pair_ranks(buckets, _take(tok, l), rmin, act & has_l, seed)
        r = _put(r, k, r_k, act)
        r = _put(r, l, r_l, act & has_l)
    tok = torch.where(alive, tok, 0)
    return tok.to(torch.int32), alive


def slot_merge_packed(buckets: torch.Tensor, byte_to_rank: torch.Tensor,
                      slot_bytes: torch.Tensor, lens: torch.Tensor, seed: int,
                      n_real: torch.Tensor, hit: torch.Tensor | None = None):
    """(buckets [nb, 32] i32, byte_to_rank [256] i32, slot_bytes [M, W] u8,
    lens [M] i32, n_real i32 scalar, hit [M] i32 or None) -> (tok_p [M,
    W] i32, count [M] i32).

    Slot m below ``n_real`` holds the ``count[m]`` tokens that survive its
    greedy merge, left-packed in order (``slot_merge`` then
    ``compact_rows``); where ``hit`` is given and ``hit[m] != -1`` (a
    whole-piece hit of a long slot), its one token is ``hit[m]``. The
    entries past a slot's count and the slots at or past ``n_real`` are
    unspecified: the kernel leaves them untouched, this version writes 0."""
    M, W = slot_bytes.shape
    real = torch.arange(M, device=lens.device) < n_real
    L = torch.where(real, lens, 0)
    if hit is not None:
        is_hit = real & (hit != -1)
        L = torch.where(is_hit, 0, L)
    tok, alive = slot_merge(buckets, byte_to_rank, slot_bytes, L, seed)
    if hit is not None:
        lane0 = (torch.arange(W, device=lens.device) == 0)[None, :] & is_hit[:, None]
        tok = torch.where(lane0, hit[:, None], tok)
        alive = alive | lane0
    return compact_rows(alive, tok)
