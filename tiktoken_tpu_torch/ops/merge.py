"""Full-grid greedy BPE of the v1 program, and its row packing (the
``grid_merge`` kernel).

The reference merges one lowest-rank pair at a time per piece
(reference: src/lib.rs:140-196). Pieces are independent, so the JAX
``make_merge_fn`` runs every piece's greedy loop in lockstep over the
whole [C, K] byte grid: each round merges, in every piece, the single
leftmost minimum-rank pair (any rule that merges more than one pair of a
piece per round is unsound for general rank tables). The looked-up rank is
the merged token id. Piece boundaries are ``piece_start | ~valid``; a pair
whose right side is a piece start or invalid is never formed.

Contracts. ``merge`` (B13, the JAX ``make_merge_fn``): (pair buckets,
byte_to_rank, byte_vals [C, K] u8, piece_start, valid [C, K] bool) ->
(tok [C, K] i32 at alive positions, 0 elsewhere; alive [C, K] bool;
rounds i32 scalar, the most merges any piece made). The JAX kernel leaves
stale ids at dead positions; the port writes 0 there. ``grid_merge``
(B13 + B14, what the v1 program runs): (pair buckets, byte_to_rank, rows
[C, KL] u8 whose first K columns are merged, piece_start [C, K] bool,
n_payload [C] i32, the valid prefix of each row) -> (packed [C, K] i32,
each row's alive tokens at its front and 0 after; counts [C] i32;
rounds).

This module holds the numpy spec (one block) and the plain PyTorch
versions (the JAX lockstep rounds, with segment minima by
``scatter_reduce``); the kernel is csrc/grid_merge.cu.
"""

from __future__ import annotations

import numpy as np
import torch

from tiktoken_tpu_torch.ops.pair_table import M32, RANK_MAX, PairTable, lookup_numpy
from tiktoken_tpu_torch.ops.slot_merge import INT_RANK_MAX, pair_ranks


# ---------------------------------------------------------------------------
# numpy spec (one block)
# ---------------------------------------------------------------------------


def merge_block_numpy(table: PairTable, byte_vals: np.ndarray, piece_start: np.ndarray,
                      valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run merge rounds over one block [K]. Returns (token_ids, alive)."""
    K = len(byte_vals)
    tok = table.byte_to_rank[byte_vals].astype(np.uint32)
    alive = valid.copy()
    nxt = np.arange(1, K + 1)
    seg = np.cumsum(piece_start | ~valid)  # piece id per position

    def ranks_np() -> np.ndarray:
        nxt_c = np.minimum(nxt, K - 1)
        right_tok = tok[nxt_c]
        ok = alive & (nxt < K)
        ok &= valid[nxt_c] & ~piece_start[nxt_c]
        r = lookup_numpy(table, tok, right_tok)
        return np.where(ok, r, RANK_MAX)

    r = ranks_np()
    while True:
        m = _leftmost_piece_min_numpy(r, seg)
        if not m.any():
            break
        k_idx = np.nonzero(m)[0]
        j_idx = nxt[k_idx]
        tok[k_idx] = r[k_idx]  # merged token id == pair rank
        alive[j_idx] = False
        nxt[k_idx] = nxt[j_idx]
        r = ranks_np()
    return tok, alive


def _leftmost_piece_min_numpy(r: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """merge[k] = r[k] finite, strictly below every earlier rank in its
    piece, and no strictly smaller rank later in the piece."""
    K = len(r)
    pref = np.full(K, INT_RANK_MAX, dtype=np.uint64)
    suf = np.full(K, INT_RANK_MAX, dtype=np.uint64)
    run = INT_RANK_MAX
    cur = -1
    for k in range(K):
        if seg[k] != cur:
            run = INT_RANK_MAX
            cur = seg[k]
        pref[k] = run
        run = min(run, int(r[k]))
    run = INT_RANK_MAX
    cur = -1
    for k in range(K - 1, -1, -1):
        suf[k] = run if seg[k] == cur else INT_RANK_MAX
        if seg[k] != cur:
            run = INT_RANK_MAX
            cur = seg[k]
        run = min(run, int(r[k]))
    rr = r.astype(np.uint64)
    return (rr != INT_RANK_MAX) & (rr < pref) & (rr <= suf)


def encode_block_tokens_numpy(table, byte_vals, piece_start, valid) -> list[int]:
    tok, alive = merge_block_numpy(table, byte_vals, piece_start, valid)
    return [int(t) for t in tok[alive]]


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def merge(buckets: torch.Tensor, byte_to_rank: torch.Tensor, byte_vals: torch.Tensor,
          piece_start: torch.Tensor, valid: torch.Tensor, seed: int):
    """B13. (buckets [nb, 32] i32, byte_to_rank [256] i32, byte_vals [C, K]
    u8, piece_start, valid [C, K] bool) -> (tok [C, K] i32, 0 where not
    alive; alive [C, K] bool; rounds i32 scalar)."""
    C, K = byte_vals.shape
    dev = byte_vals.device
    n = C * K
    tok = (byte_to_rank.to(torch.int64) & M32)[byte_vals.to(torch.int64)]
    alive = valid.clone()
    nxt = torch.arange(1, K + 1, device=dev).expand(C, K).contiguous()
    head = piece_start | ~valid
    head[:, 0] = True
    seg = torch.cumsum(head.reshape(-1).to(torch.int64), 0) - 1  # global piece ids
    n_seg = int(seg[-1]) + 1 if n else 0
    pos = torch.arange(n, device=dev)

    def right_ranks(tok, alive, nxt):
        nxt_c = nxt.clamp(max=K - 1)
        ok = alive & (nxt < K) & valid.gather(1, nxt_c) & ~piece_start.gather(1, nxt_c)
        return pair_ranks(buckets, tok, tok.gather(1, nxt_c), ok, seed)

    r = right_ranks(tok, alive, nxt)
    rounds = 0
    while rounds < K and bool((r != INT_RANK_MAX).any()):
        rf = r.reshape(-1)
        seg_min = torch.full((n_seg,), INT_RANK_MAX, dtype=torch.int64, device=dev)
        seg_min = seg_min.scatter_reduce(0, seg, rf, "amin")
        cand = (rf == seg_min[seg]) & (rf != INT_RANK_MAX)
        first = torch.full((n_seg,), n, dtype=torch.int64, device=dev)
        first = first.scatter_reduce(0, seg, torch.where(cand, pos, n), "amin")
        m = (cand & (pos == first[seg])).reshape(C, K)  # the leftmost piece minimum
        tok = torch.where(m, r, tok)
        j = torch.where(m, nxt, K).clamp(max=K - 1)
        killed = torch.zeros((C, K), dtype=torch.int8, device=dev).scatter_reduce(
            1, j, m.to(torch.int8), "amax")
        alive = alive & (killed == 0)
        nxt = torch.where(m, nxt.gather(1, j), nxt)
        r = right_ranks(tok, alive, nxt)
        rounds += 1
    tok = torch.where(alive, tok, 0).to(torch.int32)
    return tok, alive, torch.tensor(rounds, dtype=torch.int32, device=dev)


def pack_rows(tok: torch.Tensor, alive: torch.Tensor):
    """B14. Each row's alive tokens packed to its front, zero after ->
    (packed [C, K] i32, counts [C] i32)."""
    C, K = tok.shape
    counts = alive.sum(dim=1, dtype=torch.int32)
    dst = torch.where(alive, torch.cumsum(alive.to(torch.int64), 1) - 1, K)
    packed = torch.zeros((C, K + 1), dtype=torch.int32, device=tok.device)
    packed.scatter_(1, dst, torch.where(alive, tok, 0))
    return packed[:, :K].contiguous(), counts


def grid_merge(buckets: torch.Tensor, byte_to_rank: torch.Tensor, rows: torch.Tensor,
               piece_start: torch.Tensor, n_payload: torch.Tensor, seed: int):
    """B13 + B14 -> (packed, counts, rounds); see the module docstring."""
    K = piece_start.shape[1]
    valid = torch.arange(K, device=rows.device)[None, :] < n_payload[:, None]
    tok, alive, rounds = merge(buckets, byte_to_rank, rows[:, :K], piece_start, valid, seed)
    packed, counts = pack_rows(tok, alive)
    return packed, counts, rounds
