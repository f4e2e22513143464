"""Stable compaction, monotone routing and anchor expansion.

The JAX package builds these as scatter-free radix routes
(``tiktoken_tpu/ops/compaction.py``) because every scatter is slow on the
TPU. On the GPU they are prefix sums plus scatters, in the ``compaction``
kernel (csrc/compaction.cu). This module holds the numpy specs and the
plain PyTorch versions, with exactly the JAX contracts:

- ``compact``: zero fill past the count; the count is not clamped
  (callers compare it with ``out_size`` to detect overflow);
- ``expand``: returns ``(payloads, k, valid, total)``.

The chunk programs call the kernel's functions, which carry those
contracts plus what the programs need around them: ``catalog`` (the v3
piece catalog with lengths, too-long row flags and padded words),
``catalog2`` (the v2 one, over a [C, K] start grid), ``compact_slots``
(``compact`` with each entry's slot), ``compact_kinds`` (the short-miss
and long compactions of one catalog, their masks included),
``extract_slots`` (the long-piece slots) and ``assemble`` (a chunk's
per-piece counts and combos, ``piece_counts``; the token stream with the
token count of each row, ``expand_tokens_rows``, which is ``expand`` with
the token fetch, ``expand_tokens``, plus the row counts; and the header).
``compact_rows`` (with per-row counts) is the left-pack of the plain
``slot_merge_packed``.
"""

from __future__ import annotations

import numpy as np
import torch

from tiktoken_tpu_torch.ops import pieces
from tiktoken_tpu_torch.ops.pieces import LONG_SLOT, SLOT


# ---------------------------------------------------------------------------
# numpy specs
# ---------------------------------------------------------------------------


def compact_numpy(valid: np.ndarray, payloads, out_size: int, fill=0):
    """Stable left-compaction along the LAST axis. Returns (list of
    compacted payloads [..., out_size], count [...])."""
    valid = np.asarray(valid, bool)
    lead = valid.shape[:-1]
    outs = [
        np.full(lead + (out_size,), fill, dtype=np.asarray(p).dtype)
        for p in payloads
    ]
    counts = np.zeros(lead, dtype=np.int32)
    for idx in np.ndindex(*lead) if lead else [()]:
        sel = np.nonzero(valid[idx])[0]
        n = min(len(sel), out_size)
        counts[idx] = len(sel)
        for o, p in zip(outs, payloads):
            o[idx][:n] = np.asarray(p)[idx][sel[:n]]
    return outs, counts


def expand_numpy(counts: np.ndarray, payloads, out_size: int):
    """Anchor expansion: anchor i owns `counts[i]` consecutive output
    slots, in order. Returns (list of payload arrays [out_size] with
    anchor i's value over its run, within-run index k [out_size],
    valid [out_size], total)."""
    n = len(counts)
    outs = [np.zeros(out_size, dtype=np.asarray(p).dtype) for p in payloads]
    ks = np.zeros(out_size, dtype=np.int32)
    valid = np.zeros(out_size, dtype=bool)
    j = 0
    for i in range(n):
        for k in range(int(counts[i])):
            if j >= out_size:
                break
            for o, p in zip(outs, payloads):
                o[j] = np.asarray(p)[i]
            ks[j] = k
            valid[j] = True
            j += 1
    return outs, ks, valid, int(np.sum(counts))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def compact(valid: torch.Tensor, payloads, out_size: int):
    """Stable compaction along the last axis (any leading dims).

    (valid [..., n] bool, payloads: [..., n] tensors)
    -> (compacted payloads [..., out_size], zero-filled past the count;
        count [...] int32 of valid entries, not clamped)."""
    vi = valid.to(torch.int64)
    dst = torch.cumsum(vi, dim=-1) - vi  # exclusive prefix = target slot
    count = (dst[..., -1] + vi[..., -1]).to(torch.int32)
    tgt = torch.where(valid & (dst < out_size), dst, out_size)
    outs = []
    for p in payloads:
        out = torch.zeros(p.shape[:-1] + (out_size + 1,), dtype=p.dtype, device=p.device)
        out.scatter_(-1, tgt, p.masked_fill(~valid, 0))
        outs.append(out[..., :out_size])
    return outs, count


def compact_slots(valid: torch.Tensor, payloads, out_size: int):
    """``compact`` of a flat mask valid [n] whose payloads are [n] or
    [n, w] (entries of w values), also returning each entry's slot.

    -> (compacted payloads [out_size] or [out_size, w], count, slot [n]
    int32: the number of valid entries before i where valid, else -1;
    not clamped to out_size)."""
    outs, count = compact(valid, [q for p in payloads for q in
                                  (p.unbind(1) if p.dim() == 2 else (p,))], out_size)
    grouped = []
    for p in payloads:
        w = p.shape[1] if p.dim() == 2 else 0
        grouped.append(torch.stack(outs[:w], dim=1) if w else outs[0])
        outs = outs[max(w, 1):]
    vi = valid.to(torch.int32)
    slot = torch.where(valid, torch.cumsum(vi, 0, dtype=torch.int32) - vi, -1)
    return grouped, count, slot


def kind_masks(lens: torch.Tensor, hit: torch.Tensor, n_pieces: torch.Tensor):
    """(is_short_miss, is_long) [p] bool of a catalog: a live piece (below
    n_pieces) of 2..16 bytes with no whole-piece hit (hit == -1), and one
    of 17..64 bytes."""
    live = torch.arange(lens.shape[0], device=lens.device) < n_pieces
    is_short_miss = live & (lens >= 2) & (lens <= SLOT) & (hit == -1)
    is_long = live & (lens > SLOT) & (lens <= LONG_SLOT)
    return is_short_miss, is_long


def compact_kinds(words: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                  hit: torch.Tensor, n_pieces: torch.Tensor, m_cap: int, l_cap: int):
    """The short-miss and long compactions of one catalog (words [p, 4],
    starts, lens, hit [p] i32, n_pieces i32 scalar): ``compact_slots`` of
    (words, lens, piece index) by ``is_short_miss`` into m_cap slots and
    of (starts, lens, piece index) by ``is_long`` into l_cap slots
    (``kind_masks``).
    -> ((m_words, m_lens, m_pid), n_miss, mslot [p], (l_starts, l_lens,
    l_pid), n_long, lslot [p]); a slot is -1 where the piece is not of
    that kind."""
    is_short_miss, is_long = kind_masks(lens, hit, n_pieces)
    piece_idx = torch.arange(lens.shape[0], dtype=torch.int32, device=lens.device)
    m_out, n_miss, mslot = compact_slots(is_short_miss, [words, lens, piece_idx], m_cap)
    l_out, n_long, lslot = compact_slots(is_long, [starts, lens, piece_idx], l_cap)
    return tuple(m_out), n_miss, mslot, tuple(l_out), n_long, lslot


def compact_rows(valid: torch.Tensor, vals: torch.Tensor):
    """Row-wise ``compact`` of vals [M, W] by valid [M, W] -> (out [M, W],
    count [M] i32 per row)."""
    (out,), count = compact(valid, [vals], vals.shape[-1])
    return out, count


def piece_counts(n_pieces: torch.Tensor, lens: torch.Tensor, hit: torch.Tensor,
                 words: torch.Tensor, byte_to_rank: torch.Tensor, mslot: torch.Tensor,
                 lslot: torch.Tensor, m_count: torch.Tensor, l_count: torch.Tensor):
    """The expansion's input (B8): each piece's token count and combo.

    A live piece (below n_pieces) of one byte, or of 2..16 bytes with a
    whole-piece hit (hit != -1), is a single: count 1, combo its token
    (``byte_to_rank`` of its first byte, or the hit) with bit 31 set. A
    short miss (mslot >= 0) counts ``m_count[mslot]`` tokens from base
    mslot * 16 of the merged slots; a long piece (lslot >= 0)
    ``l_count[lslot]`` from base m_cap * 16 + lslot * 64 (slots clamped to
    the caps; a slot past its cap counts 0). Every other entry is 0.
    (n_pieces i32 scalar, lens, hit, mslot, lslot [p] i32, words [p, 4]
    i32, byte_to_rank [256] i32, m_count [m_cap], l_count [l_cap] i32) ->
    (counts [p] i32, combo [p] i32)."""
    m_cap, l_cap = m_count.shape[0], l_count.shape[0]
    live = torch.arange(lens.shape[0], device=lens.device) < n_pieces
    first_byte = (words[:, 0] & 0xFF).to(torch.int64)
    single_tok = torch.where(lens == 1, byte_to_rank[first_byte], hit)
    is_single = live & ((lens == 1) | ((lens >= 2) & (lens <= SLOT) & (hit != -1)))
    is_short_miss, is_long = live & (mslot >= 0), live & (lslot >= 0)
    ms, ls = mslot.clamp(0, m_cap - 1), lslot.clamp(0, l_cap - 1)
    counts = torch.where(is_single, 1, torch.where(
        is_short_miss & (mslot < m_cap), m_count[ms.to(torch.int64)],
        torch.where(is_long & (lslot < l_cap), l_count[ls.to(torch.int64)], 0)))
    # unified token base: short-miss slot s -> s*16, long slot s -> m_cap*16
    # + s*64; a single piece carries its id in-band, flagged by bit 31
    base = torch.where(is_short_miss, ms * SLOT,
                       torch.where(is_long, m_cap * SLOT + ls * LONG_SLOT, 0))
    combo = torch.where(is_single, single_tok | -0x80000000, base)
    return counts.to(torch.int32), combo.to(torch.int32)


def expand(counts: torch.Tensor, payloads, out_size: int):
    """Anchor expansion over flat arrays.

    (counts [n] i32 >= 0, payloads: [n] tensors)
    -> (expanded payloads [out_size], k [out_size] within-run index,
        valid [out_size], total i32 scalar). Anchor i's payload covers its
    run of counts[i] consecutive output slots; runs beyond out_size are
    cropped (callers flag overflow via total). Slots at and past total
    hold zero."""
    c = counts.to(torch.int64)
    incl = torch.cumsum(c, dim=0)
    total = incl[-1] if c.numel() else torch.zeros((), dtype=torch.int64, device=c.device)
    j = torch.arange(out_size, device=counts.device)
    valid = j < total
    anchor = torch.searchsorted(incl, j, right=True).clamp(max=max(c.numel() - 1, 0))
    k = torch.where(valid, j - (incl[anchor] - c[anchor]), 0).to(torch.int32)
    outs = [p[anchor].masked_fill(~valid, 0) for p in payloads]
    return outs, k, valid, total.to(torch.int32)


def expand_tokens(counts: torch.Tensor, combo: torch.Tensor, m_tok: torch.Tensor,
                  l_tok: torch.Tensor, out_size: int):
    """The chunk's token stream (B8): ``expand`` of per-piece counts and
    combos, then the fetch of each merged token.

    A combo with bit 31 set carries a single piece's token id in its low
    bits; otherwise token k of the piece's run is ``unified[combo + k]``,
    with unified = m_tok [m, 16] then l_tok [l, 64] flattened (index
    clamped to its end). -> (tokens [out_size] i32, zero at and past the
    total; total i32 scalar, not clamped)."""
    (e_combo,), e_k, e_valid, total = expand(counts, [combo], out_size)
    e_low = e_combo & 0x7FFFFFFF
    unified = torch.cat([m_tok.reshape(-1), l_tok.reshape(-1)])
    fetched = unified[(e_low + e_k).clamp(0, unified.numel() - 1).to(torch.int64)]
    tok = torch.where(e_valid, torch.where(e_combo < 0, e_low, fetched), 0)
    return tok.to(torch.int32), total


def catalog(rows: torch.Tensor, mask3: torch.Tensor, spec_f: torch.Tensor,
            row_bad: torch.Tensor, p_cap: int):
    """The piece catalog (B5): stable compaction of the piece starts of
    ``mask3`` [C, KP] in row-major order, measured and padded.

    Entry j carries its flat index ``row * KL + col`` into ``rows`` [C,
    KL] u8, its length (to the next start in its row, else to the row's
    scan end ``spec_f``; the next start reads as 0 past the count, as in
    the JAX program's zero-filled catalog) and its first 16 bytes as 4
    little-endian words, zero past min(len, 16) and past KL. A row holding
    a piece longer than LONG_SLOT is flagged bad.
    -> (starts [p_cap] i32, words [p_cap, 4] i32, lens [p_cap] i32,
    row_bad [C] bool, n_pieces i32 scalar); entries past n_pieces are
    zero."""
    C, KP = mask3.shape
    KL = rows.shape[1]
    dev = rows.device
    meta = (torch.arange(C, device=dev)[:, None] * KL
            + torch.arange(KP, device=dev)[None, :]).to(torch.int32)
    (starts,), n = compact(mask3.reshape(-1), [meta.reshape(-1)], p_cap)
    live = torch.arange(p_cap, device=dev) < n
    prow = starts // KL
    pend = prow * KL + spec_f[prow.clamp(0, C - 1)]  # last piece ends at spec_f
    nxt = torch.cat([starts[1:], starts.new_zeros(1)])
    nxt_row = torch.cat([prow[1:], prow.new_full((1,), -1)])
    ends = torch.where((nxt_row == prow) & live, nxt, pend)
    lens = torch.where(live, ends - starts, 0).to(torch.int32)
    # pieces the device cannot merge flag their rows
    too_long = lens > LONG_SLOT
    flagged = torch.zeros(C + 1, dtype=torch.uint8, device=dev)
    flagged.scatter_(0, torch.where(too_long, prow, C).to(torch.int64), too_long.to(torch.uint8))
    row_bad = row_bad | flagged[:C].bool()
    # the first min(len, 16) bytes, zero past them and past the row
    s = starts.to(torch.int64)
    b_i = torch.arange(SLOT, device=dev)[None, :]
    col = (s % KL)[:, None] + b_i
    flat = rows.reshape(-1)
    idx = (s - s % KL)[:, None] + col
    keep = (col < KL) & (b_i < lens.clamp(0, SLOT)[:, None])
    b = torch.where(keep, flat[idx.clamp(max=flat.numel() - 1)], 0)
    words = b.to(torch.uint8).contiguous().view(torch.int32)  # [p_cap, 4]
    return starts, words, lens, row_bad, n


def catalog2(piece_start: torch.Tensor, n_payload: torch.Tensor, rows: torch.Tensor,
             row_bad: torch.Tensor, p_cap: int):
    """The v2 piece catalog (B10): ``pieces.catalog`` of the start grid
    piece_start [C, K], its pieces' words (``pieces.extract`` of rows [C,
    KL] u8, whose first K columns are the grid's bytes), and row_bad [C]
    OR the rows holding a piece longer than LONG_SLOT.
    -> (starts [p_cap] i32, C*K past the count; words [p_cap, 4] i32;
    lens [p_cap] i32; row_bad [C] bool; n_pieces i32 scalar)."""
    C, K = piece_start.shape
    starts, lens, n = pieces.catalog(piece_start, n_payload, p_cap)
    words = pieces.extract(rows[:, :K].contiguous(), starts, lens)
    too_long = lens > LONG_SLOT
    row = (starts // K).clamp(max=C - 1).to(torch.int64)
    flagged = torch.zeros(C + 1, dtype=torch.uint8, device=rows.device)
    flagged.scatter_(0, torch.where(too_long, row, C), too_long.to(torch.uint8))
    return starts, words, lens, row_bad | flagged[:C].bool(), n


def extract_slots(rows: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                  K: int) -> torch.Tensor:
    """(rows [C, KL] u8, starts [n] i32 flat indices into the [C, K] grid,
    lens [n] i32) -> [n, LONG_SLOT] u8: each piece's bytes from its row,
    zero past min(len, LONG_SLOT) and past the row."""
    width = LONG_SLOT
    C, KL = rows.shape
    s = starts.to(torch.int64)
    b = torch.arange(width, device=rows.device)[None, :]
    col = (s % K)[:, None] + b
    keep = (col < KL) & (b < lens.clamp(0, width)[:, None]) & (s < C * K)[:, None]
    idx = (s // K).clamp(max=C - 1)[:, None] * KL + col.clamp(max=KL - 1)
    return torch.where(keep, rows.reshape(-1)[idx], 0).to(torch.uint8)


def expand_tokens_rows(counts: torch.Tensor, combo: torch.Tensor, m_tok: torch.Tensor,
                       l_tok: torch.Tensor, out_size: int, starts: torch.Tensor, K: int,
                       n_rows: int):
    """``expand_tokens`` plus each row's token count: piece i adds
    counts[i] to row min(max(starts[i], 0) // K, n_rows - 1).
    -> (tokens [out_size] i32, total i32, row_counts [n_rows] i32)."""
    tok, total = expand_tokens(counts, combo, m_tok, l_tok, out_size)
    row = (starts.clamp(min=0) // K).clamp(max=n_rows - 1).to(torch.int64)
    row_counts = torch.zeros(n_rows, dtype=torch.int64, device=counts.device)
    row_counts.scatter_add_(0, row, counts.to(torch.int64))
    return tok, total, row_counts.to(torch.int32)


def assemble(n_pieces: torch.Tensor, lens: torch.Tensor, hit: torch.Tensor, words: torch.Tensor,
             byte_to_rank: torch.Tensor, mslot: torch.Tensor, lslot: torch.Tensor,
             m_count: torch.Tensor, l_count: torch.Tensor, m_tok: torch.Tensor,
             l_tok: torch.Tensor, starts: torch.Tensor, row_bad: torch.Tensor,
             n_miss: torch.Tensor, n_long: torch.Tensor, na_flag: torch.Tensor | None, *, K: int,
             t_cap: int, p_limit: int, t_limit: int, full: bool):
    """The assembly of a v3 or v2 chunk (B8, B10): ``piece_counts``, then
    ``expand_tokens_rows`` into t_cap tokens over the rows of ``row_bad``
    [C] (starts index rows of K columns), then the header: the row counts,
    row_bad, (``full``, v3: n_pieces, n_miss, n_long,) n_tokens and the
    overflow flag, n_pieces > p_limit | n_miss > m_cap | n_long > l_cap |
    n_tokens > t_limit | na_flag (None: false), m_cap and l_cap the slot
    counts' lengths. -> (tokens [t_cap] i32, header [2C+5] or [2C+2] i32)."""
    C = row_bad.shape[0]
    counts, combo = piece_counts(n_pieces, lens, hit, words, byte_to_rank, mslot, lslot, m_count,
                                 l_count)
    tok, total, row_counts = expand_tokens_rows(counts, combo, m_tok, l_tok, t_cap, starts, K, C)
    overflow = ((n_pieces > p_limit) | (n_miss > m_count.shape[0]) | (n_long > l_count.shape[0])
                | (total > t_limit))
    if na_flag is not None:
        overflow = overflow | na_flag
    tail = [n_pieces, n_miss, n_long, total, overflow] if full else [total, overflow]
    header = torch.cat([row_counts, row_bad.to(torch.int32),
                        torch.stack([x.to(torch.int32) for x in tail])])
    return tok, header
