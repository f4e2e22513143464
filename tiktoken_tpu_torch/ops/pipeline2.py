"""The v2 chunk program on the GPU: safe-split rows, a boundary scan, piece
slots; and the v1 program, its re-run for a chunk whose caps overflow.

v2 (``run_chunk2``), the counterpart of the JAX ``build_pipeline2_fn``
without ``pack24``, stage for stage:

    rows [C, KL] -- char_scan (or seq_scan) --> piece_start [C, K], row_bad
        -- catalog2 --> starts / lens / words per piece (row-major order)
        -- vocab hits --> single-token pieces
        -- short misses: compact, slot merge (W=16), left-packed
        -- long pieces: compact, extract, long hits, slot merge (W=64)
        -- assemble --> flat token stream, per-row counts, header

    header [2C+2] i32 = [row_counts | row_bad | n_tokens | overflow]

The scanner is the JAX package's choice: ``scanner="char"`` (the default,
JAX's ``char_tables`` route) classifies the row bytes into char classes
and walks the char-level DFA (``char_scan``, B16), ``scanner="byte"``
(JAX's ``TIKTOKEN_TPU_SCANNER=seq`` route) walks the byte-level DFA over
the bytes (``seq_scan``, B9). The caps are the JAX ones, p_cap = max(256,
N//2), m_cap = max(256, N//16), l_cap = max(64, N//512), t_cap = max(512,
N//2) rounded up to a multiple of 4 (N = C*K), and so is the overflow
rule: n_pieces > p_cap-1, n_miss > m_cap, n_long > l_cap, n_tokens >
t_cap-1, or, under the char scanner, a row with more than ``na_cap(KL,
8)`` non-ASCII char ends (dense CJK, Cyrillic or Arabic text). A row with
a piece longer than LONG_SLOT is flagged bad. Tokens come back as int32
bit patterns (no 24-bit packing).

v1 (``run_rows1``), the counterpart of the JAX ``build_pipeline_fn``:
window scan, orbit and ``row_bad`` (one entry, ``window_orbit``),
full-grid merge and row packing. It reads the byte-level scan table.

No PyTorch op runs on the device between the kernels: the scans read the
row bytes and the merge the payload lengths directly; the slot merges
read the miss and long counts on the device and left-pack their tokens,
and ``assemble`` gathers each merged piece's count from its slot and
writes the header.
"""

from __future__ import annotations

import torch

from tiktoken_tpu_torch.ops.kernels import KERNEL_OPS
from tiktoken_tpu_torch.ops.window_scan import DEFAULT_WINDOW

LOOK = 16  # true continuation bytes per row
DEFAULT_ROW = 256  # payload bytes per row
SCANNERS = ("char", "byte")
NA_FRAC = 8  # the char scanner's non-ASCII cap, na_cap(KL, NA_FRAC) char ends per row


def chunk_caps2(K: int, C: int) -> dict[str, int]:
    """The v2 chunk program's static caps (the JAX ``build_pipeline2_fn``'s)."""
    N = C * K
    return dict(p_cap=max(256, N // 2), m_cap=max(256, N // 16), l_cap=max(64, N // 512),
                t_cap=-(-max(512, N // 2) // 4) * 4)


def run_chunk2(t, rows, n_payload, n_total, *, scanner: str = "char", ops=KERNEL_OPS):
    """One v2 chunk: (rows [C, KL] u8, n_payload, n_total [C] i32) on one
    device, with ``t`` the engine's tables (``ChunkTables``, with
    ``byte_scan`` set for ``scanner="byte"``) -> (flat_tok [t_cap] i32,
    header [2C+2] i32). ``ops``: the kernels (``KERNEL_OPS``) or their
    plain versions (``PLAIN_OPS``); nothing else runs on the device."""
    if scanner not in SCANNERS:
        raise ValueError(f"scanner must be 'char' or 'byte', got {scanner!r}")
    C, KL = rows.shape
    K = KL - LOOK
    caps = chunk_caps2(K, C)
    p_cap, m_cap, l_cap, t_cap = caps["p_cap"], caps["m_cap"], caps["l_cap"], caps["t_cap"]
    # ---- B16 (char classes, char-DFA scan) or B9 (byte-DFA scan) -------------
    if scanner == "char":
        piece_start, row_bad, na_overflow = ops.char_scan(t.scan, rows, n_payload, n_total, K=K,
                                                          na_frac=NA_FRAC)
    else:
        piece_start, row_bad = ops.seq_scan(t.byte_scan, rows, n_payload, n_total, K=K,
                                             hot=t.byte_hot)
        na_overflow = None  # the byte scanner has no non-ASCII cap

    # ---- B10: catalog, words, too-long rows ----------------------------------
    starts, words, lens, row_bad, n_pieces = ops.catalog2(piece_start, n_payload, rows,
                                                          row_bad, p_cap)

    # ---- whole-piece hits ------------------------------------------------------
    hit = ops.vocab_hit(t.vocab_buckets, words, lens, t.vocab_seed)  # none over 16 bytes

    # ---- the short-miss and long compactions, one pass ---------------------------
    (m_words, m_lens, _), n_miss, mslot, (l_starts, l_lens, _), n_long, lslot = \
        ops.compact_kinds(words, starts, lens, hit, n_pieces, m_cap, l_cap)

    # ---- short misses merged in their slots, left-packed ---------------------------
    m_tok, m_count = ops.slot_merge_packed(t.pair_buckets, t.byte_to_rank,
                                           m_words.view(torch.uint8), m_lens, t.pair_seed, n_miss)

    # ---- long pieces ---------------------------------------------------------------
    l_bytes = ops.extract_slots(rows, l_starts, l_lens, K)
    # whole-piece hits of 17..64-byte tokens skip the merge (reference
    # vocab-as-cache semantics, src/lib.rs:367-369)
    l_hit = ops.long_vocab_hit(t.long_buckets, l_bytes, l_lens, t.long_seed)
    l_tok, l_count = ops.slot_merge_packed(t.pair_buckets, t.byte_to_rank, l_bytes, l_lens,
                                           t.pair_seed, n_long, hit=l_hit)

    # ---- assembly: per-piece counts, the token stream, per-row counts, header ---------
    return ops.assemble(n_pieces, lens, hit, words, t.byte_to_rank, mslot, lslot, m_count,
                        l_count, m_tok, l_tok, starts, row_bad, n_miss, n_long, na_overflow,
                        K=K, t_cap=t_cap, p_limit=p_cap - 1, t_limit=t_cap - 1, full=False)


def run_rows1(t, rows, n_payload, n_total, *, ops=KERNEL_OPS):
    """The v1 program on one chunk: (rows [C, KL] u8, n_payload, n_total
    [C] i32) -> (packed [C, K] i32, counts [C] i32, rounds i32, row_bad
    [C] bool), K = KL - LOOK. Its caps cannot overflow; a row whose piece
    starts include an unresolved or unmatched position is flagged bad."""
    K = rows.shape[1] - LOOK
    # window lookahead past the row reads EOF (only matches already dead
    # by then can reach it)
    piece_start, row_bad = ops.window_orbit(t.byte_scan, rows, n_payload, n_total, K=K,
                                            window=DEFAULT_WINDOW, hot=t.byte_hot)
    packed, counts, rounds = ops.grid_merge(t.pair_buckets, t.byte_to_rank, rows, piece_start,
                                            n_payload, t.pair_seed)
    return packed, counts, rounds, row_bad
