"""The v3 chunk program on the GPU: handshake rows, four kernels, glue.

Host side (as in the JAX package's ops/pipeline3.py): documents are cut
every ~K bytes at a character boundary, the corpus bytes ship once, and
each chunk of C rows is described by offsets into them (``pack_corpus3``,
``chunk_inputs3``; the cuts come from the native host core's cutter,
``native.pack_cuts3``, whose spec is the numpy ``_doc_cuts_np``, which
cuts where no native core can be had).

Device side (``run_chunk``): the same stages, caps, ``worst_case``
variant and header layout as the JAX ``build_pipeline3_fn``, so every
stage can be diffed against its JAX twin:

    header [2C+5] i32 = [row_counts | row_bad | n_pieces | n_miss |
                         n_long | n_tokens | overflow]

Tokens come back as uint32 (int32 bit patterns), so there is no 24-bit
packing; and the catalog reads each piece's four slot words straight from
the row bytes, so there is no [C, KL] word grid. The stages run as the
kernels of ``ops/kernels.py`` and nothing else: no PyTorch op runs on the
device between them (``run_chunk``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np
import torch

from tiktoken_tpu_torch import native
from tiktoken_tpu_torch.ops.charclass import CharClassTables
from tiktoken_tpu_torch.ops.kernels import KERNEL_OPS
from tiktoken_tpu_torch.ops.pair_table import PairTable
from tiktoken_tpu_torch.ops.pieces import LongVocabTable, VocabTable
from tiktoken_tpu_torch.ops.sweep_scan import ScanTables, build_scan_consts, scan_tables

K_DEFAULT = 176  # nominal payload bytes per row (cuts land in [K-backup, K])
FWD = 80  # straddler-resolution margin: LONG_SLOT + lookahead slack
DIGIT_BACKUP = 40  # max bytes a cut backs out of an ASCII digit run
PAY_PAD = DIGIT_BACKUP + 8  # cut backup can lengthen the following row


def row_geometry(K: int) -> tuple[int, int]:
    """(KP, KL): payload capacity and full row-buffer length."""
    KP = K + PAY_PAD
    return KP, KP + FWD


@dataclass
class PackedCorpus3:
    """Handshake-packed corpus: the bytes ship once, rows are described
    by offsets and gathered on device."""

    flat: np.ndarray  # concatenated doc bytes + KL tail padding, uint8
    row_off: np.ndarray  # [B] int32 absolute offsets into flat
    n_payload: np.ndarray  # [B] int32 (<= K + PAY_PAD)
    n_total: np.ndarray  # [B] int32 valid bytes in the row buffer
    is_doc_end: np.ndarray  # [B] bool: row buffer reaches its doc's end
    prev_same_doc: np.ndarray  # [B] bool: previous batch row is same doc
    doc_index: np.ndarray  # [B] int32
    K: int


def _doc_cuts_np(data: np.ndarray, K: int) -> np.ndarray:
    """Cut positions for one document, numpy reference implementation.

    Candidate cut positions: character starts that do not fall inside an
    ASCII digit run. Digit runs are the one piece family whose
    boundaries are phase-locked to the run START (\\p{N}{1,3}), so a
    speculative scan beginning mid-run can never resync; every other run
    family ends at a content-determined position and self-syncs. Runs
    longer than DIGIT_BACKUP keep the in-run cut (rare; the handshake
    flags them and the document falls back)."""
    n = len(data)
    is_digit = (data >= 0x30) & (data <= 0x39)
    in_run = np.zeros(n, dtype=bool)
    in_run[1:] = is_digit[1:] & is_digit[:-1]
    okpos = ((data & 0xC0) != 0x80) & ~in_run
    nc = np.nonzero(okpos)[0]
    grid = np.arange(K, n, K, dtype=np.int64)
    cuts = nc[np.searchsorted(nc, grid, side="right") - 1]
    # keep forward progress: if backing out of a digit run moved a
    # cut more than DIGIT_BACKUP bytes, take the raw char cut
    ncc = np.nonzero((data & 0xC0) != 0x80)[0]
    raw = ncc[np.searchsorted(ncc, grid, side="right") - 1]
    cuts = np.where(raw - cuts > min(DIGIT_BACKUP, K // 2), raw, cuts)
    cuts = np.unique(cuts)
    return cuts[(cuts > 0) & (cuts < n)]


def _is_utf8(doc: bytes) -> bool:
    try:
        doc.decode("utf-8")
    except UnicodeDecodeError:
        return False
    return True


def _doc_cuts(data: np.ndarray, K: int, utf8: bool) -> np.ndarray:
    """Cut positions for one document: the native cutter where ``utf8``
    (the document is valid UTF-8 and the native core can be had), there
    bit-exact with ``_doc_cuts_np``; elsewhere the numpy cuts themselves
    (the native cutter cuts at the grid position where no character
    starts in its window, and the numpy one does not)."""
    if utf8:
        return native.pack_cuts3(data, K, DIGIT_BACKUP)
    return _doc_cuts_np(data, K)


def pack_corpus3(docs: Sequence[bytes], K: int = K_DEFAULT,
                 utf8: Sequence[bool] | None = None) -> PackedCorpus3:
    """Cut each document every ~K bytes at a character boundary (backing
    up over at most 3 continuation bytes — script-agnostic). ``utf8[i]``
    true says document i is known to be valid UTF-8 (it was encoded from a
    str); any other document is checked before it is cut."""
    KP, KL = row_geometry(K)
    native_cuts = native.available()
    offs, pays, tots, ends, prevs, dix = [], [], [], [], [], []
    parts: list[np.ndarray] = []
    base = 0
    for d_i, doc in enumerate(docs):
        data = np.frombuffer(doc, dtype=np.uint8)
        n = len(data)
        if n == 0:
            continue
        parts.append(data)
        if n <= K:
            bounds = np.asarray([0, n], dtype=np.int64)
        else:
            cuts = _doc_cuts(data, K, native_cuts and (
                (utf8 is not None and utf8[d_i]) or _is_utf8(doc)))
            bounds = np.concatenate([[0], cuts, [n]])
        starts = bounds[:-1]
        pay = np.diff(bounds)
        if pay.max(initial=0) > KP:
            raise RuntimeError("char backup exceeded PAY_PAD")
        tot = np.minimum(n - starts, KL)
        offs.append(base + starts)
        pays.append(pay)
        tots.append(tot)
        ends.append(starts + tot == n)
        pv = np.ones(len(starts), dtype=bool)
        pv[0] = False
        prevs.append(pv)
        dix.append(np.full(len(starts), d_i, dtype=np.int32))
        base += n
    if not parts:
        z = np.zeros(0, np.int32)
        return PackedCorpus3(
            flat=np.zeros(KL, np.uint8), row_off=z, n_payload=z, n_total=z,
            is_doc_end=np.zeros(0, bool), prev_same_doc=np.zeros(0, bool),
            doc_index=z, K=K,
        )
    flat = np.concatenate(parts + [np.zeros(KL + 4, np.uint8)])
    return PackedCorpus3(
        flat=flat,
        row_off=np.concatenate(offs).astype(np.int32),
        n_payload=np.concatenate(pays).astype(np.int32),
        n_total=np.concatenate(tots).astype(np.int32),
        is_doc_end=np.concatenate(ends),
        prev_same_doc=np.concatenate(prevs),
        doc_index=np.concatenate(dix),
        K=K,
    )


def chunk_inputs3(pc: "PackedCorpus3", lo: int, R: int, C: int, S: int):
    """Host-side inputs for one handshake chunk: real rows [lo, lo+R)
    plus the leading ghost (the previous row, which re-provides its
    handoff boundary and emits nothing). Returns ((flat, off, pay, tot,
    dend, prev, emit), nreal)."""
    B = pc.row_off.shape[0]
    hi = min(lo + R, B)
    nreal = hi - lo
    idx = np.arange(lo, hi)
    ghost = lo - 1  # -1 = dummy for the first chunk

    off = np.zeros(C, np.int32)
    pay = np.zeros(C, np.int32)
    tot = np.zeros(C, np.int32)
    dend = np.zeros(C, bool)
    prev = np.zeros(C, bool)
    emit = np.zeros(C, bool)
    rows_sel = np.concatenate([[ghost if ghost >= 0 else lo], idx])
    off_abs = pc.row_off[rows_sel].astype(np.int64)
    base = int(off_abs.min())
    off[: nreal + 1] = (off_abs - base).astype(np.int32)
    pay[1 : nreal + 1] = pc.n_payload[idx]
    tot[1 : nreal + 1] = pc.n_total[idx]
    dend[1 : nreal + 1] = pc.is_doc_end[idx]
    prev[1 : nreal + 1] = pc.prev_same_doc[idx]
    emit[1 : nreal + 1] = True
    if ghost >= 0:
        pay[0] = pc.n_payload[ghost]
        tot[0] = pc.n_total[ghost]
        dend[0] = pc.is_doc_end[ghost]
    flat = pc.flat[base : base + S]
    if flat.shape[0] < S:
        flat = np.concatenate([flat, np.zeros(S - flat.shape[0], np.uint8)])
    return (flat, off, pay, tot, dend, prev, emit), nreal


# static caps as fractions of the chunk's payload N = C * KP (the JAX
# defaults, measured on the bench corpus): pieces N/5, short misses N/96,
# long pieces N/1024, tokens N/5. A chunk that overflows any of them
# re-runs through the worst_case variant, whose caps cover the densest
# legal inputs and cannot overflow.
P_DIV, M_DIV, L_DIV, T_DIV = 5, 96, 1024, 5


def chunk_caps(K: int, C: int, worst_case: bool = False) -> dict[str, int]:
    """The chunk program's static caps and non-ASCII class-cap fraction."""
    KP, _ = row_geometry(K)
    N = C * KP
    if worst_case:
        return dict(p_cap=N + 256, m_cap=N // 2 + 256, l_cap=N // 17 + 64,
                    t_cap=-(-(N + 512) // 4) * 4, na_frac=2)
    return dict(p_cap=max(256, N // P_DIV), m_cap=max(256, N // M_DIV),
                l_cap=max(64, N // L_DIV), t_cap=-(-max(512, N // T_DIV) // 4) * 4,
                na_frac=8)


@dataclass
class ChunkTables:
    """Every table the chunk program reads, on one device."""

    scan: ScanTables
    pair_buckets: torch.Tensor  # [nb, 32] i32
    byte_to_rank: torch.Tensor  # [256] i32
    pair_seed: int
    vocab_buckets: torch.Tensor  # [nb, 64] i32
    vocab_seed: int
    long_buckets: torch.Tensor  # [nb, 128] i32
    long_seed: int
    # [S, 257] i32 byte-indexed scan table of the v2/v1 programs, its first
    # byte_hot states closed under ASCII bytes
    # (window_scan.hot_byte_scan_table); built at the first call that needs it
    byte_scan: torch.Tensor | None = None
    byte_hot: int = 0

    @property
    def device(self) -> torch.device:
        return self.pair_buckets.device

    def to(self, device: torch.device) -> "ChunkTables":
        """A copy of every table on ``device``, the byte-level scan table
        too once it is built."""
        return replace(
            self, scan=self.scan.to(device), pair_buckets=self.pair_buckets.to(device),
            byte_to_rank=self.byte_to_rank.to(device),
            vocab_buckets=self.vocab_buckets.to(device),
            long_buckets=self.long_buckets.to(device),
            byte_scan=None if self.byte_scan is None else self.byte_scan.to(device))


def upload_tables(char: CharClassTables, pair: PairTable, vocab: VocabTable,
                  long: LongVocabTable, device: torch.device) -> ChunkTables:
    """Move the host tables to ``device`` (once per engine)."""

    def i32(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32),
                               device=device)

    return ChunkTables(
        scan=scan_tables(char, build_scan_consts(char), device),
        pair_buckets=i32(pair.buckets), byte_to_rank=i32(pair.byte_to_rank),
        pair_seed=int(pair.seed),
        vocab_buckets=i32(vocab.buckets), vocab_seed=int(vocab.seed),
        long_buckets=i32(long.buckets), long_seed=int(long.seed),
    )


def run_chunk(t: ChunkTables, flat, row_off, n_payload, n_total, is_doc_end,
              prev_same_doc, emit, *, K: int, worst_case: bool = False, ops=KERNEL_OPS):
    """One chunk: (flat [S] u8, row_off, n_payload, n_total [C] i32,
    is_doc_end, prev_same_doc, emit [C] bool) on one device -> (flat_tok
    [t_cap] i32, header [2C+5] i32). ``ops`` is the set of stage
    operations: the kernels (``KERNEL_OPS``) or their plain versions
    (``PLAIN_OPS``, the chip check's yardstick). It calls ``ops`` and
    nothing else on the device.
    """
    C = row_off.shape[0]
    KP, KL = row_geometry(K)
    caps = chunk_caps(K, C, worst_case)
    p_cap, m_cap, l_cap, t_cap = caps["p_cap"], caps["m_cap"], caps["l_cap"], caps["t_cap"]
    # ---- B1-B4: rows, classes, scan, handshake validation -------------------
    rows, mask, spec_f, row_bad, na_overflow = ops.scan_rows(
        t.scan, flat, row_off, n_payload, n_total, is_doc_end,
        KP=KP, KL=KL, na_frac=caps["na_frac"],
    )
    mask3, row_bad = ops.scan_validate(mask, spec_f, row_bad, n_payload, prev_same_doc, emit)

    # ---- B5: catalog: starts, lengths, padded words, too-long row flags ------
    starts, words, lens, row_bad, n_pieces = ops.catalog(rows, mask3, spec_f, row_bad, p_cap)

    # ---- B6: whole-piece hits -------------------------------------------------
    # (a piece over 16 bytes never hits the short table)
    hit = ops.vocab_hit(t.vocab_buckets, words, lens, t.vocab_seed)

    # ---- B7/B8: the short-miss and long compactions, one pass ---------------
    (m_words, m_lens, _), n_miss, mslot, (l_starts, l_lens, _), n_long, lslot = \
        ops.compact_kinds(words, starts, lens, hit, n_pieces, m_cap, l_cap)

    # ---- B7: the short misses merged in their slots, left-packed ------------
    m_tok, m_count = ops.slot_merge_packed(t.pair_buckets, t.byte_to_rank,
                                           m_words.view(torch.uint8), m_lens, t.pair_seed, n_miss)

    # ---- B8: long pieces ------------------------------------------------------
    # starts index rows of KL columns; a long piece starts below KP and
    # ends by KP + LONG_SLOT <= KL, so its bytes lie in its row
    l_bytes = ops.extract_slots(rows, l_starts, l_lens, KL)
    # whole-piece hits for 17..64-byte tokens skip the merge (reference
    # vocab-as-cache semantics, src/lib.rs:367-369)
    l_hit = ops.long_vocab_hit(t.long_buckets, l_bytes, l_lens, t.long_seed)
    l_tok, l_count = ops.slot_merge_packed(t.pair_buckets, t.byte_to_rank, l_bytes, l_lens,
                                           t.pair_seed, n_long, hit=l_hit)

    # ---- B8: per-piece counts, the token stream, each row's count, header ---
    return ops.assemble(n_pieces, lens, hit, words, t.byte_to_rank, mslot, lslot, m_count,
                        l_count, m_tok, l_tok, starts, row_bad, n_miss, n_long, na_overflow,
                        K=KL, t_cap=t_cap, p_limit=p_cap, t_limit=t_cap, full=True)
