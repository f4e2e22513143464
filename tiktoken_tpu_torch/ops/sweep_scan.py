"""Char-level maximal-munch scan of a chunk's rows (the ``scan_rows`` kernel).

The JAX package runs this stage as jitted functions. On the v3 path: the
row gather (B1, ``pipeline3.row_gather``), the per-byte char classes
(B2, ``charclass.make_byte_classes_fn``), the select-sweep DFA scan (B3,
``sweep_scan.make_char_scan_fn(handshake=True)``) and the handshake
validation (B4, inside ``build_pipeline3_fn``). On the default v2 path:
the char classes of the v2 rows and the scan without the handshake (B16,
``make_char_scan_fn(handshake=False)`` from ``build_pipeline2_fn``). On
the GPU, B1-B3 are one entry point of the ``scan_rows`` kernel, one
thread per row, B4 a second, and B16 a third (csrc/scan_rows.cu). This
module holds their plain PyTorch versions, the numpy spec of the scan,
and the packed step table all of them read.

Semantics are the reference's find_iter maximal munch (reference:
src/lib.rs:363-365): repeatedly run the DFA from the piece start,
remember the last accept (with char-level lookahead rewind <= 1), and on
death restart at that accept end. Byte-position bookkeeping: an accept
with rewind 0 ends at the current char's final byte + 1; rewind 1 ends at
the current char's first byte (``cs``), or at the text end when the
consumed symbol is EOF.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from tiktoken_tpu_torch.ops.charclass import CharClassTables, byte_classes
from tiktoken_tpu_torch.ops.regex_compiler import CharScannerDFA

DEAD = CharScannerDFA.DEAD
START = CharScannerDFA.START

FIRE_BIT = 1 << 5
REW_BIT = 1 << 6


def build_scan_consts(tables: CharClassTables) -> np.ndarray:
    """[S, NW] uint32: per state, the packed per-class step values
    (4 classes per word, 8 bits each):

        val = next_state | fired << 5 | rewind << 6

    ``fired`` is set when the transition lands in a live accepting state
    (the scan records a new last-accept end); ``rewind`` is the accept's
    char-level lookahead (0 or 1). The SKIP and CONT columns (classes
    n_classes and n_classes + 1) are the identity: state unchanged,
    nothing fires."""
    S = tables.n_states
    C = tables.n_classes
    NC = C + 2  # + SKIP + CONT
    trans, accept = tables.trans, tables.accept
    if int(accept.max()) > 1:
        raise ValueError("char rewind must be <= 1")
    vals = np.zeros((S, NC), dtype=np.uint32)
    for s in range(S):
        for c in range(C):
            nxt = int(trans[s, c])
            a = int(accept[nxt])
            fired = 1 if (nxt != DEAD and a >= 0) else 0
            rew = a if (fired and a > 0) else 0
            vals[s, c] = nxt | (fired << 5) | (rew << 6)
        vals[s, C] = s  # SKIP: hold state silently
        vals[s, C + 1] = s  # CONT: ditto (mid-char death handled in-step)
    if int(vals.max()) >= 256 or S > 32:
        raise ValueError("scan DFA exceeds the packed step layout (<= 32 states)")
    n_words = (NC + 3) // 4
    words = np.zeros((S, n_words), dtype=np.uint32)
    for s in range(S):
        for c in range(NC):
            words[s, c >> 2] |= vals[s, c] << ((c & 3) * 8)
    return words


@dataclass
class ScanTables:
    """The scan's device tables: class pages and packed step words."""

    page_entry: torch.Tensor  # [N_PAGES] int32
    page16: torch.Tensor  # [N_PAGES] int16: page_entry's values (< 2^14), as the kernel reads them
    mixed_rows: torch.Tensor  # [n_mixed, 128] uint8
    consts: torch.Tensor  # [S, NW] int32 (uint32 bit patterns)
    n_classes: int
    eof_class: int

    @property
    def skip_class(self) -> int:
        return self.n_classes

    @property
    def cont_class(self) -> int:
        return self.n_classes + 1

    def to(self, device: torch.device) -> "ScanTables":
        """A copy of the tables on ``device``."""
        return replace(self, page_entry=self.page_entry.to(device),
                       page16=self.page16.to(device), mixed_rows=self.mixed_rows.to(device),
                       consts=self.consts.to(device))


def scan_tables(tables: CharClassTables, consts: np.ndarray,
                device: torch.device) -> ScanTables:
    if int(tables.page_entry.max(initial=0)) >= 1 << 15:
        raise ValueError("page entries exceed the kernel's 16-bit page table")
    return ScanTables(
        page_entry=torch.as_tensor(tables.page_entry.astype(np.int32), device=device),
        page16=torch.as_tensor(tables.page_entry.astype(np.int16), device=device),
        mixed_rows=torch.as_tensor(tables.mixed_rows.astype(np.uint8), device=device),
        consts=torch.as_tensor(consts.view(np.int32), device=device),
        n_classes=tables.n_classes,
        eof_class=tables.eof_class,
    )


# ---------------------------------------------------------------------------
# numpy reference (the spec of one row)
# ---------------------------------------------------------------------------


def walk_numpy(tables: CharClassTables, classes_ext: np.ndarray, n_payload: int,
               n_total: int, is_doc_end: bool | None, K: int
               ) -> tuple[np.ndarray, int, bool, int]:
    """One row's walk from offset 0: (piece_start mask [K], first boundary
    at or past ``n_payload``, bad, steps taken). ``is_doc_end`` None: no
    handshake. A row still unfinished after 3 * (KL + 2) steps is bad."""
    consts = build_scan_consts(tables)
    SKIP = tables.skip_class
    CONTC = tables.cont_class
    EOFC = tables.eof_class
    KL = len(classes_ext) - 1
    mask = np.zeros(K, dtype=bool)
    bad = False
    spec_f = n_payload
    if n_payload <= 0:
        return mask, 0, False, 0
    p, s, mstart, lend, cs = 0, START, 0, -1, 0
    steps = 0
    for _ in range(3 * (KL + 2)):
        steps += 1
        c = int(classes_ext[min(p, KL)])
        v = int(consts[s, c >> 2] >> ((c & 3) * 8)) & 0xFF
        s2 = v & 31
        if v & FIRE_BIT:
            if v & REW_BIT:
                lend = p if c == EOFC else cs
            else:
                lend = p + 1
        eof_death = p >= n_total
        # CONT at a match start: the match begins on a continuation byte —
        # the byte DFA dies immediately there, so force the same
        # death/no-progress outcome
        died = (s2 == DEAD) or eof_death or (c == CONTC and p == mstart)
        if died:
            if eof_death and is_doc_end is False:
                bad = True  # unresolved straddler / fake-EOF resolution
            if mstart < n_payload and mstart < K:
                mask[mstart] = True
            no_prog = lend <= mstart
            finished = lend >= n_payload
            if no_prog and not finished:
                bad = True
                break
            if bad:
                break
            if finished or no_prog:
                spec_f = lend
                break
            p, s, mstart, cs, lend = lend, START, lend, lend, -1
        else:
            if c < SKIP:  # char-end byte consumed (SKIP/CONT hold state)
                cs = p + 1
            p += 1
            s = s2
    else:
        bad = True
    return mask, int(spec_f), bad, steps


def char_scan_numpy(tables: CharClassTables, classes_ext: np.ndarray, n_payload: int,
                    n_total: int, K: int) -> tuple[np.ndarray, bool]:
    """One row, the v2 contract. classes_ext [KL+1] int32 with EOF at >=
    n_total and in the final column. Returns (piece_start mask [K] bool,
    bad)."""
    mask, _, bad, _ = walk_numpy(tables, classes_ext, n_payload, n_total, None, K)
    return mask, bad


def handshake_scan_numpy(
    tables: CharClassTables,
    classes_ext: np.ndarray,
    n_payload: int,
    n_total: int,
    is_doc_end: bool,
    K: int,
) -> tuple[np.ndarray, int, bool]:
    """One row, speculative-handoff contract (pipeline3).

    The scan starts at offset 0 (speculatively — the row may begin
    mid-piece) and runs until its first boundary at or past ``n_payload``
    (``spec_f``, the handoff the next row validates against). Returns
    (piece_start mask [K] for starts < n_payload, spec_f, bad). ``bad``
    additionally fires when resolution consumed the end-of-buffer EOF on
    a row that is NOT the end of its document. For a bad row ``spec_f``
    is unspecified (the kernels, like the JAX one, keep the end of the
    dying match)."""
    return walk_numpy(tables, classes_ext, n_payload, n_total, bool(is_doc_end), K)[:3]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def row_gather(flat: torch.Tensor, row_off: torch.Tensor, KL: int) -> torch.Tensor:
    """B1: rows[r] = flat[row_off[r] : row_off[r] + KL] (zero past the end
    of ``flat``). [C, KL] uint8."""
    idx = row_off.to(torch.int64)[:, None] + torch.arange(KL, device=flat.device)[None, :]
    inside = idx < flat.shape[0]
    return torch.where(inside, flat[idx.clamp(max=flat.shape[0] - 1)], 0).to(torch.uint8)


def _walk(consts: torch.Tensor, cls_ext: torch.Tensor, n_payload: torch.Tensor,
          n_total: torch.Tensor, is_doc_end: torch.Tensor | None, *, K: int,
          cont_class: int, eof_class: int):
    """All rows in lockstep, each following ``walk_numpy`` step for step
    with the step cap 3 * (KL + 2): (mask [C, K] bool, f [C] int64, bad [C]
    bool, steps [C] int64, each row's steps taken). ``is_doc_end`` None: no
    handshake."""
    C, KL1 = cls_ext.shape
    KL = KL1 - 1
    dev = cls_ext.device
    skip_class = cont_class - 1
    cw = consts.to(torch.int64) & 0xFFFFFFFF  # [S, NW]
    shifts = torch.arange(4, device=dev) * 8
    vals = ((cw[:, :, None] >> shifts) & 0xFF).reshape(cw.shape[0], -1)  # [S, 4*NW]

    cls_ext = cls_ext.to(torch.int64)
    n_payload = n_payload.to(torch.int64)
    n_total = n_total.to(torch.int64)
    rows = torch.arange(C, device=dev)
    p = torch.zeros(C, dtype=torch.int64, device=dev)
    s = torch.full((C,), START, dtype=torch.int64, device=dev)
    mstart = torch.zeros_like(p)
    lend = torch.full_like(p, -1)
    cs = torch.zeros_like(p)
    done = n_payload <= 0
    bad = torch.zeros(C, dtype=torch.bool, device=dev)
    f = n_payload.clamp(min=0)
    mask = torch.zeros(C * K, dtype=torch.uint8, device=dev)
    steps = torch.zeros(C, dtype=torch.int64, device=dev)
    for it in range(3 * (KL + 2)):
        if it % 16 == 0 and not bool((~(done | bad)).any()):
            break
        active = ~(done | bad)
        steps += active
        c = cls_ext[rows, p.clamp(0, KL)]
        v = vals[s, c]
        s2 = v & 31
        fired = (v & FIRE_BIT) != 0
        rew1 = (v & REW_BIT) != 0
        end_rew = torch.where(c == eof_class, p, cs)
        lend = torch.where(fired & active, torch.where(rew1, end_rew, p + 1), lend)
        died = (s2 == DEAD) | (p >= n_total) | ((c == cont_class) & (p == mstart))
        emit = died & active & (mstart < n_payload) & (mstart < K)
        mask.scatter_reduce_(
            0, rows * K + mstart.clamp(0, K - 1), emit.to(torch.uint8), "amax"
        )
        no_prog = died & (lend <= mstart)
        finished = torch.where(died, lend, mstart) >= n_payload
        bad = bad | (no_prog & active & ~finished)
        if is_doc_end is None:
            eof_bad = torch.zeros_like(bad)
        else:
            eof_bad = died & active & (p >= n_total) & ~is_doc_end
            bad = bad | eof_bad
        stop = died & (finished | no_prog) & active
        f = torch.where(stop & ~eof_bad, lend, f)
        done = done | stop
        adv = active & ~died
        restart = active & died
        cs = torch.where(adv, torch.where(c < skip_class, p + 1, cs),
                         torch.where(restart, lend, cs))
        p = torch.where(adv, p + 1, torch.where(restart, lend, p))
        s = torch.where(adv, s2, START)
        mstart = torch.where(restart, lend, mstart)
        lend = torch.where(restart, -1, lend)
    return mask.view(C, K).bool(), f, bad | ~done, steps


def handshake_scan(consts: torch.Tensor, cls_ext: torch.Tensor,
                   n_payload: torch.Tensor, n_total: torch.Tensor,
                   is_doc_end: torch.Tensor, *, KP: int, cont_class: int,
                   eof_class: int):
    """B3, all rows in lockstep: (classes_ext [C, KL+1] i32, n_payload,
    n_total [C] i32, is_doc_end [C] bool) -> (piece_start mask [C, KP]
    bool, spec_f [C] i32, row_bad [C] bool); each row as
    ``handshake_scan_numpy``."""
    mask, f, bad, _ = _walk(consts, cls_ext, n_payload, n_total, is_doc_end, K=KP,
                            cont_class=cont_class, eof_class=eof_class)
    return mask, torch.where(n_payload <= 0, 0, f).to(torch.int32), bad


def char_scan(consts: torch.Tensor, cls_ext: torch.Tensor, n_payload: torch.Tensor,
              n_total: torch.Tensor, *, K: int, cont_class: int, eof_class: int):
    """B16's scan, all rows in lockstep: (classes_ext [C, KL+1] i32,
    n_payload, n_total [C] i32) -> (piece_start [C, K] bool, row_bad [C]
    bool); each row as ``char_scan_numpy``."""
    mask, _, bad, _ = _walk(consts, cls_ext, n_payload, n_total, None, K=K,
                            cont_class=cont_class, eof_class=eof_class)
    return mask, bad


def walk_steps(tables: ScanTables, cls_ext: torch.Tensor, n_payload: torch.Tensor,
               n_total: torch.Tensor, is_doc_end: torch.Tensor | None = None) -> torch.Tensor:
    """The steps each row's walk takes (steps [C] int64), with the
    handshake when ``is_doc_end`` is given; the latency a one-thread-per-row
    walk cannot avoid."""
    K = cls_ext.shape[1] - 1
    return _walk(tables.consts, cls_ext, n_payload, n_total, is_doc_end, K=K,
                 cont_class=tables.cont_class, eof_class=tables.eof_class)[3]


def row_classes(tables: ScanTables, rows: torch.Tensor, n_total: torch.Tensor,
                na_frac: int):
    """B2 over rows [C, KL] u8, with the EOF column appended: (classes
    [C, KL+1] i32, na_overflow bool scalar)."""
    cls, na_overflow = byte_classes(
        tables.page_entry, tables.mixed_rows, rows, n_total,
        skip_class=tables.skip_class, cont_class=tables.cont_class,
        eof_class=tables.eof_class, na_frac=na_frac,
    )
    eof_col = torch.full((cls.shape[0], 1), tables.eof_class, dtype=cls.dtype,
                         device=cls.device)
    return torch.cat([cls, eof_col], dim=1), na_overflow


def scan_rows(tables: ScanTables, flat, row_off, n_payload, n_total, is_doc_end,
              *, KP: int, KL: int, na_frac: int):
    """B1+B2+B3: (rows [C, KL] u8, mask [C, KP] bool, spec_f [C] i32,
    row_bad [C] bool, na_overflow bool scalar)."""
    rows = row_gather(flat, row_off, KL)
    cls, na_overflow = row_classes(tables, rows, n_total, na_frac)
    mask, spec_f, row_bad = handshake_scan(
        tables.consts, cls, n_payload, n_total, is_doc_end, KP=KP,
        cont_class=tables.cont_class, eof_class=tables.eof_class,
    )
    return rows, mask, spec_f, row_bad, na_overflow


def char_scan_rows(tables: ScanTables, rows, n_payload, n_total, *, K: int, na_frac: int):
    """B16, the v2 rows' char classes and scan: (rows [C, KL] u8, n_payload,
    n_total [C] i32) -> (piece_start [C, K] bool, row_bad [C] bool,
    na_overflow bool scalar)."""
    cls, na_overflow = row_classes(tables, rows, n_total, na_frac)
    mask, row_bad = char_scan(tables.consts, cls, n_payload, n_total, K=K,
                              cont_class=tables.cont_class, eof_class=tables.eof_class)
    return mask, row_bad, na_overflow


def scan_validate(mask, spec_f, row_bad, n_payload, prev_same_doc, emit):
    """B4, the handshake validation: a row's start offset ``g`` (the
    previous same-doc row's ``spec_f`` minus its payload) must be a piece
    start or equal ``n_payload``, else the row is flagged. Starts before
    ``g`` and in rows that emit nothing (ghosts) are masked out.
    -> (mask3 [C, KP] bool, row_bad [C] bool)."""
    C, KP = mask.shape
    z1 = torch.zeros(1, dtype=spec_f.dtype, device=spec_f.device)
    prev_f = torch.cat([z1, spec_f[:-1]])
    prev_pay = torch.cat([z1, n_payload[:-1]])
    g = torch.where(prev_same_doc, prev_f - prev_pay, 0).clamp(0, KP)
    gbit = mask.gather(1, g.clamp(0, KP - 1).to(torch.int64)[:, None])[:, 0]
    ok = gbit | (g == n_payload)
    row_bad = row_bad | (prev_same_doc & ~ok)
    cols = torch.arange(KP, device=mask.device)[None, :]
    mask3 = mask & (cols >= g[:, None]) & emit[:, None]
    return mask3, row_bad
