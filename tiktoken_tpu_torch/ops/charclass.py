"""Per-byte char-class grid: the front half of the char-level scanner.

The char-level DFA (CharScannerDFA) steps over *characters*; the device
works on row bytes. This module labels every byte position with

- the char class of the character *ending* at that position (so the DFA
  transition fires exactly once per character, at its last byte),
- SKIP for the lead byte of a multi-byte character, CONT for an interior
  continuation byte (the scanner holds state on both),
- the EOF class at and beyond end-of-text.

Character classes come from the DFA's codepoint partition compiled into a
two-level page table:

    page = cp >> 7                                  (8704 pages)
    page uniform  -> class directly
    page mixed    -> row index into mixed_rows [n_mixed, 128]

Truncated trailing characters (a row's lookahead can end mid-character)
never fire a char end: they read as SKIP/CONT until EOF.

``byte_classes`` is the plain PyTorch version of the class stage of the
``scan_rows`` kernel (csrc/scan_rows.cu), with the JAX kernel's
non-ASCII cap: a row with more than ``L / na_frac`` non-ASCII char ends
raises ``na_overflow``, and the char ends past the cap read class 0
(exactly what the JAX per-row compaction leaves there), so headers
compare equal to the JAX pipeline's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tiktoken_tpu_torch.ops.regex_compiler import CharScannerDFA

PAGE_BITS = 7
N_PAGES = 0x110000 >> PAGE_BITS  # 8704
MIXED_FLAG = 1 << 13  # page entry: MIXED_FLAG | mixed_idx, else class id


@dataclass
class CharClassTables:
    """Codepoint -> char-class, page-compressed for device lookup."""

    page_entry: np.ndarray  # [N_PAGES] int32: class | (MIXED_FLAG|mixed_idx)
    mixed_rows: np.ndarray  # [n_mixed, 128] uint8 class ids
    n_classes: int  # char classes; SKIP == n_classes, CONT == n_classes + 1
    eof_class: int
    n_states: int
    trans: np.ndarray  # [n_states, n_classes] from the CharScannerDFA
    accept: np.ndarray  # [n_states] int8 rewind-in-chars (-1 = no accept)

    @property
    def skip_class(self) -> int:
        """Non-final *lead* byte of a (possibly truncated) character: the
        scanner holds state. A match may legitimately start here."""
        return self.n_classes

    @property
    def cont_class(self) -> int:
        """UTF-8 continuation byte that is not a char end: the scanner
        holds state, but a match starting here is mid-character and dies
        at once."""
        return self.n_classes + 1


def build_char_class_tables(dfa: CharScannerDFA) -> CharClassTables:
    """Compile the DFA's codepoint partition into page tables."""
    edges = dfa.edges.astype(np.int64)  # ascending, edges[0]=0, last=0x110000
    seg_class = dfa.seg_class.astype(np.int64)

    page_entry = np.zeros(N_PAGES, dtype=np.int32)
    mixed_rows: list[np.ndarray] = []

    # page p covers [p<<7, (p+1)<<7); mixed iff an edge falls strictly inside
    inner = edges[1:-1]
    mixed_pages = np.unique(inner[(inner & ((1 << PAGE_BITS) - 1)) != 0] >> PAGE_BITS)

    # uniform pages: class of their first codepoint
    starts = np.arange(N_PAGES, dtype=np.int64) << PAGE_BITS
    seg_of_start = np.searchsorted(edges, starts, side="right") - 1
    page_entry[:] = seg_class[np.minimum(seg_of_start, len(seg_class) - 1)]

    for p in sorted(int(p) for p in mixed_pages):
        cps = (np.int64(p) << PAGE_BITS) + np.arange(1 << PAGE_BITS, dtype=np.int64)
        segs = np.searchsorted(edges, cps, side="right") - 1
        row = seg_class[np.minimum(segs, len(seg_class) - 1)].astype(np.uint8)
        page_entry[p] = MIXED_FLAG | len(mixed_rows)
        mixed_rows.append(row)

    rows = (
        np.stack(mixed_rows)
        if mixed_rows
        else np.zeros((1, 1 << PAGE_BITS), np.uint8)
    )
    if int(dfa.accept.max()) > 1:
        raise ValueError("char-level rewind must be <= 1 char")
    if dfa.n_classes >= MIXED_FLAG:
        raise ValueError("too many char classes for the page table")
    # the scan keys its EOF end-rewind adjustment on eof_class: no real
    # codepoint may share it
    if np.any(dfa.seg_class == dfa.eof_class):
        raise ValueError("a codepoint shares the EOF class")
    return CharClassTables(
        page_entry=page_entry,
        mixed_rows=rows,
        n_classes=int(dfa.n_classes),
        eof_class=int(dfa.eof_class),
        n_states=int(dfa.n_states),
        trans=dfa.trans.astype(np.int32),
        accept=dfa.accept.astype(np.int8),
    )


def class_of_cp_tables(tables: CharClassTables, cp: int) -> int:
    """Host-side table lookup (spec cross-check vs dfa.class_of_cp)."""
    e = int(tables.page_entry[cp >> PAGE_BITS])
    if e & MIXED_FLAG:
        return int(tables.mixed_rows[e & (MIXED_FLAG - 1), cp & ((1 << PAGE_BITS) - 1)])
    return e


# ---------------------------------------------------------------------------
# numpy reference: per-byte class grid
# ---------------------------------------------------------------------------


def _utf8_len_of_lead(b: int) -> int:
    """Expected sequence length for a lead byte (0 for continuation or
    invalid leads — those never complete a character)."""
    if b < 0x80:
        return 1
    if 0xC2 <= b <= 0xDF:
        return 2
    if 0xE0 <= b <= 0xEF:
        return 3
    if 0xF0 <= b <= 0xF4:
        return 4
    return 0


def byte_classes_numpy(
    tables: CharClassTables, row: np.ndarray, n_total: int
) -> np.ndarray:
    """[len(row)] int32: char class at char-end bytes, SKIP/CONT inside
    chars, EOF at positions >= n_total. Pure per-position spec."""
    n = len(row)
    b = row.astype(np.int64)
    is_cont = (b & 0xC0) == 0x80
    out = np.where(is_cont, tables.cont_class, tables.skip_class).astype(np.int32)
    for p in range(min(n, n_total)):
        # k = number of continuation bytes ending at p (run backwards)
        k = 0
        while k < 3 and p - k >= 1 and is_cont[p - k]:
            k += 1
        lead_pos = p - k
        if is_cont[lead_pos]:
            continue  # run longer than 3: never a char end
        lead = int(b[lead_pos])
        if _utf8_len_of_lead(lead) != k + 1:
            continue  # truncated/overlong position: not a char end
        if k == 0:
            cp = lead
        elif k == 1:
            cp = ((lead & 0x1F) << 6) | (int(b[p]) & 0x3F)
        elif k == 2:
            cp = ((lead & 0x0F) << 12) | ((int(b[p - 1]) & 0x3F) << 6) | (
                int(b[p]) & 0x3F
            )
        else:
            cp = (
                ((lead & 0x07) << 18)
                | ((int(b[p - 2]) & 0x3F) << 12)
                | ((int(b[p - 1]) & 0x3F) << 6)
                | (int(b[p]) & 0x3F)
            )
        if k:  # as the device kernels: overlong forms read 0x80's class
            cp = min(max(cp, 0x80), 0x10FFFF)
        out[p] = class_of_cp_tables(tables, cp)
    out[n_total:] = tables.eof_class
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version (B2 of the scan_rows kernel)
# ---------------------------------------------------------------------------


def na_cap(L: int, na_frac: int) -> int:
    """Per-row cap on non-ASCII char ends (the JAX kernel's compaction
    width): 2-byte chars bound the density at 1/2, so na_frac <= 2 can
    never overflow."""
    if na_frac <= 2:
        return L // 2 + 1
    return max(8, -(-L // na_frac))


def lookup_class(page_entry: torch.Tensor, mixed_rows: torch.Tensor,
                 cp: torch.Tensor) -> torch.Tensor:
    """Two-level page/mixed class lookup of int64 codepoints."""
    e = page_entry[cp >> PAGE_BITS].to(torch.int64)
    mixed = (e & MIXED_FLAG) != 0
    idx = torch.where(mixed, e & (MIXED_FLAG - 1), 0)
    m = mixed_rows[idx, cp & ((1 << PAGE_BITS) - 1)].to(torch.int64)
    return torch.where(mixed, m, e)


def byte_classes(page_entry: torch.Tensor, mixed_rows: torch.Tensor,
                 rows: torch.Tensor, n_total: torch.Tensor, *, skip_class: int,
                 cont_class: int, eof_class: int, na_frac: int):
    """(rows [B, L] u8, n_total [B] i32) -> (classes [B, L] int32,
    na_overflow bool scalar tensor). Same output as the JAX
    ``make_byte_classes_fn`` on the same inputs."""
    B, L = rows.shape
    dev = rows.device
    b = rows.to(torch.int64)
    z = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    b1 = torch.cat([z, b[:, :-1]], dim=1)  # byte at p-1
    b2 = torch.cat([z, b1[:, :-1]], dim=1)
    b3 = torch.cat([z, b2[:, :-1]], dim=1)
    cont = (b & 0xC0) == 0x80
    cont1 = (b1 & 0xC0) == 0x80
    cont2 = (b2 & 0xC0) == 0x80
    cont3 = (b3 & 0xC0) == 0x80
    # continuation run length ending at p (4 = longer than any char)
    k = torch.where(
        cont,
        torch.where(cont1, torch.where(cont2, torch.where(cont3, 4, 3), 2), 1),
        0,
    )
    lead = torch.where(k == 0, b, torch.where(k == 1, b1, torch.where(k == 2, b2, b3)))
    explen = torch.where(
        lead < 0x80, 1,
        torch.where(
            (lead >= 0xC2) & (lead <= 0xDF), 2,
            torch.where((lead >= 0xE0) & (lead <= 0xEF), 3,
                        torch.where((lead >= 0xF0) & (lead <= 0xF4), 4, 0)),
        ),
    )
    char_end = (explen == k + 1) & (k < 4)
    cp = torch.where(
        k == 1, ((lead & 0x1F) << 6) | (b & 0x3F),
        torch.where(
            k == 2,
            ((lead & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b & 0x3F),
            ((lead & 0x07) << 18) | ((b2 & 0x3F) << 12)
            | ((b1 & 0x3F) << 6) | (b & 0x3F),
        ),
    )
    # non-ASCII char ends look up clip(cp, 0x80, 0x10FFFF) (overlong
    # encodings of ASCII read 0x80's class), ASCII ones their byte
    cp = torch.where(cont, cp.clamp(0x80, 0x10FFFF), b & 0x7F)
    cls = lookup_class(page_entry, mixed_rows, cp)

    pos = torch.arange(L, device=dev)[None, :]
    na = char_end & cont & (pos < n_total[:, None])
    cap = na_cap(L, na_frac)
    rank = torch.cumsum(na.to(torch.int32), dim=1) - 1
    na_overflow = (rank[:, -1] + 1 > cap).any()
    cls = torch.where(cont & (rank >= cap), 0, cls)
    out = torch.where(
        char_end, cls,
        torch.where(cont, cont_class, skip_class),
    )
    out = torch.where(pos >= n_total[:, None], eof_class, out)
    return out.to(torch.int32), na_overflow
