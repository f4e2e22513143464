"""The byte-level scanners of the v2 and v1 programs (the ``byte_scan``
kernel).

Three functions, each the counterpart of a JAX device function, with its
contract (reference: src/lib.rs:363-365 find_iter semantics; host spec
``regex_compiler.scan_classes``):

- ``seq_scan`` (v2): the reference's maximal-munch loop per row from
  offset 0, over a byte-indexed packed table; piece starts and the rows
  it could not finish;
- ``window_scan`` (v1): for every grid position, the end of the match that
  would start there, found within ``window`` bytes (a relative hop), and
  whether it is still unresolved; past ``u_cap`` positions alive after
  FIRST_WINDOW bytes, every position is unresolved;
- ``orbit`` (v1): the piece starts of each row, the chain 0, f(0), ... of
  f(p) = p + hop[p], and the rows the device cannot resolve exactly;
- ``window_orbit`` (v1): the two, as the kernel runs them in one launch.

Tables: ``pack_trans_accept`` fuses the next state and its accept rewind
into one int32 per (state, class); ``expand_packed_to_bytes`` indexes it
by byte (column 256 = EOF), so the class lookup disappears;
``hot_byte_scan_table`` renumbers its states so that those an ASCII scan
visits come first (the kernels keep their rows in shared memory). The
scans' outputs do not depend on the numbering. Both the v2
and the v1 program of the port scan that byte-indexed table straight from
the row bytes, the class being the byte or 256 (EOF) at and past
``n_total`` and past the row (the v1 JAX program uses the class-indexed
table and ``class_of``: the same values).

This module holds the numpy specs and the plain PyTorch versions; the
kernel is csrc/byte_scan.cu.
"""

from __future__ import annotations

import numpy as np
import torch

from tiktoken_tpu_torch.ops.regex_compiler import ScannerDFA

DEFAULT_WINDOW = 48
FIRST_WINDOW = 16
ACC_BITS = 5  # accept rewind in [-1, MAX_REWIND=15] -> 5 bits
START = ScannerDFA.START
DEAD = ScannerDFA.DEAD


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def pack_trans_accept(trans: np.ndarray, accept: np.ndarray) -> np.ndarray:
    """packed[s, c] = next_state << 5 | (accept[next_state] + 1): one
    table read per scanned byte instead of two."""
    nxt = trans.astype(np.int64)
    a = accept.astype(np.int64)[nxt] + 1
    assert a.min() >= 0 and a.max() < (1 << ACC_BITS)
    packed = (nxt << ACC_BITS) | a
    assert packed.max() < 2**31
    return packed.astype(np.int32)


def expand_packed_to_bytes(packed: np.ndarray, class_of: np.ndarray) -> np.ndarray:
    """[S, 257] byte-indexed transition table (column 256 = EOF)."""
    return np.ascontiguousarray(packed[:, class_of.astype(np.int64)])


def byte_scan_table(dfa: ScannerDFA) -> np.ndarray:
    """The [S, 257] int32 byte-indexed table of ``dfa``."""
    return expand_packed_to_bytes(pack_trans_accept(dfa.trans, dfa.accept), dfa.class_of)


def hot_byte_scan_table(dfa: ScannerDFA) -> tuple[np.ndarray, int]:
    """The table both scanners of the port read: ``byte_scan_table`` with
    its states renumbered so that DEAD (0), START (1) and every state
    reachable from START on ASCII bytes come first, in breadth-first order.
    -> (table [S, 257] int32, H): the first H states are closed under the
    bytes 0..127, so a scan of ASCII text reads only their rows."""
    table = byte_scan_table(dfa).astype(np.int64)
    nxt = table >> ACC_BITS
    order, seen = [DEAD, START], {DEAD, START}
    i = 1
    while i < len(order):
        for s2 in np.unique(nxt[order[i], :128]).tolist():
            if s2 not in seen:
                seen.add(s2)
                order.append(s2)
        i += 1
    H = len(order)
    order += [s for s in range(table.shape[0]) if s not in seen]
    new_of = np.empty(table.shape[0], np.int64)
    new_of[order] = np.arange(table.shape[0])
    rows = table[order]
    out = (new_of[rows >> ACC_BITS] << ACC_BITS) | (rows & ((1 << ACC_BITS) - 1))
    return np.ascontiguousarray(out.astype(np.int32)), H


# ---------------------------------------------------------------------------
# numpy specs (one row)
# ---------------------------------------------------------------------------


def match_ends_numpy(dfa: ScannerDFA, classes: np.ndarray, window: int):
    """E[p] (relative hop, 0 if no match) and unresolved[p] for every
    start position, scanning at most ``window`` classes. ``classes`` must
    already contain the EOF class at end-of-text positions."""
    n = len(classes)
    trans = dfa.trans.astype(np.int64)
    accept = dfa.accept.astype(np.int64)
    state = np.full(n, START, dtype=np.int64)
    hop = np.zeros(n, dtype=np.int64)
    alive = np.ones(n, dtype=bool)
    for o in range(window):
        cls = np.empty(n, dtype=np.int64)
        if o < n:
            cls[: n - o] = classes[o:]
        cls[max(0, n - o):] = classes[-1]  # trailing EOF padding
        state = np.where(alive, trans[state, cls], state)
        alive &= state != DEAD
        a = accept[state]
        took = alive & (a >= 0)
        hop = np.where(took, o + 1 - a, hop)
    return hop, alive


def piece_starts_numpy(dfa: ScannerDFA, data: bytes, window: int = DEFAULT_WINDOW) -> list[int]:
    """Host validation path (window scan + orbit, widening the window
    until every match resolves): agrees with ``regex_compiler.scan_bytes``."""
    if not data:
        return []
    classes = np.concatenate([
        dfa.class_of[np.frombuffer(data, dtype=np.uint8)].astype(np.int64),
        [int(dfa.class_of[256])],
    ])
    w = window
    while True:
        hop, unresolved = match_ends_numpy(dfa, classes, w)
        starts = []
        p = 0
        ok = True
        while p < len(data):
            starts.append(p)
            if unresolved[p]:
                ok = False
                break
            if hop[p] <= 0:
                raise ValueError(f"no match at offset {p}: invalid input")
            p += int(hop[p])
        if ok:
            return starts
        if w >= len(classes) + 2:
            raise RuntimeError("window covers whole text but match unresolved")
        w = min(w * 4, len(classes) + 2)


def seq_scan_numpy(dfa: ScannerDFA, packed, classes_ext, n_payload, n_total, K):
    """numpy spec of ``seq_scan`` for one row: (piece_start [K], bad)."""
    cls = classes_ext
    n = int(n_payload)
    flat = np.asarray(packed).reshape(-1)
    nc = np.asarray(packed).shape[1]
    starts = []
    bad = False
    i = 0
    while i < n:
        starts.append(i)
        s = START
        last_end = -1
        p = i
        while True:
            c = int(cls[min(p, len(cls) - 1)])
            v = int(flat[s * nc + c])
            s = v >> ACC_BITS
            a = (v & ((1 << ACC_BITS) - 1)) - 1
            if s != DEAD and a >= 0:
                last_end = p + 1 - a
            if s == DEAD or p >= int(n_total):
                break
            p += 1
        if last_end <= i:
            bad = True
            break
        i = last_end
    mask = np.zeros(K, bool)
    for st in starts:
        if st < K:
            mask[st] = True
    return mask, bad


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def byte_class_grid(rows: torch.Tensor, n_total: torch.Tensor, width: int) -> torch.Tensor:
    """[C, width] int32 classes of the byte-indexed table: the byte, or
    256 (EOF) at and past ``n_total`` and past the row."""
    C, KL = rows.shape
    col = torch.arange(width, device=rows.device)[None, :]
    byte = torch.zeros((C, width), dtype=torch.int32, device=rows.device)
    byte[:, : min(KL, width)] = rows[:, :width].to(torch.int32)
    return torch.where((col >= n_total[:, None]) | (col >= KL), 256, byte).to(torch.int32)


def seq_scan(packed: torch.Tensor, rows: torch.Tensor, n_payload: torch.Tensor,
             n_total: torch.Tensor, *, K: int, hot: int = 0):
    """B9. (packed [S, 257] i32, rows [C, KL] u8, n_payload, n_total [C]
    i32) -> (piece_start [C, K] bool, row_bad [C] bool). The scanned
    classes are ``byte_class_grid(rows, n_total, KL + 1)``: the JAX
    kernel's classes_ext, EOF at and past n_total and in column KL.
    ``hot``, the kernel's count of shared-memory states, changes nothing
    here.

    Rows step in lockstep, one byte (or one restart) per step: a death
    resolves the match at its last accept end; a start is marked where it
    lies below n_payload; a match that makes no progress marks its row
    bad unless the row is finished; a row still unfinished after
    3*(KL+2) steps is bad."""
    mask, bad, _ = seq_walk(packed, rows, n_payload, n_total, K=K)
    return mask, bad


def seq_walk(packed: torch.Tensor, rows: torch.Tensor, n_payload: torch.Tensor,
             n_total: torch.Tensor, *, K: int):
    """``seq_scan`` with each row's walk steps: (piece_start, row_bad,
    steps [C] i32), a step being one byte or one restart."""
    C, KL = rows.shape
    classes_ext = byte_class_grid(rows, n_total, KL + 1)
    nc = packed.shape[1]
    dev = rows.device
    flat_t = packed.reshape(-1)
    acc_mask = (1 << ACC_BITS) - 1
    i32 = torch.int32
    p = torch.zeros(C, dtype=i32, device=dev)
    s = torch.full((C,), START, dtype=i32, device=dev)
    mstart = torch.zeros(C, dtype=i32, device=dev)
    lend = torch.full((C,), -1, dtype=i32, device=dev)
    mask = torch.zeros((C, K), dtype=torch.bool, device=dev)
    bad = torch.zeros(C, dtype=torch.bool, device=dev)
    done = n_payload <= 0
    steps = torch.zeros(C, dtype=i32, device=dev)
    rows_i = torch.arange(C, device=dev)
    it = 0
    while it < 3 * (KL + 2) and not bool(done.all()):
        steps += (~done).to(i32)
        cls = classes_ext.gather(1, p.clamp(max=KL).to(torch.int64)[:, None])[:, 0]
        v = flat_t[(s.to(torch.int64) * nc + cls)]
        s2 = v >> ACC_BITS
        a = (v & acc_mask) - 1
        consumed_eof = p >= n_total
        fired = (s2 != DEAD) & (a >= 0)
        lend2 = torch.where(fired, p + 1 - a, lend)
        died = (s2 == DEAD) | consumed_eof
        no_progress = died & (lend2 <= mstart)
        new_start = torch.where(died, lend2, mstart)
        mark = died & ~done & (mstart < n_payload)
        col = mstart.clamp(0, K - 1).to(torch.int64)
        mask[rows_i[mark], col[mark]] = True
        finished = new_start >= n_payload
        bad = bad | (no_progress & ~done & ~finished)
        done2 = done | (died & (finished | no_progress))
        p = torch.where(done2, p, torch.where(died, lend2, p + 1))
        s = torch.where(died, START, s2)
        lend = torch.where(died, -1, lend2)
        mstart = new_start
        done = done2
        it += 1
    return mask, bad | ~done, steps


def window_scan(packed: torch.Tensor, rows: torch.Tensor, n_total: torch.Tensor, *, K: int,
                window: int = DEFAULT_WINDOW):
    """B11. (packed [S, 257] i32, rows [C, KL] u8, n_total [C] i32) ->
    (hop [C, K] i32, unresolved [C, K] bool) for the positions 0..K-1,
    scanning ``byte_class_grid(rows, n_total, K + window)``.

    hop[p] is the single-sweep maximal-munch hop: the last accept end
    within ``window`` bytes, relative to p (0 if none). A position whose
    match is still alive after ``window`` bytes is unresolved. When more
    than u_cap = max(128, N // 32) positions are still alive after
    FIRST_WINDOW bytes (the JAX kernel's phase-2 capacity), every
    position is unresolved, so the v1 row flags equal the JAX program's."""
    C = rows.shape[0]
    classes = byte_class_grid(rows, n_total, K + window)
    N = C * K
    nc = packed.shape[1]
    dev = rows.device
    flat_t = packed.reshape(-1)
    acc_mask = (1 << ACC_BITS) - 1
    w1 = min(FIRST_WINDOW, window)
    state = torch.full((C, K), START, dtype=torch.int32, device=dev)
    hop = torch.zeros((C, K), dtype=torch.int32, device=dev)
    alive = torch.ones((C, K), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for o in range(window):
        v = flat_t[state.to(torch.int64) * nc + classes[:, o : o + K]]
        state = torch.where(alive, v >> ACC_BITS, state)
        alive = alive & (state != DEAD)
        a = (v & acc_mask) - 1
        hop = torch.where(alive & (a >= 0), o + 1 - a, hop)
        if o == w1 - 1 and w1 < window:
            overflow = alive.sum() > max(128, N // 32)
    return hop, alive | overflow


def orbit(hop: torch.Tensor, unresolved: torch.Tensor, valid_len: torch.Tensor):
    """B12. (hop [C, K] i32, unresolved [C, K] bool, valid_len [C] i32)
    -> (piece_start [C, K] bool, row_bad [C] bool).

    piece_start is the orbit of 0 under p -> p + hop[p] below valid_len (a
    hop <= 0 ends the chain); a row is bad where one of its piece starts
    is unresolved or has no match."""
    C, K = hop.shape
    dev = hop.device
    rows_i = torch.arange(C, device=dev)
    mask = torch.zeros((C, K), dtype=torch.bool, device=dev)
    cur = torch.zeros(C, dtype=torch.int64, device=dev)
    done = valid_len <= 0
    while not bool(done.all()):
        live = ~done
        mask[rows_i[live], cur[live]] = True
        h = hop[rows_i, cur.clamp(max=K - 1)].to(torch.int64)
        nxt = torch.where(h > 0, cur + h, K)
        done = done | (nxt >= valid_len)
        cur = nxt.clamp(max=K - 1)
    row_bad = (mask & (unresolved | (hop <= 0))).any(dim=1)
    return mask, row_bad


def window_orbit(packed: torch.Tensor, rows: torch.Tensor, n_payload: torch.Tensor,
                 n_total: torch.Tensor, *, K: int, window: int = DEFAULT_WINDOW, hot: int = 0):
    """B11 + B12 with the v1 row flags (the JAX ``build_pipeline_fn``):
    ``window_scan`` of the rows, then ``orbit`` of its hops below
    n_payload. -> (piece_start [C, K] bool, row_bad [C] bool). ``hot``, the
    kernel's count of shared-memory states, changes nothing here."""
    hop, unresolved = window_scan(packed, rows, n_total, K=K, window=window)
    return orbit(hop, unresolved, n_payload)
