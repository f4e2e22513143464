#!/usr/bin/env python3
"""The most steps the char-DFA walk can take over a row, and a row that takes them.

    python3 scripts/scan_step_bound.py [--n 80,272,304] [--patterns r50k,cl100k,o200k]

The scans stop a row's walk after 3 * (KL + 2) steps (``sweep_scan.walk_numpy``,
the plain versions and the kernels) and call the row bad; the JAX kernel checks
the same cap only between unrolled bodies (4 steps on the CPU, 24 on the TPU),
so a row that needs a few steps more than the cap is bad in the port and may be
finished in JAX. For each pattern and row length n this script computes the
most steps that any row of n bytes of UTF-8 text can take (whole chars, then
perhaps the first bytes of a cut one), when the whole row is payload, and a
row of whole chars that takes them. It runs on the CPU in about 15 seconds.

How. A walk reads a piece from its start until the DFA dies, then restarts at
the piece's last accept end, so a byte is read by the piece that holds it and
again by every earlier piece whose run reads past its own end to reach it.
Reading a row left to right, the runs still alive form a chain: the current
piece, the run that would start at that piece's last accept end so far, that
run's own successor, and so on. A run that fires again discards the runs after
it and starts a new successor. Which runs will really be walked is known only
later, so the program guesses, at each successor's start, whether it is real
("counted") and forbids any run to fire while a counted run follows it: the
counted reads are then exactly the walk's steps, and the best guess gives the
maximum. The chains reachable from the start are few (tens), so a dynamic
program over (bytes used, chain), with each char's class and UTF-8 length,
gives the most steps for every n. A row may end in up to 3 bytes of a cut
char (every live run reads them and holds); a char past the non-ASCII cap
reads class 0, which no codepoint has and on which every run dies.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tiktoken_tpu_torch.ops import charclass, regex_compiler, sweep_scan  # noqa: E402
from tiktoken_tpu_torch.patterns import cl100k_pat_str, o200k_pat_str  # noqa: E402

R50K_PAT_STR = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
PATTERNS = {"r50k": R50K_PAT_STR, "cl100k": cl100k_pat_str, "o200k": o200k_pat_str}
DEAD, START = sweep_scan.DEAD, sweep_scan.START
NEG = -(1 << 40)

# a run of the chain: (DFA state, or -1 once dead; has fired past its start;
# has read a char; counted)
Run = tuple[int, bool, bool, bool]


def char_tables(pat: str) -> charclass.CharClassTables:
    return charclass.build_char_class_tables(regex_compiler.compile_pattern_chars(pat))


def class_chars(t: charclass.CharClassTables) -> dict[tuple[int, int], int]:
    """{(class, UTF-8 length): a codepoint of that class and length}."""
    cps = np.arange(0x110000)
    cps = cps[(cps < 0xD800) | (cps > 0xDFFF)]
    e = t.page_entry[cps >> 7]
    mixed = (e & charclass.MIXED_FLAG) != 0
    cls = np.where(mixed, t.mixed_rows[e & (charclass.MIXED_FLAG - 1), cps & 127], e)
    lens = 1 + (cps >= 0x80) + (cps >= 0x800) + (cps >= 0x10000)
    keys, first = np.unique(cls.astype(np.int64) * 8 + lens, return_index=True)
    return {(int(k) >> 3, int(k) & 7): int(cps[i]) for k, i in zip(keys, first)}


def advance(chain: tuple[Run, ...], c: int, trans: np.ndarray, accept: np.ndarray
            ) -> list[tuple[tuple[Run, ...] | None, int]]:
    """Every way one char of class ``c`` moves the chain: (the next chain, or
    None once the walk has ended, the counted runs that read the char)."""
    out: list[tuple[tuple[Run, ...] | None, int]] = []

    def go(i: int, done: list[Run], reads: int, todo: list[Run]) -> None:
        if i == len(todo):
            while done and done[0][0] < 0:  # the front piece died
                if not done[0][1]:
                    out.append((None, reads))  # without progress: the walk ends
                    return
                done = done[1:]
            out.append((tuple(done), reads))
            return
        s, fired, started, counted = todo[i]
        if s < 0:
            go(i + 1, done + [todo[i]], reads, todo)
            return
        reads += counted
        n = int(trans[s, c])
        if n == DEAD:
            go(i + 1, done + [(-1, fired, True, counted)], reads, todo)
            return
        rew = int(accept[n])
        if rew < 0:
            go(i + 1, done + [(n, fired, True, counted)], reads, todo)
            return
        # fires: the runs after this one are discarded, so none may be counted
        if any(r[3] for r in todo[i + 1:]):
            return
        if rew == 1 and not started:  # the accept end is the run's own start
            go(i + 1, done + [(n, fired, True, counted)], reads, todo[: i + 1])
            return
        for real in (False, True) if counted else (False,):
            succ = (START, False, False, real)
            if rew == 1:  # the successor starts at this char and reads it
                go(i + 1, done + [(n, True, True, counted)], reads, todo[: i + 1] + [succ])
            else:
                go(i + 1, done + [(n, True, True, counted), succ], reads, todo[: i + 1])

    go(0, [], 0, list(chain))
    return out


class StepBound:
    """The dynamic program for one pattern up to rows of ``n_max`` bytes."""

    def __init__(self, t: charclass.CharClassTables, n_max: int):
        trans, accept = t.trans, t.accept
        self.chars = {k: cp for k, cp in class_chars(t).items() if k[0] != t.eof_class}
        # class 0 has no codepoint: it is what a char past the non-ASCII cap reads
        pairs = sorted(self.chars) + [(0, n) for n in (2, 3, 4) if (0, n) not in self.chars]
        classes = sorted({c for c, _ in pairs})
        chains: list[tuple[Run, ...]] = [((START, False, False, True),)]
        index = {chains[0]: 0}
        moves: dict[tuple[int, int], list[tuple[int, int]]] = {}
        k = 0
        while k < len(chains):
            for c in classes:
                for nxt, reads in advance(chains[k], c, trans, accept):
                    if nxt is not None and nxt not in index:
                        index[nxt] = len(chains)
                        chains.append(nxt)
                    moves.setdefault((k, c), []).append(
                        (-1 if nxt is None else index[nxt], reads))
            k += 1
        self.n_chains = len(chains)
        # the row's end: the bytes of a cut char, which every counted live run
        # reads and holds on, then EOF, where every live run dies. A run that
        # fires there finishes the walk, so no counted run may follow it; with
        # no cut char, a successor not started yet would start at the end and
        # is never walked.
        def eof_ok(ch: tuple[Run, ...]) -> bool:
            fires = [r[0] >= 0 and trans[r[0], t.eof_class] != DEAD
                     and accept[trans[r[0], t.eof_class]] >= 0 for r in ch]
            return not any(f and any(r[3] for r in ch[i + 1:]) for i, f in enumerate(fires))

        ok = np.array([eof_ok(ch) for ch in chains])
        live = np.array([sum(r[0] >= 0 and r[3] for r in ch) for ch in chains])
        started = np.array([sum(r[0] >= 0 and r[3] and r[2] for r in ch) for ch in chains])
        best = np.full((n_max + 1, len(chains)), NEG, np.int64)
        best[0, 0] = 0
        ended = np.full(n_max + 1, NEG, np.int64)  # walks that ended before the row's end
        self.parent: dict[tuple[int, int], tuple[int, int, tuple[int, int]]] = {}
        for b in range(n_max + 1):
            for ci in np.nonzero(best[b] > NEG)[0].tolist():
                v = int(best[b, ci])
                for c, n in pairs:
                    if b + n > n_max:
                        continue
                    for nci, reads in moves.get((ci, c), ()):
                        val = v + reads * n
                        if nci < 0:
                            if val > ended[b + n]:
                                ended[b + n] = val
                        elif val > best[b + n, nci]:
                            best[b + n, nci] = val
                            self.parent[(b + n, nci)] = (b, ci, (c, n))
        self.best, self.at_end = best, np.where(ok, started, NEG)
        most = np.full(n_max + 1, NEG, np.int64)
        for n in range(n_max + 1):
            most[n] = (best[n] + self.at_end).max()
            for cut in range(1, min(3, n) + 1):
                most[n] = max(most[n], (best[n - cut] + np.where(ok, live * (cut + 1), NEG)).max())
        self.most = np.maximum(most, np.maximum.accumulate(ended))

    def row(self, n: int) -> tuple[bytes, int]:
        """A row of n bytes of whole chars that takes the most steps such
        rows can take, and those steps."""
        total = self.best[n] + self.at_end
        ci = int(np.argmax(total))
        steps = int(total[ci])
        out: list[str] = []
        b = n
        while b > 0:
            b, ci, key = self.parent[(b, ci)]
            out.append(chr(self.chars[key]))
        return "".join(reversed(out)).encode(), steps


def walk_steps_of(t: charclass.CharClassTables, row: bytes) -> int:
    """The plain walk's steps over the whole row, with no cap in reach."""
    st = sweep_scan.scan_tables(t, sweep_scan.build_scan_consts(t), torch.device("cpu"))
    n = len(row)
    grid = np.zeros((1, 4 * n + 8), np.uint8)
    grid[0, :n] = np.frombuffer(row, np.uint8)
    tot = torch.tensor([n], dtype=torch.int32)
    cls, _ = sweep_scan.row_classes(st, torch.from_numpy(grid), tot, 2)
    return int(sweep_scan.walk_steps(st, cls, tot, tot)[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", default="80,272,304", help="row lengths (KL) to report")
    ap.add_argument("--patterns", default=",".join(PATTERNS))
    a = ap.parse_args()
    ns = [int(x) for x in a.n.split(",")]
    for name in a.patterns.split(","):
        t = char_tables(PATTERNS[name])
        sb = StepBound(t, max(ns))
        n = np.arange(len(sb.most))
        over = np.nonzero(sb.most > 3 * (n + 2))[0]
        if len(over):
            print(f"{name}: {sb.n_chains} chains; the most steps pass the cap 3 * (n + 2) from "
                  f"n = {int(over[0])} bytes", flush=True)
        else:
            print(f"{name}: {sb.n_chains} chains; the most steps stay within 3 * n + "
                  f"{int((sb.most - 3 * n)[1:].max())} for n <= {max(ns)}, below the cap "
                  "3 * (n + 2)", flush=True)
        for m in ns:
            row, steps = sb.row(m)
            print(f"  n={m}: at most {int(sb.most[m])} steps, cap {3 * (m + 2)}; of whole "
                  f"chars at most {steps}, and this row takes {walk_steps_of(t, row)}: "
                  f"{row.decode()!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
