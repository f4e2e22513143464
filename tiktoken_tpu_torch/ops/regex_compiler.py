"""Compile a split pattern (pat_str) into scanner DFAs (char and byte level).

The reference pre-tokenizes with a backtracking regex engine over unicode
text (reference: src/lib.rs:363-365, patterns in
tiktoken_ext/openai_public.py). The device scanner needs a table-driven
automaton instead. This module performs the offline compilation:

    pat_str --parse--> AST over codepoint classes
            --fold---> case-insensitive groups expanded via case folding
            --nfa----> priority NFA over codepoint-segment ranges (Thompson
                       with *ordered* epsilon edges: alternation order and
                       greedy repetition become thread priority)
            --subset-> DFA whose states are priority-ordered thread lists,
                       truncated at the first accepting thread

Semantics preserved exactly:

- leftmost-first alternation and greedy quantifiers: a thread list in
  priority order simulates the backtracker; when a thread accepts, all
  lower-priority threads are discarded (they can never win), while
  higher-priority threads keep running and may override the recorded
  match later. Possessive quantifiers are compiled as greedy: for these
  patterns they only prune backtracking, never change the match.
- one-character lookahead ``(?!\\S)`` and the end anchor ``$``: compiled
  as *consume-then-rewind*. The allowed next character (or the
  end-of-text sentinel, class EOF) is consumed by the automaton and the
  accept is tagged with a rewind of one char, so acceptance is a pure
  function of the state reached.

Two automata come out of the same parser and NFA builder:

- the char-level one (``compile_pattern_chars``): one transition per
  CHARACTER, over codepoint equivalence classes. It drives the host
  scanner (``scan_codepoints``) and the v3 scan kernel
  (csrc/scan_rows.cu);
- the byte-level one (``compile_pattern``): one transition per UTF-8
  BYTE, the lookahead's bytes consumed and rewound. It drives the v2/v1
  scanners (``ops/window_scan.py``, csrc/byte_scan.cu) and the host
  reference ``scan_bytes``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from tiktoken_tpu_torch.ops import unicode_tables as ut

EOF_SYMBOL = 256  # the byte-level automaton's end-of-text symbol
MAX_REWIND = 15

# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Lit:
    """One character drawn from a codepoint interval set."""

    cps: ut.IntervalSet


@dataclass(frozen=True)
class Seq:
    items: tuple


@dataclass(frozen=True)
class Alt:
    options: tuple


@dataclass(frozen=True)
class Rep:
    item: object
    lo: int
    hi: Optional[int]  # None = unbounded


@dataclass(frozen=True)
class Look:
    """Trailing one-character lookahead: accept iff the next character is
    in ``cps`` (or end-of-text, if ``eof_ok``). ``$`` is Look((), eof only)."""

    cps: ut.IntervalSet
    eof_ok: bool


class PatternError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Parser for the pattern dialect used by the shipped encodings
# ---------------------------------------------------------------------------

_ESCAPE_CHARS = {
    "r": 0x0D, "n": 0x0A, "t": 0x09, "f": 0x0C, "v": 0x0B,
    "\\": 0x5C, "'": 0x27, ".": 0x2E, "+": 0x2B, "*": 0x2A, "?": 0x3F,
    "(": 0x28, ")": 0x29, "[": 0x5B, "]": 0x5D, "{": 0x7B, "}": 0x7D,
    "|": 0x7C, "^": 0x5E, "$": 0x24, "/": 0x2F, "-": 0x2D, " ": 0x20,
}


class _Parser:
    def __init__(self, pattern: str):
        self.pat = pattern
        self.pos = 0

    # -- low-level ----------------------------------------------------------

    def _peek(self) -> str:
        return self.pat[self.pos] if self.pos < len(self.pat) else ""

    def _take(self) -> str:
        ch = self.pat[self.pos]
        self.pos += 1
        return ch

    def _expect(self, ch: str) -> None:
        if self._peek() != ch:
            raise PatternError(f"expected {ch!r} at {self.pos} in {self.pat!r}")
        self.pos += 1

    # -- grammar --------------------------------------------------------------

    def parse(self) -> Alt:
        alt = self._alternation(case_insensitive=False, top=True)
        if self.pos != len(self.pat):
            raise PatternError(f"trailing input at {self.pos}")
        return alt

    def _alternation(self, case_insensitive: bool, top: bool = False) -> Alt:
        options = [self._sequence(case_insensitive, top)]
        while self._peek() == "|":
            self._take()
            options.append(self._sequence(case_insensitive, top))
        return Alt(tuple(options))

    def _sequence(self, ci: bool, top: bool) -> Seq:
        items: list = []
        while True:
            ch = self._peek()
            if ch in ("", "|") or ch == ")":
                break
            item = self._atom(ci, top)
            item = self._quantified(item)
            items.append(item)
        # Lookaheads and anchors are only supported in tail position of a
        # top-level alternative (all the shipped patterns satisfy this).
        for i, it in enumerate(items):
            if isinstance(it, Look) and (not top or i != len(items) - 1):
                raise PatternError("lookahead/anchor must end a top-level alternative")
        return Seq(tuple(items))

    def _atom(self, ci: bool, top: bool):
        ch = self._take()
        if ch == "(":
            if self._peek() != "?":
                raise PatternError("capturing groups are not supported")
            self._take()
            mod = self._take()
            if mod == ":":
                inner = self._alternation(ci)
                self._expect(")")
                return inner
            if mod == "i":
                self._expect(":")
                inner = self._alternation(True)
                self._expect(")")
                return inner
            if mod == "!":
                neg = self._single_class(ci)
                self._expect(")")
                # (?!X) at tail position: next char must NOT be in X, or
                # text must end.
                return Look(ut.negate(neg), eof_ok=True)
            if mod == "=":
                pos_cls = self._single_class(ci)
                self._expect(")")
                return Look(pos_cls, eof_ok=False)
            raise PatternError(f"unsupported group (?{mod}")
        if ch == "$":
            return Look((), eof_ok=True)
        if ch == "[":
            return Lit(self._char_class(ci))
        if ch == "\\":
            return Lit(self._escape_class(self._take(), ci))
        if ch == ".":
            return Lit(ut.dot_set())
        if ch in "*+?{":
            raise PatternError(f"dangling quantifier {ch!r}")
        return Lit(self._literal(ord(ch), ci))

    def _single_class(self, ci: bool) -> ut.IntervalSet:
        ch = self._take()
        if ch == "\\":
            return self._escape_class(self._take(), ci)
        if ch == "[":
            return self._char_class(ci)
        if ch == ".":
            return ut.dot_set()
        return self._literal(ord(ch), ci)

    def _literal(self, cp: int, ci: bool) -> ut.IntervalSet:
        base: ut.IntervalSet = ((cp, cp),)
        return ut.case_fold_class(base) if ci else base

    def _escape_class(self, esc: str, ci: bool) -> ut.IntervalSet:
        if esc == "s":
            return ut.white_space_set()
        if esc == "S":
            return ut.negate(ut.white_space_set())
        if esc == "p":
            self._expect("{")
            name = ""
            while self._peek() != "}":
                name += self._take()
            self._take()
            return ut.category_set(name)
        if esc in _ESCAPE_CHARS:
            return self._literal(_ESCAPE_CHARS[esc], ci)
        if esc == "d":
            return ut.category_set("Nd")
        if esc == "D":
            return ut.negate(ut.category_set("Nd"))
        if esc == "w":
            return ut.word_set()
        if esc == "W":
            return ut.negate(ut.word_set())
        raise PatternError(f"unsupported escape \\{esc}")

    def _char_class(self, ci: bool) -> ut.IntervalSet:
        negated = False
        if self._peek() == "^":
            self._take()
            negated = True
        parts: list[ut.IntervalSet] = []
        while True:
            ch = self._take()
            if ch == "]":
                break
            if ch == "\\":
                cls = self._escape_class(self._take(), False)
                parts.append(cls)
                continue
            lo = ord(ch)
            if self._peek() == "-" and self.pos + 1 < len(self.pat) and self.pat[self.pos + 1] != "]":
                self._take()
                hi_ch = self._take()
                hi = _ESCAPE_CHARS[self._take()] if hi_ch == "\\" else ord(hi_ch)
                parts.append(((lo, hi),))
            else:
                parts.append(((lo, lo),))
        merged = ut.union(*parts) if parts else ()
        if negated:
            merged = ut.negate(merged)
        return ut.case_fold_class(merged) if ci else merged

    def _quantified(self, item):
        ch = self._peek()
        if not ch or ch not in "*+?{":
            return item
        if isinstance(item, Look):
            raise PatternError("cannot quantify a lookahead")
        self._take()
        if ch == "*":
            rep = Rep(item, 0, None)
        elif ch == "+":
            rep = Rep(item, 1, None)
        elif ch == "?":
            rep = Rep(item, 0, 1)
        else:  # {m,n} / {m,} / {m}
            digits = ""
            while self._peek() not in ",}":
                digits += self._take()
            lo = int(digits)
            hi: Optional[int] = lo
            if self._peek() == ",":
                self._take()
                digits = ""
                while self._peek() != "}":
                    digits += self._take()
                hi = int(digits) if digits else None
            self._expect("}")
            rep = Rep(item, lo, hi)
        # Possessive suffix: compiled as greedy (for these patterns the
        # match is identical; possessiveness only prunes backtracking).
        if self._peek() == "+":
            self._take()
        elif self._peek() == "?":
            raise PatternError("lazy quantifiers are not supported")
        return rep


def parse_pattern(pat_str: str) -> Alt:
    return _Parser(pat_str).parse()


# ---------------------------------------------------------------------------
# Priority NFA (Thompson construction with ordered epsilon edges)
# ---------------------------------------------------------------------------


@dataclass
class _Nfa:
    # node kinds:
    #   ("byte", lo, hi, target)  consume one symbol in [lo, hi] (or the EOF symbol)
    #   ("eps", [t0, t1, ...])    ordered epsilon fan-out (priority order)
    #   ("accept", rewind)        terminal accept; rewind bytes already consumed
    nodes: list = field(default_factory=list)

    def add(self, node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1


class _Frag:
    """NFA fragment: a start node plus dangling (node, slot) holes to patch."""

    def __init__(self, start: int, holes: list[tuple[int, int]]):
        self.start = start
        self.holes = holes


def _patch(nfa: _Nfa, holes: list[tuple[int, int]], target: int) -> None:
    for node_idx, slot in holes:
        nfa.nodes[node_idx][1][slot] = target


def _frag_for_lit(nfa: _Nfa, lit: Lit, seqs_fn) -> _Frag:
    seqs = seqs_fn(lit.cps)
    if not seqs:
        raise PatternError("empty character class")
    starts: list[int] = []
    holes: list[tuple[int, int]] = []
    for seq in seqs:
        prev_hole: Optional[tuple[int, int]] = None
        first = None
        for blo, bhi in seq:
            node = nfa.add(["byte", [None], blo, bhi])
            if first is None:
                first = node
            if prev_hole is not None:
                nfa.nodes[prev_hole[0]][1][prev_hole[1]] = node
            prev_hole = (node, 0)
        starts.append(first)  # type: ignore[arg-type]
        holes.append(prev_hole)  # type: ignore[arg-type]
    if len(starts) == 1:
        return _Frag(starts[0], holes)
    fan = nfa.add(["eps", list(starts)])
    return _Frag(fan, holes)


def _frag_for_toplevel(nfa: _Nfa, seq: Seq, seqs_fn, look_fn) -> int:
    """Build one top-level alternative: inner fragments chained, terminated
    by an accept (possibly behind a lookahead verifier). Returns the start
    node."""
    items = [it for it in seq.items if not isinstance(it, Look)]
    look = seq.items[-1] if seq.items and isinstance(seq.items[-1], Look) else None
    frags = [_frag_for_inner(nfa, it, seqs_fn) for it in items]
    if not frags:
        raise PatternError("empty sequence alternative")
    for a, b in zip(frags, frags[1:]):
        _patch(nfa, a.holes, b.start)
    tail = look_fn(nfa, look)
    _patch(nfa, frags[-1].holes, tail)
    return frags[0].start


def _frag_for_inner(nfa: _Nfa, node, seqs_fn) -> _Frag:
    """Fragment for a node in non-tail position (no accepts inside)."""
    if isinstance(node, Seq):
        frags = [_frag_for_inner(nfa, it, seqs_fn) for it in node.items]
        if not frags:
            raise PatternError("empty inner sequence")
        for a, b in zip(frags, frags[1:]):
            _patch(nfa, a.holes, b.start)
        return _Frag(frags[0].start, frags[-1].holes)
    if isinstance(node, Alt):
        frags = [_frag_for_inner(nfa, opt, seqs_fn) for opt in node.options]
        fan = nfa.add(["eps", [f.start for f in frags]])
        return _Frag(fan, [h for f in frags for h in f.holes])
    if isinstance(node, Rep):
        return _frag_for_rep(nfa, node, seqs_fn)
    if isinstance(node, Lit):
        return _frag_for_lit(nfa, node, seqs_fn)
    raise PatternError(f"cannot compile inner node {node}")


def _frag_for_rep(nfa: _Nfa, rep: Rep, seqs_fn) -> _Frag:
    # X{lo,hi}: lo mandatory copies, then (hi-lo) optional greedy copies or
    # a greedy star. Greedy = the "one more X" branch outranks exiting.
    frags: list[_Frag] = []
    for _ in range(rep.lo):
        frags.append(_frag_for_inner(nfa, rep.item, seqs_fn))
    holes: list[tuple[int, int]]
    if rep.hi is None:
        # star/plus tail: loop node with [continue, exit] priority order
        loop = nfa.add(["eps", [None, None]])
        body = _frag_for_inner(nfa, rep.item, seqs_fn)
        nfa.nodes[loop][1][0] = body.start
        _patch(nfa, body.holes, loop)
        tail_start = loop
        holes = [(loop, 1)]
        if frags:
            for a, b in zip(frags, frags[1:]):
                _patch(nfa, a.holes, b.start)
            _patch(nfa, frags[-1].holes, tail_start)
            return _Frag(frags[0].start, holes)
        return _Frag(tail_start, holes)
    # bounded: chain of optional copies
    n_opt = rep.hi - rep.lo
    opt_starts: list[int] = []
    opt_holes: list[tuple[int, int]] = []
    prev_exit_holes: list[tuple[int, int]] = []
    first_opt: Optional[int] = None
    for _ in range(n_opt):
        body = _frag_for_inner(nfa, rep.item, seqs_fn)
        choice = nfa.add(["eps", [body.start, None]])  # take X first (greedy)
        if first_opt is None:
            first_opt = choice
        if prev_exit_holes:
            _patch(nfa, prev_exit_holes, choice)
        opt_holes.append((choice, 1))
        prev_exit_holes = body.holes
        opt_starts.append(choice)
    holes = opt_holes + prev_exit_holes
    if frags:
        for a, b in zip(frags, frags[1:]):
            _patch(nfa, a.holes, b.start)
        if first_opt is not None:
            _patch(nfa, frags[-1].holes, first_opt)
            return _Frag(frags[0].start, holes)
        return _Frag(frags[0].start, frags[-1].holes)
    if first_opt is None:
        raise PatternError("empty repetition")
    return _Frag(first_opt, holes)


def _closure(nfa: _Nfa, starts: Iterable[int]) -> tuple[int, ...]:
    """Ordered epsilon closure: DFS in priority order, dedup keep-first,
    truncate after the first accept node (lower-priority threads are dead
    the moment a higher-priority thread accepts)."""
    out: list[int] = []
    seen: set[int] = set()
    stack = list(starts)[::-1]
    while stack:
        n = stack.pop()
        if n in seen:
            continue
        seen.add(n)
        kind = nfa.nodes[n][0]
        if kind == "eps":
            for t in reversed(nfa.nodes[n][1]):
                stack.append(t)
        else:
            out.append(n)
            if kind == "accept":
                break
    return tuple(out)


# ---------------------------------------------------------------------------
# Char-level compilation: the scanner automaton over Unicode scalar values.
# One transition per CHARACTER; accept rewinds are counted in characters
# (never more than one char of lookahead).
# ---------------------------------------------------------------------------


@dataclass
class CharScannerDFA:
    """Scanner DFA over codepoint equivalence classes.

    - ``edges``: ascending codepoint boundaries; codepoint cp belongs to
      segment ``bisect_right(edges, cp) - 1`` (edges[0] == 0,
      edges[-1] == 0x110000).
    - ``seg_class``: [n_segments] segment -> DFA class id.
    - ``eof_class``: the virtual end-of-text symbol's class.
    - ``trans[state, cls]``: next state (0 = dead; 1 = start).
    - ``accept[state]``: -1 if not accepting, else the rewind in chars
      (0 or 1) from the current position to the match end.
    """

    trans: np.ndarray
    accept: np.ndarray
    edges: np.ndarray
    seg_class: np.ndarray
    eof_class: int
    n_states: int
    n_classes: int
    pat_str: str

    START = 1
    DEAD = 0

    def class_of_cp(self, cp: int) -> int:
        return int(self.seg_class[bisect.bisect_right(self.edges, cp) - 1])

    def classes_of_text(self, text: str) -> np.ndarray:
        """[len(text)] class ids, one per character (vectorized
        ``class_of_cp``)."""
        cps = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)
        seg = np.searchsorted(self.edges, cps.astype(np.int64), side="right") - 1
        return self.seg_class[seg]


def _collect_interval_sets(node, out: list) -> None:
    if isinstance(node, Lit):
        out.append(node.cps)
    elif isinstance(node, Look):
        if node.cps:
            out.append(node.cps)
    elif isinstance(node, Seq):
        for it in node.items:
            _collect_interval_sets(it, out)
    elif isinstance(node, Alt):
        for it in node.options:
            _collect_interval_sets(it, out)
    elif isinstance(node, Rep):
        _collect_interval_sets(node.item, out)


def build_nfa(pat_str: str) -> tuple[_Nfa, int, list[int], int]:
    """Priority NFA over codepoint segments. Returns (nfa, start node,
    segment edges, number of symbols); the last symbol is end-of-text."""
    ast = parse_pattern(pat_str)

    sets: list = []
    _collect_interval_sets(ast, sets)
    bounds = {0, 0x110000}
    for s in sets:
        for lo, hi in s:
            bounds.add(lo)
            bounds.add(hi + 1)
    bounds.discard(0x110001)
    edges = sorted(b for b in bounds if b <= 0x110000)
    n_segments = len(edges) - 1
    eof_symbol = n_segments  # one extra symbol for end-of-text

    def seg_ranges(cps) -> list:
        """Each codepoint interval -> one single-symbol 'sequence'."""
        out = []
        for lo, hi in cps:
            c0 = bisect.bisect_right(edges, lo) - 1
            c1 = bisect.bisect_right(edges, hi) - 1
            out.append(((c0, c1),))
        if not out:
            raise PatternError("empty character class")
        return out

    def look_fn(nfa: _Nfa, look):
        if look is None:
            return nfa.add(["accept", 0])
        targets: list[int] = []
        if look.eof_ok:
            acc = nfa.add(["accept", 1])
            targets.append(nfa.add(["byte", [acc], eof_symbol, eof_symbol]))
        if look.cps:
            acc = nfa.add(["accept", 1])
            for (c0, c1), in seg_ranges(look.cps):
                targets.append(nfa.add(["byte", [acc], c0, c1]))
        if not targets:
            raise PatternError("unsatisfiable lookahead")
        if len(targets) == 1:
            return targets[0]
        return nfa.add(["eps", list(targets)])

    nfa = _Nfa()
    option_starts = [
        _frag_for_toplevel(nfa, opt, seg_ranges, look_fn) for opt in ast.options
    ]
    start = nfa.add(["eps", option_starts])
    return nfa, start, edges, n_segments + 1


def compile_pattern_chars(pat_str: str, *, minimize: bool = True) -> CharScannerDFA:
    ut.require_unicode_version()
    nfa, start, edges, n_symbols = build_nfa(pat_str)
    n_segments = n_symbols - 1
    eof_symbol = n_segments

    trans, accept, sym_class = _tables_from_nfa(nfa, start, n_symbols)
    # Column dedup: segments with identical transition columns are one
    # class (e.g. the ~650 \\p{Lu} intervals collapse to one). EOF's
    # column gets a unique tag row so no real codepoint segment can ever
    # merge with it — the scan kernel keys its end-rewind handling on
    # eof_class, and patterns that match every scalar value (e.g. a
    # custom "...|.") would otherwise fold the all-dead surrogate
    # segment into EOF.
    eof_tag = np.zeros((1, trans.shape[1]), trans.dtype)
    eof_tag[0, int(sym_class[eof_symbol])] = 1
    cols, colmap = np.unique(
        np.concatenate([trans, eof_tag], axis=0).T, axis=0, return_inverse=True
    )
    trans = cols[:, :-1].T.astype(trans.dtype)
    sym_class = colmap[sym_class.astype(np.int64)].astype(np.uint16)
    dfa = CharScannerDFA(
        trans=trans,
        accept=accept,
        edges=np.asarray(edges, dtype=np.int64),
        seg_class=sym_class[:n_segments].copy(),
        eof_class=int(sym_class[eof_symbol]),
        n_states=trans.shape[0],
        n_classes=trans.shape[1],
        pat_str=pat_str,
    )
    return minimize_char_dfa(dfa) if minimize else dfa


def _tables_from_nfa(nfa: _Nfa, start: int, n_symbol_space: int, extra_bounds=()):
    """Subset construction over an arbitrary symbol space. Returns
    (trans [S, n_classes], accept [S], class_of_symbol [n_symbol_space]).
    ``extra_bounds`` forces class boundaries (the byte-level EOF symbol is
    always its own class)."""
    bounds = {0, n_symbol_space, *extra_bounds}
    for node in nfa.nodes:
        if node[0] == "byte":
            _, _, lo, hi = node
            bounds.add(lo)
            bounds.add(hi + 1)
    edges = sorted(b for b in bounds if b <= n_symbol_space)
    class_of = np.zeros(n_symbol_space, dtype=np.uint16)
    for cls, (lo, hi) in enumerate(zip(edges, edges[1:])):
        class_of[lo:hi] = cls
    n_classes = len(edges) - 1

    node_cls_range: dict[int, tuple[int, int]] = {}
    for i, node in enumerate(nfa.nodes):
        if node[0] == "byte":
            _, _, lo, hi = node
            c0 = bisect.bisect_right(edges, lo) - 1
            c1 = bisect.bisect_right(edges, hi) - 1
            node_cls_range[i] = (c0, c1)

    closure_cache: dict[tuple[int, ...], tuple[int, ...]] = {}

    def closure(starts: tuple[int, ...]) -> tuple[int, ...]:
        got = closure_cache.get(starts)
        if got is None:
            got = _closure(nfa, starts)
            closure_cache[starts] = got
        return got

    start_state = closure((start,))
    states: dict[tuple[int, ...], int] = {(): 0, start_state: 1}
    order: list[tuple[int, ...]] = [(), start_state]
    trans_rows: list[list[int]] = [[0] * n_classes]
    accepts: list[int] = [-1]

    idx = 1
    while idx < len(order):
        state = order[idx]
        acc = -1
        per_class: list[list[int]] = [[] for _ in range(n_classes)]
        for n in state:
            node = nfa.nodes[n]
            if node[0] == "byte":
                c0, c1 = node_cls_range[n]
                tgt = node[1][0]
                for cls in range(c0, c1 + 1):
                    per_class[cls].append(tgt)
            elif node[0] == "accept":
                acc = node[1]
        if acc > MAX_REWIND:
            raise PatternError(f"rewind {acc} exceeds MAX_REWIND")

        row = [0] * n_classes
        for cls in range(n_classes):
            nxt = per_class[cls]
            if not nxt:
                continue
            closed = closure(tuple(nxt))
            got = states.get(closed)
            if got is None:
                got = len(order)
                states[closed] = got
                order.append(closed)
            row[cls] = got
        trans_rows.append(row)
        accepts.append(acc)
        idx += 1

    n_states = len(order)
    dtype = np.uint16 if n_states < 2**16 else np.uint32
    trans = np.zeros((n_states, n_classes), dtype=dtype)
    for i, row in enumerate(trans_rows):
        trans[i] = row
    accept = np.asarray(accepts, dtype=np.int8)
    return trans, accept, class_of


def minimize_char_dfa(dfa: CharScannerDFA) -> CharScannerDFA:
    """``_moore_minimize`` of a char-level automaton."""
    new_trans, new_accept = _moore_minimize(dfa.trans, dfa.accept)
    return CharScannerDFA(
        trans=new_trans, accept=new_accept, edges=dfa.edges,
        seg_class=dfa.seg_class, eof_class=dfa.eof_class,
        n_states=new_trans.shape[0], n_classes=dfa.n_classes, pat_str=dfa.pat_str,
    )


def _moore_minimize(trans_in: np.ndarray, accept_in: np.ndarray):
    """Moore partition refinement. Valid because scanning semantics depend
    only on (transition, accept-rewind) observations; thread priorities are
    already folded into the tables. States 0 (dead) and 1 (start) keep
    their identities. Returns (trans, accept) of the minimal automaton."""
    trans = trans_in.astype(np.int64)
    accept = accept_in.astype(np.int64)
    n = trans.shape[0]

    # Initial blocks: by accept value, with the dead state forced alone.
    block = accept - accept.min() + 1
    block[0] = 0
    while True:
        # Signature: own block + blocks of all class successors. Refinement
        # never merges blocks, so a stable block count is the fixed point.
        sig = np.concatenate([block[:, None], block[trans]], axis=1)
        _, new_block = np.unique(sig, axis=0, return_inverse=True)
        done = len(np.unique(new_block)) == len(np.unique(block))
        block = new_block
        if done:
            break
    # Renumber: dead block -> 0, start's block -> 1, rest arbitrary.
    n_blocks = len(np.unique(block))
    remap = -np.ones(n_blocks, dtype=np.int64)
    remap[block[0]] = 0
    if block[1] == block[0]:
        raise RuntimeError("start state merged with dead state")
    remap[block[1]] = 1
    nxt = 2
    for b in block:
        if remap[b] < 0:
            remap[b] = nxt
            nxt += 1
    new_ids = remap[block]

    new_trans = np.zeros((n_blocks, trans.shape[1]), dtype=trans_in.dtype)
    new_accept = np.full(n_blocks, -1, dtype=np.int8)
    reps = np.zeros(n_blocks, dtype=np.int64)
    reps[new_ids] = np.arange(n)
    for b in range(n_blocks):
        rep = reps[b]
        new_trans[b] = new_ids[trans[rep]]
        new_accept[b] = accept[rep]
    return new_trans, new_accept


def scan_codepoints(dfa: CharScannerDFA, text: str) -> list[int]:
    """Maximal-munch scan over chars. Returns piece start CHAR offsets."""
    classes = dfa.classes_of_text(text).tolist()
    n = len(classes)
    eof_cls = dfa.eof_class
    trans = dfa.trans.tolist()
    accept = dfa.accept.tolist()
    starts: list[int] = []
    i = 0
    while i < n:
        starts.append(i)
        s = CharScannerDFA.START
        last_end = -1
        p = i
        while True:
            cls = classes[p] if p < n else eof_cls
            p += 1
            s = trans[s][cls]
            if s == CharScannerDFA.DEAD:
                break
            a = accept[s]
            if a >= 0:
                last_end = p - a
            if p > n:
                break
        if last_end <= i:
            raise RuntimeError(
                f"char scanner made no progress at char {i} (pattern {dfa.pat_str!r})"
            )
        i = last_end
    return starts


# ---------------------------------------------------------------------------
# Byte-level compilation: the scanner automaton over raw UTF-8 bytes, for
# the v2 sequential scanner and the v1 window scan. Accept rewinds count
# BYTES: the lookahead character's whole encoding (or the EOF symbol) is
# consumed and rewound.
# ---------------------------------------------------------------------------

_CONT = (0x80, 0xBF)
_LEN_BOUNDS = ((0x00, 0x7F), (0x80, 0x7FF), (0x800, 0xFFFF), (0x10000, 0x10FFFF))


def _enc(cp: int) -> bytes:
    return chr(cp).encode("utf-8")


def _ranges_same_len(a: bytes, b: bytes) -> Iterable[tuple[tuple[int, int], ...]]:
    """Byte-range sequences covering all same-length encodings in [a, b]."""
    n = len(a)
    if n == 1:
        yield ((a[0], b[0]),)
        return
    if a[0] == b[0]:
        for tail in _ranges_same_len(a[1:], b[1:]):
            yield ((a[0], a[0]),) + tail
        return
    lo_suffix_min = bytes([0x80] * (n - 1))
    lo_suffix_max = bytes([0xBF] * (n - 1))
    start, end = a[0], b[0]
    if a[1:] != lo_suffix_min:
        for tail in _ranges_same_len(a[1:], lo_suffix_max):
            yield ((a[0], a[0]),) + tail
        start = a[0] + 1
    top_separate = b[1:] != lo_suffix_max
    mid_end = end - 1 if top_separate else end
    if start <= mid_end:
        yield ((start, mid_end),) + tuple(_CONT for _ in range(n - 1))
    if top_separate:
        for tail in _ranges_same_len(lo_suffix_min, b[1:]):
            yield ((b[0], b[0]),) + tail


def utf8_byte_sequences(cps: ut.IntervalSet) -> list[tuple[tuple[int, int], ...]]:
    """Expand codepoint intervals to UTF-8 byte-range sequences (len 1-4)."""
    out: list[tuple[tuple[int, int], ...]] = []
    for lo, hi in cps:
        for blo, bhi in _LEN_BOUNDS:
            s, e = max(lo, blo), min(hi, bhi)
            if s <= e:
                out.extend(_ranges_same_len(_enc(s), _enc(e)))
    return out


def _frag_for_look_bytes(nfa: _Nfa, look: Optional[Look]) -> int:
    """Terminal of a top-level alternative: a plain accept, or the
    consume-then-rewind check of the lookahead character's bytes."""
    if look is None:
        return nfa.add(["accept", 0])
    targets: list[int] = []
    if look.eof_ok:
        acc = nfa.add(["accept", 1])  # rewind the consumed EOF symbol
        targets.append(nfa.add(["byte", [acc], EOF_SYMBOL, EOF_SYMBOL]))
    for seq in utf8_byte_sequences(look.cps):
        acc = nfa.add(["accept", len(seq)])
        prev = acc
        for blo, bhi in reversed(seq):
            prev = nfa.add(["byte", [prev], blo, bhi])
        targets.append(prev)
    if not targets:
        raise PatternError("unsatisfiable lookahead")
    if len(targets) == 1:
        return targets[0]
    return nfa.add(["eps", list(targets)])


def build_nfa_bytes(pat_str: str) -> tuple[_Nfa, int]:
    """Priority NFA over bytes 0-255 and EOF_SYMBOL; returns (nfa, start)."""
    ast = parse_pattern(pat_str)
    nfa = _Nfa()
    option_starts = [
        _frag_for_toplevel(nfa, opt, utf8_byte_sequences, _frag_for_look_bytes)
        for opt in ast.options
    ]
    start = nfa.add(["eps", option_starts])
    return nfa, start


@dataclass
class ScannerDFA:
    """Byte-level scanner automaton.

    - ``trans[state, cls]``: next state (0 = dead; 1 = start).
    - ``accept[state]``: -1 if not accepting, else the rewind (bytes to
      subtract from the current position to get the match end).
    - ``class_of[b]``: byte (0-255) or EOF_SYMBOL (256) to class id.
    """

    trans: np.ndarray  # [n_states, n_classes] uint16
    accept: np.ndarray  # [n_states] int8
    class_of: np.ndarray  # [257] uint16
    n_states: int
    n_classes: int
    pat_str: str

    START = 1
    DEAD = 0


def compile_pattern(pat_str: str, *, minimize: bool = True) -> ScannerDFA:
    """The byte-level scanner automaton of ``pat_str`` (byte classes from
    every byte-range endpoint, EOF always its own class)."""
    ut.require_unicode_version()
    nfa, start = build_nfa_bytes(pat_str)
    trans, accept, class_of = _tables_from_nfa(nfa, start, EOF_SYMBOL + 1,
                                               extra_bounds=(EOF_SYMBOL,))
    dfa = ScannerDFA(trans=trans, accept=accept, class_of=class_of,
                     n_states=trans.shape[0], n_classes=trans.shape[1], pat_str=pat_str)
    return minimize_dfa(dfa) if minimize else dfa


def minimize_dfa(dfa: ScannerDFA) -> ScannerDFA:
    """``_moore_minimize`` of a byte-level automaton."""
    new_trans, new_accept = _moore_minimize(dfa.trans, dfa.accept)
    return ScannerDFA(trans=new_trans, accept=new_accept, class_of=dfa.class_of,
                      n_states=new_trans.shape[0], n_classes=dfa.n_classes,
                      pat_str=dfa.pat_str)


def scan_bytes(dfa: ScannerDFA, data: bytes) -> list[int]:
    """Maximal-munch scan. Returns piece start offsets (ascending); the
    final piece ends at len(data). Empty input -> []."""
    classes = (dfa.class_of[np.frombuffer(data, dtype=np.uint8)] if data
               else np.zeros(0, np.uint16))
    return scan_classes(dfa, classes.tolist(), len(data))


def scan_classes(dfa: ScannerDFA, classes: list[int], n: int) -> list[int]:
    """``scan_bytes`` over byte classes already looked up."""
    eof_cls = int(dfa.class_of[EOF_SYMBOL])
    trans = dfa.trans
    accept = dfa.accept
    starts: list[int] = []
    i = 0
    while i < n:
        starts.append(i)
        s = ScannerDFA.START
        last_end = -1
        p = i
        while True:
            cls = classes[p] if p < n else eof_cls
            p += 1
            s = int(trans[s][cls])
            if s == ScannerDFA.DEAD:
                break
            a = int(accept[s])
            if a >= 0:
                last_end = p - a
            if p > n:  # EOF consumed; nothing further to read
                break
        if last_end <= i:
            raise RuntimeError(
                f"scanner made no progress at offset {i} (pattern {dfa.pat_str!r})"
            )
        i = last_end
    return starts


def split_pieces(dfa: ScannerDFA, data: bytes) -> list[bytes]:
    starts = scan_bytes(dfa, data)
    bounds = starts + [len(data)]
    return [data[a:b] for a, b in zip(bounds, bounds[1:])]
