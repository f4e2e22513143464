"""Host-side exact BPE engine: the port's host fallback and oracle.

A pure-Python implementation of the reference core's semantics
(reference: src/lib.rs:140-373):

- greedy BPE: repeatedly merge the lowest-rank adjacent pair, ties broken
  by leftmost position; pair rank is looked up by the *concatenated bytes*
  (reference: src/lib.rs:140-196);
- whole-piece vocabulary hits short-circuit BPE (reference:
  src/lib.rs:367).

``HostBPE.encode_ordinary`` runs the native host core (``native``, C++,
built at first use) for every pattern inside the DFA compiler's dialect;
the pure-Python split and merge here (``encode_ordinary_python``) are the
spec the tests hold that core against. ``HostBPE.split`` splits text with
the port's own char-level scanner DFA (``ops.regex_compiler.
scan_codepoints`` over ``ops.artifacts.cached_char_dfa``, the DFA the
engine's tables come from), so the patterns of the shipped encodings need
neither the ``regex`` module nor the reference library. A pattern outside
the DFA compiler's dialect (lookbehind, ``\\b``, backreferences) is
decided by the ``PatternError`` of that compile: it is split with the
``regex`` module instead, imported at that first split, over
``rust_compat_pattern(pattern)``, and encoded in Python, the one route
that does not use the native core.
"""

from __future__ import annotations

import heapq
import threading
from typing import Iterable

from tiktoken_tpu_torch.native import NativeCore
from tiktoken_tpu_torch.ops.artifacts import cached_char_dfa
from tiktoken_tpu_torch.ops.regex_compiler import CharScannerDFA, PatternError, scan_codepoints

RANK_MAX = 0xFFFFFFFF


def rust_compat_pattern(pat_str: str) -> str:
    """Rewrite a pat_str so Python's ``regex`` module matches the reference
    engine's semantics.

    Differences papered over:
    - ``\\s`` / ``\\S``: the reference engine uses the Unicode White_Space
      property; Python's regex module uses a slightly larger set.
    - ``$``: the reference engine (no multi-line flag) anchors at the very
      end of the haystack; Python's ``$`` also matches before a final
      newline, so use ``\\Z``.
    """
    ws = "\\t\\n\\x0b\\x0c\\r \\x85\\xa0\\u1680\\u2000-\\u200a\\u2028\\u2029\\u202f\\u205f\\u3000"
    out: list[str] = []
    in_class = False
    i = 0
    while i < len(pat_str):
        ch = pat_str[i]
        if ch == "\\" and i + 1 < len(pat_str):
            nxt = pat_str[i + 1]
            if nxt == "s":
                # bare characters inside a class, a bracketed class outside
                out.append(ws if in_class else f"[{ws}]")
            elif nxt == "S":
                if in_class:
                    raise NotImplementedError(r"\S inside a character class")
                out.append(f"[^{ws}]")
            else:
                out.append(ch + nxt)
            i += 2
            continue
        if not in_class and ch == "[":
            in_class = True
        elif in_class and ch == "]":
            in_class = False
        elif not in_class and ch == "$":
            out.append(r"\Z")
            i += 1
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def byte_pair_merge_boundaries(ranks: dict[bytes, int], piece: bytes) -> list[int]:
    """Run greedy BPE on ``piece`` and return the sorted token boundaries.

    The result includes 0 and len(piece). Semantics: repeatedly merge the
    adjacent pair whose concatenated bytes have the lowest rank; ties are
    broken by the leftmost position (reference: src/lib.rs:140-196).
    """
    n = len(piece)
    if n < 2:
        return list(range(n + 1))
    if n >= 512:
        return _byte_pair_merge_heap(ranks, piece)

    # parts[i] is a byte offset; pair_rank[i] is the rank of merging the
    # token starting at parts[i] with the token starting at parts[i+1].
    parts = list(range(n + 1))
    get = ranks.get
    pair_rank = [get(piece[i : i + 2], RANK_MAX) for i in range(n - 1)]
    pair_rank.append(RANK_MAX)  # boundary before final token
    pair_rank.append(RANK_MAX)  # sentinel at end-of-piece

    while True:
        min_rank = RANK_MAX
        min_i = -1
        for i, r in enumerate(pair_rank):
            if r < min_rank:
                min_rank = r
                min_i = i
        if min_i < 0 or min_rank == RANK_MAX:
            break
        i = min_i
        # Merge tokens i and i+1: recompute the ranks of the pair to the
        # left and of the newly-formed pair, then drop boundary i+1.
        if i > 0:
            if i + 2 < len(parts):
                pair_rank[i - 1] = get(piece[parts[i - 1] : parts[i + 2]], RANK_MAX)
            else:
                pair_rank[i - 1] = RANK_MAX
        if i + 3 < len(parts):
            pair_rank[i] = get(piece[parts[i] : parts[i + 3]], RANK_MAX)
        else:
            pair_rank[i] = RANK_MAX
        del parts[i + 1]
        del pair_rank[i + 1]

    return parts


def _byte_pair_merge_heap(ranks: dict[bytes, int], piece: bytes) -> list[int]:
    """Heap-based O(m log n) variant for long pieces.

    Same fixed point as :func:`byte_pair_merge_boundaries`; the heap pops
    (rank, start) so the lowest rank, leftmost-start pair merges first, with
    lazy invalidation of stale entries (reference: src/lib.rs:17-138).
    """
    n = len(piece)
    get = ranks.get
    # Doubly linked list over byte offsets.
    nxt = list(range(1, n + 1)) + [n + 1]
    prv = list(range(-1, n))
    cur_rank = [RANK_MAX] * (n + 1)  # rank of the pair starting at offset i
    heap: list[tuple[int, int]] = []
    for i in range(n - 1):
        r = get(piece[i : i + 2], RANK_MAX)
        if r != RANK_MAX:
            cur_rank[i] = r
            heap.append((r, i))
    heapq.heapify(heap)
    alive = [True] * (n + 1)

    while heap:
        r, i = heapq.heappop(heap)
        if not alive[i] or cur_rank[i] != r:
            continue  # stale entry
        j = nxt[i]  # start of the right token
        k = nxt[j]  # end of the right token
        # Merge tokens [i, j) and [j, k).
        alive[j] = False
        cur_rank[j] = RANK_MAX
        nxt[i] = k
        if k <= n:
            prv[k] = i
        # New pair starting at i (merged token + following token).
        if k < n:
            e = nxt[k]
            nr = get(piece[i:e], RANK_MAX)
        else:
            nr = RANK_MAX
        cur_rank[i] = nr
        if nr != RANK_MAX:
            heapq.heappush(heap, (nr, i))
        # Updated pair ending at i (previous token + merged token).
        if i > 0:
            p = prv[i]
            pr = get(piece[p:k], RANK_MAX)
            cur_rank[p] = pr
            if pr != RANK_MAX:
                heapq.heappush(heap, (pr, p))

    parts = []
    i = 0
    while i <= n:
        parts.append(i)
        if i == n:
            break
        i = nxt[i]
    return parts


def byte_pair_encode(piece: bytes, ranks: dict[bytes, int]) -> list[int]:
    """BPE-encode a piece that is not itself a vocabulary token."""
    if len(piece) == 1:
        return [ranks[piece]]
    parts = byte_pair_merge_boundaries(ranks, piece)
    return [ranks[piece[parts[i] : parts[i + 1]]] for i in range(len(parts) - 1)]


def _compile_regex(pattern: str, refused: PatternError):
    """``pattern`` compiled by the ``regex`` module, for a pattern that the
    DFA compiler refused with ``refused``; without that module, a
    ``PatternError`` that says so."""
    try:
        import regex
    except ImportError:
        raise PatternError(
            f"pat_str {pattern!r} is outside the char DFA's dialect ({refused}), and the "
            "'regex' module that splits such patterns on the host is not installed") from refused
    return regex.compile(rust_compat_pattern(pattern))


class HostBPE:
    """Exact host engine over one vocabulary and split pattern."""

    def __init__(self, encoder: dict[bytes, int], special_tokens_encoder: dict[str, int],
                 pattern: str):
        self.encoder = dict(encoder)
        self.pattern = pattern
        self._dfa = None  # compiled at first use
        self._regex = None  # the regex module's pattern, where the DFA compile fails
        self._native = None  # the native core, built at first use
        self._native_lock = threading.Lock()
        self.decoder: dict[int, bytes] = {v: k for k, v in self.encoder.items()}
        if len(self.encoder) != len(self.decoder):
            raise ValueError(
                "Encoder and decoder must be of equal length; "
                "maybe you had duplicate token indices in your encoder?"
            )
        self.special_tokens_decoder: dict[int, bytes] = {
            v: k.encode("utf-8") for k, v in special_tokens_encoder.items()
        }

    def char_dfa(self) -> CharScannerDFA | None:
        """The pattern's char-level DFA (compiled once per process, cached
        on disk), or None for a pattern outside the DFA compiler's dialect,
        which the ``regex`` module splits instead."""
        if self._dfa is None and self._regex is None:
            try:
                self._dfa = cached_char_dfa(self.pattern)
            except PatternError as e:
                self._regex = _compile_regex(self.pattern, e)
        return self._dfa

    def native_core(self) -> NativeCore | None:
        """The native core of this vocabulary and pattern, built at the
        first call under a lock (the hybrid corpus workers race into it);
        None for a pattern outside the DFA compiler's dialect."""
        if self._native is None:
            with self._native_lock:
                if self._native is None and self.char_dfa() is not None:
                    self._native = NativeCore(self.pattern, self.encoder)
        return self._native

    def split(self, text: str) -> list[str]:
        """The pattern's pieces of ``text``: maximal munch over the char
        DFA, or the ``regex`` module's ``finditer`` for a pattern the DFA
        compiler refuses."""
        dfa = self.char_dfa()
        if dfa is None:
            return [m.group() for m in self._regex.finditer(text)]
        starts = scan_codepoints(dfa, text)
        bounds = starts + [len(text)]
        return [text[a:b] for a, b in zip(bounds, bounds[1:])]

    def encode_ordinary(self, text: str) -> list[int]:
        """Split with the pattern, then whole-piece hit or BPE per piece
        (reference: src/lib.rs:360-373): in the native core, or in Python
        for a pattern outside the DFA compiler's dialect."""
        core = self.native_core()
        if core is None:
            return self.encode_ordinary_python(text)
        return core.encode_ordinary(text)

    def encode_ordinary_batch(self, texts: list[str], num_threads: int = 8) -> list[list[int]]:
        """``encode_ordinary`` of each text: one threaded call of the native
        core, or a loop in Python for a pattern outside its dialect."""
        core = self.native_core()
        if core is None:
            return [self.encode_ordinary_python(t) for t in texts]
        return core.encode_ordinary_batch(texts, num_threads)

    def encode_ordinary_python(self, text: str) -> list[int]:
        """The pure-Python encoder: ``split``, then whole-piece hit or
        ``byte_pair_encode`` per piece. The spec of the native core."""
        ret: list[int] = []
        enc = self.encoder
        for piece in self.split(text):
            b = piece.encode("utf-8")
            token = enc.get(b)
            if token is not None:
                ret.append(token)
            else:
                ret.extend(byte_pair_encode(b, enc))
        return ret

    def decode_bytes(self, tokens: Iterable[int]) -> bytes:
        dec = self.decoder
        sdec = self.special_tokens_decoder
        return b"".join(dec[t] if t in dec else sdec[t] for t in tokens)
