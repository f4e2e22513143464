"""Host-side exact BPE engine: the port's host fallback and oracle.

A pure-Python implementation of the reference core's semantics
(reference: src/lib.rs:140-373):

- greedy BPE: repeatedly merge the lowest-rank adjacent pair, ties broken
  by leftmost position; pair rank is looked up by the *concatenated bytes*
  (reference: src/lib.rs:140-196);
- whole-piece vocabulary hits short-circuit BPE (reference:
  src/lib.rs:367).

- special tokens are matched before ordinary tokenization; a special
  token found but not allowed restarts the special scan one character
  later (reference: src/lib.rs:387-401); ``encode`` returns ``(tokens,
  last_piece_token_len)`` (reference: src/lib.rs:439-441);
- unstable-token enumeration for completion APIs (reference:
  src/lib.rs:444-599) and arbitrary-bytes encoding (reference:
  src/py.rs:72-115).

``HostBPE.encode_ordinary`` runs the native host core (``native``, C++,
prebuilt or built at first use) for every pattern inside the DFA
compiler's dialect; the pure-Python split and merge here
(``encode_ordinary_python``) are the spec the tests hold that core
against, and run the host calls where no core can be had (no prebuilt
library and no compiler), as in the JAX package. ``HostBPE.split``
splits text with the port's own char-level scanner DFA (``ops.regex_compiler.
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

import bisect
import functools
import heapq
import re
import threading
from typing import AbstractSet, Iterable

from tiktoken_tpu_torch import native
from tiktoken_tpu_torch.ops.artifacts import cached_char_dfa
from tiktoken_tpu_torch.ops.regex_compiler import CharScannerDFA, PatternError, scan_codepoints
from tiktoken_tpu_torch.ops.unicode_tables import WHITE_SPACE_CPS

RANK_MAX = 0xFFFFFFFF
# the reference engine's \s: the Unicode White_Space property, which differs
# from str.isspace() (U+001C..U+001F are isspace() but not White_Space)
WHITE_SPACE = "".join(map(chr, WHITE_SPACE_CPS))
_WHITE_SPACE_SET = frozenset(WHITE_SPACE)


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


def byte_pair_split(piece: bytes, ranks: dict[bytes, int]) -> list[bytes]:
    """The byte segments greedy BPE splits ``piece`` (two bytes or more)
    into."""
    if len(piece) < 2:
        raise ValueError("byte_pair_split takes a piece of two bytes or more")
    parts = byte_pair_merge_boundaries(ranks, piece)
    return [piece[parts[i] : parts[i + 1]] for i in range(len(parts) - 1)]


def _decode_last_utf8(data: bytes) -> tuple[str | None, int]:
    """The last UTF-8 character of ``data``: (char, the bytes it takes), or
    (None, k) when the trailing bytes are not valid UTF-8 (k the length of
    the trailing invalid sequence, at most 3)."""
    if not data:
        return None, 0
    for j in range(1, min(4, len(data)) + 1):
        tail = data[-j:]
        if 0x80 <= tail[0] < 0xC0:
            continue  # a continuation byte: the start lies further left
        try:
            ch = tail.decode("utf-8")
        except UnicodeDecodeError:
            return None, j
        return (ch, j) if len(ch) == 1 else (None, j)
    return None, min(3, len(data))


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
        self.special_tokens_encoder = dict(special_tokens_encoder)
        self.pattern = pattern
        # the specials in dict order, as literals (leftmost match, the first
        # alternative winning at one position)
        self.special_regex = (re.compile("|".join(map(re.escape, self.special_tokens_encoder)))
                              if self.special_tokens_encoder else None)
        self._dfa = None  # compiled at first use
        self._regex = None  # the regex module's pattern, where the DFA compile fails
        self._native = None  # the native core at first use; False where none can be had
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

    def native_core(self) -> native.NativeCore | None:
        """The native core of this vocabulary and pattern, made at the
        first call under a lock (the hybrid corpus workers race into it);
        None for a pattern outside the DFA compiler's dialect, and where no
        core can be had (``native.available()``, decided before any build:
        no prebuilt or built library and no compiler). A compiler that is
        found and fails raises."""
        if self._native is None:
            with self._native_lock:
                if self._native is None and self.char_dfa() is not None:
                    self._native = (native.NativeCore(self.pattern, self.encoder)
                                    if native.available() else False)
        return self._native or None

    def host_engine(self) -> str:
        """Which engine the host calls run, without building it: "native"
        (the native core) or "python" (the Python encoder)."""
        if self._native is None and self.char_dfa() is not None:
            return "native" if native.available() else "python"
        return "native" if self._native else "python"

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
        return self._encode_python(text)[0]

    def _encode_python(self, text: str) -> tuple[list[int], int]:
        """``encode_ordinary_python``'s tokens and the last piece's token
        count."""
        ret: list[int] = []
        last = 0
        for piece in self.split(text):
            toks = self.encode_single_piece(piece.encode("utf-8"))
            ret.extend(toks)
            last = len(toks)
        return ret, last

    def _encode_segment(self, text: str) -> tuple[list[int], int]:
        """(tokens, the last piece's token count) of a text without special
        tokens: the native core, or the Python encoder for a pattern outside
        the DFA compiler's dialect."""
        core = self.native_core()
        if core is None:
            return self._encode_python(text)
        return core.encode_with_lptl(text.encode("utf-8"))

    def encode(self, text: str, allowed_special: AbstractSet[str]) -> tuple[list[int], int]:
        """Encode ``text``, each allowed special token to its id; returns
        (tokens, last_piece_token_len), the latter feeding the unstable-token
        search (reference: src/lib.rs:375-442)."""
        ret: list[int] = []
        start = 0
        last_piece_token_len = 0
        while True:
            next_special = None
            if self.special_regex is not None:
                start_find = start
                while (m := self.special_regex.search(text, start_find)) is not None:
                    if m.group() in allowed_special:
                        next_special = m
                        break
                    # a special that is not allowed restarts the search one
                    # character later (reference: src/lib.rs:397)
                    start_find = m.start() + 1
            end = next_special.start() if next_special is not None else len(text)
            if end > start:
                toks, lptl = self._encode_segment(text[start:end])
                ret.extend(toks)
                if toks:
                    last_piece_token_len = lptl
            if next_special is None:
                return ret, last_piece_token_len
            ret.append(self.special_tokens_encoder[next_special.group()])
            start = next_special.end()
            last_piece_token_len = 0

    def encode_with_special_tokens(self, text: str) -> list[int]:
        return self.encode(text, set(self.special_tokens_encoder))[0]

    def encode_single_token(self, piece: bytes) -> int:
        """The id of the token whose bytes are ``piece``, special tokens
        included (reference: src/py.rs:133-143)."""
        token = self.encoder.get(piece)
        if token is not None:
            return token
        try:
            token = self.special_tokens_encoder.get(piece.decode("utf-8"))
        except UnicodeDecodeError:
            token = None
        if token is not None:
            return token
        raise KeyError(piece)

    def encode_single_piece(self, piece: bytes) -> list[int]:
        """One piece by whole-piece hit or greedy merges, no split
        (reference: src/py.rs:145-150)."""
        token = self.encoder.get(piece)
        if token is not None:
            return [token]
        return byte_pair_encode(piece, self.encoder)

    def encode_bytes(self, data: bytes) -> list[int]:
        """Encode arbitrary bytes: the longest valid UTF-8 prefix as text, its
        last piece re-merged with the invalid rest (reference:
        src/py.rs:72-115)."""
        try:
            text = data.decode("utf-8")
        except UnicodeDecodeError as e:
            valid_up_to = e.start
        else:
            return self.encode_ordinary(text)
        tokens, last_piece_token_len = self._increase_last_piece_token_len(
            *self.encode(data[:valid_up_to].decode("utf-8"), frozenset()))
        if tokens and last_piece_token_len > 0:
            unstable_bytes = self.decode_bytes(tokens[len(tokens) - last_piece_token_len :])
            unstable_bytes += data[valid_up_to:]
            del tokens[len(tokens) - last_piece_token_len :]
        else:
            unstable_bytes = data[valid_up_to:]
        if unstable_bytes:
            tokens.extend(self.encode_single_piece(unstable_bytes))
        return tokens

    def _increase_last_piece_token_len(self, tokens: list[int], last_piece_token_len: int
                                       ) -> tuple[list[int], int]:
        """Widen the unstable tail over a run of whitespace tokens: splits
        inside whitespace (cl100k's ``\\s*[\\r\\n]``) are unstable too
        (reference: src/lib.rs:444-481)."""

        def all_space(token: int) -> bool:
            b = self.decoder.get(token)
            return b is not None and all(c in (0x20, 0x0A, 0x09) for c in b)

        if last_piece_token_len > 0 and all_space(tokens[len(tokens) - last_piece_token_len]):
            while (last_piece_token_len < len(tokens)
                   and all_space(tokens[len(tokens) - last_piece_token_len - 1])):
                last_piece_token_len += 1
        return tokens, last_piece_token_len

    @functools.cached_property
    def sorted_token_bytes(self) -> list[bytes]:
        """Every ordinary token's bytes, sorted (built at first use)."""
        return sorted(self.encoder)

    def encode_with_unstable(self, text: str, allowed_special: AbstractSet[str]
                             ) -> tuple[list[int], set[tuple[int, ...]]]:
        """The stable prefix's tokens and every token sequence the unstable
        tail could become as more text arrives (reference:
        src/lib.rs:483-599)."""
        tokens, last_piece_token_len = self.encode(text, allowed_special)
        if last_piece_token_len == 0:  # ends in a special token: all stable
            return tokens, set()
        tokens, last_piece_token_len = self._increase_last_piece_token_len(
            tokens, last_piece_token_len)
        unstable_bytes = self.decode_bytes(tokens[len(tokens) - last_piece_token_len :])
        del tokens[len(tokens) - last_piece_token_len :]
        completions: set[tuple[int, ...]] = set()
        if not unstable_bytes:
            return tokens, completions

        sorted_tokens = self.sorted_token_bytes
        # single tokens that start with the unstable bytes
        point = bisect.bisect_left(sorted_tokens, unstable_bytes)
        while point < len(sorted_tokens) and sorted_tokens[point].startswith(unstable_bytes):
            completions.add((self.encoder[sorted_tokens[point]],))
            point += 1
        # at every split of the unstable bytes, extend the suffix by each
        # token that starts with it, and encode again
        for i in range(1, len(unstable_bytes)):
            prefix, suffix = unstable_bytes[:i], unstable_bytes[i:]
            point = bisect.bisect_left(sorted_tokens, suffix)
            while point < len(sorted_tokens) and sorted_tokens[point].startswith(suffix):
                possibility = prefix + sorted_tokens[point]
                try:
                    # the split may cut the extended bytes where merges ran
                    encoded = self.encode_ordinary(possibility.decode("utf-8"))
                except UnicodeDecodeError:
                    encoded = byte_pair_encode(possibility, self.encoder)
                seq: list[int] = []
                seq_len = 0
                for token in encoded:
                    seq.append(token)
                    seq_len += len(self.decoder[token])
                    if seq_len >= len(unstable_bytes):
                        break
                completions.add(tuple(seq))
                point += 1
        # trailing whitespace can split off once more text arrives, as in
        # gpt2's \s+(?!\S) (reference: src/lib.rs:581-596)
        if len(unstable_bytes) > 1:
            last_char, nbytes = _decode_last_utf8(unstable_bytes)
            if (len(unstable_bytes) - nbytes > 0 and last_char is not None
                    and last_char in _WHITE_SPACE_SET):
                reencoded = byte_pair_encode(unstable_bytes[: len(unstable_bytes) - nbytes],
                                             self.encoder)
                reencoded.extend(byte_pair_encode(unstable_bytes[len(unstable_bytes) - nbytes :],
                                                  self.encoder))
                completions.add(tuple(reencoded))
        return tokens, completions

    def decode_bytes(self, tokens: Iterable[int]) -> bytes:
        """The tokens' bytes concatenated (reference: src/lib.rs:342-358):
        runs of ordinary ids through the native core, one call a run, the
        special tokens' bytes spliced in between. An id that is neither
        ordinary nor special raises ``KeyError("Invalid token for decoding:
        <id>")``."""
        if iter(tokens) is tokens:  # an iterator: read it once
            tokens = list(tokens)
        core = self.native_core()
        if core is not None:
            try:
                return core.decode_bytes(tokens)
            except (KeyError, OverflowError):
                pass  # a special token, or an invalid id
            tokens = list(tokens)  # a run is a slice of a list
            specials = self.special_tokens_decoder
            out = bytearray()
            run_start = 0
            try:
                for i, tok in enumerate(tokens):
                    sp = specials.get(tok)
                    if sp is not None:
                        if i > run_start:
                            out += core.decode_bytes(tokens[run_start:i])
                        out += sp
                        run_start = i + 1
                if len(tokens) > run_start:
                    out += core.decode_bytes(tokens[run_start:])
                return bytes(out)
            except (KeyError, OverflowError):
                pass  # an invalid id in a run: named below
        out = bytearray()
        for token in tokens:
            b = self.decoder.get(token)
            if b is None:
                b = self.special_tokens_decoder.get(token)
                if b is None:
                    raise KeyError(f"Invalid token for decoding: {token}")
            out += b
        return bytes(out)

    def decode_single_token_bytes(self, token: int) -> bytes:
        b = self.decoder.get(token)
        if b is None:
            b = self.special_tokens_decoder.get(token)
        if b is None:
            raise KeyError(str(token))
        return b

    def token_byte_values(self) -> list[bytes]:
        return list(self.sorted_token_bytes)
