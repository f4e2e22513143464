"""The public ``Encoding`` of the port.

The reference library's ``Encoding`` (reference: tiktoken/core.py:16-428)
with the same constructor, method names, defaults, error types and
messages: the host calls (``encode`` with the special-token policy,
``encode_ordinary``, the batch, numpy and unstable-token forms, the decode
family, single-token lookups) run on the native host core; pickling keeps
a registered encoding by its name and any other by its four defining
pieces. The corpus encoder (``encode_corpus`` /
``encode_corpus_to_numpy``) has the JAX package's strategies:

- ``"device"``: every document through the device engine on ``device``
  (``cuda`` unless the caller passes ``device="cpu"``, which runs the
  kernels' plain PyTorch versions), by the v3 program (``pipeline=3``, the
  default) or the v2 one (``pipeline=2``, with the char-level scanner, or
  the byte-level one with ``scanner="byte"``);
- ``"host"``: every document through the native host core, in one
  threaded call;
- ``"hybrid"``: the host core and the device engine take documents from one
  queue at the same time, so the split follows each one's speed;
- ``"auto"`` (the default): ``resolve_corpus_strategy``.

Every strategy is byte-exact with ``encode_ordinary``. ``warmup`` builds
the native core, the device tables and the kernels, and runs one empty
chunk, so that no corpus call pays for them.
"""

from __future__ import annotations

import functools
import os
import queue
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import AbstractSet, Collection, Literal, NoReturn, Sequence

import numpy as np
import torch

from tiktoken_tpu_torch import native
from tiktoken_tpu_torch._pybpe import HostBPE
from tiktoken_tpu_torch._utf8 import fix_surrogates as _fix_surrogates
from tiktoken_tpu_torch._utf8 import utf8_bytes
from tiktoken_tpu_torch.ops.engine import (
    DEFAULT_CHUNK_ROWS,
    DEFAULT_ROW,
    TorchEngine,
    check_route,
    resolve_device,
)
from tiktoken_tpu_torch.ops.regex_compiler import PatternError

STRATEGIES = ("auto", "host", "device", "hybrid")
# the most a grab of the hybrid queue's device worker may hold, counted as
# the JAX package counts it: bytes as they are, a str at two bytes a char
HYBRID_GRAB_BYTES = 8 << 20


def _host_text(t) -> str:
    """A document as the host encoder takes it: a str, bytes decoded as
    strict UTF-8 (as the device path's host fallback decodes them)."""
    return t if isinstance(t, str) else bytes(t).decode("utf-8")


def _grab_size(t) -> int:
    return 2 * len(t) if isinstance(t, str) else len(t)


class Encoding:
    def __init__(
        self,
        name: str,
        *,
        pat_str: str,
        mergeable_ranks: dict[bytes, int],
        special_tokens: dict[str, int],
        explicit_n_vocab: int | None = None,
    ):
        """Build an encoding from its four defining pieces: a name, the
        pre-tokenization split pattern, token bytes -> rank (rank order is
        merge priority), and special token string -> id.
        ``explicit_n_vocab`` cross-checks the total size."""
        self.name = name
        self._pat_str = pat_str
        self._mergeable_ranks = mergeable_ranks
        self._special_tokens = special_tokens
        self.max_token_value = max(
            max(mergeable_ranks.values()), max(special_tokens.values(), default=0)
        )
        if explicit_n_vocab:
            # AssertionError, as the reference's asserts raise (but not
            # removed under -O)
            if len(mergeable_ranks) + len(special_tokens) != explicit_n_vocab:
                raise AssertionError("ranks + special tokens do not add up to explicit_n_vocab")
            if self.max_token_value != explicit_n_vocab - 1:
                raise AssertionError("token ids are not dense up to explicit_n_vocab")
        self._special_token_values = set(special_tokens.values())
        self._core_bpe = HostBPE(mergeable_ranks, special_tokens, pat_str)
        self._engines: dict[torch.device, TorchEngine] = {}
        # the last corpus call: strategy, documents per engine, seconds, and
        # the device engine's host-clock phases (summed over the hybrid
        # device worker's calls)
        self.corpus_report: dict = {}

    def __repr__(self) -> str:
        return f"<Encoding {self.name!r}>"

    # -- host ---------------------------------------------------------------

    def _resolve_specials(self, text: str | None, allowed_special, disallowed_special):
        """The "all" sentinels resolved: (allowed, disallowed). When ``text``
        holds a disallowed special token, raises ``ValueError`` with the
        reference's message (reference: tiktoken/core.py:116-124)."""
        if allowed_special == "all":
            allowed_special = self.special_tokens_set
        if disallowed_special == "all":
            disallowed_special = self.special_tokens_set - allowed_special
        if disallowed_special:
            if not isinstance(disallowed_special, frozenset):
                disallowed_special = frozenset(disallowed_special)
            if text is not None:
                if match := _special_token_regex(disallowed_special).search(text):
                    raise_disallowed_special_token(match.group())
        return allowed_special, disallowed_special

    def encode_ordinary(self, text: str) -> list[int]:
        """Tokenize ``text`` on the host, special-token strings as plain
        text: ``encode(text, disallowed_special=())`` without the policy."""
        try:
            return self._core_bpe.encode_ordinary(text)
        except UnicodeEncodeError:
            return self._core_bpe.encode_ordinary(_fix_surrogates(text))

    def encode(
        self,
        text: str,
        *,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),  # noqa: B006
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> list[int]:
        """Tokenize ``text``, each allowed special-token string to its id.

        A special-token string in untrusted input can steer a model, so by
        default one anywhere in ``text`` raises ``ValueError``.
        ``disallowed_special=()`` encodes such strings as plain text;
        ``allowed_special="all"`` maps every one to its id."""
        allowed_special, _ = self._resolve_specials(text, allowed_special, disallowed_special)
        try:
            return self._core_bpe.encode(text, allowed_special)[0]
        except UnicodeEncodeError:
            # lone surrogates become U+FFFD, as in the reference
            return self._core_bpe.encode(_fix_surrogates(text), allowed_special)[0]

    def encode_to_numpy(
        self,
        text: str,
        *,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),  # noqa: B006
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> np.ndarray:
        """``encode`` as a uint32 array. When no allowed special token
        occurs in ``text``, the array is the buffer the native core wrote
        (no Python list; reference: src/py.rs:186-248)."""
        allowed_special, _ = self._resolve_specials(text, allowed_special, disallowed_special)
        core = self._core_bpe.native_core()
        if core is not None and not (
                allowed_special
                and _special_token_regex(frozenset(allowed_special)).search(text)):
            return core.encode_ordinary_numpy(utf8_bytes(text))
        return np.asarray(self.encode(text, allowed_special=allowed_special,
                                      disallowed_special=()), dtype=np.uint32)

    def encode_ordinary_batch(self, text: Sequence[str], *, num_threads: int = 8
                              ) -> list[list[int]]:
        """``encode_ordinary`` of each text, in one call of the native core
        over ``num_threads`` threads."""
        try:
            return self._core_bpe.encode_ordinary_batch(list(text), num_threads)
        except UnicodeEncodeError:
            return self._core_bpe.encode_ordinary_batch([_fix_surrogates(t) for t in text],
                                                        num_threads)

    def encode_batch(
        self,
        text: Sequence[str],
        *,
        num_threads: int = 8,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),  # noqa: B006
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> list[list[int]]:
        """``encode`` of each text over a pool of ``num_threads`` threads
        (the native core releases the GIL); the special-token policy as in
        ``encode``."""
        allowed_special, disallowed_special = self._resolve_specials(
            None, allowed_special, disallowed_special)
        encoder = functools.partial(self.encode, allowed_special=allowed_special,
                                    disallowed_special=frozenset(disallowed_special))
        with ThreadPoolExecutor(num_threads) as e:
            return list(e.map(encoder, text))

    def encode_with_unstable(
        self,
        text: str,
        *,
        allowed_special: Literal["all"] | AbstractSet[str] = set(),  # noqa: B006
        disallowed_special: Literal["all"] | Collection[str] = "all",
    ) -> tuple[list[int], list[list[int]]]:
        """The tokens of ``text``'s stable prefix, and every token sequence
        its unstable tail could become once more text arrives."""
        allowed_special, _ = self._resolve_specials(text, allowed_special, disallowed_special)
        tokens, completions = self._core_bpe.encode_with_unstable(text, allowed_special)
        return tokens, [list(c) for c in completions]

    def encode_single_token(self, text_or_bytes: str | bytes) -> int:
        """The id of one exact token, special tokens included (no policy
        check); ``KeyError`` when no token has these bytes."""
        if isinstance(text_or_bytes, str):
            text_or_bytes = text_or_bytes.encode("utf-8")
        return self._core_bpe.encode_single_token(text_or_bytes)

    # -- decoding -------------------------------------------------------------

    def decode_bytes(self, tokens: Sequence[int]) -> bytes:
        """Concatenate the byte values of ``tokens``; ``KeyError`` for an id
        that is neither an ordinary nor a special token."""
        return self._core_bpe.decode_bytes(tokens)

    def decode(self, tokens: Sequence[int], errors: str = "replace") -> str:
        """Decode ``tokens`` to a string. Token boundaries need not be UTF-8
        boundaries: ``errors="replace"`` (the default) puts U+FFFD where the
        bytes are not UTF-8, ``errors="strict"`` raises."""
        return self._core_bpe.decode_bytes(tokens).decode("utf-8", errors=errors)

    def decode_single_token_bytes(self, token: int) -> bytes:
        """The bytes of one id (special ids included); ``KeyError`` for an id
        outside the vocabulary."""
        return self._core_bpe.decode_single_token_bytes(token)

    def decode_tokens_bytes(self, tokens: Sequence[int]) -> list[bytes]:
        """The bytes of each id."""
        return [self.decode_single_token_bytes(token) for token in tokens]

    def decode_with_offsets(self, tokens: Sequence[int]) -> tuple[str, list[int]]:
        """The text and each token's first character offset. A token that
        starts inside a character (a UTF-8 continuation byte) gets the
        offset of that character. Raises if the bytes are not UTF-8."""
        token_bytes = self.decode_tokens_bytes(tokens)
        text_len = 0
        offsets = []
        for token in token_bytes:
            offsets.append(max(0, text_len - (0x80 <= token[0] < 0xC0)))
            text_len += sum(1 for c in token if not 0x80 <= c < 0xC0)
        text = b"".join(token_bytes).decode("utf-8", errors="strict")
        return text, offsets

    def decode_batch(self, batch: Sequence[Sequence[int]], *, errors: str = "replace",
                     num_threads: int = 8) -> list[str]:
        """``decode`` of each token list over a pool of ``num_threads``
        threads."""
        decoder = functools.partial(self.decode, errors=errors)
        with ThreadPoolExecutor(num_threads) as e:
            return list(e.map(decoder, batch))

    def decode_bytes_batch(self, batch: Sequence[Sequence[int]], *, num_threads: int = 8
                           ) -> list[bytes]:
        """``decode_bytes`` of each token list over a pool of
        ``num_threads`` threads."""
        with ThreadPoolExecutor(num_threads) as e:
            return list(e.map(self.decode_bytes, batch))

    # -- miscellaneous -------------------------------------------------------

    def token_byte_values(self) -> list[bytes]:
        """Every ordinary token's bytes, in lexicographic order."""
        return self._core_bpe.token_byte_values()

    @property
    def eot_token(self) -> int:
        return self._special_tokens["<|endoftext|>"]

    @functools.cached_property
    def special_tokens_set(self) -> set[str]:
        return set(self._special_tokens.keys())

    def is_special_token(self, token: int) -> bool:
        if not isinstance(token, int):
            raise AssertionError(f"expected an int token id, got {type(token)}")
        return token in self._special_token_values

    @property
    def n_vocab(self) -> int:
        """For backwards compatibility; prefer ``max_token_value + 1``."""
        return self.max_token_value + 1

    def _encode_single_piece(self, text_or_bytes: str | bytes) -> list[int]:
        """One piece by whole-piece hit or merges: no split, no specials."""
        if isinstance(text_or_bytes, str):
            text_or_bytes = text_or_bytes.encode("utf-8")
        return self._core_bpe.encode_single_piece(text_or_bytes)

    def _encode_only_native_bpe(self, text: str) -> list[int]:
        """The split and the per-piece merges as separate steps (the
        reference's debugging hook), split by ``HostBPE.split``."""
        ret = []
        for piece in self._core_bpe.split(text):
            ret.extend(self._core_bpe.encode_single_piece(piece.encode("utf-8")))
        return ret

    def _encode_bytes(self, text: bytes) -> list[int]:
        return self._core_bpe.encode_bytes(text)

    def __getstate__(self) -> object:
        # a registered encoding pickles as its name (unpickling takes the
        # registry's object); any other as its four defining pieces, so that
        # neither the native core nor an engine is ever pickled
        from tiktoken_tpu_torch import registry

        if self is registry.ENCODINGS.get(self.name):
            return self.name
        return {"name": self.name, "pat_str": self._pat_str,
                "mergeable_ranks": self._mergeable_ranks, "special_tokens": self._special_tokens}

    def __setstate__(self, value: object) -> None:
        from tiktoken_tpu_torch import registry

        if isinstance(value, str):
            self.__dict__ = registry.get_encoding(value).__dict__
            return
        self.__init__(**value)

    # -- device -------------------------------------------------------------

    def engine(self, device="cuda") -> TorchEngine:
        """The GPU engine of this encoding on ``device`` (tables built and
        uploaded at the first call per device)."""
        dev = resolve_device(device)
        eng = self._engines.get(dev)
        if eng is None:
            eng = TorchEngine.build(self._pat_str, self._mergeable_ranks, dev)
            self._engines[dev] = eng
        return eng

    def warmup(self, device="cuda", K: int | None = None,
               chunk_rows: int = DEFAULT_CHUNK_ROWS) -> None:
        """Build what the corpus calls need before the first one: the
        native host core (and so the pattern's byte-level DFA), the tables
        on ``device``, the kernels, and one empty v3 chunk at the geometry
        of ``K`` and ``chunk_rows`` (``TorchEngine.warmup``)."""
        self._core_bpe.native_core()
        self.engine(device).warmup(K, chunk_rows)

    def resolve_corpus_strategy(self, strategy: str = "auto", *, device="cuda") -> str:
        """The strategy a corpus call with these arguments runs.

        "auto" resolves to "host" when ``device`` is the CPU, as the JAX
        package's does on a CPU backend (the plain PyTorch versions add
        nothing beside the native core); on a GPU to "device" where no
        native core can be had (``native.available()``: the host would run
        the Python encoder), as JAX's does on a host without one, else to
        "hybrid" when the host has more than one core, else "host" (the
        device worker's host work would come out of the only core). A CUDA
        ``device`` without CUDA raises. A pattern outside the device's
        dialect is then kept on the host by the corpus call itself."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown corpus strategy {strategy!r}; expected one of "
                             + ", ".join(repr(s) for s in STRATEGIES))
        if strategy != "auto":
            return strategy
        if resolve_device(device).type == "cpu":
            return "host"
        if not native.available():
            return "device"
        return "hybrid" if (os.cpu_count() or 1) > 1 else "host"

    def _route(self, strategy: str, device) -> str:
        """``resolve_corpus_strategy``; "auto" keeps a pattern outside the
        device's dialect on the host, where an explicit "device" or
        "hybrid" raises the engine's ``PatternError``."""
        resolved = self.resolve_corpus_strategy(strategy, device=device)
        if strategy == "auto" and resolved != "host":
            try:
                self.engine(device)
            except PatternError:
                return "host"
        return resolved

    def _host_encode(self, texts: list, as_numpy: bool, num_threads: int):
        docs = [_host_text(t) for t in texts]
        if as_numpy and self._core_bpe.native_core() is not None:
            flat, offs = self._core_bpe.native_core().encode_ordinary_batch_arrays(
                docs, num_threads)
            return [flat[offs[d] : offs[d + 1]] for d in range(len(docs))]
        got = self.encode_ordinary_batch(docs, num_threads=num_threads)
        return [np.asarray(x, dtype=np.uint32) for x in got] if as_numpy else got

    def _device_encode(self, texts, device, row_capacity, chunk_rows, pipeline, scanner,
                       as_numpy):
        eng = self.engine(device)
        if pipeline == 2:
            return eng.encode_corpus(texts, host_fallback=self._core_bpe,
                                     row_capacity=row_capacity or DEFAULT_ROW,
                                     chunk_rows=chunk_rows, as_numpy=as_numpy, scanner=scanner)
        return eng.encode_corpus3(texts, host_fallback=self._core_bpe, K=row_capacity,
                                  chunk_rows=chunk_rows, as_numpy=as_numpy)

    def _hybrid_encode(self, texts: list, device_args: tuple, as_numpy: bool, report: dict):
        """The hybrid queue: a host worker takes a few documents at a time
        into the native batch call (on every core but one), and a device
        worker takes at most a third of the queue, and at most
        ``HYBRID_GRAB_BYTES``, into the device engine while four documents
        or more are left. An exception in either worker stops both and is
        raised here once both have stopped; no document is encoded twice."""
        out: list = [None] * len(texts)
        q: queue.Queue = queue.Queue()
        for i in range(len(texts)):
            q.put(i)
        stop = threading.Event()
        errors: list[BaseException] = []
        n_thr = max(1, min(32, (os.cpu_count() or 1) - 1))
        timing: dict[str, float] = {}

        def grab(n_docs: int, n_bytes: int | None = None) -> list[int]:
            idxs, size = [], 0
            while len(idxs) < n_docs and (n_bytes is None or size < n_bytes):
                try:
                    i = q.get_nowait()
                except queue.Empty:
                    break
                idxs.append(i)
                size += _grab_size(texts[i])
            return idxs

        def host_worker():
            while not stop.is_set():
                idxs = grab(2 * n_thr)
                if not idxs:
                    return
                got = self._host_encode([texts[i] for i in idxs], as_numpy, n_thr)
                for i, toks in zip(idxs, got):
                    out[i] = toks
                report["docs"]["host"] += len(idxs)

        def device_worker():
            eng = self.engine(device_args[0])
            while not stop.is_set() and q.qsize() >= 4:
                idxs = grab(max(1, q.qsize() // 3), HYBRID_GRAB_BYTES)
                if not idxs:
                    return
                got = self._device_encode([texts[i] for i in idxs], *device_args, as_numpy)
                for k, v in eng.timing.items():
                    timing[k] = timing.get(k, 0.0) + v
                for i, toks in zip(idxs, got):
                    out[i] = toks
                report["docs"]["device"] += len(idxs)

        def run(worker):
            try:
                worker()
            except BaseException as e:  # noqa: BLE001 - re-raised in the caller below
                errors.append(e)
                stop.set()

        threads = [threading.Thread(target=run, args=(w,)) for w in (host_worker, device_worker)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        report["device_timing"] = timing
        if errors:
            raise errors[0]
        return out

    def _encode_corpus(self, texts, device, row_capacity, chunk_rows, pipeline, scanner,
                       strategy, as_numpy):
        """The ids by ``strategy``: per document, or with ``as_numpy``
        ``(tokens, offsets)``; fills ``corpus_report``."""
        check_route(pipeline, scanner)
        resolved = self._route(strategy, device)
        texts = list(texts)
        report = {"strategy": resolved, "host_engine": self._core_bpe.host_engine(),
                  "docs": {"host": 0, "device": 0}}
        t0 = time.perf_counter()
        core = self._core_bpe.native_core() if resolved == "host" else None
        if core is not None and as_numpy:
            # the native batch call gives exactly (tokens, offsets)
            out = core.encode_ordinary_batch_arrays([_host_text(t) for t in texts],
                                                    max(1, min(32, os.cpu_count() or 1)))
            report["docs"]["host"] = len(texts)
        else:
            if resolved == "host":
                out = self._host_encode(texts, as_numpy, max(1, min(32, os.cpu_count() or 1)))
                report["docs"]["host"] = len(texts)
            elif resolved == "device":
                out = self._device_encode(texts, device, row_capacity, chunk_rows, pipeline,
                                          scanner, as_numpy)
                report["docs"]["device"] = len(texts)
                report["device_timing"] = dict(self.engine(device).timing)
            else:
                out = self._hybrid_encode(texts, (device, row_capacity, chunk_rows, pipeline,
                                                  scanner), as_numpy, report)
            if as_numpy:
                offsets = np.zeros(len(out) + 1, dtype=np.int64)
                np.cumsum([len(a) for a in out], out=offsets[1:])
                tokens = (np.concatenate(out).astype(np.uint32, copy=False)
                          if out else np.empty(0, np.uint32))
                out = (tokens, offsets)
        report["seconds"] = time.perf_counter() - t0
        self.corpus_report = report
        return out

    def encode_corpus(
        self,
        texts: Sequence[str] | Sequence[bytes],
        *,
        device="cuda",
        strategy: str = "auto",
        row_capacity: int | None = None,
        chunk_rows: int | None = None,
        pipeline: int = 3,
        scanner: str = "char",
    ) -> list[list[int]]:
        """Encode a batch of documents; byte-exact with ``encode_ordinary``.

        ``strategy`` is "auto" (``resolve_corpus_strategy``), "host" (the
        native core), "device" (the device engine on ``device``, "cuda" by
        default) or "hybrid" (both, from one queue). The device engine runs
        ``pipeline=3`` (the default), the v3 program: handshake rows and
        the char-level scanner; or ``pipeline=2``, the v2 program over rows
        cut at safe split points (``row_capacity`` bytes each, 256 by
        default), the JAX package's ``TIKTOKEN_TPU_PIPELINE=2`` route,
        which re-runs a chunk whose caps overflow through the v1 program.
        ``scanner`` applies to ``pipeline=2``: "char" (the default) scans
        the rows with the char-level DFA, and a chunk with dense non-ASCII
        rows overflows into v1; "byte" scans them with the byte-level DFA,
        the JAX package's ``TIKTOKEN_TPU_SCANNER=seq``. The byte-level scan
        table is uploaded at the first call that needs it: the byte
        scanner, or a v1 re-run. ``corpus_report`` then holds the strategy
        run, the host engine ("native" or "python", ``HostBPE.host_engine``),
        the documents each engine took and the device's host-clock
        phases."""
        return self._encode_corpus(texts, device, row_capacity, chunk_rows, pipeline, scanner,
                                   strategy, False)

    def encode_corpus_to_numpy(
        self,
        texts: Sequence[str] | Sequence[bytes],
        *,
        device="cuda",
        strategy: str = "auto",
        row_capacity: int | None = None,
        chunk_rows: int | None = None,
        pipeline: int = 3,
        scanner: str = "char",
    ) -> tuple[np.ndarray, np.ndarray]:
        """``encode_corpus`` with array output: ``(tokens, offsets)``, where
        document ``i``'s ids are ``tokens[offsets[i]:offsets[i+1]]``
        (uint32 / int64). On the host the native batch call gives exactly
        these arrays."""
        return self._encode_corpus(texts, device, row_capacity, chunk_rows, pipeline, scanner,
                                   strategy, True)


@functools.lru_cache(maxsize=128)
def _special_token_regex(tokens: frozenset[str]) -> re.Pattern[str]:
    inner = "|".join(re.escape(token) for token in tokens)
    return re.compile(f"({inner})")


def raise_disallowed_special_token(token: str) -> NoReturn:
    raise ValueError(
        f"Encountered text corresponding to disallowed special token {token!r}.\n"
        "If you want this text to be encoded as a special token, "
        f"pass it to `allowed_special`, e.g. `allowed_special={{{token!r}, ...}}`.\n"
        f"If you want this text to be encoded as normal text, disable the check for this token "
        f"by passing `disallowed_special=(enc.special_tokens_set - {{{token!r}}})`.\n"
        "To disable this check for all special tokens, pass `disallowed_special=()`.\n"
    )
