"""The public ``Encoding`` of the port.

The same constructor and method names as the reference library's
``Encoding`` for the part this package covers: host ``encode_ordinary``,
``decode`` / ``decode_bytes``, and the corpus encoder on the GPU
(``encode_corpus`` / ``encode_corpus_to_numpy``), which runs on ``cuda``
unless the caller passes ``device="cpu"``, through the v3 program
(``pipeline=3``, the default) or the v2 one (``pipeline=2``, with the
char-level scanner, or the byte-level one with ``scanner="byte"``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tiktoken_tpu_torch._pybpe import HostBPE
from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, TorchEngine, check_route, resolve_device


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
            if len(mergeable_ranks) + len(special_tokens) != explicit_n_vocab:
                raise ValueError("ranks + special tokens do not add up to explicit_n_vocab")
            if self.max_token_value != explicit_n_vocab - 1:
                raise ValueError("token ids are not dense up to explicit_n_vocab")
        self._core_bpe = HostBPE(mergeable_ranks, special_tokens, pat_str)
        self._engines: dict[torch.device, TorchEngine] = {}

    def __repr__(self) -> str:
        return f"<Encoding {self.name!r}>"

    @property
    def n_vocab(self) -> int:
        return self.max_token_value + 1

    # -- host ---------------------------------------------------------------

    def encode_ordinary(self, text: str) -> list[int]:
        """Tokenize ``text`` on the host, special-token strings as plain
        text."""
        try:
            return self._core_bpe.encode_ordinary(text)
        except UnicodeEncodeError:
            # lone surrogates become U+FFFD, as in the reference
            text = text.encode("utf-16", "surrogatepass").decode("utf-16", "replace")
            return self._core_bpe.encode_ordinary(text)

    def decode_bytes(self, tokens: Sequence[int]) -> bytes:
        """Concatenate the byte values of ``tokens``."""
        return self._core_bpe.decode_bytes(tokens)

    def decode(self, tokens: Sequence[int], errors: str = "replace") -> str:
        """Decode ``tokens`` to a string (``errors`` as in bytes.decode)."""
        return self._core_bpe.decode_bytes(tokens).decode("utf-8", errors=errors)

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

    def _encode_corpus(self, texts, device, row_capacity, chunk_rows, pipeline, scanner,
                       as_numpy):
        check_route(pipeline, scanner)
        eng = self.engine(device)
        if pipeline == 2:
            return eng.encode_corpus(texts, host_fallback=self._core_bpe,
                                     row_capacity=row_capacity or DEFAULT_ROW,
                                     chunk_rows=chunk_rows, as_numpy=as_numpy, scanner=scanner)
        return eng.encode_corpus3(texts, host_fallback=self._core_bpe, K=row_capacity,
                                  chunk_rows=chunk_rows, as_numpy=as_numpy)

    def encode_corpus(
        self,
        texts: Sequence[str] | Sequence[bytes],
        *,
        device="cuda",
        row_capacity: int | None = None,
        chunk_rows: int | None = None,
        pipeline: int = 3,
        scanner: str = "char",
    ) -> list[list[int]]:
        """Encode a batch of documents on ``device`` ("cuda" by default);
        byte-exact with ``encode_ordinary``.

        ``pipeline=3`` (the default) runs the v3 program: handshake rows
        and the char-level scanner. ``pipeline=2`` runs the v2 program
        over rows cut at safe split points (``row_capacity`` bytes each,
        256 by default), the JAX package's ``TIKTOKEN_TPU_PIPELINE=2``
        route, and re-runs a chunk whose caps overflow through the v1
        program. ``scanner`` applies to ``pipeline=2``: "char" (the
        default) scans the rows with the char-level DFA, and a chunk with
        dense non-ASCII rows overflows into v1; "byte" scans them with the
        byte-level DFA, the JAX package's ``TIKTOKEN_TPU_SCANNER=seq``.
        The byte-level scan table is compiled and uploaded at the first
        call that needs it: the byte scanner, or a v1 re-run."""
        return self._encode_corpus(texts, device, row_capacity, chunk_rows, pipeline, scanner,
                                   False)

    def encode_corpus_to_numpy(
        self,
        texts: Sequence[str] | Sequence[bytes],
        *,
        device="cuda",
        row_capacity: int | None = None,
        chunk_rows: int | None = None,
        pipeline: int = 3,
        scanner: str = "char",
    ) -> tuple[np.ndarray, np.ndarray]:
        """``encode_corpus`` with array output: ``(tokens, offsets)``, where
        document ``i``'s ids are ``tokens[offsets[i]:offsets[i+1]]``
        (uint32 / int64)."""
        per_doc = self._encode_corpus(texts, device, row_capacity, chunk_rows, pipeline, scanner,
                                      True)
        offsets = np.zeros(len(per_doc) + 1, dtype=np.int64)
        np.cumsum([len(a) for a in per_doc], out=offsets[1:])
        tokens = (np.concatenate(per_doc).astype(np.uint32, copy=False)
                  if per_doc else np.empty(0, np.uint32))
        return tokens, offsets
