"""The GPU engine: corpus bytes -> token ids, end to end.

``TorchEngine`` is the counterpart of the JAX package's ``DeviceEngine``
on its v3 path (``encode_corpus3``). It builds the tables once, uploads
them to its device once, packs documents into handshake rows on the host,
runs one chunk program (``ops/pipeline3.run_chunk``) per chunk, re-runs a
chunk whose caps overflowed through the ``worst_case`` variant, stitches
the per-row token streams back into documents, and hands documents the
device could not finish exactly (``row_bad`` rows: handshake failures,
pieces over 64 bytes) to the host engine. Those fallbacks are counted in
``stats["fallback_docs"]``; they are never silent.

Chunk inputs go up as plain pinned-memory copies on the current CUDA
stream; every chunk is enqueued before the first header is read back.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from tiktoken_tpu_torch.ops.charclass import build_char_class_tables
from tiktoken_tpu_torch.ops.pair_table import PairTable, build_pair_table
from tiktoken_tpu_torch.ops.pieces import (
    LONG_SLOT,
    SLOT,
    LongVocabTable,
    VocabTable,
    build_long_vocab_table,
    build_vocab_table,
)
from tiktoken_tpu_torch.ops.pipeline3 import (
    K_DEFAULT,
    ChunkTables,
    chunk_inputs3,
    pack_corpus3,
    row_geometry,
    run_chunk,
    upload_tables,
)
from tiktoken_tpu_torch.ops.regex_compiler import compile_pattern_chars

DEFAULT_CHUNK_ROWS = 32768
# chunk sizes quantize to these tiers, so small corpora run small chunks
# while the set of chunk shapes stays bounded
_CHUNK_TIERS = (8, 128, 2048, 8192, DEFAULT_CHUNK_ROWS)
MAX_K = 256  # scan work per row grows with the row buffer


def quantize_chunk_rows(need: int, cap: int) -> int:
    """Smallest tier >= need, capped (cap itself if it's non-standard)."""
    for t in _CHUNK_TIERS:
        if t >= min(need, cap):
            return min(t, cap)
    return cap


def resolve_device(device) -> torch.device:
    """A concrete device for the engine. A CUDA device without CUDA
    raises: the port never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def host_tables(pat_str: str, mergeable_ranks: dict[bytes, int]):
    """Build the engine's host tables: (char classes, pair table, short
    vocab table, long vocab table), checking the device-path assumptions
    for this vocabulary."""
    # the assembly flags single-piece tokens in bit 31 of the expand
    # payload, so device-handled ranks must stay below 2^31
    max_rank = max(mergeable_ranks.values(), default=0)
    if max_rank >= 1 << 31:
        raise ValueError(
            f"device engine requires token ranks < 2**31 (got {max_rank}); "
            "use the host path for this vocabulary"
        )
    char = build_char_class_tables(compile_pattern_chars(pat_str))
    pair = build_pair_table(mergeable_ranks)
    vocab = build_vocab_table(mergeable_ranks)
    long = build_long_vocab_table(mergeable_ranks)
    return char, pair, vocab, long


def _vocab_readiness(mergeable_ranks: dict[bytes, int], pt: PairTable,
                     vt: VocabTable, lvt: LongVocabTable) -> dict:
    """Check (not just document) the device-path assumptions for THIS
    vocabulary, and record the length profile that decides which tokens
    short-circuit on the device."""
    lens = [len(t) for t in mergeable_ranks]
    n_short = sum(1 for l in lens if 2 <= l <= SLOT)
    n_long = sum(1 for l in lens if SLOT < l <= LONG_SLOT)
    n_over = sum(1 for l in lens if l > LONG_SLOT)
    # the vocab tables must cover every 2..64-byte token, or device
    # vocab-hit semantics would diverge from the reference's
    # vocab-as-cache short-circuit (reference: src/lib.rs:247-254)
    if vt.n_short != n_short:
        raise ValueError(f"vocab table covers {vt.n_short} of {n_short} short tokens")
    if lvt.n_long != n_long:
        raise ValueError(f"long vocab table covers {lvt.n_long} of {n_long} long tokens")
    return {
        "n_vocab": pt.n_vocab,
        "max_token_bytes": max(lens, default=0),
        "short_tokens": n_short,  # <= SLOT bytes: device vocab-hit covered
        "long_tokens": n_long,  # SLOT+1..LONG_SLOT: device long path
        "over_long_tokens": n_over,  # > LONG_SLOT: pieces fall back to the host
    }


class TorchEngine:
    """The tables of one (pat_str, vocabulary) on one device, and the v3
    corpus encoder over them."""

    def __init__(self, tables: ChunkTables, vocab_report: dict | None = None):
        self.tables = tables
        self.device = tables.device
        self.vocab_report = vocab_report
        self.stats = {"rows": 0, "chunks": 0, "worst_case_chunks": 0, "fallback_docs": 0}
        # host-clock seconds of the last encode_corpus3 call, by phase:
        # pack (host row cuts), enqueue (chunk inputs + uploads + launches),
        # fetch (header/token read-back, which waits for the device, and
        # worst-case re-runs), assemble (per-document stitching), fallback
        # (host encoding of flagged documents)
        self.timing: dict[str, float] = {}

    @staticmethod
    def build(pat_str: str, mergeable_ranks: dict[bytes, int], device="cuda") -> "TorchEngine":
        dev = resolve_device(device)
        char, pair, vocab, long = host_tables(pat_str, mergeable_ranks)
        report = _vocab_readiness(mergeable_ranks, pair, vocab, long)
        return TorchEngine(upload_tables(char, pair, vocab, long, dev), report)

    def upload(self, arrays) -> list[torch.Tensor]:
        """numpy chunk inputs -> tensors on the engine's device (pinned
        host copies, non-blocking on the current stream)."""
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return out

    def _run_chunks(self, pc, chunk_rows: int):
        """Run every chunk; returns [(header, tokens, n_real_rows, first
        row)] and the chunk row count C. Slot 0 of each chunk is a ghost of
        the previous chunk's last row: it re-provides its handoff boundary
        and emits nothing."""
        B = pc.row_off.shape[0]
        K = pc.K
        KP, KL = row_geometry(K)
        C = quantize_chunk_rows(B + 1, chunk_rows)
        R = max(1, C - 1)  # real rows per chunk
        C = R + 1
        S = -(-(C * KP + KL + 8) // 128) * 128
        t0 = time.perf_counter()
        pending = []
        for lo in range(0, B, R):
            inputs, nreal = chunk_inputs3(pc, lo, R, C, S)
            tok, hdr = run_chunk(self.tables, *self.upload(inputs), K=K)
            pending.append((lo, nreal, tok, hdr))
        t1 = time.perf_counter()
        self.timing["enqueue_s"] = t1 - t0
        results = []
        for lo, nreal, tok, hdr in pending:
            h = hdr.cpu().numpy()
            if h[-1]:
                # a cap overflowed: re-run through the worst-case caps,
                # which by construction cannot overflow
                inputs, _ = chunk_inputs3(pc, lo, R, C, S)
                tok, hdr = run_chunk(self.tables, *self.upload(inputs), K=K, worst_case=True)
                h = hdr.cpu().numpy()
                if h[-1]:
                    raise RuntimeError(f"worst-case chunk program overflowed at row {lo}")
                self.stats["worst_case_chunks"] += 1
            toks = tok[: int(h[-2])].cpu().numpy().view(np.uint32)
            results.append((h, toks, nreal, lo))
        self.timing["fetch_s"] = time.perf_counter() - t1
        self.stats["chunks"] += len(pending)
        return results, C

    def encode_corpus3(self, texts: Sequence[str] | Sequence[bytes], host_fallback=None,
                       K: int | None = None, chunk_rows: int | None = None,
                       as_numpy: bool = False):
        """Encode documents on the engine's device, byte-exact with the
        host ``encode_ordinary``. ``as_numpy=True`` returns per-document
        uint32 arrays instead of lists of ints."""
        if K and K > MAX_K:
            raise ValueError(f"row_capacity={K} exceeds the device maximum {MAX_K}")
        K = K or K_DEFAULT
        docs = [t.encode("utf-8") if isinstance(t, str) else bytes(t) for t in texts]
        out: list = [np.empty(0, np.uint32) if as_numpy else [] for _ in docs]
        t0 = time.perf_counter()
        pc = pack_corpus3(docs, K)
        self.timing = {"pack_s": time.perf_counter() - t0}
        B = pc.row_off.shape[0]
        if B == 0:
            return out
        results, C = self._run_chunks(pc, chunk_rows or DEFAULT_CHUNK_ROWS)

        t0 = time.perf_counter()
        frags: dict[int, list[np.ndarray]] = {}
        fallback_docs: set[int] = set()
        for hdr, toks, nreal, lo in results:
            counts = hdr[:C][1 : nreal + 1].astype(np.int64)
            bad = hdr[C : 2 * C][1 : nreal + 1].astype(bool)
            d = pc.doc_index[lo : lo + nreal]
            fallback_docs.update(int(x) for x in np.unique(d[bad]))
            offs = np.concatenate([[0], np.cumsum(counts)])
            changes = np.nonzero(np.diff(d))[0] + 1
            fr_start = np.concatenate([[0], changes])
            fr_end = np.concatenate([changes, [nreal]])
            for a, b in zip(fr_start, fr_end):
                frags.setdefault(int(d[a]), []).append(toks[offs[a] : offs[b]])
        for doc, parts in frags.items():
            if doc in fallback_docs:
                continue
            arr = parts[0] if len(parts) == 1 else np.concatenate(parts)
            out[doc] = arr if as_numpy else arr.tolist()
        self.stats["rows"] += B
        t1 = time.perf_counter()
        self.timing["assemble_s"] = t1 - t0
        if fallback_docs:
            self.stats["fallback_docs"] += len(fallback_docs)
            if host_fallback is None:
                raise ValueError(
                    f"{len(fallback_docs)} documents need host fallback but none given"
                )
            for d_i in fallback_docs:
                toks = host_fallback.encode_ordinary(docs[d_i].decode("utf-8"))
                out[d_i] = np.asarray(toks, dtype=np.uint32) if as_numpy else toks
        self.timing["fallback_s"] = time.perf_counter() - t1
        return out
