"""The GPU engine: corpus bytes -> token ids, end to end.

``TorchEngine`` is the counterpart of the JAX package's ``DeviceEngine``
on two of its paths:

- v3 (``encode_corpus3``): documents packed into handshake rows, one
  ``ops/pipeline3.run_chunk`` per chunk, a chunk whose caps overflowed
  re-run through the ``worst_case`` variant;
- v2 (``encode_corpus``): documents cut at safe split points
  (``pack_documents``), one ``ops/pipeline2.run_chunk2`` per chunk, a
  chunk whose caps overflowed re-run through the v1 program
  (``run_rows1``), counted in ``stats["v1_fallback_chunks"]``. Its
  scanner is the JAX package's: the char-level one by default
  (``scanner="char"``, whose non-ASCII cap also sends a chunk to v1), the
  byte-level one with ``scanner="byte"`` (JAX's
  ``TIKTOKEN_TPU_SCANNER=seq``).

The engine builds the tables once and uploads them to its device once,
from the pattern's DFAs as ``ops/artifacts`` keeps them (compiled once per
process, cached on disk) and from the vocabulary's pair, short-vocab and
long-vocab hash tables (built once per machine, cached on disk the same
way, keyed by a sha256 of the ranks); the v3 rows are cut by the native
host core's cutter. The byte-level scan table is uploaded only when a call
first needs it (the byte scanner, or a v1 re-run), so the v3 path and a v2
call that never overflows never pay for it. Both paths stitch the per-row token streams
back into documents and hand documents the device could not finish
exactly (``row_bad`` rows: handshake failures or unresolved scans,
pieces over 64 bytes, v2 hard cuts) to the host engine. Those fallbacks
are counted in ``stats["fallback_docs"]``; they are never silent.

Chunk inputs go up as plain pinned-memory copies on the current CUDA
stream; every chunk is enqueued before the first header is read back. The
chunk loops (``run_chunks3``, ``resolve_chunks2``) take a list of engines,
chunk i running on the i-th modulo its length: one engine here, a mesh's
in ``parallel.ShardedEngine``.
"""

from __future__ import annotations

import hashlib
import itertools
import time
import warnings
from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np
import torch

from tiktoken_tpu_torch._utf8 import utf8_bytes
from tiktoken_tpu_torch.ops import artifacts, kernels
from tiktoken_tpu_torch.ops.artifacts import cached_char_class_tables, cached_scanner_dfa
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
from tiktoken_tpu_torch.ops.pipeline2 import DEFAULT_ROW, LOOK, SCANNERS, run_chunk2, run_rows1
from tiktoken_tpu_torch.ops.regex_compiler import PatternError
from tiktoken_tpu_torch.ops.window_scan import hot_byte_scan_table

DEFAULT_CHUNK_ROWS = 32768
# chunk sizes quantize to these tiers, so small corpora run small chunks
# while the set of chunk shapes stays bounded
_CHUNK_TIERS = (8, 128, 2048, 8192, DEFAULT_CHUNK_ROWS)
MAX_K = 256  # v3: scan work per row grows with the row buffer


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array -> a tensor on ``device``: on a GPU through a pinned
    host copy, non-blocking on the device's current stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


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


def check_route(pipeline: int, scanner: str) -> None:
    """Raise on a corpus route that does not exist: ``pipeline`` 2 or 3;
    ``scanner`` "char" or "byte", and "byte" only with ``pipeline=2``."""
    if pipeline not in (2, 3):
        raise ValueError(f"pipeline must be 2 or 3, got {pipeline!r}")
    if scanner not in SCANNERS:
        raise ValueError(f"scanner must be 'char' or 'byte', got {scanner!r}")
    if scanner == "byte" and pipeline != 2:
        raise ValueError("scanner='byte' applies to pipeline=2 only")


def _find_safe_splits(data: np.ndarray) -> np.ndarray:
    """Offsets guaranteed to start a piece in any context, for all shipped
    patterns (the JAX package's rules, validated there):

    - newline -> ASCII letter: data[i-1] in {\\r,\\n}, data[i] a letter;
    - printable -> space -> ASCII letter: data[i] == ' ', data[i+1] a
      letter, data[i-1] ASCII printable non-space (the ' ?' prefixes bind
      the space to the following word).

    The second rule fires every few words in real text, so short rows
    pack without hard cuts."""
    if len(data) < 2:
        return np.zeros(0, dtype=np.int64)
    is_letter = ((data >= 0x41) & (data <= 0x5A)) | ((data >= 0x61) & (data <= 0x7A))
    prev_nl = (data[:-1] == 0x0A) | (data[:-1] == 0x0D)
    out = np.nonzero(prev_nl & is_letter[1:])[0] + 1
    if len(data) >= 3:
        sp_rule = ((data[1:-1] == 0x20) & is_letter[2:] & (data[:-2] >= 0x21)
                   & (data[:-2] <= 0x7E))
        out = np.union1d(out, np.nonzero(sp_rule)[0] + 1)
    return out


@dataclass
class PackedBatch:
    rows: np.ndarray  # [B, K+LOOK] uint8
    n_payload: np.ndarray  # [B] int32: payload bytes in the row
    n_total: np.ndarray  # [B] int32: payload+lookahead bytes actually valid
    doc_index: np.ndarray  # [B] int32: which document each row belongs to
    hard_cut_docs: frozenset  # docs with a row cut at an unsafe position
    row_capacity: int  # K


def _doc_row_bounds(n: int, splits: np.ndarray, K: int) -> tuple[np.ndarray, bool]:
    """Greedy row boundaries for one document: each cut is the last safe
    split within K bytes of the previous cut (the greedy jump function is
    one vectorized searchsorted over all splits). Stretches with no safe
    split within K bytes are force-cut at pos+K (a hard cut: the whole
    document goes to the host)."""
    if n <= K:
        return np.asarray([0, n], dtype=np.int64), False
    jump = np.searchsorted(splits, splits + K, side="right") - 1 if len(splits) else None
    bounds = [0]
    hard = False
    pos = 0
    # index of the last split <= pos + K, maintained incrementally
    i = int(np.searchsorted(splits, K, side="right")) - 1
    while n - pos > K:
        if i >= 0 and splits[i] > pos:
            end = int(splits[i])
            i = int(jump[i])
        else:
            end = pos + K  # no safe split in range: hard cut
            hard = True
            i = int(np.searchsorted(splits, end + K, side="right")) - 1
        bounds.append(end)
        pos = end
    bounds.append(n)
    return np.asarray(bounds, dtype=np.int64), hard


def pack_documents(docs: Sequence[bytes], row_capacity: int = DEFAULT_ROW) -> PackedBatch:
    """Slice documents into independent rows of ``row_capacity`` payload
    bytes plus LOOK continuation bytes, at safe split points."""
    K = row_capacity
    all_rows, all_payload, all_total, all_doc = [], [], [], []
    hard_cut: set[int] = set()
    for d_i, doc in enumerate(docs):
        data = np.frombuffer(doc, dtype=np.uint8)
        n = len(data)
        if n == 0:
            continue
        bounds, hard = _doc_row_bounds(n, _find_safe_splits(data), K)
        if hard:
            hard_cut.add(d_i)
        starts, ends = bounds[:-1], bounds[1:]
        padded = np.concatenate([data, np.zeros(K + LOOK, np.uint8)])
        all_rows.append(padded[starts[:, None] + np.arange(K + LOOK, dtype=np.int64)[None, :]])
        all_payload.append((ends - starts).astype(np.int32))
        all_total.append((np.minimum(ends + LOOK, n) - starts).astype(np.int32))
        all_doc.append(np.full(len(starts), d_i, dtype=np.int32))
    if not all_rows:
        z = np.zeros(0, dtype=np.int32)
        return PackedBatch(rows=np.zeros((0, K + LOOK), dtype=np.uint8), n_payload=z,
                           n_total=z, doc_index=z, hard_cut_docs=frozenset(), row_capacity=K)
    return PackedBatch(
        rows=np.concatenate(all_rows), n_payload=np.concatenate(all_payload),
        n_total=np.concatenate(all_total), doc_index=np.concatenate(all_doc),
        hard_cut_docs=frozenset(hard_cut), row_capacity=K,
    )


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
    char = cached_char_class_tables(pat_str)
    fp = _pair_table_fingerprint(mergeable_ranks)
    pair = _cached_pair_table(mergeable_ranks, fp)
    vocab = _cached_vocab_table(mergeable_ranks, fp)
    long = _cached_long_vocab_table(mergeable_ranks, fp)
    return char, pair, vocab, long


# The three hash tables of a vocabulary, built once per machine: stored as
# artifacts (ops/artifacts.py) keyed by a sha256 of the ranks, as the JAX
# package keeps them (its ops/engine.py, same names; here each takes the
# fingerprint, computed once for the three), under the port's own directory
# and compiler version. A file that fails to load is removed and the table
# built and stored again; with the cache off, or a directory that cannot be
# written, every build builds.


def _pair_table_fingerprint(mergeable_ranks: dict[bytes, int]) -> bytes:
    """sha256 over the tokens in rank order, each followed by its rank as
    4 little-endian bytes."""
    h = hashlib.sha256()
    for token, rank in sorted(mergeable_ranks.items(), key=lambda kv: kv[1]):
        h.update(token)
        h.update(rank.to_bytes(4, "little"))
    return h.digest()


def _cached_pair_table(mergeable_ranks: dict[bytes, int], fingerprint: bytes) -> PairTable:
    key = artifacts.artifact_key("pair-table", fingerprint)
    arrays = artifacts.load_arrays(key)
    if arrays is not None:
        meta = arrays["meta"]
        return PairTable(buckets=arrays["buckets"], n_buckets=int(arrays["buckets"].shape[0]),
                         seed=int(meta[0]), n_pairs=int(meta[1]),
                         byte_to_rank=arrays["byte_to_rank"], n_vocab=int(meta[2]))
    pt = build_pair_table(mergeable_ranks)
    artifacts.store_arrays(key, {
        "buckets": pt.buckets, "byte_to_rank": pt.byte_to_rank,
        "meta": np.asarray([pt.seed, pt.n_pairs, pt.n_vocab], dtype=np.int64)})
    return pt


def _cached_vocab_table(mergeable_ranks: dict[bytes, int],
                        fingerprint: bytes) -> VocabTable:
    key = artifacts.artifact_key("vocab-table", fingerprint)
    arrays = artifacts.load_arrays(key)
    if arrays is not None:
        return VocabTable(buckets=arrays["buckets"], n_buckets=int(arrays["buckets"].shape[0]),
                          seed=int(arrays["meta"][0]), n_short=int(arrays["meta"][1]))
    vt = build_vocab_table(mergeable_ranks)
    artifacts.store_arrays(key, {"buckets": vt.buckets,
                                 "meta": np.asarray([vt.seed, vt.n_short], dtype=np.int64)})
    return vt


def _cached_long_vocab_table(mergeable_ranks: dict[bytes, int],
                             fingerprint: bytes) -> LongVocabTable:
    key = artifacts.artifact_key("long-vocab-table", fingerprint)
    arrays = artifacts.load_arrays(key)
    if arrays is not None:
        return LongVocabTable(buckets=arrays["buckets"],
                              n_buckets=int(arrays["buckets"].shape[0]),
                              seed=int(arrays["meta"][0]), n_long=int(arrays["meta"][1]))
    lvt = build_long_vocab_table(mergeable_ranks)
    artifacts.store_arrays(key, {"buckets": lvt.buckets,
                                 "meta": np.asarray([lvt.seed, lvt.n_long], dtype=np.int64)})
    return lvt


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
        "pair_entries": pt.n_pairs,
        "max_token_bytes": max(lens, default=0),
        "short_tokens": n_short,  # <= SLOT bytes: device vocab-hit covered
        "long_tokens": n_long,  # SLOT+1..LONG_SLOT: device long path
        "over_long_tokens": n_over,  # > LONG_SLOT: pieces fall back to the host
    }


def chunk_result3(tok: torch.Tensor, h: np.ndarray, C: int, nreal: int, lo: int):
    """A v3 chunk's (tokens uint32, row_counts, row_bad, n_real_rows, first
    row) from its token stream and its header read back."""
    toks = tok[: int(h[-2])].cpu().numpy().view(np.uint32)
    return (toks, h[:C][1 : nreal + 1].astype(np.int64), h[C : 2 * C][1 : nreal + 1].astype(bool),
            nreal, lo)


def fetch_rows1(outs: list, batch: PackedBatch):
    """The enqueued v1 chunks of ``batch`` read back: (packed [B, K] uint32,
    counts [B] int32, row_bad [B] bool, rounds: the most merge rounds of
    any chunk)."""
    if not outs:
        K = batch.rows.shape[1] - LOOK
        return np.zeros((0, K), np.uint32), np.zeros(0, np.int32), np.zeros(0, bool), 0
    packed = np.concatenate([o[0][: o[4]].cpu().numpy().view(np.uint32) for o in outs])
    counts = np.concatenate([o[1][: o[4]].cpu().numpy() for o in outs])
    row_bad = np.concatenate([o[3][: o[4]].cpu().numpy() for o in outs])
    return packed, counts, row_bad, max(int(o[2]) for o in outs)


def assemble(docs: list[bytes], doc_index: np.ndarray, results, fallback_docs: set[int],
             host_fallback, as_numpy: bool, stats: dict, timing: dict) -> list:
    """Stitch the per-chunk token streams ((tokens, row_counts, row_bad, n,
    first row) per chunk, in row order) back into documents. A document
    with a bad row, or in ``fallback_docs``, is encoded by
    ``host_fallback``; counted in ``stats`` ("rows", "fallback_docs"),
    timed in ``timing`` ("assemble_s", "fallback_s")."""
    out: list = [np.empty(0, np.uint32) if as_numpy else [] for _ in docs]
    t0 = time.perf_counter()
    frags: dict[int, list[np.ndarray]] = {}
    for toks, counts, bad, n, lo in results:
        d = doc_index[lo : lo + n]
        fallback_docs.update(int(x) for x in np.unique(d[bad]))
        offs = np.concatenate([[0], np.cumsum(counts)])
        changes = np.nonzero(np.diff(d))[0] + 1
        fr_start = np.concatenate([[0], changes])
        fr_end = np.concatenate([changes, [n]])
        for a, b in zip(fr_start, fr_end):
            frags.setdefault(int(d[a]), []).append(toks[offs[a] : offs[b]])
    for doc, parts in frags.items():
        if doc in fallback_docs:
            continue
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts)
        out[doc] = arr if as_numpy else arr.tolist()
    stats["rows"] += len(doc_index)
    t1 = time.perf_counter()
    timing["assemble_s"] = t1 - t0
    if fallback_docs:
        stats["fallback_docs"] += len(fallback_docs)
        if host_fallback is None:
            raise ValueError(
                f"{len(fallback_docs)} documents need host fallback but none given"
            )
        for d_i in fallback_docs:
            toks = host_fallback.encode_ordinary(docs[d_i].decode("utf-8"))
            out[d_i] = np.asarray(toks, dtype=np.uint32) if as_numpy else toks
    timing["fallback_s"] = time.perf_counter() - t1
    return out


def chunk_bytes3(K: int, C: int) -> int:
    """Bytes of the flat input of a v3 chunk of C rows."""
    KP, KL = row_geometry(K)
    return -(-(C * KP + KL + 8) // 128) * 128


def run_chunks3(engines: Sequence["TorchEngine"], pc, chunk_rows: int, stats: dict,
                timing: dict) -> list:
    """Run every v3 chunk of ``pc``, chunk i on ``engines[i % n]``, all
    enqueued before the first header is read back; a dispatch is one chunk
    per engine. Returns [(tokens, row_counts, row_bad, n_real_rows, first
    row)] per chunk. Slot 0 of each chunk is a ghost of the previous
    chunk's last row: it re-provides its handoff boundary and emits
    nothing. When a cap of a dispatch overflowed, the whole dispatch re-runs
    through the worst-case caps, which by construction cannot overflow: a
    header that still overflows is a fault and raises."""
    B = pc.row_off.shape[0]
    n = len(engines)
    C = quantize_chunk_rows(-(-B // n) + 1, chunk_rows)
    R = max(1, C - 1)  # real rows per chunk
    C = R + 1
    S = chunk_bytes3(pc.K, C)
    t0 = time.perf_counter()
    chunks = [(eng, lo, min(R, B - lo), *eng.enqueue3(pc, lo, R, C, S))
              for lo, eng in zip(range(0, B, R), itertools.cycle(engines))]
    t1 = time.perf_counter()
    timing["enqueue_s"] = t1 - t0
    results = []
    for g in range(0, len(chunks), n):
        group = chunks[g : g + n]
        heads = [hdr.cpu().numpy() for *_, hdr in group]
        if any(h[-1] for h in heads):
            group = [(eng, lo, nreal, *eng.enqueue3(pc, lo, R, C, S, worst_case=True))
                     for eng, lo, nreal, _, _ in group]
            heads = [hdr.cpu().numpy() for *_, hdr in group]
            stats["worst_case_chunks"] += len(group)
        for (_, lo, nreal, tok, _), h in zip(group, heads):
            if h[-1]:
                raise RuntimeError(f"worst-case chunk program overflowed at row {lo}")
            results.append(chunk_result3(tok, h, C, nreal, lo))
    timing["fetch_s"] = time.perf_counter() - t1
    stats["chunks"] += len(chunks)
    return results


def resolve_chunks2(engines: Sequence["TorchEngine"], batch: PackedBatch, chunk_rows: int,
                    stats: dict, timing: dict, scanner: str = "char") -> list:
    """Run the v2 program with ``scanner`` over every row of ``batch``,
    chunk i on ``engines[i % n]``, all enqueued before the first header is
    read back. Returns [(tokens uint32, row_counts [n], row_bad [n], n,
    first row)] per chunk; a chunk whose caps overflowed re-runs through
    its engine's v1 program, counted in ``stats["v1_fallback_chunks"]``."""
    check_route(2, scanner)
    B = batch.rows.shape[0]
    C = quantize_chunk_rows(-(-B // len(engines)), chunk_rows)
    t0 = time.perf_counter()
    pending = []
    for lo, eng in zip(range(0, B, C), itertools.cycle(engines)):
        rows, pay, tot, n = eng.upload_rows(batch, lo, C)
        tables = eng.byte_tables() if scanner == "byte" else eng.tables
        pending.append((eng, n, lo, *run_chunk2(tables, rows, pay, tot, scanner=scanner)))
    t1 = time.perf_counter()
    timing["enqueue_s"] = t1 - t0
    results = []
    for eng, n, lo, flat, hdr in pending:
        h = hdr.cpu().numpy()
        if h[-1]:
            stats["v1_fallback_chunks"] += 1
            sl = slice(lo, lo + n)
            sub = replace(batch, rows=batch.rows[sl], n_payload=batch.n_payload[sl],
                          n_total=batch.n_total[sl], doc_index=batch.doc_index[sl],
                          hard_cut_docs=frozenset())
            packed, counts, bad = eng.encode_rows(sub, chunk_rows)
            keep = np.arange(packed.shape[1])[None, :] < counts[:, None]
            results.append((packed[keep], counts.astype(np.int64), bad, n, lo))
            continue
        toks = flat[: int(h[-2])].cpu().numpy().view(np.uint32)
        results.append((toks, h[:n].astype(np.int64), h[C : C + n].astype(bool), n, lo))
    timing["fetch_s"] = time.perf_counter() - t1
    stats["chunks"] += len(pending)
    return results


def split_rows(results) -> tuple[list[np.ndarray], np.ndarray]:
    """Per-chunk results -> (row_tokens, one uint32 array per row; row_bad
    [B] bool)."""
    row_tokens: list[np.ndarray] = []
    for toks, counts, _bad, _n, _lo in results:
        offs = np.concatenate([[0], np.cumsum(counts)])
        row_tokens.extend(toks[offs[r] : offs[r + 1]] for r in range(len(counts)))
    return row_tokens, np.concatenate([r[2] for r in results] or [np.zeros(0, bool)])


def encode_corpus3_on(engines: Sequence["TorchEngine"], texts, host_fallback, K, chunk_rows,
                      as_numpy: bool, stats: dict, timing: dict) -> list:
    """The v3 corpus encoder over ``engines`` (one, or a mesh's): pack,
    ``run_chunks3``, ``assemble``; ``timing`` is refilled for this call."""
    if K and K > MAX_K:
        # the caller asked for a geometry: cap it loudly, as JAX does
        warnings.warn(f"row_capacity={K} capped to {MAX_K} on the device pipeline "
                      "(scan cost grows with row length)", stacklevel=4)
    K = min(K or K_DEFAULT, MAX_K)
    texts = list(texts)
    docs = [utf8_bytes(t) for t in texts]
    timing.clear()
    t0 = time.perf_counter()
    pc = pack_corpus3(docs, K, utf8=[isinstance(t, str) for t in texts])
    timing["pack_s"] = time.perf_counter() - t0
    if pc.row_off.shape[0] == 0:
        return [np.empty(0, np.uint32) if as_numpy else [] for _ in docs]
    results = run_chunks3(engines, pc, chunk_rows or DEFAULT_CHUNK_ROWS, stats, timing)
    return assemble(docs, pc.doc_index, results, set(), host_fallback, as_numpy, stats, timing)


def encode_corpus2_on(engines: Sequence["TorchEngine"], texts, host_fallback, row_capacity,
                      chunk_rows, as_numpy: bool, stats: dict, timing: dict,
                      scanner: str = "char") -> list:
    """The v2 corpus encoder over ``engines``: ``pack_documents``,
    ``resolve_chunks2`` with ``scanner``, ``assemble``; ``timing`` is
    refilled for this call."""
    docs = [utf8_bytes(t) for t in texts]
    timing.clear()
    t0 = time.perf_counter()
    batch = pack_documents(docs, row_capacity or DEFAULT_ROW)
    timing["pack_s"] = time.perf_counter() - t0
    if batch.rows.shape[0] == 0:
        return [np.empty(0, np.uint32) if as_numpy else [] for _ in docs]
    results = resolve_chunks2(engines, batch, chunk_rows or DEFAULT_CHUNK_ROWS, stats, timing,
                              scanner)
    return assemble(docs, batch.doc_index, results, set(batch.hard_cut_docs), host_fallback,
                    as_numpy, stats, timing)


class TorchEngine:
    """The tables of one (pat_str, vocabulary) on one device, and the v3
    and v2 corpus encoders over them."""

    def __init__(self, tables: ChunkTables, vocab_report: dict | None = None,
                 pat_str: str | None = None, byte_source: "TorchEngine | None" = None):
        self.tables = tables
        self.device = tables.device
        self.vocab_report = vocab_report
        self.pat_str = pat_str  # compiles the byte-level scan table on demand
        # an engine of the same tables on another device: its byte-level
        # scan table, compiled once, is copied here in place of compiling
        self.byte_source = byte_source
        self.stats = {"rows": 0, "chunks": 0, "worst_case_chunks": 0, "fallback_docs": 0,
                      "v1_fallback_chunks": 0}
        # host-clock seconds of the last corpus call, by phase: pack (host
        # row cuts), enqueue (chunk inputs + uploads + launches), fetch
        # (header/token read-back, which waits for the device, and the
        # worst-case or v1 re-runs), assemble (per-document stitching),
        # fallback (host encoding of flagged documents)
        self.timing: dict[str, float] = {}

    @staticmethod
    def build(pat_str: str, mergeable_ranks: dict[bytes, int], device="cuda") -> "TorchEngine":
        dev = resolve_device(device)
        try:
            char, pair, vocab, long = host_tables(pat_str, mergeable_ranks)
        except PatternError as e:
            raise PatternError(
                f"pat_str {pat_str!r} uses a construct outside the device scanner's dialect "
                f"({e}). Encode on the host instead: Encoding.encode_ordinary, which accepts "
                "any pattern the regex module compiles.") from e
        report = _vocab_readiness(mergeable_ranks, pair, vocab, long)
        return TorchEngine(upload_tables(char, pair, vocab, long, dev), report, pat_str)

    def warmup(self, K: int | None = None, chunk_rows: int = DEFAULT_CHUNK_ROWS) -> None:
        """Build the kernels (on a GPU) and run one all-empty v3 chunk at
        the geometry ``encode_corpus3`` runs with these arguments, so the
        first call pays for neither."""
        if self.device.type == "cuda":
            kernels.build()
        K = min(K or K_DEFAULT, MAX_K)
        C = quantize_chunk_rows(chunk_rows, chunk_rows)
        i32 = np.zeros(C, np.int32)
        b1 = np.zeros(C, bool)
        chunk = self.upload([np.zeros(chunk_bytes3(K, C), np.uint8), i32, i32, i32, b1, b1, b1])
        run_chunk(self.tables, *chunk, K=K)[1].cpu()

    def byte_tables(self) -> ChunkTables:
        """The tables with the byte-level scan table of the byte scanner
        and the v1 program, at the first call copied from ``byte_source``
        or compiled from the pattern, and uploaded."""
        if self.tables.byte_scan is None:
            if self.byte_source is not None:
                src = self.byte_source.byte_tables()
                table, hot = src.byte_scan, src.byte_hot
            elif self.pat_str is not None:
                table, hot = hot_byte_scan_table(cached_scanner_dfa(self.pat_str))
                table = torch.as_tensor(table)
            else:
                raise ValueError("the engine has neither a byte-level scan table nor a "
                                 "pattern to compile one from")
            self.tables.byte_scan, self.tables.byte_hot = table.to(self.device), hot
        return self.tables

    def upload(self, arrays) -> list[torch.Tensor]:
        """numpy chunk inputs -> tensors on the engine's device."""
        return [to_device(a, self.device) for a in arrays]

    def enqueue3(self, pc, lo: int, R: int, C: int, S: int, worst_case: bool = False):
        """Upload the v3 chunk of real rows [lo, lo+R) (ghost row first) and
        enqueue its program on the engine's device: (tokens, header)."""
        inputs, _ = chunk_inputs3(pc, lo, R, C, S)
        return run_chunk(self.tables, *self.upload(inputs), K=pc.K, worst_case=worst_case)

    def encode_corpus3(self, texts: Sequence[str] | Sequence[bytes], host_fallback=None,
                       K: int | None = None, chunk_rows: int | None = None,
                       as_numpy: bool = False):
        """Encode documents on the engine's device, byte-exact with the
        host ``encode_ordinary``. ``as_numpy=True`` returns per-document
        uint32 arrays instead of lists of ints."""
        return encode_corpus3_on([self], texts, host_fallback, K, chunk_rows, as_numpy,
                                 self.stats, self.timing)

    # -- v2 and its v1 re-run ---------------------------------------------------

    def upload_rows(self, batch: PackedBatch, lo: int, C: int):
        """Rows [lo, lo+C) of the batch, zero-padded to C, on the device;
        returns (rows, n_payload, n_total, n_real)."""
        rows = batch.rows[lo : lo + C]
        pay = batch.n_payload[lo : lo + C]
        tot = batch.n_total[lo : lo + C]
        n = rows.shape[0]
        if n < C:
            rows = np.concatenate([rows, np.zeros((C - n, rows.shape[1]), np.uint8)])
            pay = np.concatenate([pay, np.zeros(C - n, np.int32)])
            tot = np.concatenate([tot, np.zeros(C - n, np.int32)])
        return (*self.upload([rows, pay, tot]), n)

    def encode_rows(self, batch: PackedBatch, chunk_rows: int = DEFAULT_CHUNK_ROWS):
        """The v1 program over every row: (packed [B, K] uint32, counts [B]
        int32, row_bad [B] bool) as numpy arrays."""
        return fetch_rows1(self.enqueue_rows1(batch, chunk_rows), batch)[:3]

    def enqueue_rows1(self, batch: PackedBatch, chunk_rows: int = DEFAULT_CHUNK_ROWS) -> list:
        """Enqueue the v1 program over every row, chunk by chunk, on the
        engine's device; ``fetch_rows1`` reads the results back."""
        B = batch.rows.shape[0]
        if B == 0:
            return []
        t = self.byte_tables()
        C = quantize_chunk_rows(B, chunk_rows)
        outs = []
        for lo in range(0, B, C):
            rows, pay, tot, n = self.upload_rows(batch, lo, C)
            outs.append((*run_rows1(t, rows, pay, tot), n))
        return outs

    def encode_rows_tokens(self, batch: PackedBatch, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                           scanner: str = "char"):
        """The v2 path row by row: (row_tokens, one uint32 array per row;
        row_bad [B] bool)."""
        return split_rows(resolve_chunks2([self], batch, chunk_rows, self.stats, self.timing,
                                          scanner))

    def encode_corpus(self, texts: Sequence[str] | Sequence[bytes], host_fallback=None,
                      row_capacity: int = DEFAULT_ROW, chunk_rows: int | None = None,
                      as_numpy: bool = False, scanner: str = "char"):
        """Encode documents on the engine's device through the v2 program
        with ``scanner`` ("char" or "byte"; v1 for overflowing chunks),
        byte-exact with the host ``encode_ordinary``. ``as_numpy=True``
        returns per-document uint32 arrays instead of lists of ints."""
        return encode_corpus2_on([self], texts, host_fallback, row_capacity, chunk_rows, as_numpy,
                                 self.stats, self.timing, scanner)
