"""Data-parallel corpus encoding over a list of devices and, given a
``torch.distributed`` process group, over the processes of the group.

The counterpart of the JAX package's ``parallel/encode.py``, where one
program runs on every chip of a mesh under ``shard_map``. Here the mesh is
a list of devices (``parallel.mesh.data_mesh``): the engine's tables are
replicated once per distinct device, each with its own ``TorchEngine``,
and the host enqueues each device's share of rows on that device before it
reads any result back, so the devices work at the same time. The forward
pass stays collective-free within a process, as in JAX: rows are
independent, and the counters are summed on the host.

- v3 (``encode_corpus3``): one self-contained chunk per device per
  dispatch, ghost row included; when any header of a dispatch overflows
  its caps, the dispatch's chunks re-run through the worst-case variant,
  and a worst-case header that still overflows raises;
- v2 (``encode_corpus(pipeline=2)``, ``encode_rows_tokens``): rows split
  into per-device chunks, scanned by the char-level scanner or, with
  ``scanner="byte"``, the byte-level one; a chunk that overflows re-runs
  through its device's v1 program (straight to v1, where the JAX sharded
  v2 first re-runs it through the single-device v2 program: the ids are
  equal, the chunk counters may differ);
- v1 (``encode_rows``): every device runs the v1 program over its share of
  the rows, with the counters as ``CorpusStats``.

The v3 and v2 chunk loops are the single-device engine's own
(``ops/engine.run_chunks3``, ``resolve_chunks2``), given the mesh's
engines in place of one.

Across processes (``group=``, the JAX package's mesh over several
processes): one process per GPU, each with its own mesh, usually
``[torch.device("cuda", local_rank)]``. Every rank calls with the same
inputs (SPMD) and gets the same outputs as the one-process engine. The
corpus calls split the documents into contiguous shares balanced by
length (bytes, or a str's characters), one a rank; each rank packs and
encodes only its share on its own mesh, so the host's row cutting
spreads over the processes too. The rows of ``encode_rows`` are split
over the global device list (every rank's mesh, in rank order), padded
to a multiple of its length as JAX pads over its global mesh; those of
``encode_rows_tokens`` one contiguous share a rank. Each call then runs
one ``all_reduce`` (failure flags and counters: every rank raises if any
failed) and one gather of the results (``parallel/collective.py``). Rows are cut per
document, so the rows and tokens summed over the ranks equal the
one-process run's, and on v3 the host-fallback documents too. The chunk
and worst-case counts may differ, and so may v2's host-fallback
documents: a v1 re-run whose window scan trips its chunk-wide cap of
unresolved positions flags every row of its chunk, as in JAX.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, replace
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from tiktoken_tpu_torch.ops.engine import (
    DEFAULT_CHUNK_ROWS,
    PackedBatch,
    TorchEngine,
    check_route,
    encode_corpus2_on,
    encode_corpus3_on,
    fetch_rows1,
    resolve_chunks2,
    split_rows,
)
from tiktoken_tpu_torch.parallel import collective


@dataclass
class CorpusStats:
    """Counters of a sharded v1 run, summed over the devices (and the ranks)."""

    rows: int  # rows run, padding included
    payload_bytes: int
    tokens: int
    fallback_rows: int
    merge_rounds: int  # per device the most rounds of its chunks, summed


def document_shares(texts: Sequence, world: int) -> np.ndarray:
    """Bounds [world + 1] of contiguous shares of ``texts`` balanced by
    length: rank r takes ``texts[b[r]:b[r + 1]]``, the documents whose
    middle falls in its r-th of the total. A document's length is its
    bytes, or a str's characters: the same for ASCII, and taken without
    the pass over the whole corpus that its UTF-8 bytes would cost every
    rank. A share may be empty."""
    sizes = np.fromiter(map(len, texts), np.int64, len(texts))
    total = int(sizes.sum())
    if total == 0:
        owner = np.zeros(len(texts), np.int64)
    else:
        start = np.cumsum(sizes) - sizes
        owner = np.minimum((2 * start + sizes) * world // (2 * total), world - 1)
    return np.searchsorted(owner, np.arange(world + 1), side="left")


def _rows_of(batch: PackedBatch, sl: slice) -> PackedBatch:
    return replace(batch, rows=batch.rows[sl], n_payload=batch.n_payload[sl],
                   n_total=batch.n_total[sl], doc_index=batch.doc_index[sl])


def _split_flat(flat: np.ndarray, lengths: np.ndarray) -> list[np.ndarray]:
    """``flat`` cut into consecutive pieces of ``lengths``."""
    return np.split(flat, np.cumsum(lengths)[:-1]) if len(lengths) else []


class ShardedEngine:
    """A ``TorchEngine`` spread over a list of devices and, with ``group``,
    over the ranks of a ``torch.distributed`` process group.

    Rows are split over ``mesh`` in order; the tables are copied once to
    every distinct device of the list (a repeated device shares one
    copy), the byte-level scan table when a call first needs it, from the
    source engine, which compiles it once. With ``group`` (NCCL with the
    mesh on the current CUDA device, or gloo), ``mesh`` is this rank's
    devices, every rank calls each entry point with the same arguments,
    ``stats`` is summed over the ranks after each call, and ``timing`` is
    this rank's, with ``gather_s``: the collectives, from the end of this
    rank's encode to the end of the gather, so the wait for the slowest
    rank included."""

    def __init__(self, engine: TorchEngine, mesh: Sequence[torch.device], group=None):
        if not mesh:
            raise ValueError("the mesh holds no device")
        self.engine = engine
        self.mesh = [torch.device(d) for d in mesh]
        self.n_devices = len(self.mesh)
        self.group = group
        self.rank, self.world = 0, 1
        self.mesh_sizes = [self.n_devices]  # every rank's, in rank order
        if group is not None:
            collective.collective_device(group, self.mesh[0])  # a backend that does not fit raises
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
            sizes = collective.all_gather_ragged([np.array([self.n_devices])], group, self.mesh[0])
            self.mesh_sizes = [int(part[0][0]) for part in sizes]
        self.engines: dict[torch.device, TorchEngine] = {engine.device: engine}
        for dev in self.mesh:
            if dev not in self.engines:
                self.engines[dev] = TorchEngine(engine.tables.to(dev), engine.vocab_report,
                                                byte_source=engine)
        self.stats = {"rows": 0, "chunks": 0, "worst_case_chunks": 0, "fallback_docs": 0,
                      "v1_fallback_chunks": 0}
        self.timing: dict[str, float] = {}

    def _replicas(self) -> list[TorchEngine]:
        """The engine of each mesh entry, in order."""
        return [self.engines[dev] for dev in self.mesh]

    # -- across processes ---------------------------------------------------------

    def _gathered(self, encode, counts: dict):
        """Run ``encode(counts)`` on this rank: it adds to ``counts``, a dict
        of zeros, and returns (pieces, a list of uint32 arrays; extras, a
        list of arrays of any number of rows). Then the ranks agree on
        failure and sum ``counts`` (``collective.run_agreed``), and gather
        (``collective.all_gather_ragged``). Returns (every rank's pieces in
        rank order, every rank's extras concatenated, the summed counts);
        ``timing`` holds this rank's encode and ``gather_s``."""
        start = 0.0

        def local():
            nonlocal start
            self.timing.clear()
            out = encode(counts)
            start = time.perf_counter()
            return out, counts

        (pieces, extras), counts = collective.run_agreed(local, dict.fromkeys(counts, 0),
                                                         self.group, self.mesh[0])
        lengths = np.fromiter(map(len, pieces), np.int64, len(pieces))
        flat = np.concatenate(pieces) if pieces else np.zeros(0, np.uint32)
        parts = collective.all_gather_ragged([lengths, flat, *extras], self.group, self.mesh[0])
        self.timing["gather_s"] = time.perf_counter() - start
        pieces = [p for lens, toks, *_ in parts for p in _split_flat(toks, lens)]
        extras = [np.concatenate(x) for x in zip(*(p[2:] for p in parts))]
        return pieces, extras, counts

    def _add_stats(self, stats: dict) -> None:
        for k, v in stats.items():
            self.stats[k] += v

    def _encode_shares(self, texts, as_numpy: bool, encode_on) -> list:
        """Every rank encodes its share of the documents with
        ``encode_on(share, stats)`` (per-document uint32 arrays); the ranks
        agree on failure and sum ``stats``, and gather every document's
        ids in order."""
        texts = list(texts)
        b = document_shares(texts, self.world)
        share = texts[b[self.rank] : b[self.rank + 1]]
        docs, _, stats = self._gathered(
            lambda stats: (encode_on(share, stats) if share else [], []),
            dict.fromkeys(self.stats, 0))
        self._add_stats(stats)
        return docs if as_numpy else [d.tolist() for d in docs]

    # -- v3 -------------------------------------------------------------------

    def encode_corpus3(self, texts: Sequence[str] | Sequence[bytes], host_fallback=None,
                       K: int | None = None, chunk_rows: int | None = None,
                       as_numpy: bool = False):
        """Handshake-packed encode over the mesh: each dispatch gives every
        device one self-contained chunk of consecutive rows; byte-exact with
        the host ``encode_ordinary``. With a group, each rank encodes its
        share of the documents and every rank returns every document."""
        if self.group is None:
            return encode_corpus3_on(self._replicas(), texts, host_fallback, K, chunk_rows,
                                     as_numpy, self.stats, self.timing)
        return self._encode_shares(texts, as_numpy, lambda share, stats: encode_corpus3_on(
            self._replicas(), share, host_fallback, K, chunk_rows, True, stats, self.timing))

    def warmup(self, K: int | None = None, chunk_rows: int = DEFAULT_CHUNK_ROWS) -> None:
        """Build the kernels and run one empty v3 chunk at the canonical
        geometry on every distinct device of this rank's mesh
        (``TorchEngine.warmup``)."""
        for eng in self.engines.values():
            eng.warmup(K, chunk_rows)

    # -- v2 and v1 ------------------------------------------------------------

    def pad_batch(self, batch: PackedBatch) -> PackedBatch:
        """Pad the row count to a multiple of the global device count (the
        devices of every rank's mesh; empty rows of document -1)."""
        pad = (-batch.rows.shape[0]) % sum(self.mesh_sizes)
        if pad == 0:
            return batch
        KL = batch.rows.shape[1]
        return replace(
            batch,
            rows=np.concatenate([batch.rows, np.zeros((pad, KL), np.uint8)]),
            n_payload=np.concatenate([batch.n_payload, np.zeros(pad, np.int32)]),
            n_total=np.concatenate([batch.n_total, np.zeros(pad, np.int32)]),
            doc_index=np.concatenate([batch.doc_index, np.full(pad, -1, np.int32)]),
        )

    def _rows1(self, batch: PackedBatch, chunk_rows: int):
        """The v1 program over rows whose count is a multiple of the mesh
        size, split over the mesh: (packed, counts, row_bad, CorpusStats)."""
        per = batch.rows.shape[0] // self.n_devices
        shares = [_rows_of(batch, slice(d * per, (d + 1) * per)) for d in range(self.n_devices)]
        pending = [eng.enqueue_rows1(share, chunk_rows)
                   for eng, share in zip(self._replicas(), shares)]
        outs = [fetch_rows1(p, share) for p, share in zip(pending, shares)]
        packed, counts, row_bad = (np.concatenate([o[i] for o in outs]) for i in range(3))
        stats = CorpusStats(rows=batch.rows.shape[0], payload_bytes=int(batch.n_payload.sum()),
                            tokens=int(counts.sum()), fallback_rows=int(row_bad.sum()),
                            merge_rounds=sum(o[3] for o in outs))
        return packed, counts, row_bad, stats

    def encode_rows(self, batch: PackedBatch, chunk_rows: int = DEFAULT_CHUNK_ROWS):
        """The v1 program over the rows, split over the mesh (with a group,
        over every rank's mesh in rank order): (packed [B, K] uint32, counts
        [B] int32, row_bad [B] bool, CorpusStats), padding rows stripped."""
        B0 = batch.rows.shape[0]
        batch = self.pad_batch(batch)
        if self.group is None:
            packed, counts, row_bad, stats = self._rows1(batch, chunk_rows)
        else:
            per = batch.rows.shape[0] // sum(self.mesh_sizes)  # rows a device
            lo = sum(self.mesh_sizes[: self.rank]) * per
            mine = _rows_of(batch, slice(lo, lo + self.n_devices * per))

            def encode(counts):
                *out, stats = self._rows1(mine, chunk_rows)
                counts.update(asdict(stats))
                return [], out

            _, (packed, counts, row_bad), summed = self._gathered(
                encode, dict.fromkeys(CorpusStats.__dataclass_fields__, 0))
            stats = CorpusStats(**summed)
        self.stats["rows"] += B0
        return packed[:B0], counts[:B0], row_bad[:B0], stats

    def encode_rows_tokens(self, batch: PackedBatch, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                           scanner: str = "char"):
        """The v2 path with ``scanner`` over the mesh: (row_tokens, one
        uint32 array per row; row_bad [B] bool). Each dispatch gives every
        device a chunk of consecutive rows; a chunk that overflows a cap
        re-runs through its device's v1 program. With a group, each rank
        takes one contiguous share of the rows."""
        if self.group is None:
            return split_rows(resolve_chunks2(self._replicas(), batch, chunk_rows, self.stats,
                                              self.timing, scanner))
        per = -(-batch.rows.shape[0] // self.world)
        mine = _rows_of(batch, slice(self.rank * per, (self.rank + 1) * per))

        def encode(stats):
            row_tokens, row_bad = split_rows(resolve_chunks2(self._replicas(), mine, chunk_rows,
                                                             stats, self.timing, scanner))
            return row_tokens, [row_bad]

        row_tokens, (row_bad,), stats = self._gathered(encode, dict.fromkeys(self.stats, 0))
        self._add_stats(stats)
        return row_tokens, row_bad

    def encode_corpus(self, texts: Sequence[str] | Sequence[bytes], host_fallback=None,
                      row_capacity: int | None = None, chunk_rows: int | None = None,
                      pipeline: int = 3, as_numpy: bool = False, scanner: str = "char"):
        """Encode documents over the mesh; byte-exact with the host
        ``encode_ordinary``. ``pipeline`` and ``scanner`` as in
        ``Encoding.encode_corpus``: 3 (the default) runs ``encode_corpus3``,
        2 the v2 program with ``scanner`` over rows of ``row_capacity``
        bytes cut at safe split points."""
        check_route(pipeline, scanner)
        if pipeline == 3:
            return self.encode_corpus3(texts, host_fallback=host_fallback, K=row_capacity,
                                       chunk_rows=chunk_rows, as_numpy=as_numpy)
        if self.group is None:
            return encode_corpus2_on(self._replicas(), texts, host_fallback, row_capacity,
                                     chunk_rows, as_numpy, self.stats, self.timing, scanner)
        return self._encode_shares(texts, as_numpy, lambda share, stats: encode_corpus2_on(
            self._replicas(), share, host_fallback, row_capacity, chunk_rows, True, stats,
            self.timing, scanner))
