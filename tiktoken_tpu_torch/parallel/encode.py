"""Data-parallel corpus encoding over a list of devices.

The counterpart of the JAX package's ``parallel/encode.py``, where one
program runs on every chip of a mesh under ``shard_map``. Here the mesh is
a list of devices (``parallel.mesh.data_mesh``): the engine's tables are
replicated once per distinct device, each with its own ``TorchEngine``,
and the host enqueues each device's share of rows on that device before it
reads any result back, so the devices work at the same time. The forward
pass stays collective-free, as in JAX: rows are independent, and the
counters are summed on the host.

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
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np
import torch

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


@dataclass
class CorpusStats:
    """Counters of a sharded v1 run, summed over the devices."""

    rows: int  # rows run, padding included
    payload_bytes: int
    tokens: int
    fallback_rows: int
    merge_rounds: int  # per device the most rounds of its chunks, summed


class ShardedEngine:
    """A ``TorchEngine`` spread over a list of devices.

    Rows are split over ``mesh`` in order; the tables are copied once to
    every distinct device of the list (a repeated device shares one
    copy), the byte-level scan table when a call first needs it, from the
    source engine, which compiles it once."""

    def __init__(self, engine: TorchEngine, mesh: Sequence[torch.device]):
        if not mesh:
            raise ValueError("the mesh holds no device")
        self.engine = engine
        self.mesh = [torch.device(d) for d in mesh]
        self.n_devices = len(self.mesh)
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

    # -- v3 -------------------------------------------------------------------

    def encode_corpus3(self, texts: Sequence[str] | Sequence[bytes], host_fallback=None,
                       K: int | None = None, chunk_rows: int | None = None,
                       as_numpy: bool = False):
        """Handshake-packed encode over the mesh: each dispatch gives every
        device one self-contained chunk of consecutive rows; byte-exact with
        the host ``encode_ordinary``."""
        return encode_corpus3_on(self._replicas(), texts, host_fallback, K, chunk_rows, as_numpy,
                                 self.stats, self.timing)

    def warmup(self, K: int | None = None, chunk_rows: int = DEFAULT_CHUNK_ROWS) -> None:
        """Build the kernels and run one empty v3 chunk at the canonical
        geometry on every distinct device (``TorchEngine.warmup``)."""
        for eng in self.engines.values():
            eng.warmup(K, chunk_rows)

    # -- v2 and v1 ------------------------------------------------------------

    def pad_batch(self, batch: PackedBatch) -> PackedBatch:
        """Pad the row count to a multiple of the mesh size (empty rows of
        document -1)."""
        pad = (-batch.rows.shape[0]) % self.n_devices
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

    def encode_rows(self, batch: PackedBatch, chunk_rows: int = DEFAULT_CHUNK_ROWS):
        """The v1 program over the rows, split over the mesh: (packed [B, K]
        uint32, counts [B] int32, row_bad [B] bool, CorpusStats), padding
        rows stripped."""
        B0 = batch.rows.shape[0]
        batch = self.pad_batch(batch)
        per = batch.rows.shape[0] // self.n_devices
        shares = [replace(batch, rows=batch.rows[sl], n_payload=batch.n_payload[sl],
                          n_total=batch.n_total[sl], doc_index=batch.doc_index[sl])
                  for sl in (slice(d * per, (d + 1) * per) for d in range(self.n_devices))]
        pending = [eng.enqueue_rows1(share, chunk_rows)
                   for eng, share in zip(self._replicas(), shares)]
        outs = [fetch_rows1(p, share) for p, share in zip(pending, shares)]
        packed, counts, row_bad = (np.concatenate([o[i] for o in outs]) for i in range(3))
        stats = CorpusStats(rows=batch.rows.shape[0], payload_bytes=int(batch.n_payload.sum()),
                            tokens=int(counts.sum()), fallback_rows=int(row_bad.sum()),
                            merge_rounds=sum(o[3] for o in outs))
        self.stats["rows"] += B0
        return packed[:B0], counts[:B0], row_bad[:B0], stats

    def encode_rows_tokens(self, batch: PackedBatch, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                           scanner: str = "char"):
        """The v2 path with ``scanner`` over the mesh: (row_tokens, one
        uint32 array per row; row_bad [B] bool). Each dispatch gives every
        device a chunk of consecutive rows; a chunk that overflows a cap
        re-runs through its device's v1 program."""
        return split_rows(resolve_chunks2(self._replicas(), batch, chunk_rows, self.stats,
                                          self.timing, scanner))

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
        return encode_corpus2_on(self._replicas(), texts, host_fallback, row_capacity, chunk_rows,
                                 as_numpy, self.stats, self.timing, scanner)
