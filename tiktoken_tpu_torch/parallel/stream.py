"""Corpus encoding shard by shard, checkpointed, resumable.

The port of the JAX package's ``parallel/stream.py``: a corpus is
processed as numbered shards of ``shard_docs`` documents; each shard's
tokens and its manifest line are written atomically, and a restart skips
the shards the manifest already records (a torn last line is redone).

Output layout, one directory per run:
    manifest.jsonl      one line per finished shard: its index, document,
                        byte and token counts, the documents' token
                        offsets and the seconds it took
    shard_{i:06d}.npy   the shard's uint32 token stream

Each shard goes through ``Encoding.encode_corpus`` with the encoder's
``device`` and ``strategy``. An exception there stops the run and reaches
the caller (the JAX encoder re-encodes such a shard on the host instead);
the shards finished before it stay recorded, so the next run resumes
after them.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Iterable, Iterator

import numpy as np

from tiktoken_tpu_torch._utf8 import utf8_bytes


def _iter_shards(docs: Iterable, shard_docs: int) -> Iterator[list]:
    buf: list = []
    for d in docs:
        buf.append(d)
        if len(buf) >= shard_docs:
            yield buf
            buf = []
    if buf:
        yield buf


def _atomic_write(path: str, write_fn) -> None:
    tmp = f"{path}.{uuid.uuid4()}.tmp"
    write_fn(tmp)
    os.replace(tmp, path)


def _save(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.save(f, arr)


class StreamEncoder:
    """Checkpointed corpus encoding over an ``Encoding``."""

    def __init__(self, encoding, out_dir: str, *, shard_docs: int = 64):
        self.encoding = encoding
        self.out_dir = out_dir
        self.shard_docs = shard_docs
        os.makedirs(out_dir, exist_ok=True)
        self.manifest_path = os.path.join(out_dir, "manifest.jsonl")
        self._done: dict[int, dict] = {}
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                for line in f:
                    try:
                        e = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # a line torn by a crash: the shard is redone
                    if os.path.exists(self._shard_path(e["shard"])):
                        self._done[e["shard"]] = e

    def _shard_path(self, i: int) -> str:
        return os.path.join(self.out_dir, f"shard_{i:06d}.npy")

    def encode_corpus(self, docs: Iterable, *, device="cuda", strategy: str = "auto",
                      progress=None) -> dict:
        """Encode every document, resuming after the shards already done,
        each shard by ``Encoding.encode_corpus(device=, strategy=)``.
        Returns the run's totals: shards, documents, bytes, tokens, resumed
        (shards skipped) and seconds."""
        totals = {"shards": 0, "documents": 0, "bytes": 0, "tokens": 0, "resumed": 0,
                  "seconds": 0.0}
        with open(self.manifest_path, "a") as mf:
            for i, shard in enumerate(_iter_shards(docs, self.shard_docs)):
                totals["shards"] += 1
                totals["documents"] += len(shard)
                nbytes = sum(len(utf8_bytes(d)) for d in shard)
                totals["bytes"] += nbytes
                if i in self._done:
                    totals["resumed"] += 1
                    totals["tokens"] += self._done[i]["tokens"]
                    continue
                t0 = time.perf_counter()
                flat, offsets = self.encoding.encode_corpus_to_numpy(shard, device=device,
                                                                     strategy=strategy)
                dt = time.perf_counter() - t0
                _atomic_write(self._shard_path(i), lambda p: _save(p, flat))
                entry = {"shard": i, "documents": len(shard), "bytes": nbytes,
                         "tokens": int(offsets[-1]), "doc_offsets": offsets.tolist(),
                         "seconds": round(dt, 3)}
                mf.write(json.dumps(entry) + "\n")
                mf.flush()
                os.fsync(mf.fileno())
                self._done[i] = entry
                totals["tokens"] += entry["tokens"]
                totals["seconds"] += dt
                if progress is not None:
                    progress(entry)
        return totals

    def read_shard(self, i: int) -> tuple[np.ndarray, list[int]]:
        """(the flat tokens, the per-document offsets) of a finished shard."""
        if i not in self._done:
            with open(self.manifest_path) as f:
                for line in f:
                    e = json.loads(line)
                    if e["shard"] == i:
                        self._done[i] = e
        e = self._done[i]
        return np.load(self._shard_path(i)), e["doc_offsets"]
