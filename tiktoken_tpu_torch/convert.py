"""Carry compiled tables across from the JAX engine.

For a tokenizer the "weights" are the compiled tables: the char-class
pages and scanner DFA, the pair table, and the short and long vocabulary
tables. ``tables_from_numpy`` takes them as numpy arrays (for example the
fields of a JAX ``DeviceEngine``'s tables), moves them into the port's
table objects and puts them on a device, ready for
``ops.engine.TorchEngine``.

Expected keys. ``arrays``: ``page_entry``, ``mixed_rows``, ``trans``,
``accept`` (CharClassTables), ``pair_buckets``, ``byte_to_rank``,
``vocab_buckets``, ``long_buckets``. ``meta``: ``n_classes``,
``eof_class``, ``n_states``, ``pair_seed``, ``n_vocab``, ``vocab_seed``,
``long_seed``.
"""

from __future__ import annotations

import numpy as np

from tiktoken_tpu_torch.ops.charclass import CharClassTables
from tiktoken_tpu_torch.ops.engine import resolve_device
from tiktoken_tpu_torch.ops.pair_table import EMPTY_KEY, PairTable
from tiktoken_tpu_torch.ops.pieces import LongVocabTable, VocabTable
from tiktoken_tpu_torch.ops.pipeline3 import ChunkTables, upload_tables


def host_tables_from_numpy(arrays: dict[str, np.ndarray], meta: dict[str, int]):
    """The port's host table objects over the given arrays:
    (CharClassTables, PairTable, VocabTable, LongVocabTable)."""
    char = CharClassTables(
        page_entry=np.asarray(arrays["page_entry"], np.int32),
        mixed_rows=np.asarray(arrays["mixed_rows"], np.uint8),
        n_classes=int(meta["n_classes"]),
        eof_class=int(meta["eof_class"]),
        n_states=int(meta["n_states"]),
        trans=np.asarray(arrays["trans"], np.int32),
        accept=np.asarray(arrays["accept"], np.int8),
    )
    pb = np.asarray(arrays["pair_buckets"], np.uint32)
    pair = PairTable(
        buckets=pb,
        n_buckets=pb.shape[0],
        seed=int(meta["pair_seed"]),
        n_pairs=int(np.count_nonzero(pb[:, 0::4] != EMPTY_KEY)),
        byte_to_rank=np.asarray(arrays["byte_to_rank"], np.uint32),
        n_vocab=int(meta["n_vocab"]),
    )
    vb = np.asarray(arrays["vocab_buckets"], np.uint32)
    vocab = VocabTable(buckets=vb, n_buckets=vb.shape[0], seed=int(meta["vocab_seed"]),
                       n_short=int(np.count_nonzero(vb[:, 4::6])))
    lb = np.asarray(arrays["long_buckets"], np.uint32)
    long = LongVocabTable(buckets=lb, n_buckets=lb.shape[0], seed=int(meta["long_seed"]),
                          n_long=int(np.count_nonzero(lb[:, 16:126:18])))
    return char, pair, vocab, long


def tables_from_numpy(arrays: dict[str, np.ndarray], meta: dict[str, int],
                      device="cuda") -> ChunkTables:
    """Upload the given table arrays to ``device`` as the chunk program's
    tables."""
    return upload_tables(*host_tables_from_numpy(arrays, meta), resolve_device(device))
