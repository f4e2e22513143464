"""Carry compiled tables across from the JAX engine.

For a tokenizer the "weights" are the compiled tables: the char-class
pages and scanner DFA, the byte-level scanner DFA, the pair table, and
the short and long vocabulary tables. ``tables_from_numpy`` takes them as numpy arrays (for example the
fields of a JAX ``DeviceEngine``'s tables), moves them into the port's
table objects and puts them on a device, ready for
``ops.engine.TorchEngine``.

Expected keys. ``arrays``: ``page_entry``, ``mixed_rows``, ``trans``,
``accept`` (CharClassTables), ``pair_buckets``, ``byte_to_rank``,
``vocab_buckets``, ``long_buckets``, and optionally the byte-level
``ScannerDFA``'s ``byte_trans``, ``byte_accept``, ``byte_class_of``.
``meta``: ``n_classes``, ``eof_class``, ``n_states``, ``pair_seed``,
``n_vocab``, ``vocab_seed``, ``long_seed``, and with the byte-level
arrays ``byte_n_states``, ``byte_n_classes``.
"""

from __future__ import annotations

import numpy as np
import torch

from tiktoken_tpu_torch.ops.charclass import CharClassTables
from tiktoken_tpu_torch.ops.engine import resolve_device
from tiktoken_tpu_torch.ops.pair_table import EMPTY_KEY, PairTable
from tiktoken_tpu_torch.ops.pieces import LongVocabTable, VocabTable
from tiktoken_tpu_torch.ops.pipeline3 import ChunkTables, upload_tables
from tiktoken_tpu_torch.ops.regex_compiler import ScannerDFA
from tiktoken_tpu_torch.ops.window_scan import hot_byte_scan_table


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


def _byte_dfa(arrays: dict[str, np.ndarray], meta: dict[str, int]) -> ScannerDFA:
    """The port's byte-level ``ScannerDFA`` over the given arrays."""
    trans = np.asarray(arrays["byte_trans"])
    dfa = ScannerDFA(trans=trans, accept=np.asarray(arrays["byte_accept"], np.int8),
                     class_of=np.asarray(arrays["byte_class_of"]),
                     n_states=int(meta["byte_n_states"]), n_classes=int(meta["byte_n_classes"]),
                     pat_str="")
    if trans.shape != (dfa.n_states, dfa.n_classes):
        raise ValueError(f"byte_trans has shape {trans.shape}, meta says "
                         f"({dfa.n_states}, {dfa.n_classes})")
    return dfa


def tables_from_numpy(arrays: dict[str, np.ndarray], meta: dict[str, int],
                      device="cuda") -> ChunkTables:
    """Upload the given table arrays to ``device`` as the chunk programs'
    tables (with the v2/v1 byte-level scan table when the byte-level
    arrays are given)."""
    dev = resolve_device(device)
    tables = upload_tables(*host_tables_from_numpy(arrays, meta), dev)
    if "byte_trans" in arrays:
        table, tables.byte_hot = hot_byte_scan_table(_byte_dfa(arrays, meta))
        tables.byte_scan = torch.as_tensor(table, device=dev)
    return tables
