"""PyTorch port: the sharded engine over a list of CPU devices against the
JAX ``ShardedEngine`` on the virtual CPU mesh, the host encoder and the
reference ``tiktoken``.

The v3 split runs at the multi-chip dry run's geometry (K=64, 8 rows per
chunk, ``__graft_entry__.py``): its ids equal JAX ``encode_corpus3`` on a
2-device mesh and ``encode_ordinary``, and the dry run's training step
over them (one document per row) equals JAX ``corpus_pair_counts``. Both
engines are built from the same tables (``convert.tables_from_numpy``)."""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from tests.helpers import make_mixed_corpus
from tests.test_torch_pipeline2 import random_words

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def torch_engine(jax_engine):
    """A CPU ``TorchEngine`` over a JAX ``DeviceEngine``'s tables, the
    byte-level scan table included."""
    from tiktoken_tpu_torch.convert import tables_from_numpy
    from tiktoken_tpu_torch.ops.engine import TorchEngine

    ct, dfa = jax_engine.char_tables, jax_engine.dfa
    pt, vt, lvt = jax_engine.pair_table, jax_engine.vocab_table, jax_engine.long_vocab_table
    arrays = dict(page_entry=ct.page_entry, mixed_rows=ct.mixed_rows, trans=ct.trans,
                  accept=ct.accept, pair_buckets=pt.buckets, byte_to_rank=pt.byte_to_rank,
                  vocab_buckets=vt.buckets, long_buckets=lvt.buckets, byte_trans=dfa.trans,
                  byte_accept=dfa.accept, byte_class_of=dfa.class_of)
    meta = dict(n_classes=ct.n_classes, eof_class=ct.eof_class, n_states=ct.n_states,
                pair_seed=pt.seed, n_vocab=pt.n_vocab, vocab_seed=vt.seed, long_seed=lvt.seed,
                byte_n_states=dfa.n_states, byte_n_classes=dfa.n_classes)
    return TorchEngine(tables_from_numpy(arrays, meta, device="cpu"))


@pytest.fixture(scope="module")
def dry():
    """The dry run's encoding and documents, and its sharded v3 encode on
    both sides: (enc, docs, port engine, jax ids, port sharded, port ids)."""
    from jax.sharding import Mesh

    from tiktoken_tpu.parallel import ShardedEngine as JaxSharded

    from tiktoken_tpu_torch.parallel import ShardedEngine, data_mesh

    enc, sample = graft._make_encoding()
    third = len(sample) // 3
    docs = [sample[:third], sample[third : 2 * third], sample[2 * third :], sample]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    want = JaxSharded(enc.device_engine, mesh).encode_corpus3(
        docs, host_fallback=enc, K=graft._DRY_K, chunk_rows=graft._DRY_CHUNK)
    eng = torch_engine(enc.device_engine)
    sharded = ShardedEngine(eng, data_mesh(2, device="cpu"))
    got = sharded.encode_corpus3(docs, host_fallback=enc, K=graft._DRY_K,
                                 chunk_rows=graft._DRY_CHUNK)
    return enc, docs, eng, want, sharded, got


def test_sharded_v3_matches_jax_and_host(dry):
    enc, docs, _eng, want, sharded, got = dry
    assert got == want
    assert got == [enc.encode_ordinary(d) for d in docs]
    assert sharded.stats["fallback_docs"] == 0  # ordinary text: no host fallback
    assert sharded.stats["chunks"] > 2  # several dispatches of two chunks
    # the multi-script sample overflows the normal caps at K=64: whole
    # dispatches re-run through the worst-case variant
    assert sharded.stats["worst_case_chunks"] > 0


def test_dry_run_training_step_matches_jax(dry):
    """tokens -> one document per row -> pair counts, as the dry run."""
    from tiktoken_tpu.parallel import corpus_pair_counts as jax_counts
    from tiktoken_tpu.parallel import data_mesh as jax_mesh

    from tiktoken_tpu_torch.parallel import corpus_pair_counts, data_mesh

    toks = [np.asarray(t, dtype=np.uint32) for t in dry[5]]
    K = max(len(t) for t in toks)
    grid = np.zeros((len(toks), K), np.uint32)
    alive = np.zeros((len(toks), K), bool)
    for i, t in enumerate(toks):
        grid[i, : len(t)] = t
        alive[i, : len(t)] = True
    piece_start = np.zeros_like(alive)
    piece_start[:, 0] = True
    hist, best_bin, best_count = corpus_pair_counts(data_mesh(2, device="cpu"), grid, alive,
                                                    piece_start)
    w_hist, w_bin, w_count = jax_counts(jax_mesh(2), grid, alive, piece_start)
    np.testing.assert_array_equal(hist, w_hist)
    assert (best_bin, best_count) == (w_bin, w_count)
    assert int(hist.sum()) == sum(len(t) - 1 for t in toks) and best_count > 0


def test_uneven_rows_on_a_three_way_split(dry):
    from tiktoken_tpu_torch.parallel import ShardedEngine, data_mesh

    enc, _docs, eng, *_ = dry
    docs = [make_mixed_corpus(700, seed=9), "tail", "", make_mixed_corpus(300, seed=4)]
    sharded = ShardedEngine(eng, data_mesh(3, device="cpu"))
    sharded.warmup(K=64, chunk_rows=8)
    got = sharded.encode_corpus(docs, host_fallback=enc, row_capacity=64, chunk_rows=8)
    assert got == [enc.encode_ordinary(d) for d in docs]
    arrays = sharded.encode_corpus(docs, host_fallback=enc, row_capacity=64, chunk_rows=8,
                                   as_numpy=True)
    assert [a.dtype for a in arrays] == [np.uint32] * 4 and [a.tolist() for a in arrays] == got


@pytest.mark.parametrize("scanner", ["byte", "char"])
def test_sharded_v2_reruns_overflowing_chunks_through_v1(dry, scanner):
    """Both v2 scanners over a 2-way split against the host encoder; the
    char route also re-runs its chunk of CJK rows over the non-ASCII cap."""
    from tiktoken_tpu_torch.ops.engine import pack_documents
    from tiktoken_tpu_torch.parallel import ShardedEngine, data_mesh

    enc, _docs, eng, *_ = dry
    texts = [random_words(4000, seed=3), make_mixed_corpus(1500, seed=6), "hello world\n" * 200]
    if scanner == "char":
        texts.append("東京タワーは高い。パリは花の都、" * 40)
    sharded = ShardedEngine(eng, data_mesh(2, device="cpu"))
    got = sharded.encode_corpus(texts, host_fallback=enc, pipeline=2, chunk_rows=8,
                                scanner=scanner)
    assert got == [enc.encode_ordinary(t) for t in texts]
    assert sharded.stats["v1_fallback_chunks"] > 0
    assert sharded.stats["v1_fallback_chunks"] < sharded.stats["chunks"]  # not every chunk
    with pytest.raises(ValueError, match="pipeline must be 2 or 3"):
        sharded.encode_corpus(texts, pipeline=1)
    with pytest.raises(ValueError, match="applies to pipeline=2 only"):
        sharded.encode_corpus(texts, scanner="byte")
    # row by row: each document's rows concatenate to its ids
    batch = pack_documents([t.encode() for t in texts[:3]])
    row_tokens, row_bad = sharded.encode_rows_tokens(batch, chunk_rows=8, scanner=scanner)
    assert not row_bad.any()
    for d, t in enumerate(texts[:3]):
        rows = np.nonzero(batch.doc_index == d)[0]
        assert np.concatenate([row_tokens[r] for r in rows]).tolist() == enc.encode_ordinary(t)


@pytest.mark.parametrize("n", [1, 2])
def test_worst_case_overflow_raises(dry, monkeypatch, n):
    """A worst-case header that still overflows is a fault of the device
    program: the single-device and the sharded encoder raise, and neither
    hands the chunk's documents to the host."""
    from tiktoken_tpu_torch.ops.engine import TorchEngine
    from tiktoken_tpu_torch.parallel import ShardedEngine, data_mesh

    enc, docs, eng, *_ = dry
    real = TorchEngine.enqueue3

    def overflowing(self, *args, **kwargs):
        tok, hdr = real(self, *args, **kwargs)
        hdr = hdr.clone()
        hdr[-1] = 1
        return tok, hdr

    monkeypatch.setattr(TorchEngine, "enqueue3", overflowing)
    target = eng if n == 1 else ShardedEngine(eng, data_mesh(n, device="cpu"))
    before = target.stats["fallback_docs"]
    with pytest.raises(RuntimeError, match="worst-case chunk program overflowed"):
        target.encode_corpus3(docs, host_fallback=enc, K=graft._DRY_K,
                              chunk_rows=graft._DRY_CHUNK)
    assert target.stats["fallback_docs"] == before


def test_encode_rows_stats_match_jax(dry):
    from tiktoken_tpu.ops.engine import pack_documents as jax_pack
    from tiktoken_tpu.parallel import ShardedEngine as JaxSharded
    from tiktoken_tpu.parallel import data_mesh as jax_mesh

    from tiktoken_tpu_torch.ops.engine import pack_documents
    from tiktoken_tpu_torch.parallel import ShardedEngine, data_mesh

    enc, _docs, eng, *_ = dry
    docs = [make_mixed_corpus(1200, seed=s).encode() for s in range(3)]
    batch = pack_documents(docs, 64)
    assert batch.rows.shape[0] % 2 == 1  # one padding row
    packed, counts, row_bad, stats = ShardedEngine(eng, data_mesh(2, device="cpu")).encode_rows(
        batch, chunk_rows=8)
    w_packed, w_counts, w_bad, w_stats = JaxSharded(enc.device_engine, jax_mesh(2)).encode_rows(
        jax_pack(docs, 64))
    np.testing.assert_array_equal(counts, w_counts)
    np.testing.assert_array_equal(row_bad, w_bad)
    np.testing.assert_array_equal(packed, np.asarray(w_packed, np.uint32))
    assert dataclasses.astuple(stats) == dataclasses.astuple(w_stats)
    assert stats.payload_bytes == sum(len(d) for d in docs)
    assert stats.tokens == int(counts.sum()) and stats.rows == batch.rows.shape[0] + 1
    single = eng.encode_rows(batch)
    np.testing.assert_array_equal(single[0], packed)
    np.testing.assert_array_equal(single[1], counts)
    exact = [d for d in range(len(docs)) if d not in batch.hard_cut_docs
             and not row_bad[batch.doc_index == d].any()]
    assert exact  # a hard cut or a bad row sends its document to the host
    for d in exact:
        rows = np.nonzero(batch.doc_index == d)[0]
        ids = np.concatenate([packed[r, : counts[r]] for r in rows]).tolist()
        assert ids == enc.encode_ordinary(docs[d].decode())


def test_mesh_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    from tiktoken_tpu_torch.parallel import data_mesh

    assert data_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        data_mesh()


def test_parallel_and_train_import_nothing_of_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'tiktoken_tpu', 'tiktoken_tpu_ext',\n"
        "                                  'regex', 'tiktoken'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import tiktoken_tpu_torch.parallel, tiktoken_tpu_torch.train\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr
