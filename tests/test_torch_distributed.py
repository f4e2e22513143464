"""PyTorch port: the sharded engine across processes.

Two gloo ranks (``torch.multiprocessing.spawn``, a ``FileStore`` in
``tmp_path``), each on ``device="cpu"`` so the plain versions run, call
``ShardedEngine(engine, mesh, group=WORLD)`` with the same inputs (SPMD,
as the JAX program over a mesh of two processes in
``tests/test_distributed.py``). The ranks import nothing of JAX: they
build their engines with the port from the vocabulary the parent passes
them, and write their results to ``tmp_path``. The parent holds them
against the port's one-process ``ShardedEngine``, the reference
``tiktoken`` 0.13 and the JAX ``ShardedEngine`` on the virtual CPU mesh.
One spawn runs every case; a second one makes one rank fail.

The vocabulary is the o200k pattern's 512-rank trained vocabulary of
``tests/helpers.py`` at the multi-chip dry run's geometry (K=64, 8 rows a
chunk), as ``tests/test_torch_parallel.py``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from tests.helpers import make_mixed_corpus, make_oracle, trained_ranks
from tiktoken_tpu_torch._utf8 import fix_surrogates, utf8_bytes

VOCAB = 512
K, CHUNK = 64, 8
WORLD = 2
DEADLINE_S = 180  # a spawn that has not finished by then is killed and fails
CJK = "東京タワーは高い。パリは花の都、" * 40  # dense non-ASCII: a v2-char chunk goes to v1
FALLBACK = "x" * 300  # one piece over 64 bytes: the document falls back to the host
# lone surrogates (each encodes as U+FFFD) in 16 v2 rows: the corpus's 48
# rows split over the two ranks in whole chunks of 8, as without it (32)
SURROGATE = ("\ud800" + make_mixed_corpus(3100, seed=5).replace("!", "\udfff!").replace(
    "?", "\ud83d ?") + "\udc00\ud800")


def random_words(n_chars: int, seed: int) -> str:
    """Random lower-case words (``tests/test_torch_pipeline2.py``): nearly
    every piece misses the vocabulary, so a v2 chunk overflows into v1."""
    import random

    rng = random.Random(seed)
    out, size = [], 0
    while size < n_chars:
        w = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(rng.randrange(4, 9)))
        out.append(w)
        size += len(w) + 1
    return " ".join(out)


def corpus() -> list[str]:
    """Mixed documents and the edge documents: empty, one that falls back
    to the host, dense CJK, random words, and lone surrogates."""
    return [make_mixed_corpus(900, seed=1), "", make_mixed_corpus(1500, seed=2), FALLBACK,
            CJK, random_words(1500, seed=3), make_mixed_corpus(400, seed=4), "tail", SURROGATE]


def row_docs() -> list[bytes]:
    """``tests/test_torch_parallel.py``'s rows: an odd row count at K=64."""
    return [make_mixed_corpus(1200, seed=s).encode() for s in range(3)]


def port_encoding(ranks: dict[bytes, int]):
    import tiktoken_tpu_torch

    return tiktoken_tpu_torch.Encoding(
        f"dist_o200k_{VOCAB}", pat_str=tiktoken_tpu_torch.o200k_pat_str, mergeable_ranks=ranks,
        special_tokens={"<|endoftext|>": len(ranks)})


CASES = ("v3", "v3_np", "v3_one_doc", "v3_none", "v2_char", "rows_tokens_char", "v2_byte",
         "rows_tokens_byte", "rows")  # in the order run_cases runs them


def delta(res: dict, name: str) -> dict:
    """What case ``name`` added to the engine's ``stats``."""
    i = CASES.index(name)
    after = res[name + ".stats"]
    before = res[CASES[i - 1] + ".stats"] if i else dict.fromkeys(after, 0)
    return {k: after[k] - before[k] for k in after}


def run_cases(sharded, enc, docs: list[str], out: dict) -> None:
    """Every case on one engine (a rank's, or the one-process one), with its
    ``stats`` after each call."""
    from tiktoken_tpu_torch.ops.engine import pack_documents

    def record(name, value):
        out[name] = value
        out[name + ".stats"] = dict(sharded.stats)
        out[name + ".timing"] = dict(sharded.timing)

    record("v3", sharded.encode_corpus3(docs, host_fallback=enc, K=K, chunk_rows=CHUNK))
    record("v3_np", sharded.encode_corpus(docs, host_fallback=enc, row_capacity=K,
                                          chunk_rows=CHUNK, as_numpy=True))
    record("v3_one_doc", sharded.encode_corpus3(["tail end"], host_fallback=enc, K=K,
                                                chunk_rows=CHUNK))
    record("v3_none", sharded.encode_corpus3([], host_fallback=enc, K=K, chunk_rows=CHUNK))
    for scanner in ("char", "byte"):
        record(f"v2_{scanner}", sharded.encode_corpus(docs, host_fallback=enc, pipeline=2,
                                                      chunk_rows=CHUNK, scanner=scanner))
        batch = pack_documents([utf8_bytes(d) for d in docs])
        record(f"rows_tokens_{scanner}", sharded.encode_rows_tokens(batch, chunk_rows=CHUNK,
                                                                    scanner=scanner))
    record("rows", sharded.encode_rows(pack_documents(row_docs(), K), chunk_rows=CHUNK))


def _rank(rank: int, store_path: str, out_dir: str, ranks: dict, fail: bool) -> None:
    import torch.distributed as dist

    from tiktoken_tpu_torch.ops.engine import pack_documents
    from tiktoken_tpu_torch.parallel import ShardedEngine, data_mesh

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=60))
    try:
        enc = port_encoding(ranks)
        eng = enc.engine("cpu")
        out: dict = {}
        if fail:
            # the document that needs the host lies in rank 1's share, and
            # no host encoder is given: rank 1's encode raises
            sharded = ShardedEngine(eng, data_mesh(1, device="cpu"), group=dist.group.WORLD)
            try:
                sharded.encode_corpus3(["hello world " * 40, FALLBACK], K=K, chunk_rows=CHUNK)
            except (ValueError, RuntimeError) as e:
                out["error"] = (type(e).__name__, str(e))
            # the group still works after the failure
            out["after"] = sharded.encode_corpus3(["hello world", "again"], host_fallback=enc,
                                                  K=K, chunk_rows=CHUNK)
        else:
            docs = corpus()
            for n_local in (1, 2):
                sharded = ShardedEngine(eng, data_mesh(n_local, device="cpu"),
                                        group=dist.group.WORLD)
                part: dict = {}
                run_cases(sharded, enc, docs, part)
                out[n_local] = part
            # meshes of different sizes: rank r holds 1 + 2r devices
            sharded = ShardedEngine(eng, data_mesh(1 + 2 * rank, device="cpu"),
                                    group=dist.group.WORLD)
            out["mixed"] = (sharded.mesh_sizes, sharded.encode_rows(
                pack_documents(row_docs(), K), chunk_rows=CHUNK))
        out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "tiktoken_tpu", "tiktoken_tpu_ext", "tiktoken"))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, name: str, ranks: dict, fail: bool) -> list[dict]:
    """Run ``_rank`` in WORLD processes; kill them and fail past the
    deadline. Returns each rank's results."""
    import torch.multiprocessing as mp

    out_dir = tmp_path / name
    out_dir.mkdir()
    ctx = mp.spawn(_rank, args=(str(out_dir / "store"), str(out_dir), ranks, fail),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks did not finish within {DEADLINE_S} s")
    results = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two spawns, and the one-process runs on meshes of 2 and 4
    devices (the global device counts of the ranks' meshes)."""
    from tiktoken_tpu_torch.parallel import ShardedEngine, data_mesh

    tmp = tmp_path_factory.mktemp("dist")
    ranks = trained_ranks("o200k", VOCAB)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp / "dfa"))  # the ranks read what this writes
        enc = port_encoding(ranks)
        eng = enc.engine("cpu")
        eng.byte_tables()  # the byte-level DFA on disk for the ranks' v1 re-runs
        single = {}
        for n_local in (1, 2):
            part: dict = {}
            run_cases(ShardedEngine(eng, data_mesh(WORLD * n_local, device="cpu")), enc, corpus(),
                      part)
            single[n_local] = part
        ranked = spawn(tmp, "cases", ranks, fail=False)
        failed = spawn(tmp, "fail", ranks, fail=True)
    return enc, single, ranked, failed


def oracle_ids(docs) -> list[list[int]]:
    oracle = make_oracle("o200k", VOCAB)
    return [oracle.encode_ordinary(d) for d in docs]


def test_document_shares_are_contiguous_and_balanced():
    from tiktoken_tpu_torch.parallel.encode import document_shares

    docs = ["a" * 100, "b" * 100, "ü" * 100, "c" * 100, b"d" * 100]  # a str by characters
    assert document_shares(docs, 1).tolist() == [0, 5]
    assert document_shares(docs, 5).tolist() == [0, 1, 2, 3, 4, 5]
    # the third document's middle is at 250 of 500: the second half
    assert document_shares(docs, 2).tolist() == [0, 2, 5]
    assert document_shares(["x" * 1000, "y"], 2).tolist() == [0, 1, 2]
    assert document_shares(["only"], 3).tolist() == [0, 0, 1, 1]  # fewer documents than ranks
    assert document_shares(["", ""], 2).tolist() == [0, 2, 2]
    assert document_shares([], 2).tolist() == [0, 0, 0]
    sizes = np.random.default_rng(0).integers(0, 5000, size=200)
    b = document_shares([b"z" * int(n) for n in sizes], 4)
    per_rank = [int(sizes[b[r] : b[r + 1]].sum()) for r in range(4)]
    assert max(per_rank) - min(per_rank) <= 2 * int(sizes.max())


def test_ranks_import_nothing_of_jax(runs):
    *_, ranked, failed = runs
    for res in ranked + failed:
        assert res["modules"] == []


def test_v3_ids_across_processes(runs):
    """v3, lists and arrays, on ranks with one and two local devices: the
    one-process engine's ids, ``tiktoken``'s and the JAX ``ShardedEngine``'s
    on a 2-device virtual mesh."""
    from tiktoken_tpu.parallel import ShardedEngine as JaxSharded
    from tiktoken_tpu.parallel import data_mesh as jax_mesh

    from tests.helpers import make_encoding

    enc, single, ranked, _ = runs
    docs = corpus()
    want = oracle_ids(docs)
    jax_enc = make_encoding("o200k", VOCAB)
    # the JAX device route raises on a lone surrogate: it takes the text as
    # the reference encodes it
    jax_ids = JaxSharded(jax_enc.device_engine, jax_mesh(WORLD)).encode_corpus3(
        [fix_surrogates(d) for d in docs], host_fallback=jax_enc, K=K, chunk_rows=CHUNK)
    assert jax_ids == want
    for n_local in (1, 2):
        assert single[n_local]["v3"] == want
        for res in ranked:
            got = res[n_local]
            assert got["v3"] == want
            assert [a.dtype for a in got["v3_np"]] == [np.uint32] * len(docs)
            assert [a.tolist() for a in got["v3_np"]] == want
            assert got["v3_one_doc"] == oracle_ids(["tail end"])  # one rank's share is empty
            assert got["v3_none"] == []


@pytest.fixture(scope="module")
def jax_rows_tokens():
    """The JAX ``ShardedEngine``'s v2 rows of the corpus on a 2-device
    virtual mesh (its char-level scanner): (row_tokens, row_bad)."""
    from tiktoken_tpu.ops.engine import pack_documents as jax_pack
    from tiktoken_tpu.parallel import ShardedEngine as JaxSharded
    from tiktoken_tpu.parallel import data_mesh as jax_mesh

    from tests.helpers import make_encoding

    jax_enc = make_encoding("o200k", VOCAB)
    row_tokens, row_bad = JaxSharded(jax_enc.device_engine, jax_mesh(WORLD)).encode_rows_tokens(
        jax_pack([utf8_bytes(d) for d in corpus()]), chunk_rows=CHUNK)
    return [np.asarray(t, np.uint32) for t in row_tokens], np.asarray(row_bad)


@pytest.mark.parametrize("scanner", ["char", "byte"])
def test_v2_ids_across_processes(runs, jax_rows_tokens, scanner):
    """v2 under both scanners: ids, row tokens and row flags equal the
    one-process engine's and ``tiktoken``'s, and each document whose rows
    no flag marks concatenates its rows to ``tiktoken``'s ids; a chunk
    re-ran through v1. The char scanner's rows and flags equal the JAX
    ``ShardedEngine``'s; the byte scanner (which JAX has not) flags fewer
    rows of the CJK document, and the rows that neither flags are JAX's."""
    from tiktoken_tpu_torch.ops.engine import pack_documents

    _enc, single, ranked, _ = runs
    j_tok, j_bad = jax_rows_tokens
    docs = corpus()
    want = oracle_ids(docs)
    batch = pack_documents([utf8_bytes(d) for d in docs])
    for n_local in (1, 2):
        s_tok, s_bad = single[n_local][f"rows_tokens_{scanner}"]
        for res in ranked:
            got = res[n_local]
            assert got[f"v2_{scanner}"] == want
            r_tok, r_bad = got[f"rows_tokens_{scanner}"]
            assert len(r_tok) == batch.rows.shape[0] == len(s_tok)
            assert all(a.dtype == np.uint32 for a in r_tok)
            assert [a.tolist() for a in r_tok] == [a.tolist() for a in s_tok]
            np.testing.assert_array_equal(r_bad, s_bad)
            assert r_bad.dtype == bool
            assert delta(got, f"v2_{scanner}")["v1_fallback_chunks"] > 0
            if scanner == "char":
                np.testing.assert_array_equal(r_bad, j_bad)
            both = ~(r_bad | j_bad)
            assert [a.tolist() for a, ok in zip(r_tok, both) if ok] == [
                a.tolist() for a, ok in zip(j_tok, both) if ok]
            clean = []
            for d, ids in enumerate(want):
                rows = np.nonzero(batch.doc_index == d)[0]
                if not r_bad[rows].any():
                    clean.append(d)
                    assert [t for r in rows for t in r_tok[r].tolist()] == ids
            assert {0, 1, 6, 7, 8} <= set(clean)  # a v1 re-run may flag every row of its chunk


def test_encode_rows_across_processes(runs):
    """v1 rows over the global device list: 2 ranks x 1 device against the
    JAX ``ShardedEngine`` on a 2-device virtual mesh (rows, counts, flags
    and ``CorpusStats``), and 2 ranks x 2 devices against the port's
    one-process engine on 4 devices (the padding counts in ``rows``)."""
    from tiktoken_tpu.ops.engine import pack_documents as jax_pack
    from tiktoken_tpu.parallel import ShardedEngine as JaxSharded
    from tiktoken_tpu.parallel import data_mesh as jax_mesh

    from tests.helpers import make_encoding

    _enc, single, ranked, _ = runs
    jax_enc = make_encoding("o200k", VOCAB)
    w_packed, w_counts, w_bad, w_stats = JaxSharded(jax_enc.device_engine,
                                                    jax_mesh(WORLD)).encode_rows(
        jax_pack(row_docs(), K))
    B = len(w_counts)
    for n_local in (1, 2):
        s_packed, s_counts, s_bad, s_stats = single[n_local]["rows"]
        for res in ranked:
            packed, counts, row_bad, stats = res[n_local]["rows"]
            assert packed.dtype == np.uint32 and counts.dtype == np.int32 and row_bad.dtype == bool
            np.testing.assert_array_equal(packed, s_packed)
            np.testing.assert_array_equal(counts, s_counts)
            np.testing.assert_array_equal(row_bad, s_bad)
            assert stats == s_stats
            assert stats.rows == B + (-B) % (WORLD * n_local)
            if n_local == 1:
                np.testing.assert_array_equal(packed, np.asarray(w_packed, np.uint32))
                np.testing.assert_array_equal(counts, w_counts)
                np.testing.assert_array_equal(row_bad, w_bad)
                assert dataclasses.astuple(stats) == dataclasses.astuple(w_stats)


def test_encode_rows_over_meshes_of_different_sizes(runs):
    """Rank 0 holds 1 device and rank 1 holds 3: the rows split over the 4
    devices of the global list, as the one-process engine on 4 devices
    splits them, padding included."""
    _enc, single, ranked, _ = runs
    s_packed, s_counts, s_bad, s_stats = single[2]["rows"]
    B = len(s_counts)
    assert s_stats.rows == B + (-B) % 4 > B  # padding rows on the global list
    for res in ranked:
        sizes, (packed, counts, row_bad, stats) = res["mixed"]
        assert sizes == [1, 3]
        np.testing.assert_array_equal(packed, s_packed)
        np.testing.assert_array_equal(counts, s_counts)
        np.testing.assert_array_equal(row_bad, s_bad)
        assert stats == s_stats


def test_stats_sum_over_ranks(runs):
    """After each call every rank holds the same ``stats``; the rows and
    tokens sum to the one-process run's, and on v3 the fallback documents
    too. The chunk counts may differ: each rank cuts chunks of its own
    share. So may v2's fallback documents: a chunk that overflows re-runs
    through v1, whose window scan flags every row of the chunk when the
    chunk trips its cap of unresolved positions (as in JAX: the v1
    program flags all 8 rows of this corpus's CJK chunk, and not the
    random-words row among them when that row runs alone)."""
    _enc, single, ranked, _ = runs
    for n_local in (1, 2):
        one = single[n_local]
        r0, r1 = (res[n_local] for res in ranked)
        for name in CASES:
            assert r0[name + ".stats"] == r1[name + ".stats"]
            assert delta(r0, name)["rows"] == delta(one, name)["rows"]
        for name in ("v3", "v3_np", "v3_one_doc"):
            assert delta(r0, name)["fallback_docs"] == delta(one, name)["fallback_docs"]
        assert delta(r0, "v3")["fallback_docs"] == 1  # FALLBACK
        for name in ("v3", "v2_char", "v2_byte"):
            assert sum(map(len, r0[name])) == sum(map(len, one[name]))  # tokens
    for res in ranked:  # each rank's own phases, and the collectives
        for n_local in (1, 2):
            for name in CASES:
                assert "gather_s" in res[n_local][name + ".timing"]
            assert {"pack_s", "fetch_s"} <= set(res[n_local]["v3.timing"])


def test_a_failing_rank_stops_every_rank(runs):
    """Rank 1's share needs the host and no host encoder is given: rank 1
    raises its own ``ValueError``, rank 0 a ``RuntimeError`` naming rank 1,
    both within the deadline; the group then encodes again."""
    *_, failed = runs
    r0, r1 = failed
    assert r1["error"][0] == "ValueError" and "need host fallback" in r1["error"][1]
    assert r0["error"][0] == "RuntimeError" and "rank(s) [1]" in r0["error"][1]
    want = oracle_ids(["hello world", "again"])
    assert r0["after"] == r1["after"] == want


def test_a_group_that_does_not_fit_raises(monkeypatch):
    from tiktoken_tpu_torch.parallel import collective

    monkeypatch.setattr(collective.dist, "get_backend", lambda group: "nccl")
    with pytest.raises(ValueError, match="needs the rank's engines on a CUDA device"):
        collective.collective_device(None, torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="is not the current CUDA device"):
        collective.collective_device(None, torch.device("cuda", 1))
    assert collective.collective_device(None, torch.device("cuda", 0)) == torch.device("cuda", 0)
    monkeypatch.setattr(collective.dist, "get_backend", lambda group: "mpi")
    with pytest.raises(ValueError, match="unsupported process-group backend 'mpi'"):
        collective.collective_device(None, torch.device("cpu"))
    monkeypatch.setattr(collective.dist, "get_backend", lambda group: "gloo")
    assert collective.collective_device(None, torch.device("cuda", 3)) == torch.device("cpu")


def test_v1_flags_every_row_of_a_chunk_over_its_scan_cap():
    """Why v2's host fallbacks may differ with the chunking: the v1 program
    flags every row of a chunk whose window scan trips its chunk-wide cap
    of unresolved positions, in the port and in JAX alike. The last seven
    CJK rows of this corpus and the first random-words row make such a
    chunk (8 rows, a chunk tier: no padding rows); that row alone is not
    flagged."""
    from tiktoken_tpu.ops.engine import pack_documents as jax_pack
    from tiktoken_tpu.parallel import ShardedEngine as JaxSharded
    from tiktoken_tpu.parallel import data_mesh as jax_mesh

    from tests.helpers import make_encoding
    from tiktoken_tpu_torch.ops.engine import pack_documents
    from tiktoken_tpu_torch.parallel.encode import _rows_of

    docs = [utf8_bytes(d) for d in corpus()]
    batch = pack_documents(docs)
    cjk = np.nonzero(batch.doc_index == 4)[0]
    rows = slice(int(cjk[-1]) - 6, int(cjk[-1]) + 2)
    assert (batch.doc_index[rows] == [4] * 7 + [5]).all()
    eng = port_encoding(trained_ranks("o200k", VOCAB)).engine("cpu")
    jax_engine = JaxSharded(make_encoding("o200k", VOCAB).device_engine, jax_mesh(1))
    jb = jax_pack(docs)
    for sl, want in ((rows, True), (slice(rows.stop - 1, rows.stop), False)):
        row_bad = eng.encode_rows(_rows_of(batch, sl))[2]
        j_bad = np.asarray(jax_engine.encode_rows(dataclasses.replace(
            jb, rows=jb.rows[sl], n_payload=jb.n_payload[sl], n_total=jb.n_total[sl],
            doc_index=jb.doc_index[sl]))[2])
        np.testing.assert_array_equal(row_bad, j_bad)
        assert row_bad.all() if want else not row_bad.any()
