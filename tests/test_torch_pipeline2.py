"""PyTorch port: the v2 chunk program under both scanners, its v1 re-run,
and the v2 corpus path end to end.

``run_chunk2`` (the CPU path of its kernels) against the JAX
``build_pipeline2_fn(pack24=False)``, with the char-level scanner
(``char_tables`` given, ``scanner="char"``) and with the byte-level one
(``char_tables=None``, ``scanner="byte"``), and ``run_rows1`` against the
JAX ``build_pipeline_fn``, on the same ``pack_documents`` rows and on
tables carried across with ``convert.tables_from_numpy``: the header and
``flat_tok[:n_tokens]`` are equal (tokens only when the chunk did not
overflow: an overflowing chunk's stream is discarded and re-run through
v1), and v1's packed rows, counts, rounds and row flags are equal.
``Encoding.encode_corpus(..., device="cpu", pipeline=2)`` equals the
reference ``tiktoken`` under both scanners, and the port's
``encode_rows_tokens`` equals the JAX ``DeviceEngine``'s row by row."""

from __future__ import annotations

import random

import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_encoding, make_mixed_corpus, make_oracle, special_tokens_for
from tests.test_torch_char_scan import STEP_CAP_DOC
from tests.helpers import trained_ranks

CJK = "東京タワーは高い。パリは花の都、そして京都は古都です。春はあけぼの、やうやう白くなりゆく山際。"
CYR = "Широкая электрификация южных губерний даст мощный толчок подъёму сельского хозяйства. "
K, C = 256, 8  # N = 2048: m_cap = 256 short misses, p_cap = 1024 pieces
KL = K + 16


def random_words(n_chars: int, seed: int) -> str:
    """Random lower-case 4-8-letter words: nearly every piece misses the
    vocabulary, so a chunk overflows the short-miss cap."""
    rng = random.Random(seed)
    out, size = [], 0
    while size < n_chars:
        w = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(rng.randrange(4, 9)))
        out.append(w)
        size += len(w) + 1
    return " ".join(out)


@pytest.fixture(scope="module", params=["byte", "char"])
def setup(request):
    """(scanner, the JAX v2 program and its tables, the JAX v1 program and
    its tables (byte case only: v1 is the same program under both), the
    port's tables)."""
    import jax.numpy as jnp

    from tiktoken_tpu.ops.charclass import prepare_device_tables
    from tiktoken_tpu.ops.engine import build_pipeline_fn
    from tiktoken_tpu.ops.pipeline2 import build_pipeline2_fn
    from tiktoken_tpu.ops.window_scan import expand_packed_to_bytes, pack_trans_accept

    from tiktoken_tpu_torch.convert import tables_from_numpy

    scanner = request.param
    eng = make_encoding("o200k", 800).device_engine
    dfa, ct = eng.dfa, eng.char_tables
    pt, vt, lvt = eng.pair_table, eng.vocab_table, eng.long_vocab_table
    fn2 = jax.jit(build_pipeline2_fn(
        row_total=KL, look=16, pair_seed=pt.seed, pair_buckets=pt.n_buckets,
        vocab_seed=vt.seed, vocab_buckets=vt.n_buckets, long_seed=lvt.seed,
        long_buckets=lvt.n_buckets, B=C, pack24=False,
        char_tables=ct if scanner == "char" else None))
    packed = pack_trans_accept(dfa.trans, dfa.accept)
    if scanner == "char":
        prep = prepare_device_tables(ct)
        scan2 = (jnp.asarray(prep["page_planes"]), jnp.asarray(prep["mixed_t"]))
    else:
        scan2 = jnp.asarray(expand_packed_to_bytes(packed, dfa.class_of))
    args2 = (scan2, jnp.asarray(pt.buckets), jnp.asarray(pt.byte_to_rank),
             (jnp.asarray(vt.buckets), jnp.asarray(lvt.buckets)))
    fn1 = args1 = None
    if scanner == "byte":
        fn1 = jax.jit(build_pipeline_fn(
            row_total=KL, window=48, n_states=dfa.n_states, n_classes=dfa.n_classes,
            eof_cls=int(dfa.class_of[256]), pair_seed=pt.seed, pair_buckets=pt.n_buckets))
        args1 = (jnp.asarray(packed), jnp.asarray(dfa.class_of.astype(np.int32)),
                 jnp.asarray(pt.buckets), jnp.asarray(pt.byte_to_rank))
    arrays = dict(page_entry=ct.page_entry, mixed_rows=ct.mixed_rows, trans=ct.trans,
                  accept=ct.accept, pair_buckets=pt.buckets, byte_to_rank=pt.byte_to_rank,
                  vocab_buckets=vt.buckets, long_buckets=lvt.buckets, byte_trans=dfa.trans,
                  byte_accept=dfa.accept, byte_class_of=dfa.class_of)
    meta = dict(n_classes=ct.n_classes, eof_class=ct.eof_class, n_states=ct.n_states,
                pair_seed=pt.seed, n_vocab=pt.n_vocab, vocab_seed=vt.seed, long_seed=lvt.seed,
                byte_n_states=dfa.n_states, byte_n_classes=dfa.n_classes)
    return scanner, fn2, args2, fn1, args1, tables_from_numpy(arrays, meta, device="cpu")


def _compare(setup, texts, want_overflow: bool):
    from tiktoken_tpu.ops.engine import pack_documents as jpack

    from tiktoken_tpu_torch.ops.engine import pack_documents
    from tiktoken_tpu_torch.ops.pipeline2 import run_chunk2, run_rows1

    scanner, fn2, args2, fn1, args1, tables = setup
    docs = [t.encode() for t in texts]
    jb, pb = jpack(docs, K), pack_documents(docs, K)
    for f in ("rows", "n_payload", "n_total", "doc_index"):
        np.testing.assert_array_equal(getattr(pb, f), getattr(jb, f), err_msg=f)
    assert pb.hard_cut_docs == jb.hard_cut_docs
    overflows = []
    for lo in range(0, pb.rows.shape[0], C):
        rows = np.zeros((C, KL), np.uint8)
        pay, tot = np.zeros(C, np.int32), np.zeros(C, np.int32)
        n = min(C, pb.rows.shape[0] - lo)
        rows[:n], pay[:n], tot[:n] = (a[lo : lo + n] for a in (pb.rows, pb.n_payload, pb.n_total))
        jt, jh = (np.asarray(x) for x in fn2(*args2, rows, pay, tot))
        tt, th = run_chunk2(tables, *(torch.from_numpy(x) for x in (rows, pay, tot)),
                            scanner=scanner)
        th, tt = th.numpy(), tt.numpy().view(np.uint32)
        assert th.shape == (2 * C + 2,)
        np.testing.assert_array_equal(th, jh, err_msg=f"header lo={lo}")
        overflows.append(bool(th[-1]))
        if not th[-1]:
            nt = int(jh[-2])
            np.testing.assert_array_equal(tt[:nt], jt[:nt], err_msg=f"tokens lo={lo}")
        if fn1 is None:
            continue
        # v1 on the same rows
        jp, jc, jr, jbad = (np.asarray(x) for x in fn1(*args1, rows, pay, tot))
        pp, pc, pr, pbad = run_rows1(tables, *(torch.from_numpy(x) for x in (rows, pay, tot)))
        np.testing.assert_array_equal(pp.numpy().view(np.uint32), jp, err_msg=f"v1 lo={lo}")
        np.testing.assert_array_equal(pc.numpy(), jc)
        np.testing.assert_array_equal(pbad.numpy(), jbad)
        assert int(pr) == int(jr)
    assert any(overflows) == want_overflow


def test_mixed_corpus(setup):
    # under the char scanner, rows dense in the corpus's non-Latin words
    # exceed the non-ASCII cap: those chunks overflow, as in JAX
    _compare(setup, [make_mixed_corpus(2500, seed=s) for s in range(2)],
             want_overflow=setup[0] == "char")


def test_short_miss_overflow(setup):
    # random words: more short misses per chunk than m_cap
    _compare(setup, [random_words(3000, seed=1)], want_overflow=True)


def test_piece_and_token_overflow(setup):
    # one-byte pieces: more pieces than p_cap-1 and tokens than t_cap-1
    _compare(setup, ["1a" * 1100, "? " * 300], want_overflow=True)


def test_long_pieces_and_fallback_rows(setup):
    # >64-byte pieces flag their rows; 17..64-byte pieces take the long path;
    # under the char scanner the CJK rows exceed the non-ASCII cap
    _compare(setup, ["x" * 700, "ab" + "c" * 500, "0" * 997, "word" * 12 + " " + "z" * 40,
                     "a\n b", "today\n \n", "🌍🌍🌍 emoji soup 🚀", CJK * 3],
             want_overflow=setup[0] == "char")


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def enc():
    import tiktoken_tpu_torch

    ranks = trained_ranks("o200k", 800)
    return tiktoken_tpu_torch.Encoding(
        "torch_o200k_800", pat_str=tiktoken_tpu_torch.o200k_pat_str,
        mergeable_ranks=ranks, special_tokens=special_tokens_for(ranks),
    )


@pytest.mark.parametrize("scanner", ["char", "byte"])
@pytest.mark.parametrize("corpus", ["mixed", "scripts", "long_runs", "degenerate", "overflow",
                                    "step_cap"])
def test_encode_corpus_v2_matches_tiktoken(enc, corpus, scanner):
    texts = {
        "mixed": [make_mixed_corpus(4000, seed=s) for s in range(3)] + ["", "x", "hello world!"],
        "scripts": [CJK * 20, CYR * 10, CJK[:30] + " and ascii words " + CYR[:40]],
        "long_runs": ["x" * 500, "x" * 500 + " normal words here\nand more", "0" * 997],
        "degenerate": ["a\n b", "today\n \n", " \n\n\n  x", "\t\t\t", " ", "🌍🚀" * 10,
                       "don't you're it's", "1a" * 600, "? " * 300, "word " * 400],
        "overflow": [random_words(6000, seed=2), make_mixed_corpus(1500, seed=7)],
        # rows whose char-scan walks pass the step cap (test_torch_char_scan.py)
        "step_cap": [STEP_CAP_DOC],
    }[corpus]
    eng = enc.engine("cpu")
    before = dict(eng.stats)
    got = enc.encode_corpus(texts, device="cpu", strategy="device", pipeline=2, chunk_rows=8,
                            scanner=scanner)
    oracle = make_oracle("o200k", 800)
    for i, t in enumerate(texts):
        assert got[i] == oracle.encode_ordinary(t), f"doc {i}"
    # the v1 re-run, loud and counted: a short-miss cap overflow, or under
    # the char scanner dense non-ASCII rows
    if corpus == "overflow" or (corpus == "scripts" and scanner == "char"):
        assert eng.stats["v1_fallback_chunks"] > before["v1_fallback_chunks"]
    if corpus in ("scripts", "long_runs"):  # hard cuts, >64-byte pieces: host fallback
        assert eng.stats["fallback_docs"] > before["fallback_docs"]
    if corpus == "step_cap":  # bad rows under the char scan's step cap: host fallback
        assert eng.stats["fallback_docs"] - before["fallback_docs"] == (scanner == "char")
    tokens, offsets = enc.encode_corpus_to_numpy(texts, device="cpu", strategy="device",
                                                 pipeline=2, scanner=scanner)
    assert tokens.dtype == np.uint32
    for i in range(len(texts)):
        assert tokens[offsets[i] : offsets[i + 1]].tolist() == got[i]


def test_pipeline_argument(enc, monkeypatch):
    with pytest.raises(ValueError, match="pipeline must be 2 or 3"):
        enc.encode_corpus(["hello"], device="cpu", pipeline=1)
    with pytest.raises(ValueError, match="scanner must be 'char' or 'byte'"):
        enc.encode_corpus(["hello"], device="cpu", pipeline=2, scanner="seq")
    with pytest.raises(ValueError, match="scanner='byte' applies to pipeline=2 only"):
        enc.encode_corpus_to_numpy(["hello"], device="cpu", scanner="byte")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        enc.encode_corpus(["hello world"], pipeline=2)


def test_row_capacity_over_256_is_capped_like_jax(enc):
    # the v3 path caps K at 256 with a warning, as DeviceEngine.encode_corpus3 does
    texts = [make_mixed_corpus(3000, seed=12), "tail doc 123"]
    with pytest.warns(UserWarning, match="row_capacity=300 capped to 256"):
        got = enc.encode_corpus(texts, device="cpu", strategy="device", row_capacity=300,
                                chunk_rows=8)
    jax_enc = make_encoding("o200k", 800)
    with pytest.warns(UserWarning, match="row_capacity=300 capped to 256"):
        want = jax_enc.device_engine.encode_corpus3(texts, host_fallback=jax_enc,
                                                    K=300, chunk_rows=8)
    assert got == want


# ---------------------------------------------------------------------------
# the v2 entries of the compaction kernel (B10)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p_cap", [128, 16])
def test_catalog2_matches_jax_and_numpy(p_cap):
    """catalog2 = the JAX make_catalog_fn + make_extract_fn + too-long row
    flags; at p_cap=16 the catalog overflows (the numpy spec's last entry
    then runs to the next start, JAX's to its row end: compared with JAX
    only)."""
    from tiktoken_tpu.ops.pieces import (
        catalog_numpy, extract_numpy, make_catalog_fn, make_extract_fn,
    )

    from tiktoken_tpu_torch.ops.compaction import catalog2

    rng = np.random.default_rng(0)
    B, Kc = 4, 96
    rows = rng.integers(32, 127, (B, Kc + 16)).astype(np.uint8)
    piece_start = rng.random((B, Kc)) < 0.25
    piece_start[:, 0] = True
    piece_start[0, 1:70] = False  # a 70-byte piece: its row is flagged
    n_payload = np.asarray([Kc, Kc - 5, 30, 0], np.int32)
    piece_start &= np.arange(Kc)[None, :] < n_payload[:, None]
    row_bad = np.asarray([False, False, True, False])
    starts, words, lens, bad, n = (x.numpy() for x in catalog2(
        torch.from_numpy(piece_start), torch.from_numpy(n_payload), torch.from_numpy(rows),
        torch.from_numpy(row_bad), p_cap))
    js, jl, jn, _pid = (np.asarray(x) for x in jax.jit(make_catalog_fn(B, Kc, p_cap))(
        piece_start, n_payload))
    jw = np.asarray(jax.jit(make_extract_fn(B, Kc, p_cap))(rows[:, :Kc], js, jl))
    assert int(n) == int(jn)
    np.testing.assert_array_equal(starts, js)
    np.testing.assert_array_equal(lens, jl)
    np.testing.assert_array_equal(words.view(np.uint32), jw)
    want_bad = row_bad.copy()
    want_bad[np.minimum(js[jl > 64] // Kc, B - 1)] = True
    np.testing.assert_array_equal(bad, want_bad)
    assert bad[0]
    if int(n) <= p_cap:
        ns, nl, nn = catalog_numpy(piece_start, n_payload, p_cap)
        assert nn == int(n)
        np.testing.assert_array_equal(starts, ns)
        np.testing.assert_array_equal(lens, nl)
        np.testing.assert_array_equal(words.view(np.uint32), extract_numpy(rows[:, :Kc], ns, nl))


def test_extract_slots_and_row_counts():
    from tiktoken_tpu_torch.ops.compaction import (
        expand_numpy, expand_tokens_rows, extract_slots,
    )

    rng = np.random.default_rng(3)
    C, Kc = 5, 80
    rows = rng.integers(0, 256, (C, Kc + 16)).astype(np.uint8)
    starts = np.asarray([0, 17, Kc + 3, 3 * Kc + 40, C * Kc], np.int32)  # the last one is a fill
    lens = np.asarray([64, 20, 0, 33, 0], np.int32)
    got = extract_slots(torch.from_numpy(rows), torch.from_numpy(starts), torch.from_numpy(lens),
                        Kc).numpy()
    for i, (s, ln) in enumerate(zip(starts, lens)):
        want = np.zeros(64, np.uint8)
        if s < C * Kc:
            want[:ln] = rows[s // Kc, s % Kc : s % Kc + ln]
        np.testing.assert_array_equal(got[i], want)
    counts = np.asarray([1, 3, 0, 2, 0], np.int32)
    combo = np.asarray([7 | -0x80000000, 0, 0, 16, 0], np.int32)
    m_tok = np.arange(32, dtype=np.int32) + 100
    tok, total, row_counts = expand_tokens_rows(
        torch.from_numpy(counts), torch.from_numpy(combo), torch.from_numpy(m_tok),
        torch.zeros(64, dtype=torch.int32), 8, torch.from_numpy(starts), Kc, C)
    (e_combo,), e_k, e_valid, e_total = expand_numpy(counts, [combo], 8)
    want = np.where(e_combo < 0, e_combo & 0x7FFFFFFF, m_tok[(e_combo + e_k).clip(0, 31)])
    np.testing.assert_array_equal(tok.numpy(), np.where(e_valid, want, 0))
    assert int(total) == e_total == 6
    np.testing.assert_array_equal(row_counts.numpy(), [4, 0, 0, 2, 0])


def test_encode_rows_tokens_and_v1_rows(enc):
    """The row-level v2 API: each row's tokens, with an overflowing chunk
    re-run through v1, concatenate to each document's reference ids; the
    v1 program alone (encode_rows) gives the same rows."""
    from tiktoken_tpu_torch.ops.engine import pack_documents

    texts = [random_words(2500, seed=5), make_mixed_corpus(1200, seed=8)]
    batch = pack_documents([t.encode() for t in texts])
    eng = enc.engine("cpu")
    before = eng.stats["v1_fallback_chunks"]
    row_tokens, row_bad = eng.encode_rows_tokens(batch, chunk_rows=8)
    assert eng.stats["v1_fallback_chunks"] > before
    assert not row_bad.any() and len(row_tokens) == batch.rows.shape[0]
    packed, counts, bad1 = eng.encode_rows(batch, chunk_rows=8)
    oracle = make_oracle("o200k", 800)
    for d, t in enumerate(texts):
        rows = np.nonzero(batch.doc_index == d)[0]
        assert np.concatenate([row_tokens[r] for r in rows]).tolist() == oracle.encode_ordinary(t)
        assert np.concatenate([packed[r, : counts[r]] for r in rows]).tolist() == \
            oracle.encode_ordinary(t)
    assert not bad1.any()


def test_encode_rows_tokens_matches_jax_row_by_row(enc):
    """The char route row by row against the JAX ``DeviceEngine`` (whose
    default v2 scanner is the char-level one), at chunk_rows=8: the same
    row tokens and row flags, and the same chunks re-run through v1 (a
    short-miss overflow, and a chunk of CJK rows over the non-ASCII
    cap)."""
    from tiktoken_tpu.ops.engine import pack_documents as jax_pack

    from tiktoken_tpu_torch.ops.engine import pack_documents

    texts = [random_words(2000, seed=4), "hello world\n" * 200, CJK * 12,
             make_mixed_corpus(1500, seed=9), "a\n b today\n \n"]
    docs = [t.encode() for t in texts]
    batch = pack_documents(docs)
    jax_eng = make_encoding("o200k", 800).device_engine
    assert jax_eng.char_tables is not None  # the JAX default v2 route
    eng = enc.engine("cpu")
    before, j_before = eng.stats["v1_fallback_chunks"], jax_eng.stats["v1_fallback_chunks"]
    rows, bad = eng.encode_rows_tokens(batch, chunk_rows=8)
    j_rows, j_bad = jax_eng.encode_rows_tokens(jax_pack(docs), chunk_rows=8)
    assert len(rows) == len(j_rows) == batch.rows.shape[0]
    for r, (a, b) in enumerate(zip(rows, j_rows)):
        np.testing.assert_array_equal(a, np.asarray(b, np.uint32), err_msg=f"row {r}")
    np.testing.assert_array_equal(bad, j_bad)
    delta = eng.stats["v1_fallback_chunks"] - before
    assert delta == jax_eng.stats["v1_fallback_chunks"] - j_before
    assert 2 <= delta < -(-batch.rows.shape[0] // 8), delta  # some chunks, not all


def test_replicas_copy_the_source_byte_table(enc):
    """An engine built with ``byte_source`` takes that engine's byte-level
    scan table when it first needs one, and compiles none of its own."""
    from tiktoken_tpu_torch.ops.engine import TorchEngine

    src = enc.engine("cpu")
    replica = TorchEngine(src.tables.to(torch.device("cpu")), byte_source=src)
    replica.tables.byte_scan = None
    assert replica.pat_str is None  # nothing to compile from
    assert torch.equal(replica.byte_tables().byte_scan, src.byte_tables().byte_scan)


# cap -> (documents, the count over that cap; None: the non-ASCII cap of the
# char scanner, every count within its cap)
CAP_CASES = {
    "pieces": (["1a" * 1100], "n_pieces"),
    "misses": (["!q " * 700], "n_miss"),
    "longs": ([(" " + "a" * 24) * 100], "n_long"),
    "tokens": ([(" " + "a" * 17) * 60], "n_tokens"),
    "non_ascii": ([CJK * 6], None),
}


def _counts(setup, texts) -> list[dict]:
    """Each chunk's counts and non-ASCII flag, from the port's plain stages."""
    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.engine import pack_documents
    from tiktoken_tpu_torch.ops.pipeline2 import run_chunk2

    scanner, *_, tables = setup
    b = pack_documents([t.encode() for t in texts], K)
    out = []
    for lo in range(0, b.rows.shape[0], C):
        rows = np.zeros((C, KL), np.uint8)
        pay, tot = np.zeros(C, np.int32), np.zeros(C, np.int32)
        n = min(C, b.rows.shape[0] - lo)
        rows[:n], pay[:n], tot[:n] = (a[lo : lo + n] for a in (b.rows, b.n_payload, b.n_total))
        seen = {}

        def record(name):
            def call(*a, **k):
                seen[name] = getattr(kernels.PLAIN_OPS, name)(*a, **k)
                return seen[name]
            return call

        ops = type("Ops", (), {n_: staticmethod(record(n_)) for n_ in vars(kernels.PLAIN_OPS)})
        _, h = run_chunk2(tables, *(torch.from_numpy(x) for x in (rows, pay, tot)),
                          scanner=scanner, ops=ops)
        out.append(dict(n_pieces=int(seen["catalog2"][4]), n_miss=int(seen["compact_kinds"][1]),
                        n_long=int(seen["compact_kinds"][4]), n_tokens=int(h[-2]),
                        na=scanner == "char" and bool(seen["char_scan"][2]),
                        overflow=bool(h[-1])))
    return out


@pytest.mark.parametrize("cap", list(CAP_CASES))
def test_header_overflow_each_cap(setup, cap):
    """The header written by the assembly (n_tokens, and the overflow rule
    n_pieces > p_cap - 1, n_miss > m_cap, n_long > l_cap, n_tokens > t_cap -
    1, the char scan's non-ASCII flag) equals the JAX program's on a chunk
    over each cap."""
    from tiktoken_tpu_torch.ops.pipeline2 import chunk_caps2

    docs, field = CAP_CASES[cap]
    scanner = setup[0]
    _compare(setup, docs, want_overflow=field is not None or scanner == "char")
    caps = chunk_caps2(K, C)
    limits = dict(n_pieces=caps["p_cap"] - 1, n_miss=caps["m_cap"], n_long=caps["l_cap"],
                  n_tokens=caps["t_cap"] - 1)
    counts = _counts(setup, docs)
    if field is not None:
        assert any(c[field] > limits[field] and c["overflow"] for c in counts)
    elif scanner == "char":
        assert any(c["na"] and c["overflow"] and all(c[k] <= v for k, v in limits.items())
                   for c in counts)
