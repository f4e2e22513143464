"""PyTorch port: its table builders give the JAX package's arrays exactly,
``convert.tables_from_numpy`` carries the JAX engine's tables across, and
tables refuse to build against the wrong Unicode data."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from tests.helpers import make_encoding, pat_str, trained_ranks

PORT_PATTERNS = ("cl100k", "o200k")


def _port_pat(name):
    import tiktoken_tpu_torch.patterns as pp

    return {"cl100k": pp.cl100k_pat_str, "o200k": pp.o200k_pat_str}[name]


def test_patterns_are_the_shipped_ones():
    for name in PORT_PATTERNS:
        assert _port_pat(name) == pat_str(name)


@pytest.mark.parametrize("name", PORT_PATTERNS)
def test_char_tables_and_scan_consts_match_jax(name):
    from tiktoken_tpu.ops.charclass import build_char_class_tables as jbuild
    from tiktoken_tpu.ops.regex_compiler import compile_pattern_chars as jcompile
    from tiktoken_tpu.ops.sweep_scan import build_scan_consts as jconsts

    from tiktoken_tpu_torch.ops.charclass import build_char_class_tables
    from tiktoken_tpu_torch.ops.regex_compiler import compile_pattern_chars
    from tiktoken_tpu_torch.ops.sweep_scan import build_scan_consts

    jd, pd = jcompile(pat_str(name)), compile_pattern_chars(_port_pat(name))
    for f in ("trans", "accept", "edges", "seg_class"):
        np.testing.assert_array_equal(getattr(pd, f), getattr(jd, f), err_msg=f)
    assert (pd.eof_class, pd.n_states, pd.n_classes) == (jd.eof_class, jd.n_states, jd.n_classes)
    jt, pt = jbuild(jd), build_char_class_tables(pd)
    for f in ("page_entry", "mixed_rows", "trans", "accept"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(jt, f), err_msg=f)
    assert (pt.n_classes, pt.eof_class, pt.n_states) == (jt.n_classes, jt.eof_class, jt.n_states)
    np.testing.assert_array_equal(build_scan_consts(pt), jconsts(jt))


def test_vocab_tables_match_jax():
    from tiktoken_tpu.ops.pair_table import build_pair_table as jpair
    from tiktoken_tpu.ops.pieces import build_long_vocab_table as jlong
    from tiktoken_tpu.ops.pieces import build_vocab_table as jvocab

    from tiktoken_tpu_torch.ops.pair_table import build_pair_table
    from tiktoken_tpu_torch.ops.pieces import build_long_vocab_table, build_vocab_table

    ranks = dict(trained_ranks("o200k", 800))
    for n in range(17, 40, 3):  # some long tokens for the long table
        ranks[b"q" * n] = len(ranks)
    jp, pp = jpair(ranks), build_pair_table(ranks)
    np.testing.assert_array_equal(pp.buckets, jp.buckets)
    np.testing.assert_array_equal(pp.byte_to_rank, jp.byte_to_rank)
    assert (pp.seed, pp.n_buckets, pp.n_pairs, pp.n_vocab) == (
        jp.seed, jp.n_buckets, jp.n_pairs, jp.n_vocab)
    for jb, pb in ((jvocab(ranks), build_vocab_table(ranks)),
                   (jlong(ranks), build_long_vocab_table(ranks))):
        np.testing.assert_array_equal(pb.buckets, jb.buckets)
        assert (pb.seed, pb.n_buckets) == (jb.seed, jb.n_buckets)


def _jax_engine_arrays(eng):
    ct, pt, vt, lvt = eng.char_tables, eng.pair_table, eng.vocab_table, eng.long_vocab_table
    arrays = dict(page_entry=ct.page_entry, mixed_rows=ct.mixed_rows, trans=ct.trans,
                  accept=ct.accept, pair_buckets=pt.buckets, byte_to_rank=pt.byte_to_rank,
                  vocab_buckets=vt.buckets, long_buckets=lvt.buckets)
    meta = dict(n_classes=ct.n_classes, eof_class=ct.eof_class, n_states=ct.n_states,
                pair_seed=pt.seed, n_vocab=pt.n_vocab, vocab_seed=vt.seed,
                long_seed=lvt.seed)
    return arrays, meta


def test_tables_from_numpy_round_trips_the_jax_engine():
    from tiktoken_tpu.ops.sweep_scan import build_scan_consts as jconsts

    from tiktoken_tpu_torch.convert import host_tables_from_numpy, tables_from_numpy
    from tiktoken_tpu_torch.ops.engine import host_tables

    eng = make_encoding("o200k", 800).device_engine
    arrays, meta = _jax_engine_arrays(eng)
    t = tables_from_numpy(arrays, meta, device="cpu")
    assert t.device == torch.device("cpu")

    def u32(x):
        return x.numpy().view(np.uint32)

    np.testing.assert_array_equal(t.scan.page_entry.numpy(), arrays["page_entry"])
    np.testing.assert_array_equal(t.scan.mixed_rows.numpy(), arrays["mixed_rows"])
    np.testing.assert_array_equal(u32(t.scan.consts), jconsts(eng.char_tables))
    assert (t.scan.n_classes, t.scan.eof_class) == (meta["n_classes"], meta["eof_class"])
    np.testing.assert_array_equal(u32(t.pair_buckets), arrays["pair_buckets"])
    np.testing.assert_array_equal(u32(t.byte_to_rank), arrays["byte_to_rank"])
    np.testing.assert_array_equal(u32(t.vocab_buckets), arrays["vocab_buckets"])
    np.testing.assert_array_equal(u32(t.long_buckets), arrays["long_buckets"])
    assert (t.pair_seed, t.vocab_seed, t.long_seed) == (
        meta["pair_seed"], meta["vocab_seed"], meta["long_seed"])

    # the port's own builders give the same host tables
    char, pair, vocab, long = host_tables_from_numpy(arrays, meta)
    mine = host_tables(pat_str("o200k"), trained_ranks("o200k", 800))
    for a, b in zip((char, pair, vocab, long), mine):
        for f, v in vars(a).items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(getattr(b, f), v, err_msg=f)
            else:
                assert getattr(b, f) == v, f


def test_tables_refuse_other_unicode_data(monkeypatch):
    import unicodedata

    from tiktoken_tpu_torch.ops.regex_compiler import compile_pattern_chars

    monkeypatch.setattr(unicodedata, "unidata_version", "14.0.0")
    with pytest.raises(RuntimeError, match="15.0.0"):
        compile_pattern_chars(_port_pat("o200k"))


def test_load_tiktoken_bpe_matches_jax():
    from tiktoken_tpu.load import load_tiktoken_bpe as jload

    from tiktoken_tpu_torch.load import load_tiktoken_bpe

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "bench_vocab2_100000.tiktoken")
    assert load_tiktoken_bpe(path) == jload(path)
