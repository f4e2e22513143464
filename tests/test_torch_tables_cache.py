"""PyTorch port: the disk cache of the engine's hash tables.

``ops/engine.host_tables`` keeps the pair, short-vocab and long-vocab
tables of a vocabulary as artifacts keyed by a sha256 of the ranks
(``_pair_table_fingerprint``), under the port's own ``compiled-torch``
directory, as the JAX package's ``ops/engine.py`` keeps its own. A second
build loads all three; the loaded arrays equal the built ones and the JAX
package's; a file that does not load is rebuilt; with the cache off, or a
directory that cannot be written, every build builds and nothing raises;
the ids of an engine on cached tables do not change. The o200k pattern's
600-rank trained vocabulary; each test has its own cache directory.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from tests.helpers import make_mixed_corpus, make_oracle, pat_str, special_tokens_for, trained_ranks

VOCAB = 600
BUILDERS = ("build_pair_table", "build_vocab_table", "build_long_vocab_table")


def tables():
    from tiktoken_tpu_torch.ops.engine import host_tables

    return host_tables(pat_str("o200k"), trained_ranks("o200k", VOCAB))[1:]


def assert_same(a, b) -> None:
    assert type(a) is type(b)
    for f, v in vars(a).items():
        if isinstance(v, np.ndarray):
            assert getattr(b, f).dtype == v.dtype, f
            np.testing.assert_array_equal(getattr(b, f), v, err_msg=f)
        else:
            assert getattr(b, f) == v, f


def count_builds(monkeypatch) -> dict[str, int]:
    from tiktoken_tpu_torch.ops import engine

    calls = dict.fromkeys(BUILDERS, 0)
    for name in BUILDERS:
        def counted(ranks, _name=name, _real=getattr(engine, name)):
            calls[_name] += 1
            return _real(ranks)

        monkeypatch.setattr(engine, name, counted)
    return calls


def npz_files(d) -> list[str]:
    return sorted(f for f in os.listdir(d) if f.endswith(".npz")) if os.path.isdir(d) else []


def table_files() -> list[str]:
    """The names of the three tables' files, from their artifact keys."""
    from tiktoken_tpu_torch.ops import artifacts
    from tiktoken_tpu_torch.ops.engine import _pair_table_fingerprint

    fp = _pair_table_fingerprint(trained_ranks("o200k", VOCAB))
    return sorted(artifacts.artifact_key(kind, fp) + ".npz"
                  for kind in ("pair-table", "vocab-table", "long-vocab-table"))


def test_second_build_loads_every_table(monkeypatch, tmp_path):
    from tiktoken_tpu.ops import engine as jax_engine

    from tiktoken_tpu_torch.ops import engine

    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp_path))
    built = tables()
    stored = npz_files(tmp_path / "compiled-torch")
    assert set(table_files()) <= set(stored)

    def boom(ranks):
        raise AssertionError("a table was built where the cache holds it")

    for name in BUILDERS:
        monkeypatch.setattr(engine, name, boom)
    loaded = tables()
    assert npz_files(tmp_path / "compiled-torch") == stored
    ranks = trained_ranks("o200k", VOCAB)
    jax_tables = (jax_engine._cached_pair_table(ranks), jax_engine._cached_vocab_table(ranks),
                  jax_engine._cached_long_vocab_table(ranks))
    for b, lo, j in zip(built, loaded, jax_tables, strict=True):
        assert_same(b, lo)
        for f, v in vars(j).items():  # the JAX package's table, field for field
            mine = getattr(b, f)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(mine, v, err_msg=f)
            else:
                assert mine == v, f
    # neither package reads the other's files
    assert npz_files(tmp_path / "compiled") and not set(npz_files(tmp_path / "compiled")) & set(
        stored)


def test_corrupt_file_is_rebuilt(monkeypatch, tmp_path):
    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp_path))
    built = tables()
    d = tmp_path / "compiled-torch"
    for f in table_files():
        path = d / f
        path.write_bytes(path.read_bytes()[:100])  # truncated
    calls = count_builds(monkeypatch)
    for a, b in zip(built, tables(), strict=True):
        assert_same(a, b)
    assert calls == dict.fromkeys(BUILDERS, 1)
    for a, b in zip(built, tables(), strict=True):  # stored again: loaded now
        assert_same(a, b)
    assert calls == dict.fromkeys(BUILDERS, 1)


@pytest.mark.parametrize("where", ["off", "unwritable"])
def test_cache_off_or_unwritable_builds_every_time(monkeypatch, tmp_path, where):
    from tiktoken_tpu_torch.ops import artifacts

    if where == "off":
        monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", "")
        assert artifacts.artifact_dir() is None
    else:
        blocker = tmp_path / "a_file"
        blocker.write_text("not a directory")
        monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(blocker))
    calls = count_builds(monkeypatch)
    first, second = tables(), tables()
    for a, b in zip(first, second, strict=True):
        assert_same(a, b)
    assert calls == dict.fromkeys(BUILDERS, 2)
    assert [p.name for p in tmp_path.iterdir()] == ([] if where == "off" else ["a_file"])


def test_fingerprint_changes_with_one_rank():
    from tiktoken_tpu.ops.engine import _pair_table_fingerprint as jax_fingerprint

    from tiktoken_tpu_torch.ops.engine import _pair_table_fingerprint

    ranks = dict(trained_ranks("o200k", VOCAB))
    fp = _pair_table_fingerprint(ranks)
    assert fp == jax_fingerprint(ranks)
    assert _pair_table_fingerprint(dict(reversed(list(ranks.items())))) == fp  # rank order
    token = max(ranks, key=ranks.get)
    ranks[token] += 1
    assert _pair_table_fingerprint(ranks) != fp


def test_engine_from_cached_tables_gives_the_same_ids(monkeypatch, tmp_path):
    import tiktoken_tpu_torch

    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp_path))
    ranks = trained_ranks("o200k", VOCAB)
    docs = [make_mixed_corpus(400, seed=s) for s in range(2)] + [""]
    want = [make_oracle("o200k", VOCAB).encode_ordinary(d) for d in docs]
    calls = count_builds(monkeypatch)
    encs = [tiktoken_tpu_torch.Encoding("cached", pat_str=pat_str("o200k"), mergeable_ranks=ranks,
                                        special_tokens=special_tokens_for(ranks))
            for _ in range(2)]
    built, loaded = (e.engine("cpu") for e in encs)  # built and stored, then loaded
    assert calls == dict.fromkeys(BUILDERS, 1)
    assert loaded is not built and loaded.vocab_report == built.vocab_report
    assert encs[1].encode_corpus(docs, device="cpu", strategy="device") == want
