"""PyTorch port, native host core: ``tiktoken_tpu_torch.native`` (the C++
core built with g++ at first use), the v3 cutter on it, and the disk cache
of compiled DFAs (``ops/artifacts.py``).

- ``NativeCore`` equals the JAX package's ``NativeCore``, the port's
  pure-Python encoder (``HostBPE.encode_ordinary_python``) and the
  reference ``tiktoken`` 0.13, exactly, on the tests' trained vocabularies
  under the cl100k and o200k patterns; its batch call equals its
  per-document calls; ``decode_bytes`` refuses a special id.
- ``pack_cuts3`` equals the port's numpy ``_doc_cuts_np`` and the JAX
  ``pack_cuts3`` on valid UTF-8; ``pack_corpus3`` gives identical arrays
  with either cutter, and a document that is not UTF-8 is cut, encoded or
  refused exactly as by the numpy cutter alone.
- A failed build raises with the compiler's output; a failed call raises.
- The cache: a hit equals a fresh compile, a corrupt file is compiled and
  written again, the port never reads the JAX package's directory, and
  the engine and the host splitter share one char-DFA compile.

The module's cache lives in a temporary directory (``TIKTOKEN_TPU_CACHE_DIR``);
the JAX ``NativeCore`` reads its byte DFA from its own cache there, seeded
with the port's arrays (the two compilers' arrays are held equal in
``tests/test_torch_window_scan.py``), so each pattern compiles once here.
"""

from __future__ import annotations

import os
import stat

import numpy as np
import pytest
import tiktoken
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.helpers import (
    MAX_EXAMPLES,
    make_mixed_corpus,
    make_oracle,
    pat_str,
    special_tokens_for,
    trained_ranks,
)

PATS = ("cl100k", "o200k")
EDGE = ["", "x", "hello world", "a\nb\r\nc  d", "0" * 40, "x" * 5000, "  " * 300, "🌍🚀" * 20,
        "A\U000323b0", "'s 'LL", "naïve café 東京 ١٢٣ 12345678"]
SMALL_PATTERN = r"[a-z]+|\s+|."


@pytest.fixture(scope="module", autouse=True)
def cores(tmp_path_factory):
    """Per pattern: (port NativeCore, JAX NativeCore, port HostBPE, oracle),
    under a module-wide temporary cache."""
    from tiktoken_tpu.native import NativeCore as JaxNativeCore
    from tiktoken_tpu.ops import artifacts as jax_artifacts

    from tiktoken_tpu_torch._pybpe import HostBPE
    from tiktoken_tpu_torch.native import NativeCore
    from tiktoken_tpu_torch.ops import artifacts

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp_path_factory.mktemp("cache")))
        out = {}
        for name in PATS:
            ranks = trained_ranks(name)
            dfa = artifacts.cached_scanner_dfa(pat_str(name))
            jax_artifacts.store_arrays(
                jax_artifacts.artifact_key("scanner-dfa", pat_str(name).encode()),
                {"trans": dfa.trans, "accept": dfa.accept, "class_of": dfa.class_of})
            out[name] = (NativeCore(pat_str(name), ranks), JaxNativeCore(pat_str(name), ranks),
                         HostBPE(ranks, special_tokens_for(ranks), pat_str(name)),
                         make_oracle(name))
        yield out


@pytest.mark.parametrize("name", PATS)
def test_native_core_matches_jax_python_and_tiktoken(cores, name):
    core, jax_core, host, oracle = cores[name]
    texts = [make_mixed_corpus(4000, seed=s) for s in range(4)] + EDGE
    for t in texts:
        want = oracle.encode_ordinary(t)
        assert core.encode_ordinary(t) == want, repr(t[:40])
        assert jax_core.encode_ordinary(t) == want
        assert host.encode_ordinary_python(t) == want
        assert host.encode_ordinary(t) == want
        assert core.encode_ordinary_numpy(t.encode()).tolist() == want
    assert host.native_core() is not None


@settings(max_examples=MAX_EXAMPLES, deadline=None)
@given(text=st.text(max_size=200))
def test_native_core_fuzz(cores, text):
    core, jax_core, host, oracle = cores["o200k"]
    try:
        text.encode("utf-8")
    except UnicodeEncodeError:
        text = text.encode("utf-16", "surrogatepass").decode("utf-16", "replace")
    want = oracle.encode_ordinary(text)
    assert core.encode_ordinary(text) == want == jax_core.encode_ordinary(text)
    assert host.encode_ordinary_python(text) == want


def test_native_core_heap_path_long_pieces(cores):
    """Pieces of 512 bytes or more take the heap merge."""
    core, jax_core, host, oracle = cores["cl100k"]
    for s in ["x" * 100_000, "0" * 2000, " " * 1500, "ab" * 5000]:
        want = oracle.encode_ordinary(s)
        assert core.encode_ordinary(s) == want == jax_core.encode_ordinary(s)
        if len(s) <= 10_000:
            assert host.encode_ordinary_python(s) == want


@pytest.mark.parametrize("threads", [1, 3])
def test_batch_arrays_equal_per_document_calls(cores, threads):
    core, _, host, _ = cores["o200k"]
    texts = [make_mixed_corpus(2000, seed=s) for s in range(7)] + EDGE
    flat, offs = core.encode_ordinary_batch_arrays(texts, num_threads=threads)
    assert flat.dtype == np.uint32 and offs.dtype == np.int64 and len(offs) == len(texts) + 1
    want = [core.encode_ordinary(t) for t in texts]
    assert [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(texts))] == want
    assert core.encode_ordinary_batch(texts, num_threads=threads) == want
    assert host.encode_ordinary_batch(texts, num_threads=threads) == want
    empty = core.encode_ordinary_batch_arrays([])
    assert empty[0].size == 0 and empty[1].tolist() == [0]


def test_decode_bytes_and_special_ids(cores):
    core, jax_core, _, _ = cores["o200k"]
    ranks = trained_ranks("o200k")
    t = make_mixed_corpus(1000, seed=5)
    ids = core.encode_ordinary(t)
    assert core.decode_bytes(ids) == t.encode() == jax_core.decode_bytes(ids)
    assert core.decode_bytes([]) == b""
    special = special_tokens_for(ranks)["<|endoftext|>"]
    with pytest.raises(KeyError) as e:
        core.decode_bytes(ids[:3] + [special] + ids[3:5])
    assert e.value.args[0] == special


@given(st.binary(min_size=0, max_size=4000), st.sampled_from([40, 64, 176]))
@settings(max_examples=MAX_EXAMPLES, deadline=None)
def test_pack_cuts3_matches_numpy_and_jax(data, K):
    from tiktoken_tpu.native import pack_cuts3 as jax_pack_cuts3

    from tiktoken_tpu_torch.native import pack_cuts3
    from tiktoken_tpu_torch.ops.pipeline3 import DIGIT_BACKUP, _doc_cuts_np

    data = data.decode("utf-8", errors="replace").encode("utf-8")  # valid UTF-8
    arr = np.frombuffer(data, np.uint8)
    if len(arr) <= K:
        return
    got = pack_cuts3(arr, K, DIGIT_BACKUP)
    assert np.array_equal(got, _doc_cuts_np(arr, K))
    assert np.array_equal(got, jax_pack_cuts3(arr, K, DIGIT_BACKUP))


DIGIT_DOCS = [
    b"7" * 5000,  # one giant run: the raw cuts stay in the run
    (b"abc " + b"9" * 30) * 300,  # runs shorter than the backup
    (b"x" * 170 + b"12345678901234567890123456789012345678901234567890") * 40,
    "東京1234567890".encode() * 400,
]


@pytest.mark.parametrize("doc", DIGIT_DOCS, ids=["one_run", "short_runs", "long_runs", "cjk"])
def test_pack_cuts3_digit_runs(doc):
    from tiktoken_tpu.native import pack_cuts3 as jax_pack_cuts3

    from tiktoken_tpu_torch.native import pack_cuts3
    from tiktoken_tpu_torch.ops.pipeline3 import DIGIT_BACKUP, _doc_cuts_np

    arr = np.frombuffer(doc, np.uint8)
    for K in (64, 176):
        got = pack_cuts3(arr, K, DIGIT_BACKUP)
        assert np.array_equal(got, _doc_cuts_np(arr, K))
        assert np.array_equal(got, jax_pack_cuts3(arr, K, DIGIT_BACKUP))


def _numpy_cutter(monkeypatch):
    """Make ``pack_corpus3`` cut every document with the numpy spec, as it
    did before the native cutter."""
    from tiktoken_tpu_torch.ops import pipeline3

    monkeypatch.setattr(pipeline3, "_doc_cuts", lambda data, K, utf8: pipeline3._doc_cuts_np(
        data, K))


def _arrays(pc):
    return {k: getattr(pc, k) for k in ("flat", "row_off", "n_payload", "n_total", "is_doc_end",
                                         "prev_same_doc", "doc_index")}


@pytest.mark.parametrize("K", [64, 176])
def test_pack_corpus3_identical_with_either_cutter(monkeypatch, K):
    from tiktoken_tpu.ops.pipeline3 import pack_corpus3 as jax_pack_corpus3

    from tiktoken_tpu_torch.ops.pipeline3 import pack_corpus3

    docs = [make_mixed_corpus(3000, seed=s).encode() for s in range(4)] + DIGIT_DOCS + [b"", b"x"]
    native_pc = pack_corpus3(docs, K, utf8=[True] * len(docs))
    checked_pc = pack_corpus3(docs, K)
    jax_pc = jax_pack_corpus3(docs, K)
    _numpy_cutter(monkeypatch)
    numpy_pc = pack_corpus3(docs, K)
    for k, want in _arrays(numpy_pc).items():
        assert np.array_equal(_arrays(native_pc)[k], want), k
        assert np.array_equal(_arrays(checked_pc)[k], want), k
        assert np.array_equal(_arrays(jax_pc)[k], want), k


NOT_UTF8 = [
    b"hello \xff\xfe world, " * 40,  # stray bytes between characters
    b"\x80" * 500,  # continuation bytes only: no character starts anywhere
    b"a" + b"\x80" * 400,  # one character start, then a run past the backup
    "東京".encode() * 60 + b"\xe6\x9d",  # a truncated last character
]


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the outcome compared is the exception itself
        return type(e).__name__, str(e)


@pytest.mark.parametrize("doc", NOT_UTF8, ids=["stray", "continuations", "long_run", "truncated"])
def test_non_utf8_bytes_document_behaves_as_before(monkeypatch, cores, doc):
    """A bytes document that is not UTF-8 is cut by the numpy cutter, as
    before the native cutter: the packed arrays, and what the device path
    then returns or raises, are those of the numpy cutter."""
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch import native
    from tiktoken_tpu_torch.ops.pipeline3 import DIGIT_BACKUP, pack_corpus3

    K = 64
    ranks = trained_ranks("o200k")
    enc = tiktoken_tpu_torch.Encoding("t", pat_str=pat_str("o200k"), mergeable_ranks=ranks,
                                      special_tokens=special_tokens_for(ranks))
    docs = [make_mixed_corpus(500, seed=1).encode(), doc]

    def run():
        pc = _outcome(lambda: _arrays(pack_corpus3(docs, K)))
        ids = _outcome(lambda: enc.encode_corpus(docs, device="cpu", strategy="device",
                                                 row_capacity=K))
        return pc, ids

    now = run()
    _numpy_cutter(monkeypatch)
    before = run()
    assert now[0][0] == before[0][0] and now[1] == before[1]
    if now[0][0] == "ok":
        for k, want in before[0][1].items():
            assert np.array_equal(now[0][1][k], want), k
    if doc.startswith(b"\x80"):
        # the case the check exists for: the native cutter would cut at the
        # grid, where the numpy cutter finds no character start
        assert native.pack_cuts3(np.frombuffer(doc, np.uint8), K, DIGIT_BACKUP).size > 0
        assert now[0][0] != "ok"


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    from tiktoken_tpu_torch import native

    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'core.cpp:1: error: no compiler here' >&2\nexit 3\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)exit 3.*no compiler here"):
        native.load_library()
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.NativeCore(SMALL_PATTERN, {bytes([b]): b for b in range(256)})
    assert os.listdir(tmp_path / "build") == []  # no half-written library left behind


def test_failed_native_call_raises(cores):
    """A scan that makes no progress (a pattern that matches no character
    of the text) raises in the core, as in the pure-Python spec."""
    from tiktoken_tpu_torch._pybpe import HostBPE

    host = HostBPE({bytes([b]): b for b in range(256)}, {}, r"[a-z]+")
    assert host.native_core() is not None
    assert host.encode_ordinary("abc") == [97, 98, 99]
    with pytest.raises(RuntimeError, match="no progress"):
        host.encode_ordinary("ab !")
    with pytest.raises(RuntimeError, match="no progress"):
        host.encode_ordinary_batch(["abc", "ab !"])
    with pytest.raises(RuntimeError, match="no progress"):
        host.encode_ordinary_python("ab !")


def _forget(artifacts, d):
    """Drop the in-memory artifacts of cache directory ``d``."""
    for slot in [s for s in artifacts._memo if s[0] == d]:
        del artifacts._memo[slot]


def test_artifact_cache_hit_equals_fresh_compile(monkeypatch, tmp_path):
    from tiktoken_tpu_torch.ops import artifacts
    from tiktoken_tpu_torch.ops.regex_compiler import compile_pattern, compile_pattern_chars

    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp_path))
    d = artifacts.artifact_dir()
    assert d == os.path.join(str(tmp_path), "compiled-torch")
    first = artifacts.cached_scanner_dfa(SMALL_PATTERN), artifacts.cached_char_dfa(SMALL_PATTERN)
    assert len(os.listdir(d)) == 2
    assert artifacts.cached_scanner_dfa(SMALL_PATTERN) is first[0]  # one compile per process
    _forget(artifacts, d)
    monkeypatch.setattr(artifacts, "compile_pattern", None)  # a hit must not compile
    monkeypatch.setattr(artifacts, "compile_pattern_chars", None)
    hit = artifacts.cached_scanner_dfa(SMALL_PATTERN)
    chit = artifacts.cached_char_dfa(SMALL_PATTERN)
    fresh, cfresh = compile_pattern(SMALL_PATTERN), compile_pattern_chars(SMALL_PATTERN)
    for f in ("trans", "accept", "class_of"):
        assert np.array_equal(getattr(hit, f), getattr(fresh, f))
        assert getattr(hit, f).dtype == getattr(fresh, f).dtype
    assert (hit.n_states, hit.n_classes, hit.pat_str) == (fresh.n_states, fresh.n_classes,
                                                          SMALL_PATTERN)
    for f in ("trans", "accept", "edges", "seg_class"):
        assert np.array_equal(getattr(chit, f), getattr(cfresh, f))
        assert getattr(chit, f).dtype == getattr(cfresh, f).dtype
    assert (chit.eof_class, chit.n_states, chit.n_classes) == (cfresh.eof_class, cfresh.n_states,
                                                               cfresh.n_classes)
    _forget(artifacts, d)


def test_artifact_cache_recompiles_a_corrupt_file(monkeypatch, tmp_path):
    from tiktoken_tpu_torch.ops import artifacts
    from tiktoken_tpu_torch.ops.regex_compiler import compile_pattern

    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp_path))
    d = artifacts.artifact_dir()
    artifacts.cached_scanner_dfa(SMALL_PATTERN)
    (path,) = [os.path.join(d, f) for f in os.listdir(d)]
    with open(path, "wb") as f:
        f.write(b"not an npz")
    _forget(artifacts, d)
    got = artifacts.cached_scanner_dfa(SMALL_PATTERN)
    assert np.array_equal(got.trans, compile_pattern(SMALL_PATTERN).trans)
    with np.load(path) as z:  # written again, whole
        assert np.array_equal(z["trans"], got.trans)
    _forget(artifacts, d)


def test_artifact_cache_never_reads_the_jax_directory(monkeypatch, tmp_path):
    from tiktoken_tpu.ops import artifacts as jax_artifacts

    from tiktoken_tpu_torch.ops import artifacts

    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp_path))
    jax_artifacts.cached_scanner_dfa(SMALL_PATTERN)
    jax_dir = jax_artifacts._artifact_dir()
    assert os.listdir(jax_dir)
    # a poisoned file in the JAX directory under every name the port uses
    key = artifacts.artifact_key("scanner-dfa", SMALL_PATTERN.encode())
    np.savez(os.path.join(jax_dir, key + ".npz"), trans=np.zeros((2, 2), np.uint16),
             accept=np.zeros(2, np.int8), class_of=np.zeros(257, np.uint16))
    compiles = []
    real = artifacts.compile_pattern
    monkeypatch.setattr(artifacts, "compile_pattern", lambda p: compiles.append(p) or real(p))
    got = artifacts.cached_scanner_dfa(SMALL_PATTERN)
    assert compiles == [SMALL_PATTERN]
    assert artifacts.artifact_dir() != jax_dir
    assert os.listdir(artifacts.artifact_dir()) == [key + ".npz"]
    assert got.n_states > 2
    _forget(artifacts, artifacts.artifact_dir())


def test_engine_and_host_split_share_one_char_dfa_compile(monkeypatch, tmp_path):
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch.ops import artifacts

    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp_path))
    compiles = []
    real = artifacts.compile_pattern_chars
    monkeypatch.setattr(artifacts, "compile_pattern_chars",
                        lambda p: compiles.append(p) or real(p))
    ranks = {**{bytes([b]): b for b in range(256)}, b"ab": 256, b"abc": 257}
    enc = tiktoken_tpu_torch.Encoding("small", pat_str=SMALL_PATTERN, mergeable_ranks=ranks,
                                      special_tokens={})
    eng = enc.engine("cpu")
    assert enc._core_bpe.split("abc ab x") == ["abc", " ", "ab", " ", "x"]
    assert enc._core_bpe.char_dfa() is artifacts.cached_char_dfa(SMALL_PATTERN)
    assert enc.encode_corpus(["abc ab x"], device="cpu", strategy="device") == [[257, 32, 256,
                                                                               32, 120]]
    assert eng.tables is not None and compiles == [SMALL_PATTERN]
    oracle = tiktoken.Encoding("o", pat_str=SMALL_PATTERN, mergeable_ranks=ranks,
                               special_tokens={})
    assert enc.encode_ordinary("abc ab x") == oracle.encode_ordinary("abc ab x")
    _forget(artifacts, artifacts.artifact_dir())
