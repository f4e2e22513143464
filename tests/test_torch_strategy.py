"""PyTorch port, corpus strategies: ``Encoding.resolve_corpus_strategy``,
``encode_corpus(strategy="host" | "device" | "hybrid")`` on the CPU, the
hybrid queue's failures, ``warmup``, and the checkpointed
``StreamEncoder``.

Every strategy equals ``encode_ordinary`` and the reference ``tiktoken``
0.13, as lists and as arrays. Which worker of the hybrid queue takes which
document depends on timing, so no test asserts the split. An exception in
either worker reaches the caller, and no document is encoded twice. The
stream encoder's shards equal the JAX package's under ``strategy="host"``.
The module's DFA cache lives in a temporary directory.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from tests.helpers import make_mixed_corpus, make_oracle, pat_str, special_tokens_for, trained_ranks

CJK = "東京タワーは高い。パリは花の都、そして京都は古都です。"
DOCS = ([make_mixed_corpus(1500, seed=s) for s in range(10)]
        + ["", "x" * 900, "0" * 500, CJK * 12, "tail doc 123"])


@pytest.fixture(scope="module")
def enc(tmp_path_factory):
    import tiktoken_tpu_torch

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp_path_factory.mktemp("cache")))
        ranks = trained_ranks("o200k", 800)
        yield tiktoken_tpu_torch.Encoding("strategy", pat_str=pat_str("o200k"),
                                          mergeable_ranks=ranks,
                                          special_tokens=special_tokens_for(ranks))


@pytest.fixture(scope="module")
def want():
    oracle = make_oracle("o200k", 800)
    return [oracle.encode_ordinary(d) for d in DOCS]


@pytest.mark.parametrize("strategy,device,expected", [
    ("host", "cpu", "host"), ("device", "cpu", "device"), ("hybrid", "cpu", "hybrid"),
    ("auto", "cpu", "host"), ("host", "cuda", "host"), ("device", "cuda", "device"),
])
def test_resolve_corpus_strategy(enc, strategy, device, expected):
    assert enc.resolve_corpus_strategy(strategy, device=device) == expected


def test_resolve_corpus_strategy_refuses(enc):
    with pytest.raises(ValueError, match="unknown corpus strategy"):
        enc.encode_corpus(["hello"], device="cpu", strategy="hyrbid")
    with pytest.raises(ValueError, match="unknown corpus strategy"):
        enc.resolve_corpus_strategy("fastest")
    if torch.cuda.is_available():
        assert enc.resolve_corpus_strategy("auto", device="cuda") in ("hybrid", "host")
    else:
        # "auto" never carries on on the CPU when the caller named CUDA
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            enc.resolve_corpus_strategy("auto", device="cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            enc.encode_corpus(["hello"])


@pytest.mark.parametrize("strategy", ["auto", "host", "device", "hybrid"])
def test_strategies_equal_encode_ordinary_and_tiktoken(enc, want, strategy):
    got = enc.encode_corpus(DOCS, device="cpu", strategy=strategy)
    assert got == want
    assert got == [enc.encode_ordinary(d) for d in DOCS]
    report = enc.corpus_report
    assert report["strategy"] == ("host" if strategy == "auto" else strategy)
    assert sum(report["docs"].values()) == len(DOCS)
    tokens, offsets = enc.encode_corpus_to_numpy([d.encode() for d in DOCS], device="cpu",
                                                 strategy=strategy)
    assert tokens.dtype == np.uint32 and offsets.dtype == np.int64
    assert [tokens[offsets[i] : offsets[i + 1]].tolist() for i in range(len(DOCS))] == want
    assert enc.encode_ordinary_batch(DOCS, num_threads=2) == want


def test_auto_keeps_a_pattern_outside_the_device_dialect_on_the_host(monkeypatch):
    """Where "auto" would take the device (a GPU), a pattern the device
    cannot scan stays on the host; an explicit "device" raises."""
    import tiktoken
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch.ops.regex_compiler import PatternError

    pattern = r"(?<=x)ab|[a-z]+|\s+|."
    ranks = {**{bytes([b]): b for b in range(256)}, b"ab": 256}
    enc = tiktoken_tpu_torch.Encoding("lookbehind", pat_str=pattern, mergeable_ranks=ranks,
                                      special_tokens={})
    resolve = enc.resolve_corpus_strategy
    monkeypatch.setattr(enc, "resolve_corpus_strategy", lambda strategy, device: (
        "hybrid" if strategy == "auto" else resolve(strategy, device=device)))
    texts = ["xab cab aa bb\n", "aab xxab abab"]
    oracle = tiktoken.Encoding("o", pat_str=pattern, mergeable_ranks=ranks, special_tokens={})
    assert enc.encode_corpus(texts, device="cpu") == [oracle.encode_ordinary(t) for t in texts]
    assert enc.corpus_report["strategy"] == "host"
    for strategy in ("device", "hybrid"):
        with pytest.raises(PatternError, match="outside the device scanner's dialect"):
            enc.encode_corpus(texts, device="cpu", strategy=strategy)


def _record_workers(monkeypatch, enc, fail: str):
    """Record the documents each worker takes; the worker named ``fail``
    raises on its first grab, after the other has taken one. The host
    worker's first grab waits for the device worker's, and takes six
    documents (three threads), so the device worker always finds some."""
    from tiktoken_tpu_torch import core

    monkeypatch.setattr(core.os, "cpu_count", lambda: 4)
    taken = {"host": [], "device": []}
    device_in = threading.Event()
    host_encode, device_encode = enc._host_encode, enc._device_encode

    def host(texts, as_numpy, num_threads):
        device_in.wait(30)  # let the device worker take its first grab
        taken["host"].extend(texts)
        if fail == "host":
            raise RuntimeError("host worker failed")
        return host_encode(texts, as_numpy, num_threads)

    def device(texts, *args):
        taken["device"].extend(texts)
        device_in.set()
        if fail == "device":
            raise RuntimeError("device worker failed")
        return device_encode(texts, *args)

    monkeypatch.setattr(enc, "_host_encode", host)
    monkeypatch.setattr(enc, "_device_encode", device)
    return taken


@pytest.mark.parametrize("fail", ["device", "host"])
def test_hybrid_worker_exception_reaches_the_caller(monkeypatch, enc, fail):
    docs = [f"document {i} " + make_mixed_corpus(200, seed=i) for i in range(40)]
    taken = _record_workers(monkeypatch, enc, fail)
    encoded = []
    real = enc.encode_ordinary
    monkeypatch.setattr(enc, "encode_ordinary", lambda t: encoded.append(t) or real(t))
    with pytest.raises(RuntimeError, match=f"{fail} worker failed"):
        enc.encode_corpus(docs, device="cpu", strategy="hybrid")
    assert taken["device"] and taken["host"]
    # no document went through both workers, and none was re-encoded on
    # the host after the failure
    assert not set(taken["device"]) & set(taken["host"])
    assert encoded == []


def test_hybrid_device_worker_takes_part(monkeypatch, enc, want):
    """With the host worker held until the device worker has taken a grab,
    both take documents and the ids are still exact."""
    taken = _record_workers(monkeypatch, enc, fail="")
    got = enc.encode_corpus(DOCS, device="cpu", strategy="hybrid")
    assert got == want
    assert taken["device"] and taken["host"]
    assert sorted(taken["device"] + taken["host"]) == sorted(DOCS)
    assert enc.corpus_report["docs"] == {"host": len(taken["host"]),
                                         "device": len(taken["device"])}
    assert "pack_s" in enc.corpus_report["device_timing"]


def test_warmup_on_the_cpu(enc):
    enc.warmup(device="cpu", chunk_rows=8)
    assert enc._core_bpe.native_core() is not None
    assert torch.device("cpu") in enc._engines


def test_stream_encoder_checkpoint_resume_matches_jax(tmp_path, enc, want):
    import os

    from tests.helpers import make_encoding
    from tiktoken_tpu.ops import artifacts as jax_artifacts
    from tiktoken_tpu.parallel.stream import StreamEncoder as JaxStreamEncoder
    from tiktoken_tpu_torch.ops import artifacts
    from tiktoken_tpu_torch.parallel import StreamEncoder

    # the JAX host core reads its byte DFA from its own cache, seeded with
    # the port's arrays (held equal in tests/test_torch_window_scan.py)
    dfa = artifacts.cached_scanner_dfa(pat_str("o200k"))
    jax_artifacts.store_arrays(jax_artifacts.artifact_key("scanner-dfa", pat_str("o200k").encode()),
                               {"trans": dfa.trans, "accept": dfa.accept,
                                "class_of": dfa.class_of})

    docs = [make_mixed_corpus(400, seed=s) for s in range(10)]
    out = tmp_path / "port"
    se = StreamEncoder(enc, str(out), shard_docs=3)
    totals = se.encode_corpus(docs, device="cpu", strategy="host")
    assert totals["shards"] == 4 and totals["resumed"] == 0
    want_tokens = sum(len(enc.encode_ordinary(d)) for d in docs)
    assert totals["tokens"] == want_tokens

    # the JAX stream encoder writes the same shards
    jax_se = JaxStreamEncoder(make_encoding("o200k", 800), str(tmp_path / "jax"), shard_docs=3)
    jax_se.encode_corpus(docs, strategy="host")
    for i in range(4):
        flat, offs = se.read_shard(i)
        jflat, joffs = jax_se.read_shard(i)
        assert flat.dtype == jflat.dtype == np.uint32
        assert np.array_equal(flat, jflat) and offs == joffs

    # resume: a fresh encoder over the same directory skips every shard
    se2 = StreamEncoder(enc, str(out), shard_docs=3)
    totals2 = se2.encode_corpus(docs, device="cpu", strategy="host")
    assert totals2["resumed"] == 4 and totals2["tokens"] == want_tokens
    flat, offs = se2.read_shard(1)
    for j, d in enumerate(docs[3:6]):
        assert flat[offs[j] : offs[j + 1]].tolist() == enc.encode_ordinary(d)

    # a lost shard (a crash before its write) is redone, the rest resume
    os.remove(str(out / "shard_000002.npy"))
    se3 = StreamEncoder(enc, str(out), shard_docs=3)
    totals3 = se3.encode_corpus(docs, device="cpu", strategy="device")
    assert totals3["resumed"] == 3 and totals3["tokens"] == want_tokens
    flat, offs = se3.read_shard(2)
    assert [flat[offs[j] : offs[j + 1]].tolist() for j in range(3)] == [
        enc.encode_ordinary(d) for d in docs[6:9]]
