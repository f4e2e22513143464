"""PyTorch port: a ``str`` document with lone surrogates, on every corpus
route.

A lone surrogate (U+D800-U+DFFF, not half of a pair) has no UTF-8 form.
The reference ``tiktoken`` 0.13 and the port's ``encode_ordinary`` encode
it as U+FFFD; every corpus route must give the same ids: the host, device
(v3, v2 under both scanners) and hybrid strategies as lists and arrays,
the hybrid queue's device worker drawing such a document, the stream
encoder (its manifest's byte count too) and a 2-way CPU ``ShardedEngine``
on v3 and v2. Two patterns, o200k and cl100k, on 600-rank trained
vocabularies. The documents mix lone surrogates (leading, trailing, one
that looks like the first half of a pair, two in a row, a real pair) with
valid text, whose ids must not change.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

from tests.helpers import make_mixed_corpus, make_oracle, pat_str, special_tokens_for, trained_ranks

VOCAB = 600
SURROGATE_DOCS = [
    "\ud800 leading lone surrogate",
    "trailing lone surrogate \udfff",
    "looks paired \ud83d x, and a real pair 😀 here",
    "two in a row \udc00\ud800 then text",
    "a\ud800b hello",
]
DOCS = SURROGATE_DOCS + [make_mixed_corpus(500, seed=s) for s in range(3)] + ["", "tail 123"]
PATTERNS = ("o200k", "cl100k")


@pytest.fixture(scope="module", params=PATTERNS)
def case(request):
    """(the port's encoding, the reference ids of ``DOCS``, the pattern's
    name) for a pattern."""
    import tiktoken_tpu_torch

    ranks = trained_ranks(request.param, VOCAB)
    enc = tiktoken_tpu_torch.Encoding(f"surrogates_{request.param}",
                                      pat_str=pat_str(request.param), mergeable_ranks=ranks,
                                      special_tokens=special_tokens_for(ranks))
    want = [make_oracle(request.param, VOCAB).encode_ordinary(d) for d in DOCS]
    assert want == [enc.encode_ordinary(d) for d in DOCS]
    return enc, want, request.param


def as_lists(tokens: np.ndarray, offsets: np.ndarray) -> list[list[int]]:
    assert tokens.dtype == np.uint32 and offsets.dtype == np.int64
    return [tokens[offsets[i] : offsets[i + 1]].tolist() for i in range(len(offsets) - 1)]


def test_utf8_bytes():
    from tiktoken_tpu_torch._utf8 import utf8_bytes

    assert utf8_bytes("naïve 東京") == "naïve 東京".encode()
    assert utf8_bytes("a\ud800b") == "a�b".encode()
    assert utf8_bytes("😀 \udc00\ud800") == "😀 ��".encode()
    assert utf8_bytes(b"not utf-8 \xff\xfe") == b"not utf-8 \xff\xfe"  # bytes are left alone
    assert utf8_bytes(bytearray(b"ab")) == b"ab"


@pytest.mark.parametrize("route", [
    dict(strategy="host"),
    dict(strategy="device", pipeline=3),
    dict(strategy="device", pipeline=2, scanner="char"),
    dict(strategy="device", pipeline=2, scanner="byte"),
    dict(strategy="hybrid"),
], ids=["host", "device_v3", "device_v2_char", "device_v2_byte", "hybrid"])
def test_corpus_routes(case, route):
    enc, want, _ = case
    assert enc.encode_corpus(DOCS, device="cpu", **route) == want
    assert as_lists(*enc.encode_corpus_to_numpy(DOCS, device="cpu", **route)) == want


def test_hybrid_device_worker_draws_a_surrogate_document(monkeypatch, case):
    """Every document holds a lone surrogate, and the host worker's first
    encode waits until the device worker has taken a grab: on 4 cores the
    host worker grabs 6 documents at a time, so of 10 the device worker
    takes one or more whatever the order of the two workers' grabs."""
    from tiktoken_tpu_torch import core

    enc, _, name = case
    docs = [d + s for d, s in zip(DOCS, SURROGATE_DOCS * 2, strict=True)]
    want = [make_oracle(name, VOCAB).encode_ordinary(d) for d in docs]
    monkeypatch.setattr(core.os, "cpu_count", lambda: 4)
    taken = []
    device_in = threading.Event()
    host_encode, device_encode = enc._host_encode, enc._device_encode

    def host(texts, *args):
        device_in.wait(30)
        return host_encode(texts, *args)

    def device(texts, *args):
        taken.extend(texts)
        device_in.set()
        return device_encode(texts, *args)

    monkeypatch.setattr(enc, "_host_encode", host)
    monkeypatch.setattr(enc, "_device_encode", device)
    for as_numpy in (False, True):
        taken.clear()
        device_in.clear()
        if as_numpy:
            got = as_lists(*enc.encode_corpus_to_numpy(docs, device="cpu", strategy="hybrid"))
        else:
            got = enc.encode_corpus(docs, device="cpu", strategy="hybrid")
        assert got == want
        assert taken
        assert enc.corpus_report["docs"]["device"] == len(taken)


@pytest.mark.parametrize("strategy", ["host", "device"])
def test_stream_encoder(tmp_path, case, strategy):
    from tiktoken_tpu_torch.parallel import StreamEncoder

    enc, want, _ = case
    se = StreamEncoder(enc, str(tmp_path), shard_docs=3)
    totals = se.encode_corpus(DOCS, device="cpu", strategy=strategy)
    fixed = [d.encode("utf-16", "surrogatepass").decode("utf-16", "replace").encode()
             for d in DOCS]
    assert totals["bytes"] == sum(len(b) for b in fixed)
    assert totals["tokens"] == sum(len(w) for w in want)
    with open(tmp_path / "manifest.jsonl") as f:
        manifest = [json.loads(line) for line in f]
    assert [e["bytes"] for e in manifest] == [sum(len(b) for b in fixed[i : i + 3])
                                              for i in range(0, len(DOCS), 3)]
    got = []
    for i in range(len(manifest)):
        flat, offs = se.read_shard(i)
        got += [flat[offs[j] : offs[j + 1]].tolist() for j in range(len(offs) - 1)]
    assert got == want


@pytest.mark.parametrize("pipeline", [3, 2])
def test_sharded_engine(case, pipeline):
    from tiktoken_tpu_torch.parallel import ShardedEngine, data_mesh

    enc, want, _ = case
    sharded = ShardedEngine(enc.engine("cpu"), data_mesh(2, device="cpu"))
    assert sharded.encode_corpus(DOCS, host_fallback=enc, pipeline=pipeline) == want
    got = sharded.encode_corpus(DOCS, host_fallback=enc, pipeline=pipeline, as_numpy=True)
    assert [a.tolist() for a in got] == want
