"""PyTorch port, ``_educational`` and ``utils.profiling``: the educational
trainer and encoder against the JAX package's (the same ranks, ids and
printed output, the port splitting with its char DFA where JAX uses the
``regex`` module), ``Throughput``, ``engine_report`` after an engine was
built, and ``device_trace`` writing one trace on the CPU."""

from __future__ import annotations

import json

import pytest

import tiktoken_tpu._educational as jax_edu
import tiktoken_tpu.utils.profiling as jax_profiling

from tests.helpers import make_mixed_corpus, pat_str, special_tokens_for, trained_ranks

GPT2_PLAIN = r"""'s|'t|'re|'ve|'m|'ll|'d| ?[\p{L}]+| ?[\p{N}]+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


@pytest.mark.parametrize("pattern", ["gpt2", "r50k", "o200k"])
@pytest.mark.parametrize("visualise", [None, "simple", "colour"])
def test_bpe_train_matches_jax(pattern, visualise, capsys):
    from tiktoken_tpu_torch import _educational as edu

    pat = GPT2_PLAIN if pattern == "gpt2" else pat_str(pattern)
    data = make_mixed_corpus(1200, seed=1)
    ranks = edu.bpe_train(data, 300, pat, visualise=visualise)
    printed = capsys.readouterr().out
    assert ranks == jax_edu.bpe_train(data, 300, pat, visualise=visualise)
    assert printed == capsys.readouterr().out
    assert len(ranks) == 300 and bool(printed) == bool(visualise)
    with pytest.raises(ValueError, match="vocab_size must be at least 256"):
        edu.bpe_train(data, 255, pat)


@pytest.mark.parametrize("visualise", [None, "simple", "colour"])
def test_simple_encoding_matches_jax(visualise, capsys):
    from tiktoken_tpu_torch._educational import SimpleBytePairEncoding

    ranks = trained_ranks("o200k", 400)
    enc = SimpleBytePairEncoding(pat_str=pat_str("o200k"), mergeable_ranks=ranks)
    ref = jax_edu.SimpleBytePairEncoding(pat_str=pat_str("o200k"), mergeable_ranks=ranks)
    text = "hello world, it's naïve 東京 12345\n\n  " + make_mixed_corpus(200, seed=6)
    tokens = enc.encode(text, visualise=visualise)
    printed = capsys.readouterr().out
    assert tokens == ref.encode(text, visualise=visualise)
    assert printed == capsys.readouterr().out
    assert enc.decode(tokens) == text and enc.decode_bytes(tokens) == text.encode()
    assert enc.decode_tokens_bytes(tokens) == ref.decode_tokens_bytes(tokens)
    import tiktoken_tpu_torch

    port = tiktoken_tpu_torch.Encoding("edu", pat_str=pat_str("o200k"), mergeable_ranks=ranks,
                                       special_tokens=special_tokens_for(ranks))
    assert tokens == port.encode_ordinary(text)
    from_enc = SimpleBytePairEncoding.from_tiktoken(port)
    assert from_enc.encode(text, visualise=None) == tokens


def test_train_simple_encoding(capsys):
    from tiktoken_tpu_torch._educational import train_simple_encoding

    enc = train_simple_encoding()  # asserts its own round trip of "hello world"
    out = capsys.readouterr().out
    assert len(enc.mergeable_ranks) == 600
    assert "This is the sequence of merges performed in order to encode 'hello world':" in out


def test_throughput_matches_jax(monkeypatch):
    from tiktoken_tpu_torch.utils import profiling

    for mod in (profiling, jax_profiling):
        clock = iter([1.0, 1.5, 2.0, 4.0])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        meter = mod.Throughput()
        assert meter.mb_per_s == 0.0
        with meter.measure(1_000_000):
            pass
        with pytest.raises(RuntimeError), meter.measure(3_000_000):
            raise RuntimeError("counted all the same")
        assert (meter.bytes, meter.seconds, meter.mb_per_s) == (4_000_000, 2.5, 1.6)


def test_engine_report_after_an_engine():
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch.utils import engine_report

    ranks = trained_ranks("o200k", 400)
    enc = tiktoken_tpu_torch.Encoding("report", pat_str=pat_str("o200k"), mergeable_ranks=ranks,
                                      special_tokens=special_tokens_for(ranks))
    assert engine_report(enc) == {"name": "report", "host_native": "not built yet",
                                  "engines": {}}
    enc.encode_corpus(["hello world", make_mixed_corpus(800, seed=2)], device="cpu",
                      strategy="device")
    assert engine_report(enc)["host_native"] == "not built yet"  # no host fallback ran
    enc.encode_ordinary("hello")
    report = engine_report(enc)
    assert report["host_native"] == "active"
    (eng,) = enc._engines.values()
    entry = report["engines"]["cpu"]
    assert entry["stats"] == eng.stats and entry["stats"]["chunks"] >= 1
    t = eng.tables
    assert entry["tables"] == {
        "dfa_states": t.scan.consts.shape[0], "dfa_classes": t.scan.n_classes,
        "pair_buckets": t.pair_buckets.shape[0], "pair_entries": eng.vocab_report["pair_entries"],
        "vocab_buckets": t.vocab_buckets.shape[0], "long_vocab_buckets": t.long_buckets.shape[0]}
    from tiktoken_tpu.ops.pair_table import build_pair_table

    from tiktoken_tpu_torch.ops.artifacts import cached_char_dfa

    dfa = cached_char_dfa(pat_str("o200k"))
    assert (entry["tables"]["dfa_states"], entry["tables"]["dfa_classes"]) == (dfa.n_states,
                                                                               dfa.n_classes)
    assert entry["tables"]["pair_entries"] == build_pair_table(ranks).n_pairs
    assert json.dumps(report)  # plain values only


def test_device_trace_writes_one_trace(tmp_path):
    import torch

    from tiktoken_tpu_torch.utils import device_trace

    with device_trace(str(tmp_path / "trace")):
        torch.arange(1000).cumsum(0)
    (path,) = (tmp_path / "trace").iterdir()
    assert path.suffix == ".json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
