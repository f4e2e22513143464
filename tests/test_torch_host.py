"""PyTorch port, host side: patterns outside the char DFA's dialect
(lookbehind, word boundaries, backreferences) split through the ``regex``
module, byte-exact with the reference ``tiktoken`` and with
``tiktoken_tpu``'s host engine, in ``encode_ordinary`` and in the
trainer's split; the device engine refuses them with a ``PatternError``
that points at the host path."""

from __future__ import annotations

import pytest
import tiktoken

from tiktoken_tpu._pybpe import HostBPE as JaxHostBPE
from tiktoken_tpu._pybpe import rust_compat_pattern as jax_rust_compat_pattern

from tests.helpers import pat_str

PATTERNS = [r"(?<=x)ab|[a-z]+|\s+|.", r"\b\w+\b|\s+|.", r"(\w)\1|\w+|\s+|."]
TEXTS = ["xab cab aa bb\n", "aab xxab abab\tba  ab\n\nzz café 東京 ab1 11 a"]
RANKS = {**{bytes([b]): b for b in range(256)}, b"ab": 256}


def _enc(pattern):
    import tiktoken_tpu_torch

    return tiktoken_tpu_torch.Encoding("host_only", pat_str=pattern, mergeable_ranks=RANKS,
                                       special_tokens={})


@pytest.mark.parametrize("pattern", PATTERNS)
def test_host_encoder_splits_patterns_outside_the_dfa(pattern):
    enc = _enc(pattern)
    oracle = tiktoken.Encoding("o", pat_str=pattern, mergeable_ranks=RANKS, special_tokens={})
    jax_host = JaxHostBPE(RANKS, {}, pattern)
    for text in TEXTS:
        want = oracle.encode_ordinary(text)
        assert enc.encode_ordinary(text) == want == jax_host.encode_ordinary(text)
    if pattern.startswith("(?<="):
        assert enc.encode_ordinary(TEXTS[0]) == [120, 256, 32, 99, 256, 32, 97, 97, 32, 98, 98,
                                                 10]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_trainer_split_matches_jax_host_engine(pattern):
    from tiktoken_tpu_torch._pybpe import HostBPE
    from tiktoken_tpu_torch.train import _pretokenize_histogram, train_bpe

    split = HostBPE({}, {}, pattern).split
    jax_host = JaxHostBPE(RANKS, {}, pattern)
    for text in TEXTS:
        pieces = split(text)
        assert "".join(pieces) == text
        assert [p.encode() for p in pieces] == list(jax_host._piece_bytes(text))
    hist = _pretokenize_histogram(TEXTS, pattern)
    assert sum(hist.values()) == sum(len(split(t)) for t in TEXTS)
    ranks = train_bpe(TEXTS * 3, 270, pattern)
    assert len(ranks) > 256
    # every trained vocabulary encodes its own corpus as the reference does
    oracle = tiktoken.Encoding("o", pat_str=pattern, mergeable_ranks=ranks, special_tokens={})
    enc = _enc(pattern)
    enc_t = type(enc)("t", pat_str=pattern, mergeable_ranks=ranks, special_tokens={})
    for text in TEXTS:
        assert enc_t.encode_ordinary(text) == oracle.encode_ordinary(text)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_device_engine_refuses_with_host_hint(pattern):
    from tiktoken_tpu_torch.ops.regex_compiler import PatternError

    with pytest.raises(PatternError, match="outside the device scanner's dialect.*encode_ordinary"):
        _enc(pattern).engine("cpu")


@pytest.mark.parametrize("name", ["r50k", "cl100k", "o200k"])
def test_rust_compat_pattern_is_the_jax_rewrite(name):
    from tiktoken_tpu_torch._pybpe import rust_compat_pattern

    for pattern in [pat_str(name), *PATTERNS, r"\s+$|[^\s]+|x$"]:
        assert rust_compat_pattern(pattern) == jax_rust_compat_pattern(pattern)


def test_shipped_patterns_keep_the_dfa_split():
    from tiktoken_tpu_torch._pybpe import HostBPE

    host = HostBPE({}, {}, pat_str("cl100k"))
    assert host.split("Hello world 123\n") == ["Hello", " world", " ", "123", "\n"]
    assert host._dfa is not None and host._regex is None
