"""PyTorch port, the public API of ``Encoding`` on the host: the special-token
policy, ``encode`` and its numpy, batch and unstable-token forms, the
decode family, single-token lookups, invalid UTF-8, pickling, and the
three faults this API had (the ``KeyError`` of an invalid id, the
``AssertionError`` of ``explicit_n_vocab``, pickling after the native core
and an engine were built).

Every id is held against the reference ``tiktoken`` 0.13 and the JAX
package's ``Encoding`` on trained vocabularies of the r50k, cl100k and
o200k patterns (``tests.helpers``): ids are integers, so every comparison
is exact.
"""

from __future__ import annotations

import functools
import inspect
import pickle
import re

import numpy as np
import pytest
import regex
import tiktoken
from hypothesis import given, settings
from hypothesis import strategies as st

import tiktoken_tpu

from tests.helpers import (
    PAT_NAMES,
    make_encoding,
    make_mixed_corpus,
    make_oracle,
    pat_str,
    special_tokens_for,
    trained_ranks,
)

VOCAB = 800
EOT = "<|endoftext|>"
# texts whose tails exercise the unstable-token search: whitespace runs,
# a special token, a prefix of a longer token, CJK, digits
TAILS = ["hello world", "hello world  ", "hello\n\n", "tokenizer  \n ", "it's 12345",
         f"abc {EOT}", f"{EOT}", "the quick bro", "naïve café 東京", "x = 1;\n\t",
         "don't  you", "state-of-the-", " ", ""]
SKEW_CHARS = "".join(chr(lo) for lo in (661, 2191, 6863, 42958, 67904))


@functools.lru_cache(maxsize=None)
def port_encoding(pat_name: str):
    import tiktoken_tpu_torch

    ranks = trained_ranks(pat_name, VOCAB)
    return tiktoken_tpu_torch.Encoding(f"torch_{pat_name}_{VOCAB}", pat_str=pat_str(pat_name),
                                       mergeable_ranks=ranks,
                                       special_tokens=special_tokens_for(ranks))


def encodings(pat_name: str):
    """(the port's, the JAX package's, tiktoken's) Encoding of one
    vocabulary and pattern."""
    return port_encoding(pat_name), make_encoding(pat_name, VOCAB), make_oracle(pat_name, VOCAB)


def _all_three(fn, pat_name: str):
    """``fn`` of each of the three encodings: equal results, or the same
    exception type (returned)."""
    out = []
    for enc in encodings(pat_name):
        try:
            out.append(fn(enc))
        except Exception as e:  # noqa: BLE001 - the type is compared below
            out.append(type(e))
    return out


# ---------------------------------------------------------------------------
# the three repaired faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ids", [[1, 1399], [1, 803, 1399, 5], [-1], [2**40], [7, 2**32 + 5]])
def test_decode_of_an_invalid_id_names_it(ids):
    enc, jax_enc, oracle = encodings("o200k")
    bad = next(t for t in ids if not 0 <= t < enc.n_vocab)
    with pytest.raises(KeyError) as want:
        jax_enc.decode_bytes(ids)
    assert want.value.args == (f"Invalid token for decoding: {bad}",)
    # an int64 array too, which the JAX package's native decode wraps to
    # uint32 (2**32 + 5 decodes as 5 there)
    for tokens in (ids, np.asarray(ids, dtype=np.int64)):
        with pytest.raises(KeyError) as got:
            enc.decode_bytes(tokens)
        assert got.value.args == want.value.args
    if all(0 <= t < 2**32 for t in ids):  # tiktoken raises OverflowError outside u32
        with pytest.raises(KeyError) as ref:
            oracle.decode_bytes(ids)
        assert ref.value.args == got.value.args
    with pytest.raises(KeyError):
        enc.decode(ids)


def test_explicit_n_vocab_mismatch_raises_assertion_error():
    import tiktoken_tpu_torch

    ranks = trained_ranks("o200k", VOCAB)
    specials = special_tokens_for(ranks)
    for cls in (tiktoken_tpu_torch.Encoding, tiktoken_tpu.Encoding, tiktoken.Encoding):
        with pytest.raises(AssertionError):
            cls("x", pat_str=pat_str("o200k"), mergeable_ranks=ranks, special_tokens=specials,
                explicit_n_vocab=5)
        with pytest.raises(AssertionError):  # the count adds up, the ids are not dense
            cls("x", pat_str=pat_str("o200k"), mergeable_ranks=ranks,
                special_tokens={EOT: len(ranks) + 7}, explicit_n_vocab=len(ranks) + 1)
    enc = tiktoken_tpu_torch.Encoding("good_n", pat_str=pat_str("o200k"), mergeable_ranks=ranks,
                                      special_tokens={EOT: len(ranks)},
                                      explicit_n_vocab=len(ranks) + 1)
    assert enc.n_vocab == enc.max_token_value + 1 == len(ranks) + 1
    assert enc.eot_token == len(ranks)
    assert enc.is_special_token(len(ranks)) and not enc.is_special_token(0)
    with pytest.raises(AssertionError):
        enc.is_special_token(np.uint32(0))
    assert repr(enc) == "<Encoding 'good_n'>"


def test_pickle_after_the_native_core_and_an_engine():
    import tiktoken_tpu_torch

    ranks = trained_ranks("o200k", VOCAB)
    enc = tiktoken_tpu_torch.Encoding("pickled", pat_str=pat_str("o200k"), mergeable_ranks=ranks,
                                      special_tokens=special_tokens_for(ranks),
                                      explicit_n_vocab=len(ranks) + 4)
    docs = [make_mixed_corpus(2000, seed=3), "tail doc 123", ""]
    first = enc.encode_ordinary(docs[0])
    copy1 = pickle.loads(pickle.dumps(enc))
    assert copy1.encode_ordinary(docs[0]) == first
    want = enc.encode_corpus(docs, device="cpu", strategy="device")
    assert enc._engines and enc._core_bpe.native_core() is not None and enc.corpus_report
    copy2 = pickle.loads(pickle.dumps(enc))
    # nothing built was pickled; the copy builds again at first use
    assert copy2._engines == {} and copy2._core_bpe._native is None and copy2.corpus_report == {}
    assert (copy2.name, copy2._pat_str, copy2._special_tokens) == (
        enc.name, enc._pat_str, enc._special_tokens)
    assert copy2._mergeable_ranks == ranks
    assert copy2.encode_ordinary(docs[0]) == first
    assert copy2.encode_corpus(docs, device="cpu", strategy="device") == want
    assert want == [make_oracle("o200k", VOCAB).encode_ordinary(d) for d in docs]


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

METHODS = ("encode", "encode_ordinary", "encode_to_numpy", "encode_ordinary_batch",
           "encode_batch", "encode_with_unstable", "encode_single_token", "decode_bytes",
           "decode", "decode_single_token_bytes", "decode_tokens_bytes", "decode_with_offsets",
           "decode_batch", "decode_bytes_batch", "token_byte_values", "is_special_token",
           "_encode_single_piece", "_encode_only_native_bpe", "_encode_bytes", "__getstate__",
           "__setstate__", "__init__", "_resolve_specials")


@pytest.mark.parametrize("name", METHODS)
def test_methods_have_the_jax_signatures(name):
    import tiktoken_tpu_torch

    def shape(fn):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]

    assert shape(getattr(tiktoken_tpu_torch.Encoding, name)) == shape(
        getattr(tiktoken_tpu.Encoding, name))


def test_properties_match_jax():
    enc, jax_enc, oracle = encodings("cl100k")
    for attr in ("max_token_value", "n_vocab", "eot_token", "special_tokens_set"):
        assert getattr(enc, attr) == getattr(jax_enc, attr)
    assert enc.special_tokens_set == oracle.special_tokens_set
    assert enc.token_byte_values() == oracle.token_byte_values() == jax_enc.token_byte_values()
    for tok in (0, 5, VOCAB + 2, VOCAB + 10):
        assert enc.is_special_token(tok) == oracle.is_special_token(tok)


# ---------------------------------------------------------------------------
# the special-token policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pat_name", PAT_NAMES)
def test_special_token_policy_matrix(pat_name):
    enc, _, oracle = encodings(pat_name)
    text = f"hello {EOT}"
    for kw in ({}, {"disallowed_special": "all"}, {"disallowed_special": {EOT}},
               {"allowed_special": {EOT}, "disallowed_special": {EOT}}):
        with pytest.raises(ValueError, match="disallowed special token") as got:
            enc.encode(text, **kw)
        with pytest.raises(ValueError) as want:
            oracle.encode(text, **kw)
        assert str(got.value) == str(want.value)
    allowed = enc.encode(text, allowed_special={EOT})
    assert allowed[-1] == enc.encode_single_token(EOT) == VOCAB
    assert allowed == enc.encode(text, allowed_special="all") == oracle.encode(
        text, allowed_special={EOT})
    assert enc.encode(text, disallowed_special=()) == enc.encode_ordinary(text)
    text2 = f"{EOT}<|im_start|>"
    with pytest.raises(ValueError, match="<|im_start|>"):
        enc.encode(text2, allowed_special={EOT})
    ok = enc.encode(text2, allowed_special={EOT}, disallowed_special=())
    assert ok == oracle.encode(text2, allowed_special={EOT}, disallowed_special=())
    assert ok[0] == VOCAB


POLICY_TEXTS = [
    f"hello {EOT} world<|im_start|>x <|fim_prefix|>  ",
    f"<|im_start|>{EOT}<|im_end|>tail",
    f"a<|im_end|>b{EOT}{EOT}  \n",
    "<|endoftext<|im_end|>|> half specials <|endof",
    f"{EOT}",
    "no specials here, it's 1234567",
    "",
]


@pytest.mark.parametrize("pat_name", PAT_NAMES)
@pytest.mark.parametrize("allowed", ["all", "eot", "im_end", "none"])
def test_encode_with_specials_matches_tiktoken_and_jax(pat_name, allowed):
    allowed_special = {"all": "all", "eot": {EOT}, "im_end": {"<|im_end|>"}, "none": set()}[allowed]
    for text in POLICY_TEXTS:
        got = _all_three(lambda e: e.encode(text, allowed_special=allowed_special,
                                            disallowed_special=()), pat_name)
        assert got[0] == got[1] == got[2], text
        arr = port_encoding(pat_name).encode_to_numpy(text, allowed_special=allowed_special,
                                                      disallowed_special=())
        assert arr.dtype == np.uint32 and arr.tolist() == got[0]
        batch = port_encoding(pat_name).encode_batch(
            [text, text[::-1]], allowed_special=allowed_special, disallowed_special=())
        assert batch == [got[0], make_oracle(pat_name, VOCAB).encode(
            text[::-1], allowed_special=allowed_special, disallowed_special=())]


def test_restart_after_a_disallowed_special_one_char_later():
    """A special that is not allowed is skipped one character at a time, so
    an allowed one that starts inside it is still found (reference:
    src/lib.rs:397)."""
    import tiktoken_tpu_torch

    ranks = trained_ranks("o200k", VOCAB)
    specials = {"<|a<|b|>": VOCAB, "<|b|>": VOCAB + 1}
    args = dict(pat_str=pat_str("o200k"), mergeable_ranks=ranks, special_tokens=specials)
    encs = [tiktoken_tpu_torch.Encoding("r", **args), tiktoken_tpu.Encoding("r", **args),
            tiktoken.Encoding("r", **args)]
    for text in ("x<|a<|b|>y", "<|a<|b|><|a<|b|>"):
        got = [e.encode(text, allowed_special={"<|b|>"}, disallowed_special=()) for e in encs]
        assert got[0] == got[1] == got[2]
        assert VOCAB + 1 in got[0] and VOCAB not in got[0]


@pytest.mark.parametrize("order", ["short_first", "long_first"])
def test_a_special_that_is_a_prefix_of_another(order):
    """Specials match leftmost first, the earlier alternative winning at one
    position: the port's ``re`` patterns pick what the JAX package's
    (``regex`` for the policy check, ``re`` for the split) pick."""
    import tiktoken_tpu_torch
    from tiktoken_tpu.core import _special_token_regex as jax_regex

    from tiktoken_tpu_torch.core import _special_token_regex

    ranks = trained_ranks("o200k", VOCAB)
    pair = [("<|a", VOCAB), ("<|a|>", VOCAB + 1)]
    specials = dict(pair if order == "short_first" else pair[::-1])
    args = dict(pat_str=pat_str("o200k"), mergeable_ranks=ranks, special_tokens=specials)
    enc, jax_enc = tiktoken_tpu_torch.Encoding("p", **args), tiktoken_tpu.Encoding("p", **args)
    for text in ("x <|a|> y", "<|a<|a|>", "<|a"):
        assert enc.encode(text, allowed_special="all") == jax_enc.encode(text,
                                                                         allowed_special="all")
        assert enc._core_bpe.special_regex.pattern == jax_enc._core_bpe.special_regex.pattern
        for allowed in ({"<|a"}, {"<|a|>"}):
            assert (enc.encode(text, allowed_special=allowed, disallowed_special=())
                    == jax_enc.encode(text, allowed_special=allowed, disallowed_special=()))
        tokens = frozenset(specials)
        m, jm = _special_token_regex(tokens).search(text), jax_regex(tokens).search(text)
        assert m.group() == jm.group()
        assert isinstance(_special_token_regex(tokens), re.Pattern)
        assert regex.compile(_special_token_regex(tokens).pattern).search(text).group() == \
            m.group()


# ---------------------------------------------------------------------------
# encode forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pat_name", PAT_NAMES)
def test_encode_with_unstable_matches_tiktoken(pat_name):
    for text in TAILS + [make_mixed_corpus(300, seed=5)]:
        got = _all_three(lambda e: e.encode_with_unstable(text, allowed_special="all"), pat_name)
        (toks, comps), (jtoks, jcomps), (otoks, ocomps) = got
        assert toks == jtoks == otoks, text
        assert sorted(map(tuple, comps)) == sorted(map(tuple, jcomps)) == sorted(
            map(tuple, ocomps)), text
    enc = port_encoding(pat_name)
    with pytest.raises(ValueError):
        enc.encode_with_unstable(f"a {EOT}")


@pytest.mark.parametrize("pat_name", PAT_NAMES)
def test_encode_bytes_on_invalid_utf8(pat_name):
    cases = [b"hello \xff\xfe", b"\xe4\xbd", b"abc def\xe4", b"naive \xc3", b"\x80\x80x",
             b"tokenizer  \xf0\x9f\x8c", "東京 🌍".encode() + b"\xed\xa0\x80", b"",
             b"plain text, it's fine", b"ends in spaces   \xff"]
    for data in cases:
        got = _all_three(lambda e: e._encode_bytes(data), pat_name)
        assert got[0] == got[1] == got[2], data
        assert port_encoding(pat_name).decode_bytes(got[0]) == data


@pytest.mark.parametrize("pat_name", PAT_NAMES)
def test_lone_surrogates_encode_as_the_replacement_char(pat_name):
    enc, _, oracle = encodings(pat_name)
    for text in ("a\ud800b", "\udfff", f"x\ud83c {EOT}"):
        want = oracle.encode(text, allowed_special="all")
        assert enc.encode(text, allowed_special="all") == want
        assert enc.encode(text.replace("\ud800", "�").replace("\udfff", "�")
                          .replace("\ud83c", "�"), allowed_special="all") == want
        assert enc.encode_to_numpy(text, allowed_special="all").tolist() == want
        assert enc.encode_ordinary(text) == oracle.encode_ordinary(text)
        assert enc.encode_ordinary_batch([text]) == [oracle.encode_ordinary(text)]


def test_encode_to_numpy_is_the_native_buffer():
    enc = port_encoding("cl100k")
    text = "hello world, it's 123"
    arr = enc.encode_to_numpy(text)
    assert arr.dtype == np.uint32 and arr.tolist() == enc.encode(text)
    assert arr.base is not None and arr.base.dtype == np.uint32
    # an allowed special that occurs takes the list path
    arr2 = enc.encode_to_numpy(f"hi {EOT}", allowed_special="all")
    assert arr2.tolist() == make_oracle("cl100k", VOCAB).encode(f"hi {EOT}",
                                                                allowed_special="all")
    with pytest.raises(ValueError):
        enc.encode_to_numpy(f"hi {EOT}")


@pytest.mark.parametrize("pat_name", PAT_NAMES)
def test_skew_codepoints_split_by_the_reference_categories(pat_name):
    """Codepoints whose category the ``regex`` module gets wrong go through
    the char DFA like every other text: the ids equal tiktoken's."""
    enc, jax_enc, oracle = encodings(pat_name)
    for text in (f"a{SKEW_CHARS}b {EOT} x{SKEW_CHARS[2]}y", f"{SKEW_CHARS[:2]}12 {SKEW_CHARS}"):
        want = oracle.encode(text, allowed_special="all")
        assert enc.encode(text, allowed_special="all") == want
        assert jax_enc.encode(text, allowed_special="all") == want
        assert enc.decode(want) == text


@pytest.mark.parametrize("pat_name", PAT_NAMES)
def test_single_tokens_and_pieces(pat_name):
    enc, _, oracle = encodings(pat_name)
    ranks = trained_ranks(pat_name, VOCAB)
    long_tok = max(ranks, key=len)
    for tok in (b"a", long_tok, EOT, EOT.encode(), "<|im_end|>"):
        assert enc.encode_single_token(tok) == oracle.encode_single_token(tok)
    for bad in (b"definitely-not-a-token-xyzzy", b"\xff\xfe\xfd\xfc", "<|unknown|>"):
        with pytest.raises(KeyError):
            enc.encode_single_token(bad)
    for tok in (0, 255, len(ranks) - 1, VOCAB, VOCAB + 3):
        assert enc.decode_single_token_bytes(tok) == oracle.decode_single_token_bytes(tok)
    for bad in (VOCAB + 4, 10**9, -1):
        with pytest.raises(KeyError):
            enc.decode_single_token_bytes(bad)
    text = make_mixed_corpus(400, seed=8)
    toks = enc.encode(text + EOT, allowed_special="all")
    assert enc.decode_tokens_bytes(toks) == oracle.decode_tokens_bytes(toks)
    for piece in ("hello", " world", "东京东京东京", "x" * 70, long_tok.decode("utf-8", "replace")):
        assert enc._encode_single_piece(piece) == oracle._encode_single_piece(piece)
        assert enc._encode_single_piece(piece.encode()) == oracle._encode_single_piece(piece)
    assert enc._encode_only_native_bpe(text) == oracle._encode_only_native_bpe(text) == \
        enc.encode_ordinary(text)


@pytest.mark.parametrize("pat_name", PAT_NAMES)
def test_batches_match_tiktoken(pat_name):
    enc, _, oracle = encodings(pat_name)
    texts = [make_mixed_corpus(500, seed=s) for s in range(6)] + ["", f"x {EOT} y"]
    with pytest.raises(ValueError):
        enc.encode_batch(texts)
    want = oracle.encode_batch(texts, allowed_special="all")
    assert enc.encode_batch(texts, allowed_special="all", num_threads=3) == want
    assert enc.encode_batch(texts, disallowed_special=()) == oracle.encode_ordinary_batch(texts)
    assert enc.encode_ordinary_batch(texts, num_threads=2) == oracle.encode_ordinary_batch(texts)
    assert enc.decode_batch(want, num_threads=3) == texts == oracle.decode_batch(want)
    assert enc.decode_bytes_batch(want) == [t.encode() for t in texts]
    cut = [w[1:] for w in want]  # a first byte cut off: invalid UTF-8 in some
    assert enc.decode_batch(cut) == oracle.decode_batch(cut)
    assert enc.decode_batch(cut, errors="ignore") == oracle.decode_batch(cut, errors="ignore")


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _offsets_spec(enc, tokens: list[int]) -> list[int]:
    """Token i's offset: the characters of the longest decoded prefix that is
    a strict prefix (reference: tests/test_offsets.py:19-25)."""
    text = enc.decode(tokens, errors="strict")
    return [min(len(text) - 1, len(enc.decode_bytes(tokens[:i]).decode("utf-8", errors="ignore")))
            for i in range(len(tokens))]


@pytest.mark.parametrize("pat_name", PAT_NAMES)
def test_decode_with_offsets_multibyte(pat_name):
    enc, jax_enc, oracle = encodings(pat_name)
    for text in ["你好世界", "தமிழ் மொழி", " 除外", "naïve café", "🌍🌍", f"x {EOT} 東京",
                 make_mixed_corpus(300, seed=2)]:
        tokens = enc.encode(text, allowed_special="all")
        got = enc.decode_with_offsets(tokens)
        assert got == tuple(oracle.decode_with_offsets(tokens)) == jax_enc.decode_with_offsets(
            tokens)
        assert got[0] == text and got[1] == _offsets_spec(enc, tokens)
    with pytest.raises(UnicodeDecodeError):
        enc.decode_with_offsets([enc.encode_single_token(b"\x80")])


def test_decode_splices_many_special_tokens():
    enc, _, oracle = encodings("cl100k")
    text = f"hello {EOT} " * 3000 + "<|im_start|>tail"
    tokens = enc.encode(text, allowed_special="all")
    assert tokens == oracle.encode(text, allowed_special="all")
    assert enc.decode(tokens) == text
    assert enc.decode_bytes(np.asarray(tokens, dtype=np.uint32)) == text.encode()
    assert enc.decode_bytes(iter(tokens)) == text.encode()
    with pytest.raises(KeyError, match="Invalid token for decoding: 1000000000"):
        enc.decode_bytes(tokens[:50] + [10**9] + tokens[50:])


@pytest.mark.parametrize("pat_name", PAT_NAMES)
@settings(max_examples=25, deadline=None)
@given(text=st.text(max_size=60))
def test_round_trip_matches_tiktoken(pat_name, text):
    enc, _, oracle = encodings(pat_name)
    for piece in ("", EOT, "<|im_end|>"):
        t = text + piece + text[:5]
        want = oracle.encode(t, allowed_special="all")
        got = enc.encode(t, allowed_special="all")
        assert got == want
        if not any("\ud800" <= c <= "\udfff" for c in t):
            assert enc.decode(got) == t


def test_a_pattern_outside_the_dfa_keeps_the_special_policy():
    """The one route without the native core (a pattern the char DFA
    refuses, split by the ``regex`` module) encodes specials, unstable
    tails and invalid UTF-8 as tiktoken does."""
    import tiktoken_tpu_torch

    pattern = r"(?<=x)ab|[a-z]+|\s+|."
    ranks = {**{bytes([b]): b for b in range(256)}, b"ab": 256, b"  ": 257}
    specials = {EOT: 258}
    args = dict(pat_str=pattern, mergeable_ranks=ranks, special_tokens=specials)
    enc = tiktoken_tpu_torch.Encoding("host_only", **args)
    oracle = tiktoken.Encoding("host_only", **args)
    for text in ("xab cab", f"aab {EOT}xxab  ", "ab  "):
        assert enc.encode(text, allowed_special="all") == oracle.encode(text,
                                                                        allowed_special="all")
        a, b = enc.encode_with_unstable(text, allowed_special="all"), oracle.encode_with_unstable(
            text, allowed_special="all")
        assert a[0] == b[0] and sorted(map(tuple, a[1])) == sorted(map(tuple, b[1]))
        assert enc._encode_bytes(text.encode() + b"\xff") == oracle._encode_bytes(
            text.encode() + b"\xff")
    assert enc._core_bpe.native_core() is None
    assert enc.decode_bytes([256, 258, 1]) == b"ab" + EOT.encode() + b"\x01"
    with pytest.raises(KeyError, match="Invalid token for decoding: 300"):
        enc.decode_bytes([256, 300])
