"""PyTorch port, end to end on the CPU: ``Encoding.encode_corpus(...,
device="cpu")`` is byte-exact with the reference ``tiktoken`` and with
``tiktoken_tpu``'s ``encode_ordinary``; the corpus calls refuse to run
quietly on the CPU; the package imports nothing of the JAX package."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.helpers import (
    make_encoding,
    make_mixed_corpus,
    make_oracle,
    pat_str,
    special_tokens_for,
    trained_ranks,
)

CJK = "東京タワーは高い。パリは花の都、そして京都は古都です。春はあけぼの、やうやう白くなりゆく山際。"
CYR = "Широкая электрификация южных губерний даст мощный толчок подъёму сельского хозяйства. Съешь же ещё этих мягких французских булок, да выпей чаю! "
ARABIC = "أهلاً وسهلاً بكم في عالم البرمجة. النص العربي يمتد من اليمين إلى اليسار، وهذا اختبار للمحلل. "
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def enc():
    import tiktoken_tpu_torch

    ranks = trained_ranks("o200k", 800)
    return tiktoken_tpu_torch.Encoding(
        "torch_o200k_800", pat_str=tiktoken_tpu_torch.o200k_pat_str,
        mergeable_ranks=ranks, special_tokens=special_tokens_for(ranks),
    )


def _check(enc, texts, **kw):
    got = enc.encode_corpus(texts, device="cpu", strategy="device", **kw)
    oracle = make_oracle("o200k", 800)
    jax_enc = make_encoding("o200k", 800)
    for i, t in enumerate(texts):
        want = oracle.encode_ordinary(t)
        assert got[i] == want, f"doc {i}: {len(got[i])} vs {len(want)} tokens"
        assert jax_enc.encode_ordinary(t) == want
        assert enc.encode_ordinary(t) == want
        assert enc.decode(got[i]) == t
    return got


@pytest.mark.parametrize("corpus", ["mixed", "scripts", "edges", "fallback", "dense"])
def test_encode_corpus_matches_tiktoken(enc, corpus):
    texts = {
        "mixed": [make_mixed_corpus(4000, seed=s) for s in range(3)],
        "scripts": [CJK * 40, CJK * 3, CJK[:50], CYR * 30, ARABIC * 25],
        "edges": ["a\n b", "today\n \n", "today\n  \n", " \n\n\n  x", "\t\t\t", "", "x",
                  " ", "🌍🌍🌍 emoji soup 🚀", "don't you're it's", "word " * 400,
                  ("line\n" * 300) + "tail"],
        "fallback": ["x" * 9000, "ab" + "c" * 500, "0" * 997],
        "dense": ["1a" * 600, "? " * 300],
    }[corpus]
    eng = enc.engine("cpu")
    before = dict(eng.stats)
    _check(enc, texts, row_capacity=96, chunk_rows=8)
    if corpus == "fallback":  # >64-byte pieces: loud, counted host fallback
        assert eng.stats["fallback_docs"] > before["fallback_docs"]
    if corpus in ("scripts", "dense"):  # the worst-case re-run, no fallback
        assert eng.stats["worst_case_chunks"] > before["worst_case_chunks"]
        assert eng.stats["fallback_docs"] == before["fallback_docs"]


def test_default_geometry_and_numpy_output(enc):
    texts = [make_mixed_corpus(3000, seed=9), CJK * 20, "tail doc 123", ""]
    tokens, offsets = enc.encode_corpus_to_numpy(texts, device="cpu", strategy="device")
    assert tokens.dtype == np.uint32 and offsets.dtype == np.int64
    oracle = make_oracle("o200k", 800)
    for i, t in enumerate(texts):
        assert tokens[offsets[i] : offsets[i + 1]].tolist() == oracle.encode_ordinary(t)


def test_long_vocab_hit_is_reference_semantics():
    # a whole-piece hit of a 17..64-byte token short-circuits BPE even when
    # no merge sequence could build it (reference: src/lib.rs:367-369)
    import tiktoken

    import tiktoken_tpu_torch

    ranks = {bytes([b]): b for b in range(256)}
    ranks[b"a" * 18] = 256
    ranks[b"throw" + b"x" * 30 + b"away"] = 257
    enc = tiktoken_tpu_torch.Encoding("longhit", pat_str=pat_str("o200k"),
                                      mergeable_ranks=ranks, special_tokens={})
    oracle = tiktoken.Encoding("longhit", pat_str=pat_str("o200k"), mergeable_ranks=ranks,
                               special_tokens={})
    texts = ["a" * 18, "throw" + "x" * 30 + "away", "a" * 17, "b" + "a" * 18]
    got = enc.encode_corpus(texts, device="cpu", strategy="device")
    assert got == [oracle.encode_ordinary(t) for t in texts]
    assert got[0] == [256] and got[1] == [257]


def test_corpus_calls_need_cuda_unless_asked_for_the_cpu(enc, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        enc.encode_corpus(["hello world"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        enc.encode_corpus_to_numpy(["hello world"], device="cuda")


def test_package_imports_nothing_of_jax():
    # every module of the port and of its plugin namespace, and the registry's
    # discovery over that namespace
    code = (
        "import importlib, pkgutil, sys, tiktoken_tpu_torch, tiktoken_tpu_torch_ext; "
        "mods = [m.name for pkg in (tiktoken_tpu_torch, tiktoken_tpu_torch_ext) for m in "
        "pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]; "
        "[importlib.import_module(m) for m in mods]; "
        "assert {'tiktoken_tpu_torch.registry', 'tiktoken_tpu_torch.model', "
        "'tiktoken_tpu_torch._educational', 'tiktoken_tpu_torch.utils.profiling', "
        "'tiktoken_tpu_torch_ext.openai_public', 'tiktoken_tpu_torch.ops.kernels'} <= set(mods); "
        "assert tiktoken_tpu_torch.list_encoding_names()[:2] == ['gpt2', 'r50k_base']; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('jaxlib') or m == 'tiktoken_tpu' or m.startswith('tiktoken_tpu.') "
        "or m.startswith('tiktoken_tpu_ext') "
        "or m.split('.')[0] in ('regex', 'tiktoken', 'tiktoken_ext')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
