"""PyTorch port, the registry, the model map and the loaders: the seven
shipped encodings of ``tiktoken_tpu_torch_ext.openai_public`` against the
reference ``tiktoken_ext`` and the JAX package's (loaders stubbed, no
network), the model map against ``tiktoken.model`` and
``tiktoken_tpu.model``, plugins of the ``tiktoken_tpu_torch_ext`` namespace
in a temporary directory (duplicates, a missing ``ENCODING_CONSTRUCTORS``,
a retry after a failure, pickling by name), and the loaders' formats and
cache against ``tiktoken.load`` and ``tiktoken_tpu.load``.

Each test that adds a plugin directory clears the discovery cache and the
registry before and after (``registry`` fixture), so nothing leaks into
another test.
"""

from __future__ import annotations

import importlib
import json
import pickle
import sys

import pytest
import tiktoken
import tiktoken.load as ref_load
import tiktoken.model as ref_model
import tiktoken_ext.openai_public as ref_public

import tiktoken_tpu.load as jax_load
import tiktoken_tpu.model as jax_model
import tiktoken_tpu_ext.openai_public as jax_public

from tests.helpers import make_mixed_corpus, pat_str, trained_ranks

NAMES = ("gpt2", "r50k_base", "p50k_base", "p50k_edit", "cl100k_base", "o200k_base",
         "o200k_harmony")
SENTINEL = {b"\x00": 0}


def _stub_loaders(monkeypatch, *modules):
    for mod in modules:
        for fn in ("load_tiktoken_bpe", "data_gym_to_mergeable_bpe_ranks"):
            if hasattr(mod, fn):
                monkeypatch.setattr(mod, fn, lambda *a, **k: dict(SENTINEL))


@pytest.mark.parametrize("name", NAMES)
def test_shipped_constructors_match_tiktoken_and_jax(name, monkeypatch):
    import tiktoken_tpu_torch_ext.openai_public as ours

    calls = []  # what the port's constructor asks its loaders for
    monkeypatch.setattr(ours, "load_tiktoken_bpe", lambda url, expected_hash=None: (
        calls.append((url, expected_hash)) or dict(SENTINEL)))
    monkeypatch.setattr(ours, "data_gym_to_mergeable_bpe_ranks", lambda **kw: (
        calls.append(kw) or dict(SENTINEL)))
    _stub_loaders(monkeypatch, ref_load, ref_public, jax_load, jax_public)
    got = ours.ENCODING_CONSTRUCTORS[name]()
    for other in (ref_public, jax_public):
        want = other.ENCODING_CONSTRUCTORS[name]()
        assert got["name"] == want["name"] == name
        assert got["pat_str"] == want["pat_str"]
        assert got["special_tokens"] == want["special_tokens"]
        assert got.get("explicit_n_vocab") == want.get("explicit_n_vocab")
        assert got["mergeable_ranks"] == want["mergeable_ranks"] == SENTINEL
    # the URLs and sha256 pins the loaders were given
    if name == "gpt2":
        (kw,) = calls
        assert kw["vocab_bpe_hash"] == (
            "1ce1664773c50f3e0cc8842619a93edc4624525b728b188a9e0be33b7726adc5")
        assert kw["encoder_json_file"].endswith("/gpt-2/encodings/main/encoder.json")
    else:
        vocab = {"p50k_edit": "p50k_base", "o200k_harmony": "o200k_base"}.get(name, name)
        assert calls == [jax_public._TIKTOKEN_FILES[vocab]] == [ours._TIKTOKEN_FILES[vocab]]


def test_shipped_names_and_patterns():
    import tiktoken_tpu_torch
    import tiktoken_tpu_torch_ext.openai_public as ours

    assert tuple(ours.ENCODING_CONSTRUCTORS) == NAMES
    assert set(ours.ENCODING_CONSTRUCTORS) == set(ref_public.ENCODING_CONSTRUCTORS)
    assert ours._TIKTOKEN_FILES == jax_public._TIKTOKEN_FILES
    assert ours._HARMONY_NAMED == jax_public._HARMONY_NAMED
    for name in ("r50k", "cl100k", "o200k"):
        port_pat = getattr(tiktoken_tpu_torch, f"{name}_pat_str")
        # one copy of each pattern: the plugin takes the package's
        assert getattr(ours, f"{name}_pat_str") is port_pat
        assert port_pat == pat_str(name)
    assert set(tiktoken_tpu_torch.list_encoding_names()) >= set(NAMES)


def test_model_map_matches_tiktoken_and_jax():
    import tiktoken_tpu_torch
    import tiktoken_tpu_torch.model as ours

    assert ours.MODEL_TO_ENCODING == ref_model.MODEL_TO_ENCODING == jax_model.MODEL_TO_ENCODING
    assert list(ours.MODEL_PREFIX_TO_ENCODING.items()) == list(
        ref_model.MODEL_PREFIX_TO_ENCODING.items())
    assert list(ours.MODEL_PREFIX_TO_ENCODING.items()) == list(
        jax_model.MODEL_PREFIX_TO_ENCODING.items())
    for model in ("gpt2", "gpt-4o", "gpt-4o-2024-05-13", "gpt-4-0314", "gpt-3.5-turbo-0301",
                  "davinci", "text-davinci-003", "code-davinci-edit-001", "gpt-oss-120b",
                  "o1-mini", "ft:gpt-4o:org", "gpt-35-turbo-16k", "text-embedding-3-small"):
        assert tiktoken_tpu_torch.encoding_name_for_model(model) == \
            ref_model.encoding_name_for_model(model)
    with pytest.raises(KeyError, match="tiktoken_tpu_torch.get_encoding"):
        tiktoken_tpu_torch.encoding_name_for_model("definitely-not-a-model")
    with pytest.raises(KeyError):
        tiktoken_tpu_torch.encoding_for_model("definitely-not-a-model")


def test_get_encoding_refuses_what_is_not_a_name():
    import tiktoken_tpu_torch

    with pytest.raises(ValueError, match="Expected a string in get_encoding"):
        tiktoken_tpu_torch.get_encoding(123)  # type: ignore[arg-type]
    with pytest.raises(ValueError, match="Unknown encoding no_such_encoding"):
        tiktoken_tpu_torch.get_encoding("no_such_encoding")


# ---------------------------------------------------------------------------
# plugins
# ---------------------------------------------------------------------------

PLUGIN = """
from tiktoken_tpu_torch.load import load_tiktoken_bpe
from tiktoken_tpu_torch.patterns import o200k_pat_str


def {name}():
    ranks = load_tiktoken_bpe({path!r})
    return {{"name": {name!r}, "pat_str": o200k_pat_str, "mergeable_ranks": ranks,
             "special_tokens": {{"<|endoftext|>": len(ranks), "<|endofprompt|>": len(ranks) + 1}}}}


ENCODING_CONSTRUCTORS = {{{name!r}: {name}}}
"""


@pytest.fixture
def registry(tmp_path, monkeypatch):
    """The port's registry with a fresh discovery and an empty cache, a
    plugin directory ``tmp_path/plugins`` on ``sys.path`` and no disk cache;
    undone after."""
    from tiktoken_tpu_torch import registry as reg

    root = tmp_path / "plugins"
    (root / "tiktoken_tpu_torch_ext").mkdir(parents=True)
    monkeypatch.syspath_prepend(str(root))
    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", "")  # no vocabulary or DFA cache on disk
    monkeypatch.setattr(reg, "ENCODINGS", {})
    monkeypatch.setattr(reg, "_constructors", None)
    reg._available_plugin_modules.cache_clear()
    before = set(sys.modules)
    yield reg, root / "tiktoken_tpu_torch_ext"
    reg._available_plugin_modules.cache_clear()
    for mod in set(sys.modules) - before:
        if mod.startswith("tiktoken_tpu_torch_ext."):
            del sys.modules[mod]


def _write_plugin(pkg_dir, module: str, body: str) -> None:
    (pkg_dir / f"{module}.py").write_text(body)
    importlib.invalidate_caches()


def _local_vocab(tmp_path) -> str:
    from tiktoken_tpu_torch.load import dump_tiktoken_bpe

    path = str(tmp_path / "local.tiktoken")
    dump_tiktoken_bpe(trained_ranks("o200k", 800), path)
    return path


def test_a_local_plugin_encodes_offline_and_pickles_by_name(registry, tmp_path):
    import tiktoken_tpu_torch

    reg, pkg = registry
    _write_plugin(pkg, "local_vocab",
                  PLUGIN.format(name="local_o200k", path=_local_vocab(tmp_path)))
    names = tiktoken_tpu_torch.list_encoding_names()
    assert "local_o200k" in names and set(NAMES) <= set(names)
    enc = tiktoken_tpu_torch.get_encoding("local_o200k")
    assert tiktoken_tpu_torch.get_encoding("local_o200k") is enc is reg.ENCODINGS["local_o200k"]
    ranks = trained_ranks("o200k", 800)
    oracle = tiktoken.Encoding("o", pat_str=pat_str("o200k"), mergeable_ranks=ranks,
                               special_tokens={"<|endoftext|>": 800, "<|endofprompt|>": 801})
    text = make_mixed_corpus(1500, seed=4) + "<|endoftext|>tail<|endofprompt|>"
    assert enc.encode(text, allowed_special="all") == oracle.encode(text, allowed_special="all")
    payload = pickle.dumps(enc)
    assert len(payload) < 200  # the name, not the vocabulary
    assert pickle.loads(payload).__dict__ is enc.__dict__
    # an encoding of the same name that is not the registry's pickles whole
    twin = tiktoken_tpu_torch.Encoding("local_o200k", pat_str=enc._pat_str,
                                       mergeable_ranks=ranks, special_tokens=enc._special_tokens)
    copy = pickle.loads(pickle.dumps(twin))
    assert copy.__dict__ is not enc.__dict__ and copy.encode_ordinary(text) == \
        enc.encode_ordinary(text)
    from tiktoken_tpu_torch._educational import SimpleBytePairEncoding

    simple = SimpleBytePairEncoding.from_tiktoken("local_o200k")
    assert simple.mergeable_ranks is enc._mergeable_ranks
    assert simple.encode("hello world", visualise=None) == enc.encode_ordinary("hello world")


def test_plugin_faults_raise_and_discovery_can_be_retried(registry, tmp_path):
    import tiktoken_tpu_torch

    reg, pkg = registry
    path = _local_vocab(tmp_path)
    _write_plugin(pkg, "no_constructors", "X = 1\n")
    with pytest.raises(ValueError, match="does not define ENCODING_CONSTRUCTORS"):
        tiktoken_tpu_torch.list_encoding_names()
    assert reg._constructors is None  # nothing half-registered
    (pkg / "no_constructors.py").unlink()
    _write_plugin(pkg, "dup_a", PLUGIN.format(name="dup_o200k", path=path))
    _write_plugin(pkg, "dup_b", PLUGIN.format(name="dup_o200k", path=path))
    reg._available_plugin_modules.cache_clear()
    with pytest.raises(ValueError, match="Duplicate encoding name dup_o200k"):
        tiktoken_tpu_torch.get_encoding("dup_o200k")
    assert reg._constructors is None
    (pkg / "dup_b.py").unlink()
    reg._available_plugin_modules.cache_clear()
    enc = tiktoken_tpu_torch.get_encoding("dup_o200k")  # the retry succeeds
    assert enc.n_vocab == 802 and reg._constructors is not None
    assert "dup_o200k" in tiktoken_tpu_torch.list_encoding_names()


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def test_dump_and_load_round_trip(tmp_path, monkeypatch):
    from tiktoken_tpu_torch.load import dump_tiktoken_bpe, load_tiktoken_bpe

    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp_path / "cache"))
    ranks = trained_ranks("cl100k", 800)
    path = str(tmp_path / "v.tiktoken")
    dump_tiktoken_bpe(ranks, path)
    jax_path = str(tmp_path / "jax.tiktoken")
    jax_load.dump_tiktoken_bpe(ranks, jax_path)
    assert open(path, "rb").read() == open(jax_path, "rb").read()
    assert load_tiktoken_bpe(path) == ranks == ref_load.load_tiktoken_bpe(path)
    sha = ref_load.hashlib.sha256(open(path, "rb").read()).hexdigest()
    assert load_tiktoken_bpe(path, expected_hash=sha) == ranks
    (tmp_path / "bad.tiktoken").write_bytes(b"YQ== 0\nnot a line\n")
    with pytest.raises(ValueError, match="Error parsing line"):
        load_tiktoken_bpe(str(tmp_path / "bad.tiktoken"))


def test_the_cache_hits_and_evicts_on_a_hash_mismatch(tmp_path, monkeypatch):
    import hashlib

    from tiktoken_tpu_torch import load

    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(tmp_path / "cache"))
    url = "https://example.invalid/vocab.tiktoken"
    good, bad = b"YQ== 0\nYg== 1\n", b"YQ== 0\n"
    fetched = []
    served = {"data": good}

    def fetch(blobpath):
        fetched.append(blobpath)
        return served["data"]

    monkeypatch.setattr(load, "read_file", fetch)
    sha = hashlib.sha256(good).hexdigest()
    assert load.load_tiktoken_bpe(url, expected_hash=sha) == {b"a": 0, b"b": 1}
    entry = tmp_path / "cache" / hashlib.sha1(url.encode()).hexdigest()
    assert entry.read_bytes() == good and not list((tmp_path / "cache").glob("*.tmp"))
    assert load.read_file_cached(url, sha) == good and len(fetched) == 1  # a hit
    entry.write_bytes(bad)  # a corrupt entry is evicted and fetched again
    assert load.read_file_cached(url, sha) == good and len(fetched) == 2
    assert entry.read_bytes() == good
    served["data"] = bad
    entry.unlink()
    with pytest.raises(ValueError, match="Hash mismatch for data downloaded"):
        load.read_file_cached(url, sha)
    assert not entry.exists()
    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", "")  # no cache: every read fetches
    assert load.read_file_cached(url) == bad and len(fetched) == 4


def test_an_unwritable_default_cache_is_tolerated(tmp_path, monkeypatch):
    from tiktoken_tpu_torch import load

    for var in load._CACHE_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")  # the cache directory cannot be made under a file
    monkeypatch.setattr(load.tempfile, "gettempdir", lambda: str(blocker))
    monkeypatch.setattr(load, "read_file", lambda blobpath: b"YQ== 0\n")
    assert load.load_tiktoken_bpe("https://example.invalid/v.tiktoken") == {b"a": 0}
    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(blocker))  # named by the user: raises
    with pytest.raises(OSError):
        load.load_tiktoken_bpe("https://example.invalid/v.tiktoken")


@pytest.mark.parametrize("clobber", [False, True])
def test_data_gym_matches_tiktoken_and_jax(tmp_path, monkeypatch, clobber):
    from tiktoken_tpu_torch import load

    for var in ("TIKTOKEN_TPU_CACHE_DIR", "TIKTOKEN_CACHE_DIR", "DATA_GYM_CACHE_DIR"):
        monkeypatch.setenv(var, "")
    remap = load._data_gym_byte_remap()
    assert remap == jax_load._data_gym_byte_remap()
    to_gym = {b: ch for ch, b in remap.items()}

    def gym(token: bytes) -> str:
        return "".join(to_gym[b] for b in token)

    merges = [(b"h", b"e"), (b"l", b"l"), (b"he", b"ll"), (b" ", b"w"), (b"o", b"r"),
              (b" w", b"or"), (b"\n", b"\n"), (b"\xe6", b"\x9d")]
    encoder = {gym(bytes([b])): i for i, b in enumerate(remap.values())}
    for a, b in merges:
        encoder[gym(a + b)] = len(encoder)
    encoder["<|endoftext|>"] = len(encoder)
    vocab_bpe = tmp_path / "vocab.bpe"
    vocab_bpe.write_text("#version: 0.2\n" + "".join(f"{gym(a)} {gym(b)}\n" for a, b in merges))
    encoder_json = tmp_path / "encoder.json"
    encoder_json.write_text(json.dumps(encoder))
    args = (str(vocab_bpe), str(encoder_json))
    got = load.data_gym_to_mergeable_bpe_ranks(*args, clobber_one_byte_tokens=clobber)
    assert got == jax_load.data_gym_to_mergeable_bpe_ranks(*args, clobber_one_byte_tokens=clobber)
    assert got == ref_load.data_gym_to_mergeable_bpe_ranks(*args, clobber_one_byte_tokens=clobber)
    assert got[b"hell"] == 258 and got[b"\xe6\x9d"] == 263 and len(got) == 264
    encoder_json.write_text(json.dumps({**encoder, gym(b"he"): 999}))  # disagrees: refused
    with pytest.raises(AssertionError):
        load.data_gym_to_mergeable_bpe_ranks(*args)
