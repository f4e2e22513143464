"""PyTorch port, installing and running without a compiler:
``tiktoken_tpu_torch/_build.py``, the loaders that use it (``native``,
``ops/kernels``), ``setup.py``'s prebuilt libraries, the no-core rule, and
the last names of the JAX package (``__version__``, ``_pybpe.
byte_pair_split`` and ``WHITE_SPACE``).

- A ``BUILD_DIR`` that cannot be created builds the core under the disk
  cache; a prebuilt core is loaded with no compiler and no compiler process;
  a prebuilt file of other sources is ignored.
- With no core and no compiler the host calls, the v3 device path (on the
  CPU, its plain versions) and the corpus report run the Python encoder
  and equal ``tiktoken``; ``"auto"`` on a GPU resolves to ``"device"``.
- With no ``nvcc`` and no prebuilt kernels, loading the kernels raises.
- ``setup.py build_ext`` writes the core under the loader's name and
  leaves the source tree as it was; ``_build.py`` names the same libraries
  imported or loaded by its path, and loads no torch.

Each test points the loaders at its own directories; the DFAs come from a
module-wide cache copied into each test's cache directory.
"""

from __future__ import annotations

import functools
import glob
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import tomllib

import pytest
import torch
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAT, VOCAB = "r50k", 800
TEXTS = [make_mixed_corpus(700, seed=s) for s in range(4)] + [
    "", "x", "hello world", "0" * 40, "x" * 900, "naïve café 東京 12345678 🌍"]
PIECES = make_mixed_corpus(3000, seed=5).encode("utf-8")


@functools.cache
def ranks() -> dict[bytes, int]:
    return trained_ranks(PAT, VOCAB)


@pytest.fixture(scope="module")
def primed(tmp_path_factory):
    """A cache directory holding the pattern's two DFAs, compiled once."""
    from tiktoken_tpu_torch.ops import artifacts

    d = tmp_path_factory.mktemp("primed")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TIKTOKEN_TPU_CACHE_DIR", str(d))
        artifacts.cached_char_dfa(pat_str(PAT))
        artifacts.cached_scanner_dfa(pat_str(PAT))
    return d


@pytest.fixture(scope="module")
def core_so(tmp_path_factory):
    """The native core of the current source, built once with g++."""
    from tiktoken_tpu_torch import _build

    return _build.build_core("g++", str(tmp_path_factory.mktemp("core")))


@pytest.fixture()
def place(monkeypatch, tmp_path, primed):
    """The loaders pointed at this test's empty prebuilt, build and cache
    directories (the cache holding the primed DFAs), the core unloaded and
    the compiler left as it is. Returns the directories."""
    from tiktoken_tpu_torch import _build, native
    from tiktoken_tpu_torch.ops import kernels

    dirs = {"prebuilt": tmp_path / "prebuilt", "build": tmp_path / "build",
            "cache": tmp_path / "cache"}
    dirs["prebuilt"].mkdir()
    shutil.copytree(primed, dirs["cache"])
    monkeypatch.setattr(_build, "PREBUILT_DIR", str(dirs["prebuilt"]))
    monkeypatch.setattr(native, "BUILD_DIR", str(dirs["build"]))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(dirs["build"]))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("TIKTOKEN_TPU_CACHE_DIR", str(dirs["cache"]))
    return dirs


def no_compiler(monkeypatch, tmp_path):
    """``CXX`` pointed at a compiler that does not exist, no nvcc on PATH or
    at its default place."""
    from tiktoken_tpu_torch import _build, native

    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "no-such-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))


def no_process(monkeypatch):
    """Fail the test if any process is started."""
    def refuse(*args, **kwargs):
        raise AssertionError(f"a process was started: {args[:1]}")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)


def encoding():
    import tiktoken_tpu_torch

    return tiktoken_tpu_torch.Encoding("install", pat_str=pat_str(PAT), mergeable_ranks=ranks(),
                                       special_tokens=special_tokens_for(ranks()))


def assert_equals_tiktoken(enc):
    oracle = make_oracle(PAT, VOCAB)
    want = [oracle.encode_ordinary(t) for t in TEXTS]
    assert [enc.encode_ordinary(t) for t in TEXTS] == want
    assert enc.encode_ordinary_batch(TEXTS) == want
    assert enc.encode("a<|endoftext|>b", allowed_special="all") == oracle.encode(
        "a<|endoftext|>b", allowed_special="all")


def test_unwritable_build_dir_builds_the_core_under_the_cache(place, monkeypatch):
    from tiktoken_tpu_torch import _build, native

    blocker = place["build"].parent / "blocker"
    blocker.write_text("a file where the build directory's parent should be")
    monkeypatch.setattr(native, "BUILD_DIR", str(blocker / "build"))
    enc = encoding()
    assert enc._core_bpe.native_core() is not None
    want = place["cache"] / "compiled-torch" / "build" / _build.core_name()
    assert native.library_path() == str(want) and want.is_file()
    assert_equals_tiktoken(enc)


def test_prebuilt_core_loads_without_a_compiler(place, monkeypatch, tmp_path, core_so):
    from tiktoken_tpu_torch import _build, native

    shutil.copy(core_so, place["prebuilt"] / _build.core_name())
    no_compiler(monkeypatch, tmp_path)
    no_process(monkeypatch)
    assert native.available()
    enc = encoding()
    assert enc._core_bpe.native_core() is not None and enc._core_bpe.host_engine() == "native"
    assert native.library_path() == str(place["prebuilt"] / _build.core_name())
    assert_equals_tiktoken(enc)
    assert not place["build"].exists()
    assert not (place["cache"] / "compiled-torch" / "build").exists()


def test_prebuilt_core_of_other_sources_is_ignored(place, monkeypatch, tmp_path, core_so):
    from tiktoken_tpu_torch import _build, native

    stale = "ttpu_core-0123456789abcdef.so"
    assert stale != _build.core_name()
    shutil.copy(core_so, place["prebuilt"] / stale)
    no_compiler(monkeypatch, tmp_path)
    assert native.library_path() is None and not native.available()
    enc = encoding()
    assert enc._core_bpe.native_core() is None and native._lib is None


def test_no_core_and_no_compiler_runs_the_python_encoder(place, monkeypatch, tmp_path):
    from tiktoken_tpu_torch import native
    from tiktoken_tpu_torch.utils.profiling import engine_report

    path = os.environ.get("PATH", "")
    no_compiler(monkeypatch, tmp_path)
    no_process(monkeypatch)

    def no_native_cutter(*args):
        raise AssertionError("the native cutter ran with no core")

    monkeypatch.setattr(native, "pack_cuts3", no_native_cutter)
    enc = encoding()
    assert enc._core_bpe.native_core() is None and enc._core_bpe.host_engine() == "python"
    assert engine_report(enc)["host_native"] == "unavailable"
    assert_equals_tiktoken(enc)
    want = [make_oracle(PAT, VOCAB).encode_ordinary(t) for t in TEXTS]
    for strategy in ("host", "device"):
        assert enc.encode_corpus(TEXTS, device="cpu", strategy=strategy) == want, strategy
        assert enc.corpus_report["host_engine"] == "python"
    # the "auto" rule on a GPU, with only the check for CUDA answered
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    assert enc.resolve_corpus_strategy("auto", device="cuda") == "device"
    assert enc.resolve_corpus_strategy("auto", device="cpu") == "host"
    # with a compiler found, the rule of a host with a core
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setenv("PATH", path)
    assert native.available()
    assert enc.resolve_corpus_strategy("auto", device="cuda") == "hybrid"


def test_no_nvcc_and_no_prebuilt_kernels_raises(place, monkeypatch, tmp_path):
    from tiktoken_tpu_torch import _build
    from tiktoken_tpu_torch.ops import kernels

    no_compiler(monkeypatch, tmp_path)
    no_process(monkeypatch)
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match=r"(?s)nvcc is not found.*pip install \.\[torch\]"):
        kernels._Libraries().load()
    nvcc = tmp_path / "no-such-nvcc"
    nvcc.write_text("")
    assert _build.find_nvcc() == str(nvcc)


def test_lookup_order(place, tmp_path):
    from tiktoken_tpu_torch import _build

    name = _build.kernel_names()["scan_rows"]
    cache_build = place["cache"] / "compiled-torch" / "build"
    dirs = [place["prebuilt"], place["build"], cache_build]
    for d in dirs:
        d.mkdir(parents=True, exist_ok=True)
        (d / name).write_bytes(b"")
    for d in dirs:
        assert _build.find(name, str(place["build"]), str(place["cache"] / "compiled-torch")) \
            == str(d / name)
        (d / name).unlink()
    assert _build.find(name, str(place["build"]), None) is None
    assert _build.cache_build_dir(None).startswith(tempfile.gettempdir())
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    assert _build.output_dir(str(blocker / "build"), str(tmp_path / "c")) == str(
        tmp_path / "c" / "build")
    assert _build.output_dir(str(place["build"]), str(tmp_path / "c")) == str(place["build"])
    assert not [f for d in dirs + [tmp_path / "c" / "build"] for f in os.listdir(d)]


def test_setup_build_ext_writes_the_prebuilt_core(tmp_path):
    """``setup.py build_ext`` into a temporary build directory: the core
    under the loader's name, no CUDA library without nvcc, and nothing
    written where a build writes by default or in place."""
    from tiktoken_tpu_torch import _build

    def written():
        return {p for pattern in ("*.egg-info", "build/lib*", "build/temp*", "build/bdist*",
                                  "tiktoken_tpu_torch/prebuilt", "tiktoken_tpu/native/*.so")
                for p in glob.glob(os.path.join(REPO, pattern))}

    before = written()
    proc = subprocess.run([sys.executable, "setup.py", "-q", "build_ext", "--build-lib",
                           str(tmp_path / "lib"), "--build-temp", str(tmp_path / "tmp")],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    prebuilt = tmp_path / "lib" / "tiktoken_tpu_torch" / "prebuilt"
    want = {_build.core_name()}
    if _build.find_nvcc():
        want |= set(_build.kernel_names().values())
    assert set(os.listdir(prebuilt)) == want
    assert written() == before


def test_build_module_is_the_same_imported_and_by_path():
    from tiktoken_tpu_torch import _build

    spec = importlib.util.spec_from_file_location("by_path", _build.__file__)
    by_path = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(by_path)
    assert by_path.core_name() == _build.core_name()
    assert by_path.kernel_names() == _build.kernel_names()
    assert by_path.cxx_flags() == _build.cxx_flags() and by_path.NVCC_FLAGS == _build.NVCC_FLAGS
    # loaded by its path, as setup.py loads it, it imports no torch
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('b', {_build.__file__!r})\n"
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
            "print(m.core_name(), 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, check=True).stdout.split()
    assert out == [_build.core_name(), "False"]


def test_version_equals_pyproject_and_jax():
    import tiktoken_tpu
    import tiktoken_tpu_torch

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        version = tomllib.load(f)["project"]["version"]
    assert tiktoken_tpu_torch.__version__ == version == tiktoken_tpu.__version__


@settings(max_examples=MAX_EXAMPLES, deadline=None)
@given(start=st.integers(0, len(PIECES) - 2), n=st.integers(2, 64))
def test_byte_pair_split_equals_jax(start, n):
    from tiktoken_tpu import _pybpe as jax_pybpe

    from tiktoken_tpu_torch import _pybpe

    piece = PIECES[start : start + n]
    assert _pybpe.byte_pair_split(piece, ranks()) == jax_pybpe.byte_pair_split(piece, ranks())


def test_white_space_equals_jax():
    from tiktoken_tpu import _pybpe as jax_pybpe

    from tiktoken_tpu_torch import _pybpe

    assert _pybpe.WHITE_SPACE == jax_pybpe.WHITE_SPACE
    with pytest.raises(ValueError, match="two bytes or more"):
        _pybpe.byte_pair_split(b"a", ranks())
