"""The compiled DFAs of a pattern: compiled once per process, cached on
disk once per machine.

Compiling a pattern is deterministic and slow (the byte-level DFA of
o200k takes seconds on a host core), and three parts of the package need
one of its two DFAs: the engine's char-class tables and the host splitter
the char-level DFA, the native host core and the byte scanner / v1
re-run the byte-level one. Each is compiled at most once per process
(kept in memory, keyed by the cache directory and the artifact key) and
stored on disk as a ``.npz`` next to the vocabulary cache, as the JAX
package's ``ops/artifacts.py`` does. Keys include the compiler version and
the Unicode data version, so a stale artifact is never reused. A file that
fails to load is removed, and the DFA is compiled and written again.

The directory is ``$TIKTOKEN_TPU_CACHE_DIR/compiled-torch`` (or under
``TIKTOKEN_CACHE_DIR`` / ``DATA_GYM_CACHE_DIR``, the same variables as the
JAX package reads; an empty value turns the disk cache off), else
``~/.cache/tiktoken-tpu/compiled-torch``. The JAX package stores under
``compiled``, with its own compiler version: neither package reads the
other's artifacts.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import threading
import uuid

import numpy as np

from tiktoken_tpu_torch.ops.charclass import CharClassTables, build_char_class_tables
from tiktoken_tpu_torch.ops.regex_compiler import (
    CharScannerDFA,
    ScannerDFA,
    compile_pattern,
    compile_pattern_chars,
)

COMPILER_VERSION = 1  # bump to invalidate every cached artifact of this package
SUBDIR = "compiled-torch"

_memo: dict[tuple[str | None, str], object] = {}
_lock = threading.Lock()


def artifact_dir() -> str | None:
    """The directory of the disk cache, or None when it is turned off."""
    for var in ("TIKTOKEN_TPU_CACHE_DIR", "TIKTOKEN_CACHE_DIR", "DATA_GYM_CACHE_DIR"):
        if var in os.environ:
            d = os.environ[var]
            return os.path.join(d, SUBDIR) if d else None
    home = os.path.expanduser("~")
    if home and home != "~" and os.path.isdir(home):
        return os.path.join(os.environ.get("XDG_CACHE_HOME", os.path.join(home, ".cache")),
                            "tiktoken-tpu", SUBDIR)
    return os.path.join(tempfile.gettempdir(), "tiktoken-tpu-" + SUBDIR)


def artifact_key(kind: str, payload: bytes) -> str:
    import unicodedata

    meta = f"{kind}:v{COMPILER_VERSION}:u{unicodedata.unidata_version}:".encode()
    return hashlib.sha256(meta + payload).hexdigest()


def load_arrays(key: str) -> dict[str, np.ndarray] | None:
    """The arrays stored under ``key``; None when absent, when the cache
    is off, or when the file does not load (it is then removed)."""
    d = artifact_dir()
    if d is None:
        return None
    path = os.path.join(d, key + ".npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        try:
            os.remove(path)
        except OSError:
            pass
        return None


def store_arrays(key: str, arrays: dict[str, np.ndarray]) -> None:
    """Write ``arrays`` under ``key`` atomically (a temporary file, then a
    rename), so a reader never sees a half-written file. Best effort, as
    the reference's vocabulary cache: a directory that cannot be written
    leaves the cache cold."""
    d = artifact_dir()
    if d is None:
        return
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, key + ".npz")
        tmp = f"{path}.{uuid.uuid4()}.tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except OSError:
        pass


def _cached(kind: str, pat_str: str, load, compile_and_store):
    """The artifact ``kind`` of ``pat_str``: from memory, else from disk
    (``load(arrays)``), else compiled (``compile_and_store(key)``), once
    per process whatever the threads."""
    key = artifact_key(kind, pat_str.encode())
    slot = (artifact_dir(), key)
    got = _memo.get(slot)
    if got is None:
        with _lock:
            got = _memo.get(slot)
            if got is None:
                arrays = load_arrays(key)
                got = load(arrays) if arrays is not None else compile_and_store(key)
                _memo[slot] = got
    return got


def cached_scanner_dfa(pat_str: str) -> ScannerDFA:
    """The byte-level DFA of ``pat_str`` (``compile_pattern``), cached."""

    def load(a):
        return ScannerDFA(trans=a["trans"], accept=a["accept"], class_of=a["class_of"],
                          n_states=int(a["trans"].shape[0]), n_classes=int(a["trans"].shape[1]),
                          pat_str=pat_str)

    def compile_and_store(key):
        dfa = compile_pattern(pat_str)
        store_arrays(key, {"trans": dfa.trans, "accept": dfa.accept, "class_of": dfa.class_of})
        return dfa

    return _cached("scanner-dfa", pat_str, load, compile_and_store)


def cached_char_dfa(pat_str: str) -> CharScannerDFA:
    """The char-level DFA of ``pat_str`` (``compile_pattern_chars``),
    cached. A pattern outside its dialect raises ``PatternError`` at every
    call (nothing is cached for it)."""

    def load(a):
        return CharScannerDFA(trans=a["trans"], accept=a["accept"], edges=a["edges"],
                              seg_class=a["seg_class"], eof_class=int(a["eof_class"]),
                              n_states=int(a["trans"].shape[0]),
                              n_classes=int(a["trans"].shape[1]), pat_str=pat_str)

    def compile_and_store(key):
        dfa = compile_pattern_chars(pat_str)
        store_arrays(key, {"trans": dfa.trans, "accept": dfa.accept, "edges": dfa.edges,
                           "seg_class": dfa.seg_class,
                           "eof_class": np.asarray(dfa.eof_class, np.int64)})
        return dfa

    return _cached("char-dfa", pat_str, load, compile_and_store)


def cached_char_class_tables(pat_str: str) -> CharClassTables:
    """The page-compressed char-class tables of the cached char-level DFA
    (built in a few milliseconds, so kept in memory only)."""
    key = ("char-class-tables", pat_str)
    got = _memo.get(key)
    if got is None:
        got = _memo.setdefault(key, build_char_class_tables(cached_char_dfa(pat_str)))
    return got
