"""The native host core: the v3 row cutter and the host BPE encoder in C++.

``core.cpp`` is compiled with the system C++ compiler (``CXX``, ``g++
-O3 -std=c++17 -shared -fPIC -pthread``, plus ``-msse4.2`` on x86_64) into
``ttpu_core-<digest>.so``, the digest taken over the source and its
command line. ``_build`` finds it, prebuilt in a wheel or built already,
or builds it at first use into ``BUILD_DIR`` (``tiktoken_tpu_torch/build/``)
or, where that cannot be written, under the disk cache. It is loaded with
ctypes; each call releases the GIL.

Where no core can be had (``available()``: no library of the current
source and no compiler found), the host calls run the pure-Python encoder
(``_pybpe.HostBPE.encode_ordinary_python``), the spec the tests hold this
core against, as the JAX package's do. A compiler that is found and fails
raises with its output, and a failed call raises.

- ``pack_cuts3``: the handshake-row cut positions of one document, the
  native form of ``ops/pipeline3._doc_cuts_np``, bit-exact with it on
  valid UTF-8;
- ``NativeCore``: one (pattern, vocabulary) engine. It splits with the
  pattern's byte-level DFA (``ops/artifacts.cached_scanner_dfa``, the
  table of the byte scanner and the v1 program), then takes whole-piece
  vocabulary hits or merges greedily, as the reference does; its batch
  call threads below the language boundary.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from tiktoken_tpu_torch import _build
from tiktoken_tpu_torch._build import cxx_flags as cxx_flags
from tiktoken_tpu_torch._utf8 import utf8_bytes

CXX = "g++"
BUILD_DIR = os.path.join(_build.PKG_DIR, "build")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "ttpu_new": (_P, [_P, _I, _I, _P, _P, _P, _P, _I64]),
    "ttpu_free": (None, [_P]),
    "ttpu_encode": (_I64, [_P, ctypes.c_char_p, _I64, _P, _I64, _P]),
    "ttpu_encode_piece": (_I64, [_P, ctypes.c_char_p, _I64, _P, _I64]),
    "ttpu_encode_batch": (_I64, [_P, ctypes.c_char_p, _P, _I64, _P, _P, _P, _I]),
    "ttpu_pack_cuts3": (_I64, [_P, _I64, _I64, _I64, _P, _I64]),
    "ttpu_decode": (_I64, [_P, _P, _I64, _P, _I64]),
}
RANK_MAX = 0xFFFFFFFF  # the core's error sentinel: never a token id


def _cache_dir() -> str | None:
    from tiktoken_tpu_torch.ops.artifacts import artifact_dir

    return artifact_dir()


def library_path() -> str | None:
    """The core's library of the current source where one is prebuilt or
    built already (``_build.find``'s order); None where none is."""
    return _build.find(_build.core_name(), BUILD_DIR, _cache_dir())


def available() -> bool:
    """Whether the core can be had, decided without building: it is
    loaded, its library is prebuilt or built already, or the compiler
    ``CXX`` is found."""
    return _lib is not None or shutil.which(CXX) is not None or library_path() is not None


def load_library() -> ctypes.CDLL:
    """The native core, found or built (once per source and flags) and
    loaded (once per process); raises with the compiler's output when a
    build fails."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                so = library_path() or _build.build_core(
                    CXX, _build.output_dir(BUILD_DIR, _cache_dir()))
                lib = ctypes.CDLL(so)
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _lib = lib
    return _lib


def pack_cuts3(data: np.ndarray, K: int, backup: int) -> np.ndarray:
    """Handshake-row cut positions of one document's bytes (int64, strictly
    increasing, in (0, n)): bit-exact with ``ops/pipeline3._doc_cuts_np``
    on valid UTF-8. Where no character starts in a cut's window (not UTF-8)
    it cuts at the grid position instead."""
    lib = load_library()
    n = len(data)
    cap = (n - 1) // K + 1 if n > 0 else 1
    out = np.empty(cap, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m = lib.ttpu_pack_cuts3(data.ctypes.data, n, K, backup, out.ctypes.data, cap)
    if m < 0:
        raise RuntimeError(f"native pack_cuts3 wrote more than {cap} cuts")
    return out[:m]


def _check(out: np.ndarray, n: int, cap: int) -> np.ndarray:
    if n < 0 or n > cap or (n and int(out[:n].max()) == RANK_MAX):
        raise RuntimeError("the native core failed to encode (its scanner made no progress)")
    return out[:n]


class NativeCore:
    """One compiled (pattern, vocabulary) engine of the native core."""

    def __init__(self, pat_str: str, mergeable_ranks: dict[bytes, int]):
        from tiktoken_tpu_torch.ops.artifacts import cached_scanner_dfa
        from tiktoken_tpu_torch.ops.window_scan import byte_scan_table

        lib = load_library()
        dfa = cached_scanner_dfa(pat_str)
        # the byte-indexed table at a 512 stride with premultiplied
        # next-state bases: a scan step is idx = base | byte, one load, no
        # multiply (column 256 = EOF, 257..511 dead padding)
        pb = byte_scan_table(dfa).astype(np.int64)
        pb512 = np.zeros((dfa.n_states, 512), dtype=np.int64)
        pb512[:, :257] = (((pb >> 5) * 512) << 5) | (pb & 31)
        if pb512.max() >= 2**31:
            raise ValueError(f"the byte DFA of {pat_str!r} has too many states for the core")
        packed = np.ascontiguousarray(pb512, dtype=np.int32)
        class_of = np.arange(257, dtype=np.uint16)

        toks = sorted(mergeable_ranks.items(), key=lambda kv: kv[1])
        blob = b"".join(t for t, _ in toks)
        offs = np.zeros(len(toks) + 1, dtype=np.int64)
        np.cumsum([len(t) for t, _ in toks], out=offs[1:])
        rank_arr = np.asarray([r for _, r in toks], dtype=np.uint32)
        blob_arr = np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(0, np.uint8)

        self._lib = lib
        self._keepalive = (packed, class_of, blob_arr, offs, rank_arr)
        self._h = lib.ttpu_new(packed.ctypes.data, dfa.n_states, 512, class_of.ctypes.data,
                               blob_arr.ctypes.data if len(blob_arr) else None,
                               offs.ctypes.data, rank_arr.ctypes.data, len(toks))
        if not self._h:
            raise RuntimeError("the native core failed to initialise")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ttpu_free(h)
            self._h = None

    def encode_ordinary(self, text: str) -> list[int]:
        return self.encode_ordinary_bytes(text.encode("utf-8"))

    def encode_ordinary_bytes(self, data: bytes) -> list[int]:
        return self.encode_with_lptl(data)[0]

    def encode_with_lptl(self, data: bytes) -> tuple[list[int], int]:
        """(tokens, the last piece's token count) of one special-free
        segment of UTF-8 bytes."""
        if not data:
            return [], 0
        cap = len(data) + 2
        out = np.empty(cap, dtype=np.uint32)
        lptl = ctypes.c_int64(0)
        n = self._lib.ttpu_encode(self._h, data, len(data), out.ctypes.data, cap,
                                  ctypes.byref(lptl))
        return _check(out, n, cap).tolist(), int(lptl.value)

    def encode_ordinary_numpy(self, data: bytes) -> np.ndarray:
        """The ids of UTF-8 ``data`` as a uint32 view of the buffer the core
        wrote (no Python list)."""
        if not data:
            return np.empty(0, dtype=np.uint32)
        cap = len(data) + 2
        out = np.empty(cap, dtype=np.uint32)
        lptl = ctypes.c_int64(0)
        n = self._lib.ttpu_encode(self._h, data, len(data), out.ctypes.data, cap,
                                  ctypes.byref(lptl))
        return _check(out, n, cap)

    def encode_piece(self, piece: bytes) -> list[int]:
        """One piece by whole-piece hit or greedy merges (no split)."""
        cap = len(piece) + 2
        out = np.empty(cap, dtype=np.uint32)
        n = self._lib.ttpu_encode_piece(self._h, piece, len(piece), out.ctypes.data, cap)
        return _check(out, n, cap).tolist()

    def decode_bytes(self, tokens) -> bytes:
        """The tokens' bytes concatenated; raises ``KeyError`` on an id that
        is not an ordinary token (a special token, or unknown), and
        ``OverflowError`` on one outside [0, 2**32) (never wrapped to
        uint32)."""
        ids = np.asarray(tokens)
        n = len(ids)
        if n == 0:
            return b""
        if ids.dtype != np.uint32:
            if ids.dtype.kind not in "iu" or ids.min() < 0 or ids.max() > RANK_MAX:
                raise OverflowError("a token id outside [0, 2**32)")
            ids = ids.astype(np.uint32)
        ids = np.ascontiguousarray(ids)
        cap = n * 16
        buf = ctypes.create_string_buffer(cap)
        r = self._lib.ttpu_decode(self._h, ids.ctypes.data, n, buf, cap)
        if r > cap:
            cap = int(r)
            buf = ctypes.create_string_buffer(cap)
            r = self._lib.ttpu_decode(self._h, ids.ctypes.data, n, buf, cap)
        if r < 0:
            raise KeyError(int(ids[-1 - r]))
        return buf.raw[:r]

    def encode_ordinary_batch_arrays(self, texts, num_threads: int = 8
                                     ) -> tuple[np.ndarray, np.ndarray]:
        """Encode ``texts`` in one C call over ``num_threads`` threads:
        ``(tokens, offsets)``, document ``i``'s ids being
        ``tokens[offsets[i]:offsets[i+1]]`` (uint32 / int64)."""
        datas = [utf8_bytes(t) for t in texts]
        n = len(datas)
        if n == 0:
            return np.empty(0, np.uint32), np.zeros(1, np.int64)
        lens = np.fromiter((len(d) for d in datas), dtype=np.int64, count=n)
        doc_offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=doc_offs[1:])
        out_offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens + 2, out=out_offs[1:])
        out = np.empty(int(out_offs[-1]), dtype=np.uint32)
        counts = np.zeros(n, dtype=np.int64)
        rc = self._lib.ttpu_encode_batch(self._h, b"".join(datas), doc_offs.ctypes.data, n,
                                         out.ctypes.data, out_offs.ctypes.data,
                                         counts.ctypes.data, int(num_threads))
        if rc != 0:
            raise RuntimeError(f"the native batch encode failed ({rc})")
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        flat = np.empty(int(offs[-1]), dtype=np.uint32)
        for d in range(n):  # document d's ids: the first counts[d] of its region
            flat[offs[d] : offs[d + 1]] = out[out_offs[d] : out_offs[d] + counts[d]]
        if flat.size and int(flat.max()) == RANK_MAX:
            raise RuntimeError("the native core failed to encode (its scanner made no progress)")
        return flat, offs

    def encode_ordinary_batch(self, texts, num_threads: int = 8) -> list[list[int]]:
        """``encode_ordinary`` of each text, in one threaded C call."""
        flat, offs = self.encode_ordinary_batch_arrays(texts, num_threads)
        return [flat[offs[d] : offs[d + 1]].tolist() for d in range(len(offs) - 1)]
