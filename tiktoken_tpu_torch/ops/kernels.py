"""The port's hand-written CUDA kernels: build, binding, wrappers, counts.

Six kernels carry the v3, v2 and v1 chunk programs on Hopper, and a
seventh the pair-count training step (sources in
``tiktoken_tpu_torch/csrc``, each with a note on what it replaces, what
bounds it and how its design answers that):

- ``scan_rows``: row gather, char classes and the handshake DFA scan
  (entry ``scan_rows``), the handshake validation (``scan_validate``),
  and the v2 rows' char classes and scan without the handshake
  (``char_scan``), the two scans one kernel body;
- ``compaction``: the v3 and v2 piece catalogs, the fused short-miss and
  long compactions of a catalog (``compact_kinds``), slot extraction (the
  long pieces of both programs) and the assembly of a chunk: its per-piece
  counts, the token stream, the row counts and the header
  (``assemble``); the catalogs, the kind compactions and the assembly
  each one launch by decoupled look-back;
- ``vocab_hit``: whole-piece vocabulary hits, short and long tables;
- ``slot_merge``: greedy BPE in 16- and 64-byte slots below a device
  count, the tokens left-packed (``slot_merge_packed``);
- ``byte_scan``: the byte-level scanners, the v2 sequential scan
  (``seq_scan``) and the v1 window scan with its orbit and row flags in
  one launch (``window_orbit``);
- ``grid_merge``: the v1 full-grid greedy BPE over a piece list sorted by
  length, and the row packing;
- ``pair_count``: the hashed pair histogram of a token grid
  (``tt_pair_hist``) and its first argmax (``tt_hist_argmax``).

Each source is a shared library with a plain C interface, loaded with
ctypes: prebuilt in a wheel, built already, or compiled at first use by
its own ``nvcc`` process (all started together) into
``tiktoken_tpu_torch/build/`` or, where that cannot be written, under the
disk cache (``_build``'s lookup order). With no library to load and no
``nvcc``, the first launch raises: nothing falls back to the plain
versions on a GPU. Every wrapper checks device, dtype, shape and
contiguity, allocates its outputs with
``torch.empty``, raises if the entry point returns a CUDA error, and adds
one to its kernel's count in ``launches`` (and to its entry point's in
``entry_launches``). A wrapper launches on its tensors' device, on that
device's current stream, whatever device is current when it is called:
the entry point runs with that device made current. A wrapper runs the
plain PyTorch version only when its tensors lie on the CPU; a CUDA tensor
always goes to the kernel. The chunk programs (``pipeline3.run_chunk``,
``pipeline2.run_chunk2``, ``pipeline2.run_rows1``) call these entries and
nothing else on the device.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from types import SimpleNamespace

import torch

from tiktoken_tpu_torch import _build
from tiktoken_tpu_torch._build import CSRC as CSRC
from tiktoken_tpu_torch._build import KERNELS as KERNELS
from tiktoken_tpu_torch._build import NVCC_FLAGS as NVCC_FLAGS
from tiktoken_tpu_torch.ops import compaction, merge, pair_count as pair_count_mod, pieces
from tiktoken_tpu_torch.ops import slot_merge as slot_merge_mod
from tiktoken_tpu_torch.ops import sweep_scan, window_scan as window_scan_mod
from tiktoken_tpu_torch.ops.charclass import na_cap
from tiktoken_tpu_torch.ops.sweep_scan import ScanTables

BUILD_DIR = os.path.join(_build.PKG_DIR, "build")

# rows per block of the two scans (tt_scan_rows, tt_char_scan), 32-256: the
# block has four threads per row to stage and classify, one to walk it;
# chip_smoke.py sweeps 32-256
SCAN_ROWS_PER_BLOCK = 128
# rows per block of the byte-level sequential scan (tt_seq_scan), 32-256;
# chip_smoke.py sweeps 32-256
SEQ_ROWS_PER_BLOCK = 128
# the most hot rows of the byte scan table kept in shared memory (64 rows
# of 257 int32, 66 KB)
HOT_ROWS_MAX = 64

# kernel launches since the last reset_launches(), by kernel
launches: dict[str, int] = dict.fromkeys(KERNELS, 0)
# the same, by C entry point (e.g. "tt_window_scan")
entry_launches: dict[str, int] = {}


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0
    entry_launches.clear()


_P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
_SIGNATURES = {
    "scan_rows": {
        "tt_scan_rows": [_P, _LL, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P, _I, _I,
                         _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
        "tt_scan_validate": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
        "tt_char_scan": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P],
        "tt_scan_smem": [_I, _I, _I, _I, _I, _I],
        "tt_scan_max_smem": [],
    },
    "compaction": {
        "tt_catalog": [_P, _I, _I, _P, _I, _P, _P, _LL, _P, _P, _P, _P, _P, _P, _P],
        "tt_catalog2": [_P, _I, _I, _P, _P, _I, _P, _LL, _P, _P, _P, _P, _P, _P, _P],
        "tt_extract_slots": [_P, _I, _I, _I, _P, _P, _I, _I, _P, _P],
        "tt_assemble": [_P, _P, _P, _P, _P, _P, _P, _LL, _P, _I, _P, _I, _P, _P, _LL, _P, _I,
                        _P, _I, _P, _P, _P, _LL, _LL, _I, _P, _P, _P, _P],
        "tt_compact_kinds": [_P, _P, _P, _P, _P, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P],
        "tt_scratch_words": [_LL, _LL],
    },
    "vocab_hit": {
        "tt_vocab_hit": [_P, _I, _P, _P, _I, _U, _P, _P],
        "tt_long_vocab_hit": [_P, _I, _P, _P, _I, _U, _P, _P],
    },
    "slot_merge": {
        "tt_slot_merge_packed": [_I, _P, _I, _U, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    },
    "byte_scan": {
        "tt_seq_scan": [_P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
        "tt_window_orbit": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _LL, _P, _P, _P,
                            _P],
        "tt_seq_smem": [_I, _I, _I, _I],
        "tt_byte_max_smem": [],
    },
    "grid_merge": {
        "tt_grid_merge": [_P, _I, _U, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P],
        "tt_grid_scratch_words": [_I, _I],
    },
    "pair_count": {
        "tt_pair_hist": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
        "tt_hist_argmax": [_P, _I, _P, _P, _P],
        "tt_pair_scratch_words": [_I, _I],
    },
}


class _Libraries:
    """The kernel libraries, found or built and loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self.libs: dict[str, ctypes.CDLL] | None = None
        self.build_seconds: float | None = None
        self.ptxas: dict[str, str] = {}

    def load(self) -> dict[str, ctypes.CDLL]:
        with self._lock:
            if self.libs is None:
                t0 = time.perf_counter()
                self.libs = self._find_or_build()
                self.build_seconds = time.perf_counter() - t0
            return self.libs

    def _find_or_build(self) -> dict[str, ctypes.CDLL]:
        from tiktoken_tpu_torch.ops.artifacts import artifact_dir

        names = _build.kernel_names()
        cache = artifact_dir()
        paths = {k: _build.find(n, BUILD_DIR, cache) for k, n in names.items()}
        missing = [k for k, path in paths.items() if path is None]
        if missing:
            nvcc = _build.find_nvcc()
            if nvcc is None:
                raise RuntimeError(
                    f"no library of the CUDA kernels {', '.join(missing)} is prebuilt or built, "
                    f"and nvcc is not found (not on PATH, not at {_build.NVCC_DEFAULT}): install "
                    "the CUDA toolkit, or install the package from a wheel built where nvcc "
                    "was found (pip install .[torch]), which carries the kernels prebuilt")
            out = _build.output_dir(BUILD_DIR, cache)
            self.ptxas.update(_build.build_kernels(nvcc, out, missing))
            paths.update({k: os.path.join(out, names[k]) for k in missing})
        libs = {}
        for name, so in paths.items():
            lib = ctypes.CDLL(so)
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib
        return libs


_LIBS = _Libraries()


def build() -> _Libraries:
    """Find or build, and load, every kernel now (normally done at first
    launch); returns the libraries, with the time taken and nvcc's
    -Xptxas -v report for each kernel built."""
    _LIBS.load()
    return _LIBS


def _call(kernel: str, fn: str, dev: torch.device, *args) -> None:
    """Run entry point ``fn`` of ``kernel`` with ``dev`` current and its
    current stream as the last argument: the entry points' launches and
    ``cudaFuncSetAttribute`` act on the runtime's current device."""
    entry = getattr(_LIBS.load()[kernel], fn)
    with torch.cuda.device(dev):
        err = entry(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}.{fn} failed with CUDA error {err}")
    launches[kernel] += 1
    entry_launches[fn] = entry_launches.get(fn, 0) + 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> int:
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    return t.data_ptr()


# Scratch of the one-launch reductions, by (device, stream): 4 int32 words,
# zeroed once when made (copied from the host: no kernel runs), that each
# launch leaves zero again: word 0 the ticket that elects the last block to
# arrive, word 1 the scans' non-ASCII flags, words 2-3 tt_hist_argmax's
# running maximum or tt_window_orbit's count. Launches on one stream run
# one after the other, so they share it; it is kept per stream because two
# launches in flight on two streams must never share a ticket (their blocks
# would count as one grid's). A launch that the entry point reports failed
# never ran, and leaves it zero.
_stream_scratch: dict[tuple[torch.device, int], torch.Tensor] = {}


def _scratch(dev: torch.device) -> int:
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    t = _stream_scratch.get(key)
    if t is None:
        t = _stream_scratch[key] = torch.zeros(4, dtype=torch.int32).to(dev)
    return t.data_ptr()


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _dev(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got {t.device}")
    return t.device


# ---------------------------------------------------------------------------
# scan_rows
# ---------------------------------------------------------------------------


def _scan_tables_args(tables: ScanTables, dev) -> list:
    S_, NW = tables.consts.shape
    return [_check("page16", tables.page16, torch.int16, None, dev),
            _check("mixed_rows", tables.mixed_rows, torch.uint8, None, dev),
            tables.mixed_rows.shape[0],
            _check("consts", tables.consts, torch.int32, None, dev), S_, NW,
            tables.skip_class, tables.cont_class, tables.eof_class]


def _scan_geometry(tables: ScanTables, KL: int, K: int) -> int:
    """Rows per block for a scan of rows of KL bytes and K mask columns;
    raises before any launch when a block's rows and tables do not fit
    in shared memory."""
    if not 0 < K <= KL:
        raise ValueError(f"mask width K={K} must be in 1..{KL}")
    S_, NW = tables.consts.shape
    lib = _LIBS.load()["scan_rows"]
    R = SCAN_ROWS_PER_BLOCK
    smem = lib.tt_scan_smem(KL, K, S_, NW, tables.mixed_rows.shape[0], R)
    limit = lib.tt_scan_max_smem()
    if smem > limit:
        raise ValueError(f"the scan needs {smem} bytes of shared memory per block of {R} rows of "
                         f"{KL} bytes, over the limit of {limit}: use a smaller row_capacity")
    return R


def scan_rows(tables: ScanTables, flat, row_off, n_payload, n_total, is_doc_end,
              *, KP: int, KL: int, na_frac: int):
    """B1+B2+B3 -> (rows [C, KL] u8, mask [C, KP] bool, spec_f [C] i32,
    row_bad [C] bool, na_overflow bool scalar). ``flat`` must be 4-byte
    aligned."""
    if _on_cpu(flat):
        return sweep_scan.scan_rows(tables, flat, row_off, n_payload, n_total,
                                    is_doc_end, KP=KP, KL=KL, na_frac=na_frac)
    dev = _dev(flat)
    C = row_off.shape[0]
    i32, u8, b = torch.int32, torch.uint8, torch.bool
    R = _scan_geometry(tables, KL, KP)
    if flat.data_ptr() % 4:
        raise ValueError("flat must be 4-byte aligned")
    args = [
        _check("flat", flat, u8, None, dev), flat.shape[0],
        _check("row_off", row_off, i32, (C,), dev),
        _check("n_payload", n_payload, i32, (C,), dev),
        _check("n_total", n_total, i32, (C,), dev),
        _check("is_doc_end", is_doc_end, b, (C,), dev), C, KL, KP,
        *_scan_tables_args(tables, dev), na_cap(KL, na_frac), R,
    ]
    rows = torch.empty((C, KL), dtype=u8, device=dev)
    mask = torch.empty((C, KP), dtype=b, device=dev)
    spec_f = torch.empty(C, dtype=i32, device=dev)
    row_bad = torch.empty(C, dtype=b, device=dev)
    na_flag = torch.empty((), dtype=b, device=dev)
    _call("scan_rows", "tt_scan_rows", dev, *args, rows.data_ptr(), mask.data_ptr(),
          spec_f.data_ptr(), row_bad.data_ptr(), na_flag.data_ptr(), _scratch(dev))
    return rows, mask, spec_f, row_bad, na_flag


def scan_validate(mask, spec_f, row_bad, n_payload, prev_same_doc, emit):
    """B4 -> (mask3 [C, KP] bool, row_bad [C] bool)."""
    if _on_cpu(mask):
        return sweep_scan.scan_validate(mask, spec_f, row_bad, n_payload,
                                        prev_same_doc, emit)
    dev = _dev(mask)
    C, KP = mask.shape
    args = [
        _check("mask", mask, torch.bool, (C, KP), dev),
        _check("spec_f", spec_f, torch.int32, (C,), dev),
        _check("row_bad", row_bad, torch.bool, (C,), dev),
        _check("n_payload", n_payload, torch.int32, (C,), dev),
        _check("prev_same_doc", prev_same_doc, torch.bool, (C,), dev),
        _check("emit", emit, torch.bool, (C,), dev), C, KP,
    ]
    mask3 = torch.empty((C, KP), dtype=torch.bool, device=dev)
    bad = torch.empty(C, dtype=torch.bool, device=dev)
    _call("scan_rows", "tt_scan_validate", dev, *args, mask3.data_ptr(), bad.data_ptr())
    return mask3, bad


def char_scan(tables: ScanTables, rows, n_payload, n_total, *, K: int, na_frac: int):
    """B16 -> (piece_start [C, K] bool, row_bad [C] bool, na_overflow bool
    scalar); see ``sweep_scan.char_scan_rows``. The kernel stages a block's
    rows in shared memory beside the tables: a geometry that does not fit
    raises before any launch."""
    if _on_cpu(rows):
        return sweep_scan.char_scan_rows(tables, rows, n_payload, n_total, K=K, na_frac=na_frac)
    dev = _dev(rows)
    C, KL = rows.shape
    R = _scan_geometry(tables, KL, K)
    args = [
        _check("rows", rows, torch.uint8, (C, KL), dev), C, KL, K,
        _check("n_payload", n_payload, torch.int32, (C,), dev),
        _check("n_total", n_total, torch.int32, (C,), dev),
        *_scan_tables_args(tables, dev), na_cap(KL, na_frac), R,
    ]
    mask = torch.empty((C, K), dtype=torch.bool, device=dev)
    row_bad = torch.empty(C, dtype=torch.bool, device=dev)
    na_flag = torch.empty((), dtype=torch.bool, device=dev)
    _call("scan_rows", "tt_char_scan", dev, *args, mask.data_ptr(), row_bad.data_ptr(),
          na_flag.data_ptr(), _scratch(dev))
    return mask, row_bad, na_flag


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def _tile_scratch(n: int, dev, row_bytes: int = 0) -> torch.Tensor:
    """The scratch of a one-pass entry over n items with row_bytes bytes of
    per-row words (cleared by the entry)."""
    words = _LIBS.load()["compaction"].tt_scratch_words(n, row_bytes)
    return torch.empty(words, dtype=torch.int64, device=dev)


def catalog(rows, mask3, spec_f, row_bad, p_cap: int):
    """B5 -> (starts [p_cap] i32, words [p_cap, 4] i32, lens [p_cap] i32,
    row_bad [C] bool, n_pieces i32)."""
    if _on_cpu(rows):
        return compaction.catalog(rows, mask3, spec_f, row_bad, p_cap)
    dev = _dev(rows)
    C, KL = rows.shape
    KP = mask3.shape[1]
    args = [_check("mask3", mask3, torch.bool, (C, KP), dev), C, KP,
            _check("rows", rows, torch.uint8, (C, KL), dev), KL,
            _check("spec_f", spec_f, torch.int32, (C,), dev),
            _check("row_bad", row_bad, torch.bool, (C,), dev), p_cap]
    starts = torch.empty(p_cap, dtype=torch.int32, device=dev)
    words = torch.empty((p_cap, 4), dtype=torch.int32, device=dev)
    lens = torch.empty(p_cap, dtype=torch.int32, device=dev)
    bad = torch.empty(C, dtype=torch.bool, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = _tile_scratch(C * KP, dev, C)
    _call("compaction", "tt_catalog", dev, *args, starts.data_ptr(), words.data_ptr(),
          lens.data_ptr(), bad.data_ptr(), count.data_ptr(), scratch.data_ptr())
    return starts, words, lens, bad, count


def compact_kinds(words, starts, lens, hit, n_pieces, m_cap: int, l_cap: int):
    """The short-miss and long compactions of one catalog in one pass ->
    ((m_words [m_cap, 4], m_lens, m_pid [m_cap]), n_miss, mslot [p],
    (l_starts, l_lens, l_pid [l_cap]), n_long, lslot [p]); see
    ``compaction.compact_kinds``."""
    if _on_cpu(lens):
        return compaction.compact_kinds(words, starts, lens, hit, n_pieces, m_cap, l_cap)
    dev = _dev(lens)
    (p,) = lens.shape
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    args = [_check("lens", lens, torch.int32, (p,), dev),
            _check("hit", hit, torch.int32, (p,), dev),
            _check("n_pieces", n_pieces, torch.int32, (), dev),
            _check("words", words, torch.int32, (p, 4), dev),
            _check("starts", starts, torch.int32, (p,), dev), p, m_cap, l_cap]
    i32 = dict(dtype=torch.int32, device=dev)
    m_words, m_lens, m_pid = (torch.empty((m_cap, 4), **i32), torch.empty(m_cap, **i32),
                              torch.empty(m_cap, **i32))
    l_starts, l_lens, l_pid = (torch.empty(l_cap, **i32) for _ in range(3))
    n_miss, n_long = torch.empty((), **i32), torch.empty((), **i32)
    mslot, lslot = torch.empty(p, **i32), torch.empty(p, **i32)
    scratch = _tile_scratch(p, dev)
    _call("compaction", "tt_compact_kinds", dev, *args, m_words.data_ptr(), m_lens.data_ptr(),
          m_pid.data_ptr(), n_miss.data_ptr(), mslot.data_ptr(), l_starts.data_ptr(),
          l_lens.data_ptr(), l_pid.data_ptr(), n_long.data_ptr(), lslot.data_ptr(),
          scratch.data_ptr())
    return (m_words, m_lens, m_pid), n_miss, mslot, (l_starts, l_lens, l_pid), n_long, lslot


# ---------------------------------------------------------------------------
# vocab_hit
# ---------------------------------------------------------------------------


def vocab_hit(buckets, words, lens, seed: int):
    """(buckets [nb, 64] i32, words [P, 4] i32, lens [P] i32) -> ids [P] i32."""
    if _on_cpu(words):
        return pieces.vocab_hit(buckets, words, lens, seed)
    dev = _dev(words)
    P = words.shape[0]
    nb = buckets.shape[0]
    args = [_check("buckets", buckets, torch.int32, (nb, pieces.VOCAB_BUCKET_WIDTH), dev), nb,
            _check("words", words, torch.int32, (P, 4), dev),
            _check("lens", lens, torch.int32, (P,), dev), P, seed]
    out = torch.empty(P, dtype=torch.int32, device=dev)
    _call("vocab_hit", "tt_vocab_hit", dev, *args, out.data_ptr())
    return out


def long_vocab_hit(buckets, slot_bytes, lens, seed: int):
    """(buckets [nb, 128] i32, slot_bytes [M, 64] u8, lens [M] i32) -> ids [M] i32."""
    if _on_cpu(slot_bytes):
        return pieces.long_vocab_hit(buckets, slot_bytes, lens, seed)
    dev = _dev(slot_bytes)
    M = slot_bytes.shape[0]
    nb = buckets.shape[0]
    args = [_check("buckets", buckets, torch.int32, (nb, pieces.LONG_BUCKET_WIDTH), dev), nb,
            _check("slot_bytes", slot_bytes, torch.uint8, (M, pieces.LONG_SLOT), dev),
            _check("lens", lens, torch.int32, (M,), dev), M, seed]
    if slot_bytes.data_ptr() % 4:
        raise ValueError("slot_bytes must be 4-byte aligned")
    out = torch.empty(M, dtype=torch.int32, device=dev)
    _call("vocab_hit", "tt_long_vocab_hit", dev, *args, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# slot_merge
# ---------------------------------------------------------------------------


def slot_merge_packed(buckets, byte_to_rank, slot_bytes, lens, seed: int, n_real, hit=None):
    """(pair buckets [nb, 32] i32, byte_to_rank [256] i32, slot_bytes
    [M, W] u8 with W in (16, 64), lens [M] i32, n_real 0-d i32, hit [M] i32
    or None) -> (tok_p [M, W] i32, count [M] i32): the slots below n_real
    merged, their tokens left-packed; see ``slot_merge.slot_merge_packed``.
    Entries past a slot's count and slots at or past n_real are left as
    ``torch.empty`` gave them."""
    if _on_cpu(slot_bytes):
        return slot_merge_mod.slot_merge_packed(buckets, byte_to_rank, slot_bytes, lens, seed,
                                                n_real, hit)
    dev = _dev(slot_bytes)
    M, W = slot_bytes.shape
    if W not in (16, 64):
        raise ValueError(f"slot width must be 16 or 64, got {W}")
    nb = buckets.shape[0]
    if buckets.data_ptr() % 16:
        raise ValueError("pair buckets must be 16-byte aligned")
    args = [W, _check("buckets", buckets, torch.int32, (nb, 32), dev), nb, seed,
            _check("byte_to_rank", byte_to_rank, torch.int32, (256,), dev),
            _check("slot_bytes", slot_bytes, torch.uint8, (M, W), dev),
            _check("lens", lens, torch.int32, (M,), dev), M,
            _check("n_real", n_real, torch.int32, (), dev),
            None if hit is None else _check("hit", hit, torch.int32, (M,), dev)]
    tok_p = torch.empty((M, W), dtype=torch.int32, device=dev)
    count = torch.empty(M, dtype=torch.int32, device=dev)
    _call("slot_merge", "tt_slot_merge_packed", dev, *args, tok_p.data_ptr(), count.data_ptr())
    return tok_p, count


def catalog2(piece_start, n_payload, rows, row_bad, p_cap: int):
    """B10 catalog -> (starts [p_cap] i32, words [p_cap, 4] i32, lens
    [p_cap] i32, row_bad [C] bool, n_pieces i32); see
    ``compaction.catalog2``."""
    if _on_cpu(piece_start):
        return compaction.catalog2(piece_start, n_payload, rows, row_bad, p_cap)
    dev = _dev(piece_start)
    C, K = piece_start.shape
    KL = rows.shape[1]
    if KL < K:
        raise ValueError(f"rows must hold at least K={K} columns, got {KL}")
    args = [_check("piece_start", piece_start, torch.bool, (C, K), dev), C, K,
            _check("n_payload", n_payload, torch.int32, (C,), dev),
            _check("rows", rows, torch.uint8, (C, KL), dev), KL,
            _check("row_bad", row_bad, torch.bool, (C,), dev), p_cap]
    starts = torch.empty(p_cap, dtype=torch.int32, device=dev)
    words = torch.empty((p_cap, 4), dtype=torch.int32, device=dev)
    lens = torch.empty(p_cap, dtype=torch.int32, device=dev)
    bad = torch.empty(C, dtype=torch.bool, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = _tile_scratch(C * K, dev, C)
    _call("compaction", "tt_catalog2", dev, *args, starts.data_ptr(), words.data_ptr(),
          lens.data_ptr(), bad.data_ptr(), count.data_ptr(), scratch.data_ptr())
    return starts, words, lens, bad, count


def extract_slots(rows, starts, lens, K: int):
    """B10 long extraction -> [n, 64] u8; see ``compaction.extract_slots``."""
    if _on_cpu(rows):
        return compaction.extract_slots(rows, starts, lens, K)
    dev = _dev(rows)
    C, KL = rows.shape
    (n,) = starts.shape
    width = pieces.LONG_SLOT
    args = [_check("rows", rows, torch.uint8, (C, KL), dev), C, KL, K,
            _check("starts", starts, torch.int32, (n,), dev),
            _check("lens", lens, torch.int32, (n,), dev), n, width]
    out = torch.empty((n, width), dtype=torch.uint8, device=dev)
    _call("compaction", "tt_extract_slots", dev, *args, out.data_ptr())
    return out


def assemble(n_pieces, lens, hit, words, byte_to_rank, mslot, lslot, m_count, l_count, m_tok,
             l_tok, starts, row_bad, n_miss, n_long, na_flag, *, K: int, t_cap: int,
             p_limit: int, t_limit: int, full: bool):
    """B8 / B10 assembly -> (tokens [t_cap] i32, header [2C+5] (full) or
    [2C+2] i32); see ``compaction.assemble``. ``na_flag``: a 0-d bool, or
    None for a scan without the non-ASCII cap."""
    if _on_cpu(lens):
        return compaction.assemble(n_pieces, lens, hit, words, byte_to_rank, mslot, lslot,
                                   m_count, l_count, m_tok, l_tok, starts, row_bad, n_miss,
                                   n_long, na_flag, K=K, t_cap=t_cap, p_limit=p_limit,
                                   t_limit=t_limit, full=full)
    dev = _dev(lens)
    (p,) = lens.shape
    (m_cap,), (l_cap,) = m_count.shape, l_count.shape
    (C,) = row_bad.shape
    i32 = torch.int32
    args = [_check("n_pieces", n_pieces, i32, (), dev), _check("lens", lens, i32, (p,), dev),
            _check("hit", hit, i32, (p,), dev), _check("words", words, i32, (p, 4), dev),
            _check("byte_to_rank", byte_to_rank, i32, (256,), dev),
            _check("mslot", mslot, i32, (p,), dev), _check("lslot", lslot, i32, (p,), dev), p,
            _check("m_count", m_count, i32, (m_cap,), dev), m_cap,
            _check("l_count", l_count, i32, (l_cap,), dev), l_cap,
            _check("m_tok", m_tok, i32, (m_cap, pieces.SLOT), dev),
            _check("l_tok", l_tok, i32, (l_cap, pieces.LONG_SLOT), dev), t_cap,
            _check("starts", starts, i32, (p,), dev), K,
            _check("row_bad", row_bad, torch.bool, (C,), dev), C,
            _check("n_miss", n_miss, i32, (), dev), _check("n_long", n_long, i32, (), dev),
            None if na_flag is None else _check("na_flag", na_flag, torch.bool, (), dev),
            p_limit, t_limit, int(full)]
    tok = torch.empty(t_cap, dtype=i32, device=dev)
    header = torch.empty(2 * C + (5 if full else 2), dtype=i32, device=dev)
    scratch = _tile_scratch(p, dev, 4 * C)
    _call("compaction", "tt_assemble", dev, *args, tok.data_ptr(), header.data_ptr(),
          scratch.data_ptr())
    return tok, header


# ---------------------------------------------------------------------------
# byte_scan
# ---------------------------------------------------------------------------


def seq_scan(packed, rows, n_payload, n_total, *, K: int, hot: int = 0):
    """B9 -> (piece_start [C, K] bool, row_bad [C] bool); see
    ``window_scan.seq_scan``. ``packed``'s first ``hot`` states are closed
    under ASCII bytes (``window_scan.hot_byte_scan_table``) and are read
    from shared memory (at most HOT_ROWS_MAX). A block's rows and hot rows
    that do not fit in shared memory raise before any launch (v2 rows of
    at most 272 bytes fit)."""
    if _on_cpu(rows):
        return window_scan_mod.seq_scan(packed, rows, n_payload, n_total, K=K, hot=hot)
    dev = _dev(rows)
    C, KL = rows.shape
    S_, NC = packed.shape
    if not 0 <= hot <= S_:
        raise ValueError(f"hot={hot} must be in 0..{S_}")
    if packed.data_ptr() % 16:
        raise ValueError("the byte scan table must be 16-byte aligned")
    hot = min(hot, HOT_ROWS_MAX)
    R = SEQ_ROWS_PER_BLOCK
    lib = _LIBS.load()["byte_scan"]
    smem, limit = lib.tt_seq_smem(hot, R, KL, K), lib.tt_byte_max_smem()
    if smem > limit:
        raise ValueError(f"the byte scan needs {smem} bytes of shared memory per block of {R} "
                         f"rows of {KL} bytes, over the limit of {limit}: use a smaller "
                         "row_capacity")
    args = [_check("packed", packed, torch.int32, (S_, NC), dev), S_, NC, hot,
            _check("rows", rows, torch.uint8, (C, KL), dev), C, KL, K, R,
            _check("n_payload", n_payload, torch.int32, (C,), dev),
            _check("n_total", n_total, torch.int32, (C,), dev)]
    mask = torch.empty((C, K), dtype=torch.bool, device=dev)
    bad = torch.empty(C, dtype=torch.bool, device=dev)
    _call("byte_scan", "tt_seq_scan", dev, *args, mask.data_ptr(), bad.data_ptr())
    return mask, bad


def window_orbit(packed, rows, n_payload, n_total, *, K: int,
                 window: int = window_scan_mod.DEFAULT_WINDOW, hot: int = 0):
    """B11 + B12 + the v1 row flags -> (piece_start [C, K] bool, row_bad [C]
    bool); see ``window_scan.window_orbit``. ``packed``'s first ``hot``
    states are closed under ASCII bytes and are read from shared memory (at
    most HOT_ROWS_MAX). A geometry that does not fit in shared memory makes
    the entry fail before it launches, and this raises."""
    if _on_cpu(rows):
        return window_scan_mod.window_orbit(packed, rows, n_payload, n_total, K=K, window=window,
                                            hot=hot)
    dev = _dev(rows)
    C, KL = rows.shape
    S_, NC = packed.shape
    if not 0 <= hot <= S_:
        raise ValueError(f"hot={hot} must be in 0..{S_}")
    if packed.data_ptr() % 16:
        raise ValueError("the byte scan table must be 16-byte aligned")
    hot = min(hot, HOT_ROWS_MAX)
    w1 = min(window_scan_mod.FIRST_WINDOW, window)
    u_cap = max(128, C * K // 32) if w1 < window else C * K
    args = [_check("packed", packed, torch.int32, (S_, NC), dev), S_, NC, hot,
            _check("rows", rows, torch.uint8, (C, KL), dev), C, KL, K,
            _check("n_payload", n_payload, torch.int32, (C,), dev),
            _check("n_total", n_total, torch.int32, (C,), dev), window, w1, u_cap]
    mask = torch.empty((C, K), dtype=torch.bool, device=dev)
    bad = torch.empty(C, dtype=torch.bool, device=dev)
    _call("byte_scan", "tt_window_orbit", dev, *args, mask.data_ptr(), bad.data_ptr(),
          _scratch(dev))
    return mask, bad


# ---------------------------------------------------------------------------
# grid_merge
# ---------------------------------------------------------------------------

def grid_merge(buckets, byte_to_rank, rows, piece_start, n_payload, seed: int):
    """B13 + B14 -> (packed [C, K] i32, counts [C] i32, rounds i32); see
    ``merge.grid_merge``."""
    if _on_cpu(rows):
        return merge.grid_merge(buckets, byte_to_rank, rows, piece_start, n_payload, seed)
    dev = _dev(rows)
    C, K = piece_start.shape
    KL = rows.shape[1]
    nb = buckets.shape[0]
    if buckets.data_ptr() % 16:
        raise ValueError("pair buckets must be 16-byte aligned")
    args = [_check("buckets", buckets, torch.int32, (nb, 32), dev), nb, seed,
            _check("byte_to_rank", byte_to_rank, torch.int32, (256,), dev),
            _check("rows", rows, torch.uint8, (C, KL), dev), KL,
            _check("piece_start", piece_start, torch.bool, (C, K), dev),
            _check("n_payload", n_payload, torch.int32, (C,), dev), C, K]
    words = _LIBS.load()["grid_merge"].tt_grid_scratch_words(C, K)
    if words < 0:
        raise ValueError(f"grid_merge: {C} rows of {K} columns are too many for one launch")
    packed = torch.empty((C, K), dtype=torch.int32, device=dev)
    counts = torch.empty(C, dtype=torch.int32, device=dev)
    rounds = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    _call("grid_merge", "tt_grid_merge", dev, *args, packed.data_ptr(), counts.data_ptr(),
          rounds.data_ptr(), scratch.data_ptr())
    return packed, counts, rounds


# ---------------------------------------------------------------------------
# pair_count
# ---------------------------------------------------------------------------

def pair_hist(tokens, alive, piece_start, bits: int):
    """B15 -> hist [2^bits] i32 of the counted pairs' bins; see
    ``pair_count.pair_hist``."""
    if _on_cpu(tokens):
        return pair_count_mod.pair_hist(tokens, alive, piece_start, bits)
    dev = _dev(tokens)
    B, K = tokens.shape
    if not 1 <= bits <= 30:
        raise ValueError(f"hist bits must be in 1..30, got {bits}")
    args = [_check("tokens", tokens, torch.int32, (B, K), dev),
            _check("alive", alive, torch.bool, (B, K), dev),
            _check("piece_start", piece_start, torch.bool, (B, K), dev), B, K, bits]
    words = _LIBS.load()["pair_count"].tt_pair_scratch_words(B, K)
    if words < 0:
        raise ValueError(f"pair_hist: a [{B}, {K}] grid is too large for one launch")
    hist = torch.empty(1 << bits, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(4, words), dtype=torch.int32, device=dev)
    _call("pair_count", "tt_pair_hist", dev, *args, hist.data_ptr(), scratch.data_ptr())
    return hist


def hist_argmax(hist):
    """hist [n] i32 -> (best_bin, best_count), 0-d i32: the first bin of
    the maximum; see ``pair_count.hist_argmax``."""
    if _on_cpu(hist):
        return pair_count_mod.hist_argmax(hist)
    dev = _dev(hist)
    (n,) = hist.shape
    if n == 0:
        raise ValueError("hist_argmax of an empty histogram")
    out = torch.empty(2, dtype=torch.int32, device=dev)
    _call("pair_count", "tt_hist_argmax", dev, _check("hist", hist, torch.int32, (n,), dev), n,
          _scratch(dev), out.data_ptr())
    return out[0], out[1]


# The two sets of operations of the chunk programs and the training step:
# the kernels (plain versions on CPU tensors), and the plain versions
# everywhere — the yardstick the chip check holds each kernel against.
KERNEL_OPS = SimpleNamespace(
    scan_rows=scan_rows, scan_validate=scan_validate, char_scan=char_scan, catalog=catalog,
    compact_kinds=compact_kinds, vocab_hit=vocab_hit, long_vocab_hit=long_vocab_hit,
    slot_merge_packed=slot_merge_packed, catalog2=catalog2, extract_slots=extract_slots,
    assemble=assemble, seq_scan=seq_scan, window_orbit=window_orbit, grid_merge=grid_merge,
    pair_hist=pair_hist, hist_argmax=hist_argmax,
)
PLAIN_OPS = SimpleNamespace(
    scan_rows=sweep_scan.scan_rows, scan_validate=sweep_scan.scan_validate,
    char_scan=sweep_scan.char_scan_rows, catalog=compaction.catalog,
    compact_kinds=compaction.compact_kinds, vocab_hit=pieces.vocab_hit,
    long_vocab_hit=pieces.long_vocab_hit, slot_merge_packed=slot_merge_mod.slot_merge_packed,
    catalog2=compaction.catalog2, extract_slots=compaction.extract_slots,
    assemble=compaction.assemble, seq_scan=window_scan_mod.seq_scan,
    window_orbit=window_scan_mod.window_orbit, grid_merge=merge.grid_merge,
    pair_hist=pair_count_mod.pair_hist, hist_argmax=pair_count_mod.hist_argmax,
)
