#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure exits non-zero; no phase's failure is caught):

1. the card's name and power limit; the build of the seven CUDA kernels,
   none of whose libraries may export an entry point that was taken out
   (``GONE_ENTRIES``);
2. the bench vocabulary (assets/bench_vocab2_100000.tiktoken, 100,000
   ranks) with the o200k split pattern, its tables built and uploaded:
   the pair, short-vocab and long-vocab tables through the disk cache
   cold (built and stored) and warm (loaded), each timed, then a second
   ``TorchEngine.build`` on the cached tables, timed;
   then ``Encoding.warmup()``, timed apart from every main-path call: the
   native host core built with g++ (and the pattern's byte-level DFA
   compiled), the kernels, one empty v3 chunk;
3. a seeded 64 MB synthetic corpus (the bench corpus recipe), cut into
   1 MB documents, plus edge documents;
4. per kernel, on one real v3 chunk of that corpus at C=32768 rows,
   K=176: every entry point against its plain PyTorch version on the
   same inputs (integers, so exact equality; the slot merges' counts of
   the live slots and their tokens below each count, the rest being left
   unwritten), timed with CUDA events;
   then the whole chunk program with the kernels and with the plain
   versions (one call of it traced in phase 9b), and every entry point
   again on the edge documents' chunks
   (over the non-ASCII cap, in both cap variants); the scan's walk
   steps per row (the plain walk's count), its time at 32-256 rows per
   block, and the cycles of one dependent walk step with the latency
   floor they give;
4b. the same on one real v2 chunk at C=32768 rows, K=256: every entry
   point of ``run_chunk2`` under the char scanner (``tt_char_scan``), the
   byte scanner's ``tt_seq_scan`` (the byte-level scan table compiled and
   uploaded first) and every entry of the v1 ``run_rows1`` on those rows
   against its plain version, then the three programs with the kernels
   against plain (a chunk over the char scanner's non-ASCII cap is held
   by its header only, and the rows over the cap are counted); the same
   scan study as phase 4, for ``tt_char_scan`` and for ``tt_seq_scan``
   (its rows per block, and its time with no hot rows in shared memory);
   the edge documents' chunk, over the cap, entry
   point by entry point, and through the v1 program (pieces of the whole
   row, over the window scan's u_cap); the v1 program on the chunk's first
   128 rows (the sharded v2's re-run size), entry point by entry point
   (one call of each program traced in phase 9b);
   ``tt_grid_merge`` against plain on a chunk of pieces at each of
   its length-class boundaries (1 to 256 bytes) with rows of no payload,
   and its time beside its probe floor (as many reads as the chunk makes
   probes, one 16-byte load each, at hashed random rows of the pair table:
   ``scripts/floor_kernels.cu``); a row too long for the scan's shared
   memory is refused before launch;
5. the v3 main path: ``Encoding.encode_corpus_to_numpy`` over the corpus
   on ``cuda`` with ``strategy="device"``, with every kernel's launch count
   read around it;
5b. the v2 main path: the same call with ``pipeline=2`` (the char
   scanner), again with ``scanner="byte"``, then a small ``pipeline=2``
   call of random words whose chunk overflows v2's short-miss cap and
   re-runs through v1, each with the launch counts read around it (the
   char route must launch ``tt_char_scan`` and no ``tt_seq_scan``);
5c. the host and hybrid routes: the warmup's seconds; the native host
   core against the pure-Python encoder (``HostBPE.encode_ordinary_python``)
   on the edge documents and two 1 MB documents; then
   ``encode_corpus_to_numpy`` over the corpus with ``strategy="host"`` (no
   kernel may launch) and with ``strategy="hybrid"`` (the launch counts read
   around it: its device worker must have taken documents and launched the
   v3 kernels), each equal to phase 5's ids document for document, with
   their MB/s, the documents each worker took, the device worker's summed
   ``pack_s`` and ``fallback_s``, and ``os.cpu_count()``;
6. every document decodes back to its bytes; the edge documents and four
   1 MB documents equal the host ``encode_ordinary``;
6b. the v2 ids under both scanners equal the v3 ids over the whole
   corpus, and the overflow call's ids equal ``encode_ordinary``;
7. the sharded engine (``tiktoken_tpu_torch.parallel``): ``encode_corpus3``
   over every visible GPU and over a 2-way split of one card, each equal
   to phase 5's ids document for document and with phase 5's count of host
   fallbacks; a sharded ``pipeline=2`` call (char scanner)
   of the random words that re-runs chunks through v1 and equals
   ``encode_ordinary``; sharded ``encode_rows`` over those rows, equal to
   the single-device v1 rows, with its ``CorpusStats`` checked;
8. the training step on the dry run's feed at full size (phase 5's tokens,
   one document per row, a piece start at each row's front, 2^20 bins):
   ``corpus_pair_counts`` over every GPU, a 2-way split and a one-rank
   NCCL group agree; the upload, the read-back and the whole call are
   timed on the host clock; both ``pair_count`` entry points equal their
   plain version on the same tensors, timed with CUDA events, and
   ``tt_pair_hist`` on a hot-bin grid (one repeated pair, dead stretches
   across tiles) at 2^12, 2^20 and 2^26 bins; its atomic floor (one
   ``atomicAdd`` a pair on the feed's precomputed bins:
   ``scripts/floor_kernels.cu``, held against the histogram);
   ``tt_hist_argmax`` against plain on edge histograms built on the card
   (n = 1, 3, 4097, 2^20, aligned and as an unaligned view: all zeros,
   ties at the ends and spread far apart, a maximum of 2^31 - 1), one call
   launching one kernel (``torch.profiler``), and the time of an empty
   one-block launch beside its own;

9. the public API at full width: a plugin module written into a temporary
   directory (``tiktoken_tpu_torch_ext/bench_local.py``, put on ``sys.path``
   before the registry first discovers plugins) registers ``bench_o200k``
   (the bench vocabulary, ``<|endoftext|>`` = 100000, ``<|endofprompt|>`` =
   100001); ``list_encoding_names`` holds it and the seven shipped names,
   ``get_encoding`` gives the same object twice, ``encoding_name_for_model
   ("gpt-4o")`` is ``"o200k_base"``; the registry's encoding's
   ``encode_corpus_to_numpy(strategy="device")`` over the corpus (path
   ``api_v3``) equals phase 5's ids; ``encode(allowed_special="all")`` of
   eight 1 MB documents joined by ``<|endoftext|>``, one holding
   ``<|endofprompt|>``, equals phase 5's ids with the special ids between
   (and ``encode`` without it raises, ``disallowed_special=()`` equals
   ``encode_ordinary``); ``encode_batch`` and ``encode_to_numpy`` equal
   phase 5's ids, ``decode_batch`` / ``decode_bytes_batch`` give every
   document back, ``decode_with_offsets`` holds on the edge documents;
   48 documents with lone surrogates equal ``encode_ordinary`` on
   ``strategy="device"`` and ``"hybrid"``;
   the registry's encoding pickles as its name, phase 2's encoding (its
   CUDA engine built) pickles whole and its copy's device ids equal phase
   5's on the edge documents; ``device_trace`` around one more ``api_v3``
   call gives the device busy share (the union of the kernels' intervals
   over the call's wall time) and the five kernels with the most device
   time; ``encode_batch`` against ``encode_ordinary_batch`` MB/s and
   ``engine_report``;
9b. three calls of each chunk program of phases 4 and 4b (v3; v2 under
   both scanners; v1) traced with ``torch.profiler``: every CUDA kernel in
   the trace must be the package's (no PyTorch op runs between the
   kernels; PyTorch's ``at::`` kernels read 0 ms), and the trace must hold
   every kernel the host launched in it but the last (a session records
   all but its last kernel), so each call's kernels are seen in the first
   two calls whole. It runs after phase 8's
   one-kernel argmax trace: run before it, in phases 4 and 4b, these
   traces left that one empty.
10. the sharded engine across processes: ``ShardedEngine(..., group=)``
   over a one-rank NCCL group in this process (path ``xproc_nccl1``, phase
   5's corpus), then two spawned ranks (a ``FileStore`` in a temporary
   directory, the spawn start method): over NCCL with rank r on
   ``cuda:r`` where there are two GPUs, else both on ``cuda:0`` gathering
   over gloo. Each rank builds the bench encoding (the DFAs and the hash
   tables from phase 2's disk cache, the kernels phase 1 built; its setup
   and its engine's build timed), warms up, and runs
   ``encode_corpus3`` over phase 5's corpus (path ``xproc_v3``, timed from
   a barrier to the end of the gather), ``encode_corpus(pipeline=2)`` over
   phase 5b's random words cut into 8 documents (``xproc_v2``, with v1
   re-runs), ``encode_rows`` over the words' rows (``xproc_rows``) and
   ``corpus_pair_counts(group=)`` over its half of phase 8's grid
   (``xproc_train``). Every rank's v3 ids must equal phase 5's with its
   count of host fallbacks, its v2 ids the host encoder's, its rows the
   one-device rows (and their ``CorpusStats``), its histogram phase 8's,
   and every rank must launch each path's kernels on its GPU. It prints
   the cross-process MB/s and each rank's host-clock phases.
11. the installed wheel: ``setup.py build_ext`` builds the wheel's
   compiled parts into a temporary directory (timed), which must hold the
   native core and the seven kernel libraries under their digest names;
   the port's two packages are copied beside that ``prebuilt/``, and a
   fresh process where neither g++ nor nvcc is found (neither on PATH,
   ``_build``'s nvcc search pointed away) and the disk cache is empty runs
   phase 5's v3 call on ``cuda:0`` with ``strategy="device"`` (path
   ``wheel_device``) and ``"auto"`` (``wheel_auto``). Each must equal phase
   5's ids and launch every v3 kernel; every library must be loaded from
   ``prebuilt/``, none built, and none written under the copy's ``build/``
   or the cache.

Each main-path call (phases 5, 5b, 5c's hybrid call, 7, 8, 9, 10 and 11; in
phases 10 and 11 each process's own) sets the launch counts to 0
just before it and reads them just after, and fails if a kernel of its
path was not launched, if a path that merges did not launch
``tt_slot_merge_packed`` and ``tt_assemble``, or if any path launched
an entry point that was taken out (``GONE_ENTRIES``); phase 1
fails if a built kernel library still exports one.

Before the last line it prints the card line and one JSON ``kernels``
line; the last line is ``{"ok": true, "device": {...}}``. Exits non-zero
without a result when CUDA is not available or the package is missing.
"""

from __future__ import annotations

import ctypes
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CORPUS_MB = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
INT32_OPS_PER_S = 67e12  # float32 non-tensor rate, as the 32-bit ALU proxy
KERNEL_OF = {
    "pair_hist": "pair_count", "hist_argmax": "pair_count",
    "scan_rows": "scan_rows", "scan_validate": "scan_rows", "char_scan": "scan_rows",
    "catalog": "compaction", "compact_kinds": "compaction", "catalog2": "compaction",
    "extract_slots": "compaction", "assemble": "compaction",
    "vocab_hit": "vocab_hit", "long_vocab_hit": "vocab_hit",
    "slot_merge_packed": "slot_merge",
    "seq_scan": "byte_scan", "window_orbit": "byte_scan",
    "grid_merge": "grid_merge",
}
REPLACES = {
    "scan_rows": "tiktoken_tpu/ops/sweep_scan.py:233; tiktoken_tpu/ops/charclass.py:215; "
                 "tiktoken_tpu/ops/pipeline3.py:306; tiktoken_tpu/ops/pipeline3.py:410; "
                 "tiktoken_tpu/ops/pipeline2.py:86",
    "compaction": "tiktoken_tpu/ops/compaction.py:78; tiktoken_tpu/ops/compaction.py:164; "
                  "tiktoken_tpu/ops/pieces.py:288; tiktoken_tpu/ops/pieces.py:317; "
                  "tiktoken_tpu/ops/pipeline2.py:104; tiktoken_tpu/ops/pipeline3.py:351; "
                  "tiktoken_tpu/ops/pipeline3.py:584; tiktoken_tpu/ops/pipeline3.py:644; "
                  "tiktoken_tpu/ops/pipeline2.py:212",
    "vocab_hit": "tiktoken_tpu/ops/pieces.py:354; tiktoken_tpu/ops/pieces.py:205",
    "slot_merge": "tiktoken_tpu/ops/slot_merge.py:62; tiktoken_tpu/ops/pipeline3.py:553",
    "byte_scan": "tiktoken_tpu/ops/window_scan.py:287; tiktoken_tpu/ops/window_scan.py:118; "
                 "tiktoken_tpu/ops/window_scan.py:197; tiktoken_tpu/ops/engine.py:268",
    "grid_merge": "tiktoken_tpu/ops/merge.py:116; tiktoken_tpu/ops/engine.py:281",
    "pair_count": "tiktoken_tpu/parallel/train.py:60; tiktoken_tpu/parallel/train.py:28",
}
JAX_FUNCTIONS = {
    "scan_rows": ["pipeline3.row_gather", "charclass.make_byte_classes_fn",
                  "sweep_scan.make_char_scan_fn(handshake=True)",
                  "pipeline3 handshake validation",
                  "sweep_scan.make_char_scan_fn(handshake=False)"],
    "compaction": ["compaction.compact", "compaction.expand",
                   "pipeline3 catalog lengths, too-long flags and word padding",
                   "pipeline3 slot prefix sums and token fetch",
                   "pipeline3 / pipeline2 short-miss and long masks and compactions",
                   "pieces.make_catalog_fn", "pieces.make_extract_fn",
                   "pipeline2 / pipeline3 extract_long",
                   "pipeline3 / pipeline2 single, count and combo selects, route_right of the "
                   "slot counts, assembly, row counts, overflow rule and header"],
    "vocab_hit": ["pieces.make_vocab_hit_fn", "pieces.make_long_vocab_hit_fn"],
    "slot_merge": ["slot_merge.make_slot_merge_fn(W=16)", "slot_merge.make_slot_merge_fn(W=64)",
                   "pipeline3 / pipeline2 row-wise compaction of the merged slots and the long "
                   "hits' lane-0 select"],
    "byte_scan": ["window_scan.make_seq_scan_fn", "window_scan.make_window_scan_fn",
                  "window_scan.make_orbit_fn", "engine.build_pipeline_fn row flags"],
    "grid_merge": ["merge.make_merge_fn", "engine.build_pipeline_fn row assembly"],
    "pair_count": ["parallel.train.make_pair_count_step.per_shard", "parallel.train._pair_hash"],
}
# entry points taken out of the kernels: no path may launch them, and no
# built kernel library may export them
GONE_ENTRIES = ("tt_compact_rows", "tt_route", "tt_slot_merge", "tt_expand_tokens",
                "tt_expand_tokens_rows", "tt_piece_counts", "tt_window_scan", "tt_orbit",
                "tt_window_orbit_smem", "tt_window_orbit_blocks")
# which kernels each path must launch
PATH_KERNELS = {
    "v3": ("scan_rows", "compaction", "vocab_hit", "slot_merge"),
    "v2": ("scan_rows", "compaction", "vocab_hit", "slot_merge"),
    "v2_byte": ("byte_scan", "compaction", "vocab_hit", "slot_merge"),
    "v2_overflow": ("scan_rows", "byte_scan", "grid_merge"),
    "sharded_v3": ("scan_rows", "compaction", "vocab_hit", "slot_merge"),
    "sharded_v3_2way": ("scan_rows", "compaction", "vocab_hit", "slot_merge"),
    "sharded_v2": ("scan_rows", "byte_scan", "compaction", "grid_merge"),
    "train": ("pair_count",),
    "hybrid": ("scan_rows", "compaction", "vocab_hit", "slot_merge"),
    "api_v3": ("scan_rows", "compaction", "vocab_hit", "slot_merge"),
    # phase 10, across processes: a one-rank NCCL group in this process,
    # then every rank of the spawned group (each rank checked on its own)
    "xproc_nccl1": ("scan_rows", "compaction", "vocab_hit", "slot_merge"),
    "xproc_v3": ("scan_rows", "compaction", "vocab_hit", "slot_merge"),
    "xproc_v2": ("scan_rows", "byte_scan", "compaction", "grid_merge"),
    "xproc_rows": ("byte_scan", "grid_merge"),
    "xproc_train": ("pair_count",),
    # phase 11, the installed wheel in a process with no compiler: the v3
    # call with strategy="device" and with "auto"
    "wheel_device": ("scan_rows", "compaction", "vocab_hit", "slot_merge"),
    "wheel_auto": ("scan_rows", "compaction", "vocab_hit", "slot_merge"),
}

CJK = "東京タワーは高い。パリは花の都、そして京都は古都です。春はあけぼの、やうやう白くなりゆく山際。"
CYR = ("Широкая электрификация южных губерний даст мощный толчок подъёму сельского "
       "хозяйства. Съешь же ещё этих мягких французских булок, да выпей чаю! ")
ARABIC = ("أهلاً وسهلاً بكم في عالم البرمجة. النص العربي يمتد من اليمين إلى اليسار، "
          "وهذا اختبار للمحلل. ")


def log(msg: str) -> None:
    print(msg, flush=True)


def make_bench_corpus(n_chars: int, seed: int) -> str:
    """The bench corpus recipe: a 60k-word syllable lexicon sampled
    zipf-ish, mixed with digits, punctuation, multi-script words and
    varied whitespace (a copy of bench.py's, which imports the JAX
    package)."""
    rng = random.Random(seed)
    onsets = ["b", "c", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p",
              "r", "s", "t", "v", "w", "z", "ch", "sh", "th", "st", "tr",
              "pl", "br", "gr", "sp", ""]
    vowels = ["a", "e", "i", "o", "u", "ai", "ee", "ou", "io", "ea"]
    codas = ["", "", "n", "r", "s", "t", "l", "m", "ng", "ck", "st", "rd"]
    lex_rng = random.Random(1234)
    lexicon = []
    seen = set()
    while len(lexicon) < 60_000:
        w = "".join(
            lex_rng.choice(onsets) + lex_rng.choice(vowels) + lex_rng.choice(codas)
            for _ in range(lex_rng.randrange(1, 4))
        )
        if w and w not in seen:
            seen.add(w)
            lexicon.append(w)
    uni = ("naïve café jalapeño Zürich Москва привет мир 東京 こんにちは 世界 "
           "你好 北京 مرحبا שלום Ελληνικά κόσμος हिन्दी 한국어").split()
    punct = [".", ",", "!", "?", ";", ":", "(", ")", "\"", "'", "...", "-", "/"]
    ws = [" "] * 12 + ["\n", "\n\n", "\r\n", "\t", "  "]
    out: list[str] = []
    size = 0
    while size < n_chars:
        r = rng.random()
        if r < 0.80:
            rank = int(len(lexicon) ** rng.random()) - 1
            tok = lexicon[rank]
            if rng.random() < 0.12:
                tok = tok.capitalize()
        elif r < 0.86:
            tok = str(rng.randrange(10 ** rng.randrange(1, 7)))
        elif r < 0.92:
            tok = rng.choice(punct)
        elif r < 0.95:
            tok = rng.choice(uni)
        else:
            tok = rng.choice(ws)
            out.append(tok)
            size += len(tok)
            continue
        sep = rng.choice(ws)
        out.append(tok)
        out.append(sep)
        size += len(tok) + len(sep)
    return "".join(out)


def random_words(n_chars: int, seed: int) -> str:
    """Random lower-case 4-8-letter words: nearly every piece misses the
    vocabulary (0.05% of such words are tokens of the bench vocabulary)."""
    rng = random.Random(seed)
    out, size = [], 0
    while size < n_chars:
        w = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(rng.randrange(4, 9)))
        out.append(w)
        size += len(w) + 1
    return " ".join(out)


def bench_docs(corpus_mb: float) -> list[str]:
    """The corpus cut into 1 MB documents at character boundaries."""
    n = int(corpus_mb * 1_000_000)
    chunk = make_bench_corpus(2_000_000, seed=7)
    reps = max(1, n // len(chunk.encode())) + 1
    corpus = (chunk * reps).encode()[:n]
    docs = []
    for i in range(0, len(corpus), 1_000_000):
        d = corpus[i : i + 1_000_000]
        while d and d[-1] & 0xC0 == 0x80:
            d = d[:-1]
        docs.append(d.decode("utf-8", errors="ignore"))
    return docs


def bench_encoding():
    """The bench vocabulary (100,000 ranks) with the o200k pattern."""
    import tiktoken_tpu_torch

    ranks = tiktoken_tpu_torch.load_tiktoken_bpe(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                     "bench_vocab2_100000.tiktoken"))
    return tiktoken_tpu_torch.Encoding(
        "bench_o200k", pat_str=tiktoken_tpu_torch.o200k_pat_str, mergeable_ranks=ranks,
        special_tokens={"<|endoftext|>": len(ranks)},
    )


TABLE_KINDS = ("pair-table", "vocab-table", "long-vocab-table")


def table_files(ranks) -> list[str] | None:
    """The disk cache's files of the engine's three hash tables for
    ``ranks``; None when the cache is off."""
    from tiktoken_tpu_torch.ops import artifacts
    from tiktoken_tpu_torch.ops.engine import _pair_table_fingerprint

    d = artifacts.artifact_dir()
    if d is None:
        return None
    fp = _pair_table_fingerprint(ranks)
    return [os.path.join(d, artifacts.artifact_key(kind, fp) + ".npz") for kind in TABLE_KINDS]


def tables_on_disk(ranks) -> bool:
    files = table_files(ranks)
    return files is not None and all(os.path.exists(f) for f in files)


def table_phase(enc) -> None:
    """Phase 2's table times: the three hash tables through the disk cache
    cold (built and stored, unless an earlier run left them on disk) and
    warm (loaded), then a whole ``TorchEngine.build`` on the card on them."""
    from tiktoken_tpu_torch.ops import engine

    ranks = enc._mergeable_ranks
    before = tables_on_disk(ranks)
    t0 = time.perf_counter()
    fp = engine._pair_table_fingerprint(ranks)
    fp_s = time.perf_counter() - t0
    fns = (engine._cached_pair_table, engine._cached_vocab_table, engine._cached_long_vocab_table)
    secs = {}
    for what in ("cold", "warm"):
        for kind, fn in zip(TABLE_KINDS, fns):
            t0 = time.perf_counter()
            fn(ranks, fp)
            secs[what, kind] = time.perf_counter() - t0
    if table_files(ranks) is not None and not tables_on_disk(ranks):
        raise RuntimeError(f"the tables were not stored in {table_files(ranks)}")
    enc.engine("cuda")  # the char-level DFA compiled, the tables uploaded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.TorchEngine.build(enc._pat_str, ranks, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"tables through the disk cache (s), the ranks' fingerprint {fp_s:.3f} once, then "
        + "; ".join(f"{what}: " + ", ".join(f"{k} {secs[what, k]:.3f}" for k in TABLE_KINDS)
                    + f" (sum {sum(secs[what, k] for k in TABLE_KINDS):.3f})"
                    for what in ("cold", "warm"))
        + ("; the cold build found them on disk from an earlier run" if before else
           "; cold = built and stored")
        + f"; a second TorchEngine.build on them, uploads included: {build_s:.3f} s")


def edge_docs() -> list[str]:
    """Dense CJK, Cyrillic and Arabic, long runs: the worst-case re-run,
    the host fallback and the v2 char scanner's non-ASCII cap."""
    return [CJK * 40, "x" * 9000, "1a" * 600, CJK, CYR * 30, ARABIC * 25]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def gpu_ms(fn, reps: int = 10, rounds: int = 3) -> float:
    """Median over rounds of the mean device time of ``reps`` back-to-back
    calls. A long sleep kernel goes first, so the calls are all queued
    before the start event fires and host overhead stays out."""
    fn()
    torch.cuda.synchronize()
    vals = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        vals.append(start.elapsed_time(end) / reps)
    return statistics.median(vals)


def wall_ms(fn, rounds: int = 3) -> float:
    """Median synchronized time of a call that syncs inside (the plain
    versions loop on the host)."""
    vals = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        vals.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(vals)


# ---------------------------------------------------------------------------
# per-kernel phase
# ---------------------------------------------------------------------------


def flatten(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    for y in x:
        out.extend(flatten(y))
    return out


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def recording_ops(kernel_ops, calls: list):
    """The kernel ops, each call recorded with its inputs and outputs."""
    from types import SimpleNamespace

    def wrap(name):
        fn = getattr(kernel_ops, name)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out

        return call

    return SimpleNamespace(**{name: wrap(name) for name in vars(kernel_ops)})


def touched(valid: torch.Tensor, elem_bytes: int) -> int:
    """Bytes of the 32-byte sectors holding the entries where ``valid`` is
    set, in an array of entries of ``elem_bytes`` each: the least a read
    of only those entries moves."""
    per = max(1, 32 // elem_bytes)
    group = -(-per * elem_bytes // 32) * 32
    v = valid.reshape(-1)
    if v.numel() % per:
        v = torch.cat([v, v.new_zeros(per - v.numel() % per)])
    return int(v.reshape(-1, per).any(dim=1).sum()) * group


def work_of(name, args, kwargs, out) -> tuple[int, int]:
    """(bytes the call must move, operations it must do) for this call's
    data: each input read once, and only where the call needs it (live
    entries, in 32-byte sectors; a table only the rows this data probes),
    each output written once. The two scan_rows entry points count as one
    function: the mask, spec_f and row_bad that pass from the first to
    the second are written once and read by neither."""
    outs = flatten(out)
    if name == "scan_rows":
        t, flat, row_off, n_payload, n_total, is_doc_end = args
        rows, _, spec_f = outs[:3]
        C, KL = rows.shape
        moved = (nbytes([flat, row_off, n_payload, n_total, is_doc_end, t.page_entry,
                         t.mixed_rows, t.consts, rows, spec_f]) + 1)  # + na_overflow
        ops = C * KL + int(n_payload.clamp(min=0).sum())  # classify + >= 1 step per byte
    elif name == "char_scan":
        # the rows and two row vectors in, the tables once; the mask,
        # row_bad and the non-ASCII flag out
        t, rows, n_payload, n_total = args
        mask, row_bad = outs[:2]
        C, KL = rows.shape
        moved = nbytes([rows, n_payload, n_total, t.page_entry, t.mixed_rows, t.consts, mask,
                        row_bad]) + 1
        ops = C * KL + int(n_payload.clamp(min=0).sum())  # classify + >= 1 step per byte
    elif name == "scan_validate":
        prev_same_doc, emit = args[4], args[5]
        mask3, bad = outs
        moved = nbytes([prev_same_doc, emit, mask3, bad])
        ops = mask3.numel()
    elif name == "catalog":
        rows, mask3, spec_f, row_bad, _ = args
        n = min(int(outs[-1]), outs[0].numel())
        start_at = torch.zeros(rows.numel(), dtype=torch.bool, device=rows.device)
        start_at[outs[0][:n].to(torch.int64)] = True
        moved = nbytes([mask3, spec_f, row_bad]) + touched(start_at, 1) + nbytes(outs)
        ops = mask3.numel() + 16 * n
    elif name == "compact_kinds":
        # lens and hits of the live pieces, the words of the short misses
        # and the starts of the long pieces in; the compactions and slots out
        from tiktoken_tpu_torch.ops.compaction import kind_masks

        words, starts, lens, hit, n_pieces = args[:5]
        live = torch.arange(lens.shape[0], device=lens.device) < n_pieces
        miss, lng = kind_masks(lens, hit, n_pieces)
        moved = (2 * touched(live, 4) + touched(miss, 16) + touched(lng, 4) + 4
                 + nbytes(outs))
        ops = lens.numel()
    elif name in ("vocab_hit", "long_vocab_hit"):
        # the pieces whose length the table holds probe it: 1-16 bytes, or
        # 17-64 for the long table
        buckets, words, lens = args[:3]
        live = (lens > 0) & (lens <= 16) if name == "vocab_hit" else (lens > 16) & (lens <= 64)
        row = buckets.shape[1] * 4
        moved = (touched(live, words[0].numel() * words.element_size()) + lens.nbytes
                 + nbytes(outs) + min(int(live.sum()) * row, buckets.nbytes))
        ops = int(live.sum()) * buckets.shape[1]
    elif name == "slot_merge_packed":
        # the slots below n_real: the bytes and lengths of those that merge,
        # the hits, the probed bucket rows; out the count of each live slot
        # and the tokens below it
        buckets, b2r, slot_bytes, lens, _seed, n_real = args[:6]
        hit = kwargs.get("hit")
        M, W = slot_bytes.shape
        real = torch.arange(M, device=lens.device) < min(int(n_real), M)
        is_hit = real & (hit != -1) if hit is not None else torch.zeros_like(real)
        merging = real & ~is_hit
        L = torch.where(merging, lens.clamp(0, W), 0).to(torch.int64)
        cnt = torch.where(real, out[1], 0).to(torch.int64)
        probes = int((L - 1).clamp(min=0).sum() + 2 * (L - torch.where(merging, cnt, 0)).sum())
        moved = (touched(merging, W) + touched(real, 4) * (2 if hit is not None else 1)
                 + b2r.nbytes + touched(real, 4) + 4 * int(cnt.sum())
                 + min(probes * 128, buckets.nbytes))
        ops = probes * 8
    elif name == "assemble":
        # the live pieces' lengths and hits, the slots of those that are not
        # singles, the first word of the one-byte pieces, the merged slots'
        # counts and tokens that the stream takes, the starts of the pieces
        # with tokens, row_bad and the counts in; the stream and header out
        from tiktoken_tpu_torch.ops.compaction import piece_counts

        n_pieces, lens, hit, words, b2r, mslot, lslot, m_count, l_count = args[:9]
        row_bad = args[12]
        p = lens.shape[0]
        live = torch.arange(p, device=lens.device) < min(int(n_pieces), p)
        counts, combo = piece_counts(*args[:9])
        single = live & ((lens == 1) | ((lens >= 2) & (lens <= 16) & (hit != -1)))
        merged = live & ~single
        fetched = int(counts[merged].sum())
        moved = (2 * touched(live, 4) + touched(live & (lens == 1), 16) + b2r.nbytes
                 + touched(merged, 4) + touched(merged & (mslot < 0), 4)
                 + 4 * int((merged & ((mslot >= 0) | (lslot >= 0))).sum()) + 4 * fetched
                 + touched(live & (counts > 0), 4) + row_bad.nbytes + 16 + nbytes(outs))
        ops = 2 * int(live.sum()) + int(counts.sum())
    elif name == "seq_scan":
        packed, rows, n_payload, n_total = args
        mask, _ = outs
        steps = int(n_payload.clamp(min=0).sum()) + int(mask.sum())  # a byte, or a restart
        read = int(n_total.clamp(0, rows.shape[1]).sum())  # each row's bytes to its scan end
        moved = (read + nbytes([n_payload, n_total]) + nbytes(outs)
                 + min(steps * 32, packed.nbytes))
        ops = steps
    elif name == "window_orbit":
        # each row's bytes to its scan end, n_payload and n_total in, the
        # table rows the walks read (each position walks at least to its
        # match end, one 32-byte sector a step); the mask and row_bad out
        from tiktoken_tpu_torch.ops.window_scan import window_scan

        packed, rows, n_payload, n_total = args
        hop, _ = window_scan(packed, rows, n_total, K=kwargs["K"], window=kwargs["window"])
        steps = int(hop.clamp(min=1).sum())
        read = int(n_total.clamp(0, rows.shape[1]).sum())
        moved = (read + n_payload.nbytes + n_total.nbytes + min(steps * 32, packed.nbytes)
                 + nbytes(outs))
        ops = steps
    elif name == "grid_merge":
        buckets, b2r, rows, piece_start, n_payload = args[:5]
        _, counts, _ = out
        C, K = piece_start.shape
        valid = torch.arange(K, device=rows.device)[None, :] < n_payload[:, None]
        heads = valid & piece_start
        heads[:, 0] |= valid[:, 0]
        n_valid, n_heads, n_alive = int(valid.sum()), int(heads.sum()), int(counts.sum())
        probes = (n_valid - n_heads) + 2 * (n_valid - n_alive)
        # the row bytes and piece starts below each row's payload end
        moved = (2 * touched(valid, 1) + nbytes([n_payload, b2r]) + nbytes(out)
                 + min(probes * 128, buckets.nbytes))
        ops = probes * 8
    elif name == "catalog2":
        piece_start, n_payload, rows, row_bad, _ = args
        n = min(int(outs[-1]), outs[0].numel())
        moved = nbytes([piece_start, n_payload, row_bad]) + 16 * n + nbytes(outs)
        ops = piece_start.numel() + 16 * n
    elif name == "extract_slots":
        rows, starts, lens = args[:3]
        moved = int(lens.clamp(min=0).sum()) + nbytes([starts, lens]) + nbytes(outs)
        ops = outs[0].numel() // 4
    elif name == "pair_hist":
        # tokens, alive and piece_start read once, the histogram written
        # once; per position a scan step, per counted pair a hash and an add
        tokens, alive, piece_start, _bits = args
        moved = nbytes([tokens, alive, piece_start, out])
        ops = tokens.numel() + 10 * int(out.sum())
    elif name == "hist_argmax":
        (hist,) = args
        moved = hist.nbytes + nbytes(outs)
        ops = hist.numel()
    else:
        raise KeyError(name)
    return moved, ops


def library_call(name, args, kwargs, out):
    """One PyTorch call computing the core of the entry point, where
    there is one, and whether it waits for the host (nonzero,
    masked_select and bincount read a count back)."""
    if name == "catalog":
        rows, mask3 = args[0], args[1]
        C, KP = mask3.shape
        flat_idx = (torch.arange(C, device=rows.device)[:, None] * rows.shape[1]
                    + torch.arange(KP, device=rows.device)[None, :]).to(torch.int32).reshape(-1)
        m = mask3.reshape(-1)
        return (lambda: torch.index_select(flat_idx, 0, torch.nonzero(m).squeeze(1))), True
    if name == "compact_kinds":
        from tiktoken_tpu_torch.ops.compaction import kind_masks

        words, starts, lens, hit, n_pieces = args[:5]
        miss, lng = kind_masks(lens, hit, n_pieces)

        def kinds():
            m = torch.nonzero(miss).squeeze(1)
            l_ = torch.nonzero(lng).squeeze(1)
            return ([torch.index_select(x, 0, m) for x in (words, lens)],
                    [torch.index_select(x, 0, l_) for x in (starts, lens)])

        return kinds, True
    if name == "catalog2":
        m = args[0].reshape(-1)
        flat_idx = torch.arange(m.numel(), dtype=torch.int32, device=m.device)
        return (lambda: torch.index_select(flat_idx, 0, torch.nonzero(m).squeeze(1))), True
    if name == "extract_slots":
        rows, starts, K = args[0], args[1], args[3]
        width = out.shape[1]
        s64 = starts.to(torch.int64)
        idx = ((s64 // K).clamp(max=rows.shape[0] - 1) * rows.shape[1] + s64 % K)[:, None] \
            + torch.arange(width, device=rows.device)[None, :]
        idx = idx.clamp(max=rows.numel() - 1)
        flat = rows.reshape(-1)
        return (lambda: torch.take(flat, idx)), False
    if name == "assemble":
        # the expansion's core on the per-piece counts and combos (computed
        # here, outside the timed call)
        from tiktoken_tpu_torch.ops.compaction import piece_counts

        counts, combo = piece_counts(*args[:9])
        starts, row_bad, n_rows = args[11], args[12], args[12].shape[0]
        total = int(counts.sum())
        row = (starts.clamp(min=0) // kwargs["K"]).clamp(max=n_rows - 1).to(torch.int64)

        def assembly():
            torch.repeat_interleave(combo, counts, output_size=total)
            return torch.zeros(n_rows, dtype=torch.int32, device=counts.device).scatter_add_(
                0, row, counts)

        return assembly, False
    if name == "pair_hist":
        from tiktoken_tpu_torch.ops.pair_count import pair_bins

        tokens, alive, piece_start, bits = args
        bins = pair_bins(tokens, alive, piece_start, bits)
        return (lambda: torch.bincount(bins, minlength=1 << bits)), True
    if name == "hist_argmax":
        return (lambda: torch.argmax(args[0])), False
    return None, False


def kernel_phase(enc, docs, device="cuda", C: int = 32768):
    """Phase 4: one real v3 chunk through run_chunk, with the kernels
    against the plain versions, every call recorded; edge chunks in both
    cap variants."""
    from tiktoken_tpu_torch.ops import kernels, pipeline3, sweep_scan

    eng = enc.engine(device)
    K = pipeline3.K_DEFAULT
    KP, KL = pipeline3.row_geometry(K)
    S = -(-(C * KP + KL + 8) // 128) * 128
    need = C * K * 1.1
    sel, size = [], 0
    for d in docs:
        if size >= need:
            break
        sel.append(d.encode("utf-8"))
        size += len(sel[-1])
    pc = pipeline3.pack_corpus3(sel, K)
    inputs, nreal = pipeline3.chunk_inputs3(pc, 0, C - 1, C, S)
    if nreal != C - 1:
        raise RuntimeError(f"kernel phase chunk has {nreal} real rows, want {C - 1}")
    dev_inputs = eng.upload(inputs)

    calls: list = []
    tok_k, hdr_k = pipeline3.run_chunk(eng.tables, *dev_inputs, K=K,
                                       ops=recording_ops(kernels.KERNEL_OPS, calls))
    tok_p, hdr_p = pipeline3.run_chunk(eng.tables, *dev_inputs, K=K, ops=kernels.PLAIN_OPS)
    hk, hp = hdr_k.cpu().numpy(), hdr_p.cpu().numpy()
    nt = int(hk[-2])
    if not (np.array_equal(hk, hp) and torch.equal(tok_k[:nt], tok_p[:nt])):
        raise RuntimeError("chunk program: kernels and plain versions disagree")
    if hk[-1]:
        raise RuntimeError("the kernel-phase chunk overflowed its caps")
    # dense non-ASCII, long pieces and cap overflows, in both variants
    edge = [s.encode() for s in (CJK * 40, "x" * 9000, "1a" * 600, CYR * 30, ARABIC * 25,
                                 "word" * 12 + " " + "z" * 40)]
    pe = pipeline3.pack_corpus3(edge, K)
    Ce = 128
    Se = -(-(Ce * KP + KL + 8) // 128) * 128
    over_cap = 0
    for wc in (False, True):
        for lo in range(0, len(pe.row_off), Ce - 1):
            ins = eng.upload(pipeline3.chunk_inputs3(pe, lo, Ce - 1, Ce, Se)[0])
            calls_e: list = []
            tk, hk_ = pipeline3.run_chunk(eng.tables, *ins, K=K, worst_case=wc,
                                          ops=recording_ops(kernels.KERNEL_OPS, calls_e))
            tp, hp_ = pipeline3.run_chunk(eng.tables, *ins, K=K, worst_case=wc,
                                          ops=kernels.PLAIN_OPS)
            n = int(hk_[-2])
            if not (torch.equal(hk_, hp_) and torch.equal(tk[:n], tp[:n])):
                raise RuntimeError(f"edge chunk {lo} (worst_case={wc}): kernels and "
                                   "plain versions disagree")
            check_calls(calls_e, f"edge chunk {lo} (worst_case={wc})")
            over_cap += bool(calls_e[0][3][4])  # scan_rows' na_overflow
    if not over_cap:
        raise RuntimeError("no v3 edge chunk went over the non-ASCII cap")
    log(f"edge documents: chunk program with kernels == plain, normal and worst-case caps, every "
        f"entry point equal to plain; {over_cap} chunks over the non-ASCII cap")
    scan_call = calls[0]
    rows = scan_call[3][0]
    t = eng.tables.scan
    na_frac = scan_call[2]["na_frac"]
    cls, _ = sweep_scan.row_classes(t, rows, dev_inputs[3], na_frac)
    steps = sweep_scan.walk_steps(t, cls, dev_inputs[2], dev_inputs[3], dev_inputs[4])
    study = scan_study("v3 scan (tt_scan_rows)", kernels.scan_rows, dict(
        tables=t, flat=dev_inputs[0], row_off=dev_inputs[1], n_payload=dev_inputs[2],
        n_total=dev_inputs[3], is_doc_end=dev_inputs[4], KP=KP, KL=KL, na_frac=na_frac),
        ("row_off", "n_payload", "n_total", "is_doc_end"), steps)
    chunk_ms = gpu_ms(lambda: pipeline3.run_chunk(eng.tables, *dev_inputs, K=K), reps=5)
    CHUNK_TRACES.append((f"v3 chunk program C={C} K={K}",
                         lambda: pipeline3.run_chunk(eng.tables, *dev_inputs, K=K)))
    log(f"chunk program C={C} K={K}: kernels == plain (n_pieces={hk[-5]} "
        f"n_miss={hk[-4]} n_long={hk[-3]} n_tokens={nt}); device time with the "
        f"kernels {chunk_ms:.3f} ms")
    return calls, chunk_ms, study


def new_per() -> dict:
    from tiktoken_tpu_torch.ops import kernels

    return {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_bound_ms=0.0, ops_bound_ms=0.0,
                    library_ms=None, max_abs_err=0, match=True, entries=[])
            for k in kernels.KERNELS}


def plain_error(name, args, kwargs, out) -> int:
    """The largest difference between a recorded kernel call's outputs and
    its plain version's on the same inputs."""
    from tiktoken_tpu_torch.ops import kernels

    want = getattr(kernels.PLAIN_OPS, name)(*args, **kwargs)
    if name == "slot_merge_packed":
        # the slots below n_real, each slot's tokens below its count
        (gt, gc), (wt, wc) = out, want
        n = min(int(args[5]), gc.shape[0])
        err = int((gc[:n].to(torch.int64) - wc[:n]).abs().max()) if n else 0
        below = torch.arange(gt.shape[1], device=gt.device)[None, :] < wc[:n, None]
        d = (gt[:n].to(torch.int64) - wt[:n]).abs() * below
        return max(err, int(d.max()) if n else 0)
    want = flatten(want)
    err = 0
    for g, w in zip(flatten(out), want, strict=True):
        if g.shape != w.shape:
            raise RuntimeError(f"{name}: shape {tuple(g.shape)} vs plain {tuple(w.shape)}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def check_calls(calls, what: str) -> None:
    """Every recorded kernel call equals its plain version; fails otherwise."""
    for name, args, kwargs, out in calls:
        err = plain_error(name, args, kwargs, out)
        if err:
            raise RuntimeError(f"{what}: {name} differs from its plain version (max abs err {err})")


def warp_steps(steps: torch.Tensor) -> tuple[float, int, float]:
    """(mean, max, mean of each warp's max) of per-row walk steps, a warp
    being 32 consecutive rows."""
    s = steps.to(torch.float64)
    w = torch.cat([s, s.new_zeros((-s.numel()) % 32)]).view(-1, 32).amax(dim=1)
    return float(s.mean()), int(s.max()), float(w.mean())


def scan_study(kind: str, scan, rows_args: dict, per_row: tuple, steps: torch.Tensor,
               knob: str = "SCAN_ROWS_PER_BLOCK") -> dict:
    """The walk's step counts, the scan at 32-256 rows per block (the
    ``kernels`` attribute ``knob``; each equal to the default's outputs),
    and the cycles of one dependent walk step: the scan of the first 32
    rows (one warp walks; ``per_row`` names the arguments cut to them) less
    the same rows with no payload (no walk), over that warp's longest walk.
    Returns the numbers, printed too."""
    from tiktoken_tpu_torch.ops import kernels

    mean, mx, warp_max = warp_steps(steps)
    log(f"{kind} walk steps per row: mean {mean:.2f}, max {mx}, mean of each warp's max "
        f"{warp_max:.2f} ({steps.numel()} rows)")
    default = getattr(kernels, knob)
    want = flatten(scan(**rows_args))
    sweep = {}
    try:
        for R in (32, 64, 128, 256):
            setattr(kernels, knob, R)
            got = flatten(scan(**rows_args))
            if not all(torch.equal(a, b) for a, b in zip(got, want, strict=True)):
                raise RuntimeError(f"{kind}: {R} rows per block differ from {default}")
            sweep[R] = gpu_ms(lambda: scan(**rows_args))
        first = {k: v[:32] if k in per_row else v for k, v in rows_args.items()}
        nowalk = {**first, "n_payload": torch.zeros_like(first["n_payload"])}
        setattr(kernels, knob, default)
        walk_ms = gpu_ms(lambda: scan(**first), reps=50) - gpu_ms(lambda: scan(**nowalk), reps=50)
    finally:
        setattr(kernels, knob, default)
    clock = sm_clock_hz()
    cycles = walk_ms * 1e-3 * clock / int(steps[:32].max())
    floor_ms = warp_max * cycles / clock * 1e3
    log(f"{kind} ms by rows per block: " + ", ".join(f"{r}: {v:.4f}" for r, v in sweep.items())
        + f" (default {default})")
    log(f"{kind} one dependent walk step: {cycles:.1f} cycles at {clock / 1e6:.0f} MHz "
        f"(first warp: {walk_ms * 1e3:.2f} us over {int(steps[:32].max())} steps); latency floor "
        f"{warp_max:.2f} steps x {cycles:.1f} cycles = {floor_ms:.5f} ms")
    return dict(steps_mean=mean, steps_max=mx, steps_warp_max=warp_max, sweep_ms=sweep,
                cycles_per_step=cycles, latency_floor_ms=floor_ms)


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), the clock a busy card runs at."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def measure(calls, per: dict, program: str) -> None:
    """Each recorded kernel call against its plain version on the same
    inputs, timed beside its bound and library call; summed per kernel
    into ``per``. Fails on any difference."""
    from tiktoken_tpu_torch.ops import kernels

    for name, args, kwargs, out in calls:
        kname = KERNEL_OF[name]
        k_fn = getattr(kernels.KERNEL_OPS, name)
        p_fn = getattr(kernels.PLAIN_OPS, name)
        err = plain_error(name, args, kwargs, out)
        ms = gpu_ms(lambda: k_fn(*args, **kwargs))
        plain_ms = wall_ms(lambda: p_fn(*args, **kwargs))
        moved, ops = work_of(name, args, kwargs, out)
        b_ms, o_ms = moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        lib, syncs = library_call(name, args, kwargs, out)
        lib_ms = None if lib is None else wall_ms(lib, rounds=5) if syncs else gpu_ms(lib)
        e = per[kname]
        e["ms"] += ms
        e["plain_ms"] += plain_ms
        e["bytes_bound_ms"] += b_ms
        e["ops_bound_ms"] += o_ms
        e["bound_ms"] += max(b_ms, o_ms)
        if lib_ms is not None:
            e["library_ms"] = (e["library_ms"] or 0.0) + lib_ms
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["match"] &= err == 0
        e["entries"].append(dict(program=program, entry=name, ms=ms, plain_ms=plain_ms,
                                 bound_ms=max(b_ms, o_ms), library_ms=lib_ms, err=err))
        log(f"  {program} {name:18s} err={err} ms={ms:.4f} plain_ms={plain_ms:.2f} "
            f"bound_ms={max(b_ms, o_ms):.5f} library_ms={lib_ms}")
    for k, e in per.items():
        if not e["match"]:
            raise RuntimeError(f"kernel {k} disagrees with its plain version "
                               f"(max abs err {e['max_abs_err']})")


def na_rows(rows: torch.Tensor, n_total: torch.Tensor, cap: int) -> int:
    """Rows with more than ``cap`` non-ASCII char ends before n_total (the
    UTF-8 rule of ``charclass.byte_classes``)."""
    b = rows.to(torch.int64)
    z = torch.zeros_like(b[:, :1])
    prev = [b]
    for _ in range(3):
        prev.append(torch.cat([z, prev[-1][:, :-1]], dim=1))
    cont = [(x & 0xC0) == 0x80 for x in prev]
    k = torch.where(cont[0], torch.where(cont[1], torch.where(cont[2], torch.where(
        cont[3], 4, 3), 2), 1), 0)
    lead = torch.gather(torch.stack(prev + [z.expand_as(b)], dim=2), 2, k[:, :, None])[:, :, 0]
    explen = torch.where(lead < 0x80, 1, torch.where((lead >= 0xC2) & (lead <= 0xDF), 2,
                         torch.where((lead >= 0xE0) & (lead <= 0xEF), 3,
                                     torch.where((lead >= 0xF0) & (lead <= 0xF4), 4, 0))))
    pos = torch.arange(b.shape[1], device=b.device)[None, :]
    na = (explen == k + 1) & cont[0] & (pos < n_total[:, None])
    return int((na.sum(dim=1) > cap).sum())


def piece_lengths(piece_start: torch.Tensor, n_payload: torch.Tensor) -> torch.Tensor:
    """The byte length of every piece of the grid_merge rows (a piece starts
    at column 0 or at a piece start below the row's payload end)."""
    C, K = piece_start.shape
    valid = torch.arange(K, device=piece_start.device)[None, :] < n_payload[:, None]
    heads = valid & piece_start
    heads[:, 0] |= valid[:, 0]
    pid = torch.cumsum(heads.reshape(-1).to(torch.int64), 0) - 1
    v = valid.reshape(-1)
    n = int(heads.sum())
    return torch.zeros(n, dtype=torch.int64, device=pid.device).scatter_add_(
        0, pid[v], torch.ones_like(pid[v]))


BOUNDARY_LENGTHS = (1, 2, 8, 16, 17, 63, 64, 65, 255, 256)


def boundary_chunk(tb, device, C: int = 2048) -> None:
    """``tt_grid_merge`` against ``merge.grid_merge`` (exact) on a chunk of
    K=256 rows cut into pieces of each length-class boundary of the
    kernel (BOUNDARY_LENGTHS, one length a row, the row's last piece
    shorter), of bench-corpus text and of runs of one letter, and rows of
    no payload."""
    from tiktoken_tpu_torch.ops import kernels, merge

    K, KL = 256, 272
    text = np.frombuffer(make_bench_corpus(C * KL, seed=3).encode()[: C * KL], np.uint8)
    rows = text.reshape(C, KL).copy()
    piece_start = np.zeros((C, K), bool)
    n_payload = np.full(C, K, np.int32)
    for r in range(C):
        L = BOUNDARY_LENGTHS[r % len(BOUNDARY_LENGTHS)]
        piece_start[r, ::L] = True
        if r % 3 == 1:
            rows[r] = ord("x") if r % 2 else ord("a") + r % 26
        if r % 13 == 12:
            n_payload[r] = 0
        elif r % 11 == 10:
            n_payload[r] = r % K
    r, ps, pay = (torch.from_numpy(x).to(device) for x in (rows, piece_start, n_payload))
    args = (tb.pair_buckets, tb.byte_to_rank, r, ps, pay, tb.pair_seed)
    got = kernels.grid_merge(*args)
    want = merge.grid_merge(*args)
    for a, b, what in zip(got, want, ("packed", "counts", "rounds")):
        if not torch.equal(a, b):
            raise RuntimeError(f"tt_grid_merge differs from plain on the length-boundary chunk "
                               f"({what})")
    lens = piece_lengths(ps, pay)
    have = sorted(set(int(x) for x in torch.unique(lens)) & set(BOUNDARY_LENGTHS))
    if have != list(BOUNDARY_LENGTHS):
        raise RuntimeError(f"the length-boundary chunk has pieces of {have} bytes only")
    log(f"length-boundary chunk ({C} rows, pieces of {list(BOUNDARY_LENGTHS)} bytes, "
        f"{int((pay == 0).sum())} rows of no payload): tt_grid_merge == plain (rounds "
        f"{int(got[2])}, tokens {int(got[1].sum())})")


FLOOR_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "floor_kernels.cu")
FLOOR_SO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiktoken_tpu_torch", "build",
                        "floors", "floor_kernels.so")
_floor_lib: list = []


def start_floor_build() -> subprocess.Popen:
    """Starts ``nvcc`` on the floor kernels (``scripts/floor_kernels.cu``)
    into ``tiktoken_tpu_torch/build/floors/``; ``floor_lib`` waits for it."""
    from tiktoken_tpu_torch.ops.kernels import NVCC_FLAGS

    from tiktoken_tpu_torch import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the floor kernels cannot be built")
    os.makedirs(os.path.dirname(FLOOR_SO), exist_ok=True)
    return subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", FLOOR_SO, FLOOR_SRC],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def floor_lib(proc: subprocess.Popen | None = None) -> ctypes.CDLL:
    """The floor kernels, loaded once: from the build ``proc`` that
    ``start_floor_build`` started, or built now. Yardsticks; the port never
    calls them."""
    if not _floor_lib:
        proc = proc or start_floor_build()
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on scripts/floor_kernels.cu:\n{out}")
        lib = ctypes.CDLL(FLOOR_SO)
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.probe_floor.argtypes = [P, I, LL, I, P, P]
        lib.atomics_only.argtypes = [P, LL, P, P]
        lib.empty_launch.argtypes = [P]
        lib.probe_floor.restype = lib.atomics_only.restype = ctypes.c_int
        lib.empty_launch.restype = ctypes.c_int
        _floor_lib.append(lib)
    return _floor_lib[0]


def probe_floor_ms(buckets: torch.Tensor, probes: int, loads: int = 1,
                   rows: int | None = None) -> float:
    """The time of ``probes`` independent reads of a bucket row's first
    32-byte sector at random rows of the pair table, hashed from each
    read's index (no index array): one 16-byte load a read, or two; over
    the table's first ``rows`` rows (a power of two) where given. The
    floor of ``tt_grid_merge``'s probes."""
    if buckets.shape[1] * buckets.element_size() != 128:
        raise ValueError("probe_floor_ms: bucket rows of 128 bytes expected")
    lib = floor_lib()
    sink = torch.zeros(1, dtype=torch.int32, device=buckets.device)
    stream = torch.cuda.current_stream(buckets.device).cuda_stream

    def run():
        err = lib.probe_floor(buckets.data_ptr(), rows or buckets.shape[0], probes, loads,
                              sink.data_ptr(), stream)
        if err:
            raise RuntimeError(f"probe_floor: CUDA error {err}")

    return gpu_ms(run)


def atomic_floor_ms(bins: torch.Tensor, bits: int, want: torch.Tensor | None = None) -> float:
    """The time of one ``atomicAdd`` a bin into a 2^bits-bin int32 table,
    the bins precomputed (read as int4, padded with bin 0): the floor of
    ``tt_pair_hist``'s adds. Where ``want`` (the histogram of these bins)
    is given, the adds are first held against it."""
    lib = floor_lib()
    n = bins.numel()
    b32 = torch.cat([bins.to(torch.int32), bins.new_zeros((-n) % 4, dtype=torch.int32)])
    hist = torch.zeros(1 << bits, dtype=torch.int32, device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream

    def run():
        err = lib.atomics_only(b32.data_ptr(), b32.numel() // 4, hist.data_ptr(), stream)
        if err:
            raise RuntimeError(f"atomics_only: CUDA error {err}")

    if want is not None:
        run()
        hist[0] -= b32.numel() - n
        if not torch.equal(hist, want):
            raise RuntimeError("the atomic floor's adds differ from the histogram")
    return gpu_ms(run)


def launch_floor_ms(device) -> float:
    """The time of one launch of an empty one-block kernel, timed back to
    back as ``gpu_ms`` times every kernel: the floor of a one-launch
    kernel such as ``tt_hist_argmax``."""
    lib = floor_lib()
    stream = torch.cuda.current_stream(device).cuda_stream

    def run():
        err = lib.empty_launch(stream)
        if err:
            raise RuntimeError(f"empty_launch: CUDA error {err}")

    with torch.cuda.device(device):
        return gpu_ms(run, reps=50)


def kernel_phase2(enc, docs, device="cuda", C: int = 32768):
    """Phase 4b: one real v2 chunk (C rows of K=256) through run_chunk2
    under the char scanner and the byte scanner (the byte-level scan table
    compiled and uploaded first), and through the v1 run_rows1, with the
    kernels against the plain versions, every call recorded. Under the
    char scanner the chunk may overflow the non-ASCII cap: its header and
    entry points are still held against plain, its tokens are not (an
    overflowing chunk's stream is discarded and re-run through v1).
    Returns (the char route's calls, the byte route's seq_scan call, the v1
    calls, and the chunk ms of the char route, the byte route and v1)."""
    from tiktoken_tpu_torch.ops import kernels, sweep_scan, window_scan
    from tiktoken_tpu_torch.ops.charclass import na_cap
    from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, pack_documents
    from tiktoken_tpu_torch.ops.pipeline2 import NA_FRAC, run_chunk2, run_rows1

    eng = enc.engine(device)
    sel, rows_n = [], 0
    for d in docs:
        if rows_n >= C:
            break
        sel.append(d.encode("utf-8"))
        rows_n += pack_documents(sel[-1:], DEFAULT_ROW).rows.shape[0]
    batch = pack_documents(sel, DEFAULT_ROW)
    if batch.rows.shape[0] < C:
        raise RuntimeError(f"the v2 kernel-phase chunk has {batch.rows.shape[0]} rows, want {C}")
    rows, pay, tot = eng.upload([batch.rows[:C], batch.n_payload[:C], batch.n_total[:C]])
    KL = rows.shape[1]

    # the char route (the default)
    t = eng.tables
    calls: list = []
    tok_k, hdr_k = run_chunk2(t, rows, pay, tot, ops=recording_ops(kernels.KERNEL_OPS, calls))
    tok_p, hdr_p = run_chunk2(t, rows, pay, tot, ops=kernels.PLAIN_OPS)
    hk = hdr_k.cpu().numpy()
    nt = int(hk[-2])
    if not torch.equal(hdr_k, hdr_p):
        raise RuntimeError("v2 chunk program (char): kernels and plain versions disagree on the "
                           "header")
    over_cap = na_rows(rows, tot, na_cap(KL, NA_FRAC))
    if hk[-1]:
        log(f"v2 chunk (char) overflowed: {over_cap} rows over the non-ASCII cap of "
            f"{na_cap(KL, NA_FRAC)} char ends; headers equal, tokens not compared")
    elif not torch.equal(tok_k[:nt], tok_p[:nt]):
        raise RuntimeError("v2 chunk program (char): kernels and plain versions disagree")
    steps = sweep_scan.walk_steps(t.scan, sweep_scan.row_classes(t.scan, rows, tot, NA_FRAC)[0],
                                  pay, tot)
    study = scan_study("v2 scan (tt_char_scan)", kernels.char_scan, dict(
        tables=t.scan, rows=rows, n_payload=pay, n_total=tot, K=KL - 16, na_frac=NA_FRAC),
        ("rows", "n_payload", "n_total"), steps)
    # a chunk over the non-ASCII cap: the edge documents
    edge = pack_documents([x.encode() for x in (CJK * 40, "x" * 9000, "1a" * 600, CYR * 30,
                                                ARABIC * 25)], DEFAULT_ROW)
    er, ep, et, _ = eng.upload_rows(edge, 0, 128)
    calls_e: list = []
    _, hdr_e = run_chunk2(t, er, ep, et, ops=recording_ops(kernels.KERNEL_OPS, calls_e))
    _, hdr_ep = run_chunk2(t, er, ep, et, ops=kernels.PLAIN_OPS)
    if not torch.equal(hdr_e, hdr_ep):
        raise RuntimeError("v2 edge chunk (char): kernels and plain versions disagree on the "
                           "header")
    check_calls(calls_e, "v2 edge chunk (char)")
    if not (bool(calls_e[0][3][2]) and int(hdr_e[-1])):
        raise RuntimeError("the v2 edge chunk did not go over the non-ASCII cap")
    log(f"v2 edge chunk: over the non-ASCII cap ({na_rows(er, et, na_cap(KL, NA_FRAC))} rows); "
        "header and every entry point equal to plain")
    try:
        big = torch.zeros((4, 2048 + 16), dtype=torch.uint8, device=rows.device)
        z = torch.zeros(4, dtype=torch.int32, device=rows.device)
        kernels.char_scan(t.scan, big, z, z, K=2048, na_frac=NA_FRAC)
    except ValueError as e:
        log(f"tt_char_scan refuses 2048-byte rows before any launch: {e}")
    else:
        raise RuntimeError("tt_char_scan took rows that do not fit its shared memory")

    # the byte route
    t0 = time.perf_counter()
    tb = eng.byte_tables()
    torch.cuda.synchronize()
    log(f"byte-level scan table {tuple(tb.byte_scan.shape)} compiled and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    calls_b: list = []
    tok_kb, hdr_kb = run_chunk2(tb, rows, pay, tot, scanner="byte",
                                ops=recording_ops(kernels.KERNEL_OPS, calls_b))
    tok_pb, hdr_pb = run_chunk2(tb, rows, pay, tot, scanner="byte", ops=kernels.PLAIN_OPS)
    hb = hdr_kb.cpu().numpy()
    ntb = int(hb[-2])
    if not (torch.equal(hdr_kb, hdr_pb) and torch.equal(tok_kb[:ntb], tok_pb[:ntb])):
        raise RuntimeError("v2 chunk program (byte): kernels and plain versions disagree")
    if hb[-1]:
        raise RuntimeError("the v2 kernel-phase chunk overflowed its caps (byte)")
    seq_args = dict(packed=tb.byte_scan, rows=rows, n_payload=pay, n_total=tot, K=KL - 16,
                    hot=tb.byte_hot)
    study_b = scan_study("v2 byte scan (tt_seq_scan)", kernels.seq_scan, seq_args,
                         ("rows", "n_payload", "n_total"),
                         window_scan.seq_walk(**{k: v for k, v in seq_args.items()
                                                 if k != "hot"})[2],
                         knob="SEQ_ROWS_PER_BLOCK")
    cold = {**seq_args, "hot": 0}
    if not all(torch.equal(a, b) for a, b in zip(kernels.seq_scan(**cold),
                                                 kernels.seq_scan(**seq_args))):
        raise RuntimeError("tt_seq_scan with no hot rows differs from the hot-row scan")
    study_b["hot_rows"] = tb.byte_hot
    study_b["no_hot_rows_ms"] = gpu_ms(lambda: kernels.seq_scan(**cold))
    log(f"tt_seq_scan: {tb.byte_hot} hot states of {tb.byte_scan.shape[0]} in shared memory; "
        f"{study_b['no_hot_rows_ms']:.4f} ms with none (every step from L2) against "
        f"{study_b['sweep_ms'][kernels.SEQ_ROWS_PER_BLOCK]:.4f} ms")
    if not hk[-1]:
        same = np.array_equal(hk, hb) and torch.equal(tok_k[:nt], tok_kb[:nt])
        log(f"v2 chunk program: char and byte scanners give equal headers and tokens: {same}")

    calls1: list = []
    out_k = run_rows1(tb, rows, pay, tot, ops=recording_ops(kernels.KERNEL_OPS, calls1))
    out_p = run_rows1(tb, rows, pay, tot, ops=kernels.PLAIN_OPS)
    for a, b, what in zip(out_k, out_p, ("packed", "counts", "rounds", "row_bad")):
        if not torch.equal(a, b):
            raise RuntimeError(f"v1 program: kernels and plain versions disagree on {what}")
    # the v1 program on the edge documents' chunk: pieces of the whole row
    calls_e1: list = []
    run_rows1(tb, er, ep, et, ops=recording_ops(kernels.KERNEL_OPS, calls_e1))
    check_calls(calls_e1, "v1 edge chunk")
    longest = piece_lengths(*[calls_e1[-1][1][i] for i in (3, 4)]).max()
    if longest <= 64:
        raise RuntimeError(f"the v1 edge chunk's longest piece has {longest} bytes, want > 64")
    log(f"v1 edge chunk: every entry point equal to plain (longest piece {longest} bytes, "
        f"rounds {int(calls_e1[-1][3][2])})")
    # the v1 program on a 128-row chunk (the sharded v2's re-runs)
    sub = [x[:128] for x in (rows, pay, tot)]
    calls128: list = []
    out128 = run_rows1(tb, *sub, ops=recording_ops(kernels.KERNEL_OPS, calls128))
    for a, b, what in zip(out128, run_rows1(tb, *sub, ops=kernels.PLAIN_OPS),
                          ("packed", "counts", "rounds", "row_bad")):
        if not torch.equal(a, b):
            raise RuntimeError(f"v1 program on 128 rows: kernels and plain versions disagree on "
                               f"{what}")
    check_calls(calls128, "v1 128-row chunk")
    log(f"v1 128-row chunk: every entry point equal to plain (row_bad {int(out128[3].sum())})")
    boundary_chunk(tb, rows.device)
    chunk2_ms = gpu_ms(lambda: run_chunk2(t, rows, pay, tot), reps=5)
    chunk2b_ms = gpu_ms(lambda: run_chunk2(tb, rows, pay, tot, scanner="byte"), reps=5)
    rows1_ms = gpu_ms(lambda: run_rows1(tb, rows, pay, tot), reps=3)
    CHUNK_TRACES.extend([
        (f"v2 chunk program C={C} K={DEFAULT_ROW}, char scanner",
         lambda: run_chunk2(t, rows, pay, tot)),
        ("v2 chunk program, byte scanner", lambda: run_chunk2(tb, rows, pay, tot, scanner="byte")),
        ("v1 program on the same rows", lambda: run_rows1(tb, rows, pay, tot))])
    log(f"v2 chunk program C={C} K={DEFAULT_ROW}, char scanner: kernels == plain (n_tokens={nt}, "
        f"row_bad={int(hk[C:2 * C].sum())}, overflow={int(hk[-1])}, rows over the non-ASCII cap "
        f"{over_cap}); device time with the kernels {chunk2_ms:.3f} ms")
    log(f"v2 chunk program, byte scanner: kernels == plain (n_tokens={ntb}, "
        f"row_bad={int(hb[C:2 * C].sum())}); device time with the kernels {chunk2b_ms:.3f} ms")
    log(f"v1 program on the same rows: kernels == plain (rounds={int(out_k[2])}, "
        f"tokens={int(out_k[1].sum())}, row_bad={int(out_k[3].sum())}); device time with the "
        f"kernels {rows1_ms:.3f} ms")
    seq = [c for c in calls_b if c[0] == "seq_scan"]  # the rest repeats the char route's entries
    return calls, seq, calls1, calls128, (chunk2_ms, chunk2b_ms, rows1_ms), study, study_b


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from tiktoken_tpu_torch.ops import kernels

    # ---- 1: card and kernel build ------------------------------------------
    card = card_line()
    log(f"card: {card}")
    floor_build = start_floor_build()
    libs = kernels.build()
    floor_lib(floor_build)
    log(f"kernels built in {libs.build_seconds:.1f} s (and the floor kernels)")
    for name, report in sorted(libs.ptxas.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    exported = [f"{name}.{e}" for name, lib in sorted(libs.libs.items()) for e in GONE_ENTRIES
                if hasattr(lib, e)]
    if exported:
        raise RuntimeError(f"built kernel libraries still export removed entry points: {exported}")
    log(f"no built kernel library exports a removed entry point ({', '.join(GONE_ENTRIES)})")

    # ---- 2: vocabulary and tables ------------------------------------------
    t0 = time.perf_counter()
    enc = bench_encoding()
    table_phase(enc)
    eng = enc.engine("cuda")
    torch.cuda.synchronize()
    log(f"vocab {eng.vocab_report['n_vocab']} ranks; the vocabulary read and the tables' "
        f"phase run in {time.perf_counter() - t0:.1f} s; {eng.vocab_report}")
    t0 = time.perf_counter()
    enc.warmup()
    warmup_s = time.perf_counter() - t0
    log(f"warmup: {warmup_s:.2f} s (native host core and its byte-level DFA, kernels, one "
        f"empty v3 chunk)")

    # ---- 3: corpus ---------------------------------------------------------
    t0 = time.perf_counter()
    docs = bench_docs(CORPUS_MB)
    edge = edge_docs()
    all_docs = edge + docs
    total_bytes = sum(len(d.encode("utf-8")) for d in all_docs)
    log(f"corpus: {len(docs)} documents of 1 MB + {len(edge)} edge documents, "
        f"{total_bytes} bytes, built in {time.perf_counter() - t0:.1f} s")

    # ---- 4: every kernel against its plain version, v3 chunk --------------
    t0 = time.perf_counter()
    per = new_per()
    calls3, chunk_ms, study3 = kernel_phase(enc, docs)
    measure(calls3, per, "v3")
    phase_s = {"4": time.perf_counter() - t0}

    # ---- 4b: the same on a v2 chunk under both scanners and its v1 re-run -----
    t0 = time.perf_counter()
    calls2, calls2b, calls1, calls128, (chunk2_ms, chunk2b_ms, rows1_ms), study2, study_b = \
        kernel_phase2(enc, docs)
    measure(calls2, per, "v2")
    measure(calls2b, per, "v2_byte")
    measure(calls1, per, "v1")
    measure(calls128, per, "v1_128")
    (_, gm_args, gm_kwargs, gm_out), = [c for c in calls1 if c[0] == "grid_merge"]
    gm_probes = work_of("grid_merge", gm_args, gm_kwargs, gm_out)[1] // 8
    per["grid_merge"]["probe_floor_ms"] = probe_floor_ms(gm_args[0], gm_probes)
    log(f"tt_grid_merge: {gm_probes} probes; {per['grid_merge']['ms']:.4f} ms against its bound "
        f"{per['grid_merge']['bound_ms']:.5f} ms and its probe floor (as many reads, one 16-byte "
        f"load each, at hashed random rows of the {gm_args[0].nbytes / 2**20:.0f} MiB pair "
        f"table) {per['grid_merge']['probe_floor_ms']:.4f} ms")
    phase_s["4b"] = time.perf_counter() - t0

    # ---- 5: the v3 main path --------------------------------------------------
    t0 = time.perf_counter()
    launches = {}
    v3, run, secs = drive(enc, eng, all_docs, "v3", launches, pipeline=3)
    tokens, offsets = v3
    log(f"v3 main path: {total_bytes / secs / 1e6:.2f} MB/s ({secs:.2f} s, {len(tokens)} "
        f"tokens); chunks {run['chunks']}, worst-case re-runs {run['worst_case_chunks']}, "
        f"fallback documents {run['fallback_docs']}")
    busy = (run["chunks"] + run["worst_case_chunks"]) * chunk_ms / 1e3
    log(f"device busy share of the v3 main path: about {busy / secs:.3f} "
        f"({run['chunks'] + run['worst_case_chunks']} chunk programs x {chunk_ms:.3f} ms)")
    if launches["v3"]["entries"].get("tt_compact_kinds", 0) <= 0:
        raise RuntimeError("tt_compact_kinds was not launched on the v3 path")
    if run["worst_case_chunks"] <= 0 or run["fallback_docs"] <= 0:
        raise RuntimeError("the edge documents took neither the worst-case re-run "
                           "nor the host fallback")
    phase_s["5"] = time.perf_counter() - t0

    # ---- 5b: the v2 main path under both scanners, then a chunk that ---------
    # ---- overflows into v1 ---------------------------------------------------
    t0 = time.perf_counter()
    v2_runs = {}
    for path, scanner, c_ms in (("v2", "char", chunk2_ms), ("v2_byte", "byte", chunk2b_ms)):
        (toks, offs), run2, secs2 = drive(enc, eng, all_docs, path, launches, pipeline=2,
                                          scanner=scanner)
        v2_runs[path] = (toks, offs)
        log(f"{path} main path ({scanner} scanner): {total_bytes / secs2 / 1e6:.2f} MB/s "
            f"({secs2:.2f} s, {len(toks)} tokens); chunks {run2['chunks']}, v1 re-runs "
            f"{run2['v1_fallback_chunks']}, fallback documents {run2['fallback_docs']}")
        busy2 = (run2["chunks"] * c_ms + run2["v1_fallback_chunks"] * rows1_ms) / 1e3
        log(f"device busy share of the {path} main path: about {busy2 / secs2:.3f} "
            f"({run2['chunks']} chunk programs x {c_ms:.3f} ms + {run2['v1_fallback_chunks']} "
            f"v1 programs x {rows1_ms:.3f} ms)")
    words = [random_words(400_000, seed=11)]
    words_bytes = len(words[0])
    vo, run_o, secs_o = drive(enc, eng, words, "v2_overflow", launches, pipeline=2)
    log(f"v2 overflow call: {words_bytes} bytes of random words in {secs_o:.2f} s; chunks "
        f"{run_o['chunks']}, v1 re-runs {run_o['v1_fallback_chunks']}, fallback documents "
        f"{run_o['fallback_docs']}")
    if run_o["v1_fallback_chunks"] <= 0:
        raise RuntimeError("the overflow call did not re-run a chunk through v1")
    for path, entry in (("v2", "tt_char_scan"), ("v2_byte", "tt_seq_scan"),
                        ("v2", "tt_compact_kinds"), ("v2_byte", "tt_compact_kinds"),
                        ("v2_overflow", "tt_char_scan"), ("v2_overflow", "tt_window_orbit"),
                        ("v2_overflow", "tt_grid_merge")):
        if launches[path]["entries"].get(entry, 0) <= 0:
            raise RuntimeError(f"{entry} was not launched on the {path} path")
    for path in ("v2", "v2_overflow"):
        if launches[path]["entries"].get("tt_seq_scan", 0):
            raise RuntimeError(f"the {path} path (char scanner) launched tt_seq_scan")
    phase_s["5b"] = time.perf_counter() - t0

    # ---- 5c: the host and hybrid routes ---------------------------------------
    t0 = time.perf_counter()
    host_phase(enc, all_docs, edge, tokens, offsets, total_bytes, warmup_s, launches)
    phase_s["5c"] = time.perf_counter() - t0

    # ---- 6: correctness ----------------------------------------------------
    t0 = time.perf_counter()
    for i, d in enumerate(all_docs):
        ids = tokens[offsets[i] : offsets[i + 1]].tolist()
        if enc.decode_bytes(ids) != d.encode("utf-8"):
            raise RuntimeError(f"document {i} does not decode back to its bytes")
    check = list(range(len(edge))) + [len(edge) + j for j in (0, 1, len(docs) // 2, len(docs) - 1)]
    for i in sorted(set(check)):
        if tokens[offsets[i] : offsets[i + 1]].tolist() != enc.encode_ordinary(all_docs[i]):
            raise RuntimeError(f"document {i}: device ids differ from the host encoder")
    log(f"correctness: {len(all_docs)} documents decode exactly; {len(set(check))} "
        f"documents equal the host encoder ({time.perf_counter() - t0:.1f} s)")
    phase_s["6"] = time.perf_counter() - t0

    # ---- 6b: both v2 routes against v3 and the host encoder --------------------
    t0 = time.perf_counter()
    for path, (tokens2, offsets2) in v2_runs.items():
        if not (np.array_equal(offsets2, offsets) and np.array_equal(tokens2, tokens)):
            bad = [i for i in range(len(all_docs))
                   if not np.array_equal(tokens2[offsets2[i] : offsets2[i + 1]],
                                         tokens[offsets[i] : offsets[i + 1]])]
            raise RuntimeError(f"{path} ids differ from v3 ids in documents {bad[:10]}")
    if vo[0].tolist() != enc.encode_ordinary(words[0]):
        raise RuntimeError("the overflow call's ids differ from the host encoder")
    log(f"correctness v2: under both scanners {len(all_docs)} documents equal the v3 ids "
        f"({len(tokens)} tokens); the overflow call equals the host encoder "
        f"({time.perf_counter() - t0:.1f} s)")
    phase_s["6b"] = time.perf_counter() - t0

    # ---- 7: the sharded engine ----------------------------------------------
    t0 = time.perf_counter()
    sharded_phase(enc, eng, all_docs, tokens, offsets, run["fallback_docs"], words[0], launches)
    phase_s["7"] = time.perf_counter() - t0

    # ---- 8: the training step ------------------------------------------------
    t0 = time.perf_counter()
    calls_t, floors, hist = train_phase(tokens, offsets, launches)
    per["pair_count"].update(floors)
    measure(calls_t, per, "train")
    hist_e, arg_e = per["pair_count"]["entries"]
    log(f"tt_pair_hist: {hist_e['ms']:.4f} ms against its bound {hist_e['bound_ms']:.5f} ms and "
        f"its atomic floor (one atomicAdd a pair on the feed's precomputed bins) "
        f"{floors['atomic_floor_ms']:.4f} ms")
    log(f"tt_hist_argmax: {arg_e['ms']:.5f} ms (one launch) against its bound "
        f"{arg_e['bound_ms']:.5f} ms, torch.argmax {arg_e['library_ms']:.5f} ms and an empty "
        f"one-block launch {floors['launch_floor_ms']:.5f} ms (both timed as the kernel); {card}")
    for k, e in per.items():
        if not e["entries"]:
            raise RuntimeError(f"kernel {k} was not held against its plain version")
    phase_s["8"] = time.perf_counter() - t0

    # ---- 9: the public API at full width ---------------------------------------
    t0 = time.perf_counter()
    api_phase(enc, all_docs, edge, tokens, offsets, total_bytes, card, launches)
    phase_s["9"] = time.perf_counter() - t0

    # ---- 9b: each chunk program traced: only the package's kernels
    t0 = time.perf_counter()
    for what, fn in CHUNK_TRACES:
        chunk_trace(what, fn)
    CHUNK_TRACES.clear()
    phase_s["9b"] = time.perf_counter() - t0

    # ---- 10: the sharded engine across processes ---------------------------------
    t0 = time.perf_counter()
    xproc_phase(enc, eng, all_docs, tokens, offsets, run["fallback_docs"], words[0], hist,
                launches)
    phase_s["10"] = time.perf_counter() - t0

    # ---- 11: the installed wheel, in a process where no compiler is found ---------
    t0 = time.perf_counter()
    wheel_phase(all_docs, tokens, offsets, total_bytes, card, launches)
    phase_s["11"] = time.perf_counter() - t0
    log("phase seconds: " + ", ".join(f"{k}={v:.1f}" for k, v in phase_s.items()))

    rows = []
    for k in kernels.KERNELS:
        e = per[k]
        by_path = {path: launches[path]["kernels"][k] for path in PATH_KERNELS}
        by_entry: dict[str, list] = {}
        for x in e["entries"]:
            by_entry.setdefault(x["entry"], []).append(x)
        entry_rows = [dict(
            entry=f"tt_{op}", launches=sum(launches[path]["entries"].get(f"tt_{op}", 0)
                                           for path in PATH_KERNELS),
            ms=sum(x["ms"] for x in xs), plain_ms=sum(x["plain_ms"] for x in xs),
            bound_ms=sum(x["bound_ms"] for x in xs),
            library_ms=sum(x["library_ms"] or 0.0 for x in xs) or None,
            by_program={prog: sum(x["ms"] for x in xs if x["program"] == prog)
                        for prog in dict.fromkeys(x["program"] for x in xs)})
            for op, xs in by_entry.items()]
        rows.append(dict(
            name=k, route="cuda", source=f"tiktoken_tpu_torch/csrc/{k}.cu",
            replaces=REPLACES[k], jax_functions=JAX_FUNCTIONS[k],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=e["max_abs_err"], match=e["match"], ms=e["ms"],
            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by="bytes" if e["bytes_bound_ms"] >= e["ops_bound_ms"] else "operations",
            library_ms=e["library_ms"], entries=entry_rows,
            **({"scan_study": {"v3": study3, "v2": study2}} if k == "scan_rows" else {}),
            **({"scan_study": {"v2_byte": study_b}} if k == "byte_scan" else {}),
            **{f: e[f] for f in ("probe_floor_ms", "atomic_floor_ms", "launch_floor_ms")
               if f in e},
            by_program={prog: dict(
                ms=sum(x["ms"] for x in e["entries"] if x["program"] == prog),
                plain_ms=sum(x["plain_ms"] for x in e["entries"] if x["program"] == prog),
                bound_ms=sum(x["bound_ms"] for x in e["entries"] if x["program"] == prog),
                library_ms=sum(x["library_ms"] or 0.0 for x in e["entries"]
                               if x["program"] == prog) or None)
                for prog in ("v3", "v2", "v2_byte", "v1", "v1_128", "train")
                if any(x["program"] == prog for x in e["entries"])},
        ))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def counted(path: str, launches: dict, fn):
    """Run ``fn`` with the launch counts set to 0 just before and read just
    after; fails if a kernel of the path was not launched. Returns (fn's
    result, seconds)."""
    from tiktoken_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches[path] = {"kernels": dict(kernels.launches), "entries": dict(kernels.entry_launches)}
    log(f"{path} launches: {launches[path]['kernels']}; by entry point "
        f"{launches[path]['entries']}")
    check_launches(path, launches[path])
    return out, secs


def check_launches(path: str, counts: dict, who: str = "") -> None:
    """Fail if a kernel of the path was not launched, if a path that merges
    did not launch ``tt_slot_merge_packed`` and ``tt_assemble``, or if the
    path launched an entry point that a redesign took out. ``counts``:
    {"kernels": by kernel, "entries": by entry point}."""
    where = f"the {path} path{who}"
    for k in PATH_KERNELS[path]:
        if counts["kernels"][k] <= 0:
            raise RuntimeError(f"kernel {k} was not launched on {where}")
    gone = [e for e in GONE_ENTRIES if counts["entries"].get(e, 0)]
    if gone:
        raise RuntimeError(f"{where} launched {gone}")
    if "slot_merge" in PATH_KERNELS[path]:
        for e in ("tt_slot_merge_packed", "tt_assemble"):
            if counts["entries"].get(e, 0) <= 0:
                raise RuntimeError(f"{e} was not launched on {where}")


def drive(enc, eng, texts, path: str, launches: dict, *, pipeline: int, scanner: str = "char"):
    """One main-path call of ``encode_corpus_to_numpy`` on ``cuda``, counted.
    Returns (result, stats delta, seconds)."""
    stats0 = dict(eng.stats)
    out, secs = counted(path, launches, lambda: enc.encode_corpus_to_numpy(
        texts, device="cuda", strategy="device", pipeline=pipeline, scanner=scanner))
    log(f"{path} host-clock phases (s): " + ", ".join(
        f"{k}={v:.3f}" for k, v in eng.timing.items()))
    return out, {k: eng.stats[k] - stats0[k] for k in eng.stats}, secs


def same_ids(got, tokens, offsets) -> list[int]:
    """The documents whose ids in ``got`` (tokens, offsets) differ from
    phase 5's."""
    g_tok, g_off = got
    return [i for i in range(len(offsets) - 1) if not np.array_equal(
        g_tok[g_off[i] : g_off[i + 1]], tokens[offsets[i] : offsets[i + 1]])]


def host_phase(enc, all_docs, edge, tokens, offsets, total_bytes: int, warmup_s: float,
               launches: dict) -> None:
    """Phase 5c: the native host core against the pure-Python encoder, then
    the corpus through the host and hybrid routes against phase 5's ids."""
    from tiktoken_tpu_torch.ops import kernels

    log(f"warmup (phase 2): {warmup_s:.2f} s")
    host = enc._core_bpe
    core = host.native_core()
    for d in edge + [all_docs[len(edge)], all_docs[-1]]:
        t0 = time.perf_counter()
        got = core.encode_ordinary(d)
        t1 = time.perf_counter()
        want = host.encode_ordinary_python(d)
        t2 = time.perf_counter()
        if got != want:
            raise RuntimeError(f"the native core differs from the Python encoder on a document "
                               f"of {len(d)} chars")
        if len(d) >= 500_000:
            log(f"native core = Python encoder on a {len(d.encode())}-byte document: native "
                f"{t1 - t0:.3f} s, Python {t2 - t1:.3f} s")
    log(f"native core = Python encoder on the {len(edge)} edge documents and two 1 MB documents")

    cpus = os.cpu_count()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = enc.encode_corpus_to_numpy(all_docs, device="cuda", strategy="host")
    secs = time.perf_counter() - t0
    if any(kernels.launches.values()):
        raise RuntimeError(f"the host route launched kernels: {kernels.launches}")
    bad = same_ids(got, tokens, offsets)
    if bad:
        raise RuntimeError(f"host route: ids differ from phase 5's in documents {bad[:10]}")
    log(f"host route: {total_bytes / secs / 1e6:.2f} MB/s ({secs:.2f} s, {min(32, cpus)} "
        f"threads, os.cpu_count() {cpus}); {len(all_docs)} documents equal phase 5's ids")

    got, secs = counted("hybrid", launches, lambda: enc.encode_corpus_to_numpy(
        all_docs, device="cuda", strategy="hybrid"))
    report = enc.corpus_report
    bad = same_ids(got, tokens, offsets)
    if bad:
        raise RuntimeError(f"hybrid route: ids differ from phase 5's in documents {bad[:10]}")
    if report["strategy"] != "hybrid" or report["docs"]["device"] <= 0:
        raise RuntimeError(f"the hybrid call's device worker took no document: {report}")
    dt = report["device_timing"]
    log(f"hybrid route: {total_bytes / secs / 1e6:.2f} MB/s ({secs:.2f} s); documents taken: host "
        f"{report['docs']['host']}, device {report['docs']['device']}; device worker pack_s="
        f"{dt.get('pack_s', 0.0):.3f} fallback_s={dt.get('fallback_s', 0.0):.3f} (summed, s), "
        f"all phases " + ", ".join(f"{k}={v:.3f}" for k, v in dt.items())
        + f"; os.cpu_count() {cpus}, host worker threads {max(1, min(32, (cpus or 1) - 1))}; "
        f"{len(all_docs)} documents equal phase 5's ids")


def sharded_phase(enc, eng, all_docs, tokens, offsets, fallback_docs: int, words: str,
                  launches: dict) -> None:
    """Phase 7: the sharded engine over every visible GPU and over a 2-way
    split of one card, against phase 5's ids and host fallbacks, the host
    encoder and the single-device v1 rows."""
    from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, pack_documents
    from tiktoken_tpu_torch.parallel import ShardedEngine, data_mesh

    mesh = data_mesh()
    n_gpus = len(set(mesh))
    total_bytes = sum(len(d.encode("utf-8")) for d in all_docs)
    for path, m in (("sharded_v3", mesh), ("sharded_v3_2way", [torch.device("cuda", 0)] * 2)):
        sharded = ShardedEngine(eng, m)
        ids, secs = counted(path, launches, lambda: sharded.encode_corpus3(
            all_docs, host_fallback=enc, as_numpy=True))
        bad = [i for i, a in enumerate(ids)
               if not np.array_equal(a, tokens[offsets[i] : offsets[i + 1]])]
        if bad:
            raise RuntimeError(f"{path}: ids differ from phase 5's in documents {bad[:10]}")
        if sharded.stats["fallback_docs"] != fallback_docs:
            raise RuntimeError(f"{path}: {sharded.stats['fallback_docs']} documents fell back to "
                               f"the host, phase 5 had {fallback_docs}")
        log(f"{path} over {[str(d) for d in m]}: {total_bytes / secs / 1e6:.2f} MB/s "
            f"({secs:.2f} s); {len(all_docs)} documents equal phase 5's ids and host "
        f"fallbacks; stats "
            f"{sharded.stats}; host-clock phases (s): "
            + ", ".join(f"{k}={v:.3f}" for k, v in sharded.timing.items()))
    sharded = ShardedEngine(eng, mesh)
    got, secs = counted("sharded_v2", launches, lambda: sharded.encode_corpus(
        [words], host_fallback=enc, pipeline=2, chunk_rows=128))
    v1_runs = sharded.stats["v1_fallback_chunks"]
    if got[0] != enc.encode_ordinary(words):
        raise RuntimeError("sharded pipeline=2: ids differ from the host encoder")
    if v1_runs <= 0:
        raise RuntimeError("sharded pipeline=2 did not re-run a chunk through v1")
    if launches["sharded_v2"]["entries"].get("tt_char_scan", 0) <= 0:
        raise RuntimeError("sharded pipeline=2 did not launch tt_char_scan")
    log(f"sharded_v2 over {len(mesh)} GPU(s): {len(words)} bytes of random words in "
        f"{secs:.2f} s, equal to the host encoder; {v1_runs} of {sharded.stats['chunks']} "
        f"chunks re-run through v1")
    batch = pack_documents([words.encode()], DEFAULT_ROW)
    packed, counts, row_bad, stats = sharded.encode_rows(batch)
    want = eng.encode_rows(batch)
    if not (np.array_equal(packed, want[0]) and np.array_equal(counts, want[1])
            and np.array_equal(row_bad, want[2])):
        raise RuntimeError("sharded encode_rows differs from the single-device v1 rows")
    B = batch.rows.shape[0]
    if not (stats.rows == B + (-B) % len(mesh) and stats.payload_bytes == int(batch.n_payload.sum())
            and stats.tokens == int(counts.sum()) and stats.fallback_rows == int(row_bad.sum())):
        raise RuntimeError(f"sharded encode_rows: the counters do not add up: {stats}")
    log(f"sharded encode_rows: {B} rows equal the single-device v1 rows; {stats}")
    log(f"GPUs taking part in the sharded runs: {n_gpus}")
    if n_gpus == 1:
        log("one GPU: the launch on a device other than the current one is unexercised here")


def feed_grid(tokens, offsets):
    """The dry run's feed: one document's ids a row, a piece start at each
    row's front: (tokens uint32 [B, K], alive, piece_start)."""
    lens = np.diff(offsets)
    B, K = len(lens), int(lens.max())
    grid = np.zeros((B, K), np.uint32)
    alive = np.arange(K)[None, :] < lens[:, None]
    grid[alive] = tokens
    piece_start = np.zeros((B, K), bool)
    piece_start[:, 0] = True
    return grid, alive, piece_start


def train_phase(tokens, offsets, launches: dict):
    """Phase 8: the training step on the dry run's feed at full size; returns
    the two kernel calls, for ``measure``, the atomic floor and the
    histogram."""
    import tempfile

    import torch.distributed as dist

    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.engine import to_device
    from tiktoken_tpu_torch.ops.pair_count import pair_bins
    from tiktoken_tpu_torch.parallel import HIST_BITS, corpus_pair_counts, data_mesh

    grid, alive, piece_start = feed_grid(tokens, offsets)
    lens = np.diff(offsets)
    B, K = grid.shape
    mesh = data_mesh()
    (hist, best_bin, best_count), secs = counted("train", launches, lambda: corpus_pair_counts(
        mesh, grid, alive, piece_start))
    pairs = int(np.maximum(lens - 1, 0).sum())
    if int(hist.sum()) != pairs or best_count != hist.max() or hist[best_bin] != best_count:
        raise RuntimeError(f"training step: {int(hist.sum())} pairs counted, want {pairs}")
    log(f"training step over {B} rows x {K} columns ({B * K} positions, {pairs} pairs, "
        f"{grid.nbytes + 2 * alive.nbytes} bytes in): best bin {best_bin} count {best_count}; "
        f"{secs * 1e3:.1f} ms on the host clock, uploads included")
    split = corpus_pair_counts([torch.device("cuda", 0)] * 2, grid, alive, piece_start)
    if not (np.array_equal(split[0], hist) and split[1:] == (best_bin, best_count)):
        raise RuntimeError("training step: the 2-way split differs from the 1-way result")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            grouped = corpus_pair_counts(mesh, grid, alive, piece_start, group=dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    if not (np.array_equal(grouped[0], hist) and grouped[1:] == (best_bin, best_count)):
        raise RuntimeError("training step: the one-rank NCCL result differs")
    log("training step: the 2-way split and the one-rank NCCL group equal the 1-way result")

    def upload():
        return [to_device(x, mesh[0]) for x in (grid.view(np.int32), alive, piece_start)]

    upload_ms = wall_ms(upload, rounds=7)
    dev_in = upload()
    h = kernels.pair_hist(*dev_in, HIST_BITS)
    readback_ms = wall_ms(lambda: h.cpu(), rounds=7)
    whole_ms = wall_ms(lambda: corpus_pair_counts(mesh, grid, alive, piece_start), rounds=7)
    log(f"training step split on {mesh[0]} (host clock, median of 7): pinned upload "
        f"{upload_ms:.2f} ms, histogram read-back {readback_ms:.3f} ms, whole call over "
        f"{len(mesh)} GPU(s) {whole_ms:.2f} ms; the kernels' device ms follow ('train')")
    best = kernels.hist_argmax(h)
    hot_bin_grid(mesh[0])
    argmax_edges(mesh[0])
    argmax_one_launch(h)
    floors = {"atomic_floor_ms": atomic_floor_ms(pair_bins(*dev_in, HIST_BITS), HIST_BITS, h),
              "launch_floor_ms": launch_floor_ms(mesh[0])}
    return ([("pair_hist", (*dev_in, HIST_BITS), {}, h), ("hist_argmax", (h,), {}, best)],
            floors, hist)


def argmax_edges(device) -> None:
    """``tt_hist_argmax`` against ``pair_count.hist_argmax`` (exact) on edge
    histograms built on the card at n = 1, 3, 4097 and 2^20, each as a
    16-byte aligned tensor and as an unaligned view (``base[1:]``): all
    zeros; the maximum tied at the first and the last bin; a tie spread
    over bins far apart (different blocks at 2^20); one maximum of 2^31 - 1
    in the middle."""
    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.pair_count import hist_argmax

    rng = np.random.default_rng(13)
    n_cases = 0
    for n in (1, 3, 4097, 1 << 20):
        ends = rng.integers(0, 50, n).astype(np.int32)
        ends[[0, -1]] = 99
        spread = rng.integers(0, 50, n).astype(np.int32)
        spread[np.linspace(n // 7, n - 1, 5).astype(np.int64)] = 99
        big = rng.integers(0, 1 << 30, n).astype(np.int32)
        big[n // 2] = np.iinfo(np.int32).max
        for name, h in (("zeros", np.zeros(n, np.int32)), ("first and last", ends),
                        ("spread", spread), ("2^31 - 1", big)):
            for unaligned in (False, True):
                base = torch.from_numpy(np.concatenate([[7], h]).astype(np.int32) if unaligned
                                        else h).to(device)
                t = base[1:] if unaligned else base
                got = [int(x) for x in kernels.hist_argmax(t)]
                want = [int(x) for x in hist_argmax(t)]
                if got != want:
                    raise RuntimeError(f"tt_hist_argmax {got} differs from plain {want} on the "
                                       f"{name!r} histogram, n={n}, unaligned={unaligned}")
                n_cases += 1
    log(f"tt_hist_argmax == plain on {n_cases} edge histograms (n = 1, 3, 4097, 2^20; all zeros, "
        "ties at the ends and spread far apart, a maximum of 2^31 - 1; aligned and unaligned)")


def argmax_one_launch(h) -> None:
    """One ``kernels.hist_argmax`` call launches one kernel: a
    ``torch.profiler`` trace of the call (its scratch made before)."""
    import tempfile

    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.utils import device_trace

    kernels.hist_argmax(h)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            kernels.hist_argmax(h)
            torch.cuda.synchronize()
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name)) as f:
            names = [kernel_name(e["name"]) for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel" and e.get("ph") == "X"]
    if len(names) != 1 or "argmax" not in names[0]:
        raise RuntimeError(f"one hist_argmax call launched {names}, not one argmax kernel")
    log(f"one hist_argmax call launches one kernel ({names[0]}, torch.profiler)")


XPROC_RANKS = 2
XPROC_DEADLINE_S = 600  # the spawned ranks are killed, and the phase fails, past this
XPROC_PATHS = ("xproc_v3", "xproc_v2", "xproc_rows", "xproc_train")


def word_documents(words: str, n: int = 8) -> list[str]:
    """Phase 5b's random words cut at spaces into ``n`` documents."""
    cuts = [0] + [words.index(" ", i * len(words) // n) for i in range(1, n)] + [len(words)]
    return [words[a:b] for a, b in zip(cuts, cuts[1:])]


def xproc_phase(enc, eng, all_docs, tokens, offsets, fallback_docs: int, words: str, hist,
                launches: dict, n_ranks: int = XPROC_RANKS) -> dict:
    """Phase 10: the sharded engine across processes. A one-rank NCCL group
    in this process (so the NCCL collectives run on every machine), then
    ``n_ranks`` spawned ranks: over NCCL, rank r on ``cuda:r``, when there
    are that many GPUs; else every rank on ``cuda:0``, gathering over gloo
    (NCCL refuses two ranks on one device). Every rank's v3 ids must equal
    phase 5's with its host fallbacks, the v2 ids the host encoder's, the v1
    rows the one-device rows, the pair histogram phase 8's, and every rank
    must launch its paths' kernels. v3 runs twice in each rank, the second
    call timed as a warm one. Returns rank 0's MB/s and seconds and every
    rank's host-clock phases, of both v3 calls."""
    import pickle
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, pack_documents
    from tiktoken_tpu_torch.parallel import ShardedEngine

    total_bytes = sum(len(d.encode("utf-8")) for d in all_docs)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, timeout=timedelta(seconds=120))
        try:
            sharded = ShardedEngine(eng, [torch.device("cuda", 0)], group=dist.group.WORLD)
            dist.barrier(device_ids=[0])  # the communicator is set up at the first collective
            ids, secs = counted("xproc_nccl1", launches, lambda: sharded.encode_corpus3(
                all_docs, host_fallback=enc, as_numpy=True))
        finally:
            dist.destroy_process_group()
    bad = [i for i, a in enumerate(ids) if not np.array_equal(a, tokens[offsets[i] : offsets[i + 1]])]
    if bad or sharded.stats["fallback_docs"] != fallback_docs:
        raise RuntimeError(f"xproc_nccl1: ids differ from phase 5's in documents {bad[:10]}, or "
                           f"{sharded.stats['fallback_docs']} host fallbacks against {fallback_docs}")
    log(f"xproc_nccl1 (a one-rank NCCL group, cuda:0): {total_bytes / secs / 1e6:.2f} MB/s "
        f"({secs:.3f} s); {len(all_docs)} documents equal phase 5's ids and host fallbacks; "
        "host-clock phases (s): " + ", ".join(f"{k}={v:.4f}" for k, v in sharded.timing.items()))

    backend = "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"
    log(f"xproc: {n_ranks} ranks, " + (f"NCCL, rank r on cuda:r" if backend == "nccl" else
        f"all on cuda:0, gathering over gloo ({torch.cuda.device_count()} GPU visible)"))
    word_docs = word_documents(words)
    want_v2 = [enc.encode_ordinary(d) for d in word_docs]
    batch = pack_documents([words.encode()], DEFAULT_ROW)
    want_rows = eng.encode_rows(batch)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(xproc_rank, args=(n_ranks, backend, tmp, all_docs, word_docs,
                                                   words), nprocs=n_ranks, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + XPROC_DEADLINE_S
        while not ctx.join(timeout=1):  # a rank that raised raises here, with its traceback
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"the {n_ranks} ranks did not finish within "
                                   f"{XPROC_DEADLINE_S} s")
        spawn_s = time.perf_counter() - t0
        res = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out = pickle.load(f)
            out["flat"] = np.load(os.path.join(tmp, f"rank{r}_ids.npy"))
            res.append(out)
    for out in res:
        r = out["rank"]
        if not out["device"].startswith("cuda"):
            raise RuntimeError(f"rank {r} ran on {out['device']}")
        if table_files(enc._mergeable_ranks) is not None and not out["tables_cached"]:
            raise RuntimeError(f"rank {r} did not find phase 2's tables in the disk cache")
        if not (np.array_equal(out["lengths"], np.diff(offsets))
                and np.array_equal(out["flat"], tokens)):
            bad = [i for i in range(len(all_docs)) if out["lengths"][i] != offsets[i + 1] - offsets[i]]
            raise RuntimeError(f"xproc_v3: rank {r}'s ids differ from phase 5's (documents "
                               f"{bad[:10]} differ in length)")
        if out["xproc_v3"]["stats"]["fallback_docs"] != fallback_docs:
            raise RuntimeError(f"xproc_v3: rank {r} counted {out['xproc_v3']['stats']} host "
                               f"fallbacks, phase 5 had {fallback_docs}")
        if [a.tolist() for a in out["v2"]] != want_v2:
            raise RuntimeError(f"xproc_v2: rank {r}'s ids differ from the host encoder's")
        if out["xproc_v2"]["stats"]["v1_fallback_chunks"] <= 0:
            raise RuntimeError("xproc_v2: no chunk re-ran through v1")
        packed, counts, row_bad, stats = out["rows"]
        if not (np.array_equal(packed, want_rows[0]) and np.array_equal(counts, want_rows[1])
                and np.array_equal(row_bad, want_rows[2])):
            raise RuntimeError(f"xproc_rows: rank {r}'s v1 rows differ from the one-device rows")
        B = batch.rows.shape[0]
        if not (stats.rows == B + (-B) % n_ranks and stats.tokens == int(counts.sum())
                and stats.payload_bytes == int(batch.n_payload.sum())
                and stats.fallback_rows == int(row_bad.sum())):
            raise RuntimeError(f"xproc_rows: rank {r}'s counters do not add up: {stats}")
        if not (np.array_equal(out["hist"][0], hist) and out["hist"][1] == int(np.argmax(hist))
                and out["hist"][2] == int(hist.max())):
            raise RuntimeError(f"xproc_train: rank {r}'s histogram differs from phase 8's")
        for path in XPROC_PATHS:
            check_launches(path, out[path], f" in rank {r}")
    for path in XPROC_PATHS:
        launches[path] = {key: {k: sum(out[path][key].get(k, 0) for out in res)
                                for k in dict.fromkeys(k for out in res for k in out[path][key])}
                          for key in ("kernels", "entries")}
        log(f"{path} launches, summed over the ranks: {launches[path]['kernels']}; by rank: "
            + "; ".join(f"{out['rank']}: {out[path]['kernels']}" for out in res))
    r0 = res[0]
    mbs = total_bytes / r0["xproc_v3"]["secs"] / 1e6
    mbs_again = total_bytes / r0["xproc_v3_again"]["secs"] / 1e6
    log(f"xproc_v3 over {n_ranks} ranks ({backend}): {mbs:.2f} MB/s, the same call again "
        f"{mbs_again:.2f} MB/s (rank 0's wall time from a barrier to the end of the gather, "
        f"{r0['xproc_v3']['secs']:.3f} / {r0['xproc_v3_again']['secs']:.3f} s); every rank's "
        f"{len(all_docs)} documents equal phase 5's ids and its {fallback_docs} host "
        f"fallbacks; {n_ranks} processes spawned, run and joined in {spawn_s:.1f} s")
    for out in res:
        log(f"  rank {out['rank']} on {out['device']}: {out['docs']} documents, setup "
            f"{out['setup_s']:.2f} s (vocabulary, tables, warmup; the engine's build "
            f"{out['engine_s']:.3f} s, its tables "
            + ("from the disk cache" if out["tables_cached"] else "built: the cache is off")
            + "); v3 "
            f"{out['xproc_v3']['secs']:.3f} / {out['xproc_v3_again']['secs']:.3f} s, host-clock "
            "phases (s): " + "; ".join(", ".join(f"{k}={v:.4f}" for k, v in t.items()) for t in (
                out["xproc_v3"]["timing"], out["xproc_v3_again"]["timing"]))
            + f"; stats {out['xproc_v3']['stats']}")
    log(f"xproc_v2: {len(word_docs)} documents of random words ({len(words)} bytes) equal the "
        f"host encoder's on every rank ({r0['xproc_v2']['secs']:.3f} s); stats "
        f"{r0['xproc_v2']['stats']}")
    log(f"xproc_rows: {batch.rows.shape[0]} rows equal the one-device v1 rows on every rank "
        f"({r0['xproc_rows']['secs']:.3f} s); {r0['rows'][3]}")
    log(f"xproc_train: each rank's half of phase 8's grid, all-reduced over {backend}: the "
        f"histogram equals phase 8's on every rank ({r0['xproc_train']['secs'] * 1e3:.1f} ms)")
    return {"backend": backend, "ranks": n_ranks, "mb_s": [mbs, mbs_again],
            "secs": [r0["xproc_v3"]["secs"], r0["xproc_v3_again"]["secs"]],
            "timing": [[out[p]["timing"] for p in ("xproc_v3", "xproc_v3_again")] for out in res]}


def xproc_rank(rank: int, n_ranks: int, backend: str, tmp: str, all_docs, word_docs,
               words: str) -> None:
    """One rank of phase 10 (a spawned process): its device made current,
    the group joined, the bench encoding built (the DFAs and the hash tables
    from the disk cache that phase 2 filled, the kernels that phase 1 built)
    and warmed up, then
    each path with the launch counts set to 0 before it and read after,
    timed from a barrier; the results go to ``tmp``."""
    import pickle
    from datetime import timedelta

    import torch.distributed as dist

    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, pack_documents
    from tiktoken_tpu_torch.parallel import ShardedEngine, corpus_pair_counts
    from tiktoken_tpu_torch.parallel.encode import document_shares

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), n_ranks),
                            rank=rank, world_size=n_ranks, timeout=timedelta(seconds=300))
    try:
        t0 = time.perf_counter()
        enc = bench_encoding()
        cached = tables_on_disk(enc._mergeable_ranks)
        t1 = time.perf_counter()
        enc.engine(dev)
        torch.cuda.synchronize(dev)
        engine_s = time.perf_counter() - t1
        enc.warmup(dev)
        sharded = ShardedEngine(enc.engine(dev), [dev], group=dist.group.WORLD)
        b = document_shares(all_docs, n_ranks)
        out = {"rank": rank, "device": str(sharded.engine.device),
               "docs": int(b[rank + 1] - b[rank]), "setup_s": time.perf_counter() - t0,
               "tables_cached": cached, "engine_s": engine_s}

        def run(path, fn):
            torch.cuda.synchronize(dev)
            dist.barrier(**({"device_ids": [dev.index]} if backend == "nccl" else {}))
            kernels.reset_launches()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize(dev)
            out[path] = {"secs": time.perf_counter() - t0, "kernels": dict(kernels.launches),
                         "entries": dict(kernels.entry_launches),
                         "timing": dict(sharded.timing), "stats": dict(sharded.stats)}
            sharded.stats = dict.fromkeys(sharded.stats, 0)
            return got

        ids = run("xproc_v3", lambda: sharded.encode_corpus3(all_docs, host_fallback=enc,
                                                             as_numpy=True))
        out["lengths"] = np.fromiter(map(len, ids), np.int64, len(ids))
        flat = np.concatenate(ids)
        np.save(os.path.join(tmp, f"rank{rank}_ids.npy"), flat)
        again = run("xproc_v3_again", lambda: sharded.encode_corpus3(
            all_docs, host_fallback=enc, as_numpy=True))
        if not all(np.array_equal(a, b) for a, b in zip(again, ids, strict=True)):
            raise RuntimeError(f"rank {rank}: the second v3 call's ids differ from the first's")
        out["v2"] = run("xproc_v2", lambda: sharded.encode_corpus(
            word_docs, host_fallback=enc, pipeline=2, chunk_rows=128, as_numpy=True))
        out["rows"] = run("xproc_rows", lambda: sharded.encode_rows(
            pack_documents([words.encode()], DEFAULT_ROW)))
        grid = feed_grid(flat, np.concatenate([[0], np.cumsum(out["lengths"])]))
        per = -(-grid[0].shape[0] // n_ranks)
        mine = [x[rank * per : (rank + 1) * per] for x in grid]
        out["hist"] = run("xproc_train", lambda: corpus_pair_counts(
            [dev], *mine, group=dist.group.WORLD))
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


WHEEL_PATHS = {"device": "wheel_device", "auto": "wheel_auto"}
# the wheel's build and its process are each killed, and the phase fails,
# past this
WHEEL_DEADLINE_S = 600


def wheel_phase(all_docs, tokens, offsets, total_bytes: int, card: str, launches: dict) -> None:
    """Phase 11: the installed wheel on the card. ``setup.py build_ext``
    builds the wheel's compiled parts into a temporary directory (timed);
    the core and the seven kernel libraries must be there under their
    digest names. The port's two packages are copied beside that
    ``prebuilt/`` (without their ``build/``), and a fresh process with
    neither g++ nor nvcc on PATH, ``_build``'s nvcc search pointed away and
    an empty cache directory runs phase 5's v3 call on ``cuda:0`` with
    ``strategy="device"`` and with ``"auto"`` (``wheel_child``). Both must
    equal phase 5's ids and launch every v3 kernel, the kernels and the core
    must come from ``prebuilt/``, and no library may be written under the
    copy's ``build/`` or the cache."""
    import pickle

    from tiktoken_tpu_torch import _build

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip-smoke-wheel-") as tmp:
        lib = os.path.join(tmp, "lib")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "setup.py", "-q", "build_ext", "--build-lib", lib,
                               "--build-temp", os.path.join(tmp, "temp")], cwd=repo,
                              capture_output=True, text=True, timeout=WHEEL_DEADLINE_S)
        build_s = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(f"setup.py build_ext failed:\n{proc.stdout}{proc.stderr}")
        prebuilt = os.path.join(lib, "tiktoken_tpu_torch", "prebuilt")
        want = {_build.core_name(), *_build.kernel_names().values()}
        got = set(os.listdir(prebuilt)) if os.path.isdir(prebuilt) else set()
        if got != want:
            raise RuntimeError(f"the wheel's prebuilt/ holds {sorted(got)}, want {sorted(want)}:"
                               f"\n{proc.stdout}{proc.stderr}")
        log(f"wheel: setup.py build_ext wrote the native core and the seven kernel libraries "
            f"under their digest names in {build_s:.1f} s; {card}")
        for pkg in ("tiktoken_tpu_torch", "tiktoken_tpu_torch_ext"):
            shutil.copytree(os.path.join(repo, pkg), os.path.join(lib, pkg), dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns("build", "prebuilt", "__pycache__"))
        docs_path, out_path = os.path.join(tmp, "docs.pkl"), os.path.join(tmp, "out.pkl")
        with open(docs_path, "wb") as f:
            pickle.dump(all_docs, f)
        cache, empty_bin = os.path.join(tmp, "cache"), os.path.join(tmp, "bin")
        os.makedirs(cache)
        os.makedirs(empty_bin)
        code = ("import importlib.util, sys\n"
                f"sys.path.insert(0, {lib!r})\n"
                f"spec = importlib.util.spec_from_file_location('chip_smoke', "
                f"{os.path.abspath(__file__)!r})\n"
                "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
                f"m.wheel_child({lib!r}, {docs_path!r}, {out_path!r})\n")
        env = dict(os.environ, PATH=empty_bin, TIKTOKEN_TPU_CACHE_DIR=cache)
        env.pop("PYTHONPATH", None)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=tmp, env=env, capture_output=True,
                              text=True, timeout=WHEEL_DEADLINE_S)
        child_s = time.perf_counter() - t0
        if proc.returncode:
            raise RuntimeError(f"the wheel's process failed:\n{proc.stdout}{proc.stderr}")
        with open(out_path, "rb") as f:
            out = pickle.load(f)
        written = [os.path.join(d, f) for where in (os.path.join(lib, "tiktoken_tpu_torch",
                                                                 "build"), cache)
                   for d, _, files in os.walk(where) for f in files if ".so" in f]
        if written:
            raise RuntimeError(f"the wheel's process wrote libraries: {written}")
    log(f"wheel process: tiktoken_tpu_torch from {out['package']}, no compiler found "
        f"({out['compilers']}); kernels and core loaded from prebuilt/: "
        f"{sorted(os.path.basename(p) for p in out['libraries'])}")
    for strategy, path in WHEEL_PATHS.items():
        r = out[strategy]
        launches[path] = {"kernels": r["kernels"], "entries": r["entries"]}
        log(f"{path} launches: {r['kernels']}; by entry point {r['entries']}")
        check_launches(path, launches[path])
        if len(r["offsets"]) != len(offsets):
            raise RuntimeError(f"{path}: {len(r['offsets']) - 1} documents, phase 5 had "
                               f"{len(offsets) - 1}")
        bad = same_ids((r["tokens"], r["offsets"]), tokens, offsets)
        if bad:
            raise RuntimeError(f"{path}: ids differ from phase 5's in documents {bad[:10]}")
        log(f"{path}: strategy {strategy!r} ran {r['report']['strategy']!r} with the "
            f"{r['report']['host_engine']} host engine, {total_bytes / r['secs'] / 1e6:.2f} MB/s "
            f"({r['secs']:.2f} s); documents {r['report']['docs']}; {len(all_docs)} documents "
            f"equal phase 5's ids")
    log(f"phase 11: the wheel's build {build_s:.1f} s, its process {child_s:.1f} s (start, "
        f"tables and DFAs from an empty cache, both calls), no library built; {card}")


def wheel_child(lib: str, docs_path: str, out_path: str) -> None:
    """Phase 11's process: the package copied under ``lib`` beside its
    ``prebuilt/``, no compiler to be found, phase 5's documents through
    ``encode_corpus_to_numpy`` on ``cuda:0`` with ``strategy="device"`` and
    ``"auto"``, each with the launch counts set to 0 just before it and
    read just after; the results go to ``out_path``."""
    import pickle

    import tiktoken_tpu_torch
    from tiktoken_tpu_torch import _build, native
    from tiktoken_tpu_torch.ops import kernels

    _build.NVCC_DEFAULT = os.path.join(lib, "no-nvcc")  # the nvcc search pointed away
    if not tiktoken_tpu_torch.__file__.startswith(lib + os.sep):
        raise RuntimeError(f"tiktoken_tpu_torch imported from {tiktoken_tpu_torch.__file__}")
    compilers = {"g++": shutil.which("g++"), native.CXX: shutil.which(native.CXX),
                 "nvcc": _build.find_nvcc()}
    if any(compilers.values()):
        raise RuntimeError(f"a compiler is found: {compilers}")
    with open(docs_path, "rb") as f:
        docs = pickle.load(f)
    enc = bench_encoding()
    out = {"package": os.path.dirname(tiktoken_tpu_torch.__file__), "compilers": compilers}
    for strategy in WHEEL_PATHS:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        toks, offs = enc.encode_corpus_to_numpy(docs, device="cuda:0", strategy=strategy)
        torch.cuda.synchronize()
        out[strategy] = {"secs": time.perf_counter() - t0, "tokens": toks, "offsets": offs,
                         "kernels": dict(kernels.launches),
                         "entries": dict(kernels.entry_launches),
                         "report": {k: enc.corpus_report[k]
                                    for k in ("strategy", "host_engine", "docs")}}
    out["libraries"] = [lib_._name for lib_ in kernels.build().libs.values()]
    if native._lib is not None:
        out["libraries"].append(native._lib._name)
    prebuilt = os.path.join(os.path.dirname(tiktoken_tpu_torch.__file__), "prebuilt")
    outside = [p for p in out["libraries"] if os.path.dirname(p) != prebuilt]
    if outside or kernels.build().ptxas or native._lib is None:
        raise RuntimeError(f"libraries not from {prebuilt} ({outside}), kernels built "
                           f"({sorted(kernels.build().ptxas)}), or no native core loaded")
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


BENCH_PLUGIN = """
from tiktoken_tpu_torch.load import load_tiktoken_bpe
from tiktoken_tpu_torch.patterns import o200k_pat_str


def bench_o200k():
    return {{"name": "bench_o200k", "pat_str": o200k_pat_str,
             "mergeable_ranks": load_tiktoken_bpe({path!r}),
             "special_tokens": {{"<|endoftext|>": 100000, "<|endofprompt|>": 100001}}}}


ENCODING_CONSTRUCTORS = {{"bench_o200k": bench_o200k}}
"""
SHIPPED = ("gpt2", "r50k_base", "p50k_base", "p50k_edit", "cl100k_base", "o200k_base",
           "o200k_harmony")


def kernel_name(full: str) -> str:
    """A CUDA kernel's name from a trace without its namespace noise and
    parameter list (its template arguments kept)."""
    name = full.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            return name[:i]
    return name


def trace_summary(trace_dir: str, wall_s: float) -> dict:
    """From the one Chrome trace in ``trace_dir``: the union of the CUDA
    kernels' intervals over ``wall_s`` (the device busy share), the summed
    ms of the package's kernels and of PyTorch's own (``at::``), and the
    five kernels with the most device time (name, ms, launches)."""
    (name,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, name)) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel" and e.get("ph") == "X"]
    if not kernels:
        raise RuntimeError("the device trace holds no CUDA kernel")
    busy_us, end = 0.0, -1.0
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(kernel_name(e["name"]), []).append(e["dur"])
    top = sorted(((k, sum(v) / 1e3, len(v)) for k, v in by_name.items()), key=lambda x: -x[1])
    torch_ms = sum(e["dur"] for e in kernels if "at::" in e["name"]) / 1e3
    return {"busy_share": busy_us / 1e6 / wall_s, "busy_ms": busy_us / 1e3,
            "launches": len(kernels), "torch_ms": torch_ms,
            "package_ms": sum(e["dur"] for e in kernels) / 1e3 - torch_ms, "top": top[:5]}


def package_kernels() -> set[str]:
    """The names of the package's CUDA kernels (every ``__global__``
    function under ``tiktoken_tpu_torch/csrc``)."""
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiktoken_tpu_torch", "csrc")
    names: set[str] = set()
    for f in os.listdir(csrc):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, f)) as fh:
                names.update(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", fh.read()))
    return names


# (what, call) of the chunk programs that phases 4 and 4b hand to phase
# 9b's traces
CHUNK_TRACES: list = []


def chunk_trace(what: str, fn) -> dict:
    """Three calls of a chunk program (warmed up first) traced with
    ``torch.profiler``: fails unless every CUDA kernel in the trace is one
    of the package's, and unless the trace holds every kernel that the host
    launched in it (its CUDA runtime or driver launch calls, at least one
    an entry call) but the last one: a session may drop the last kernel it
    saw, so a kernel that each call launches is seen at least twice.
    Returns the kernels' count and ms and PyTorch's (``at::``) ms."""
    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.utils.profiling import device_trace

    fn()
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="chunk_trace_")
    try:
        kernels.reset_launches()
        with device_trace(tmp):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        entry_calls = sum(kernels.launches.values())
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name)) as f:
            trace = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    events = [e for e in trace if e.get("cat") == "kernel"]
    host = [e for e in trace if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and ("LaunchKernel" in e["name"] or "LaunchCooperativeKernel" in e["name"])]
    ours = package_kernels()
    foreign = [e["name"] for e in events if "at::" in e["name"]
               or kernel_name(e["name"]).split("<")[0].split("::")[-1] not in ours]
    out = dict(kernels=len(events), launched=len(host), entry_calls=entry_calls,
               ms=sum(e["dur"] for e in events) / 1e3,
               torch_ms=sum(e["dur"] for e in events if "at::" in e["name"]) / 1e3,
               foreign=len(foreign))
    log(f"{what}, three calls traced (torch.profiler): {out['kernels']} CUDA kernels recorded "
        f"of the {len(host)} the host launched from {entry_calls} entry calls, "
        f"{out['ms']:.4f} ms, every one the package's; PyTorch's own (at::) "
        f"{out['torch_ms']:.4f} ms")
    if len(host) < entry_calls or len(events) < len(host) - 1:
        raise RuntimeError(f"{what}: the trace holds {len(events)} kernels and {len(host)} "
                           f"launches from {entry_calls} entry calls")
    if foreign:
        raise RuntimeError(f"{what} ran kernels that are not the package's: {foreign[:5]}")
    return out


def api_phase(enc, all_docs, edge, tokens, offsets, total_bytes: int, card: str,
              launches: dict) -> None:
    """Phase 9: the registry over a local plugin, the registry's encoding on
    the card, special tokens, batches, numpy, decode and pickling at full
    width, and a device trace of one more main-path call."""
    import importlib
    import pickle
    import tempfile

    import tiktoken_tpu_torch
    from tiktoken_tpu_torch import registry
    from tiktoken_tpu_torch.utils import device_trace, engine_report

    if registry._constructors is not None:
        raise RuntimeError("the registry discovered its plugins before phase 9")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_api_")
    try:
        vocab = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                             "bench_vocab2_100000.tiktoken")
        os.makedirs(os.path.join(tmp, "tiktoken_tpu_torch_ext"))
        with open(os.path.join(tmp, "tiktoken_tpu_torch_ext", "bench_local.py"), "w") as f:
            f.write(BENCH_PLUGIN.format(path=vocab))
        sys.path.append(tmp)
        importlib.invalidate_caches()

        # the registry
        names = tiktoken_tpu_torch.list_encoding_names()
        if not set(SHIPPED) | {"bench_o200k"} <= set(names):
            raise RuntimeError(f"list_encoding_names() lacks a name: {names}")
        reg = tiktoken_tpu_torch.get_encoding("bench_o200k")
        if tiktoken_tpu_torch.get_encoding("bench_o200k") is not reg:
            raise RuntimeError("get_encoding gave two objects for one name")
        if tiktoken_tpu_torch.encoding_name_for_model("gpt-4o") != "o200k_base":
            raise RuntimeError("encoding_name_for_model('gpt-4o') is not o200k_base")
        t0 = time.perf_counter()
        reg.warmup()
        log(f"registry: {names}; get_encoding('bench_o200k') is one object; its warmup "
            f"{time.perf_counter() - t0:.2f} s")

        # the registry's encoding on the card
        got, secs = counted("api_v3", launches, lambda: reg.encode_corpus_to_numpy(
            all_docs, device="cuda", strategy="device"))
        bad = same_ids(got, tokens, offsets)
        if bad:
            raise RuntimeError(f"api_v3: ids differ from phase 5's in documents {bad[:10]}")
        log(f"api_v3 (the registry's encoding, strategy='device'): "
            f"{total_bytes / secs / 1e6:.2f} MB/s ({secs:.2f} s); {len(all_docs)} documents "
            f"equal phase 5's ids; {card}")

        # lone surrogates: each encodes as U+FFFD on the device and hybrid routes
        sur_docs = [d[:20_000] + "\ud800" + d[20_000:40_000] + " \udc00\ud800 \ud83d x"
                    for d in all_docs[len(edge) : len(edge) + 48]]
        want_s = [reg.encode_ordinary(d) for d in sur_docs]
        for strategy in ("device", "hybrid"):
            if reg.encode_corpus(sur_docs, device="cuda", strategy=strategy) != want_s:
                raise RuntimeError(f"lone surrogates: strategy={strategy!r} differs from "
                                   "encode_ordinary")
        log(f"lone surrogates: {len(sur_docs)} documents of 40 KB, each with four, equal "
            f"encode_ordinary on strategy='device' and 'hybrid' (its device worker took "
            f"{reg.corpus_report['docs']['device']} of them)")

        def ids(i):
            return tokens[offsets[i] : offsets[i + 1]]

        # special tokens at full width
        eot, eop = reg.encode_single_token("<|endoftext|>"), reg.encode_single_token(
            "<|endofprompt|>")
        picks = list(range(len(edge), len(edge) + 8))
        k = picks[3]
        cut = len(all_docs[k]) // 2
        texts = [all_docs[i] for i in picks]
        texts[3] = all_docs[k][:cut] + "<|endofprompt|>" + all_docs[k][cut:]
        text = "<|endoftext|>".join(texts)
        want = []
        for j, i in enumerate(picks):
            if j:
                want.append(eot)
            if i == k:
                want += reg.encode_ordinary(all_docs[k][:cut]) + [eop] + reg.encode_ordinary(
                    all_docs[k][cut:])
            else:
                want += ids(i).tolist()
        t0 = time.perf_counter()
        if reg.encode(text, allowed_special="all") != want:
            raise RuntimeError("encode(allowed_special='all') differs from the spec")
        secs_sp = time.perf_counter() - t0
        try:
            reg.encode(text)
        except ValueError:
            pass
        else:
            raise RuntimeError("encode() of a text with a special token did not raise")
        if reg.encode(text, disallowed_special=()) != reg.encode_ordinary(text):
            raise RuntimeError("encode(disallowed_special=()) differs from encode_ordinary")
        log(f"special tokens: encode(allowed_special='all') of {len(text.encode())} bytes "
            f"({len(picks)} documents, {len(want)} ids) equals the spec in {secs_sp:.2f} s; "
            f"encode() raises; disallowed_special=() equals encode_ordinary")

        # batch, numpy and decode
        t0 = time.perf_counter()
        batch = reg.encode_batch(all_docs)
        secs_b = time.perf_counter() - t0
        t0 = time.perf_counter()
        ordinary = reg.encode_ordinary_batch(all_docs)
        secs_o = time.perf_counter() - t0
        for name, out in (("encode_batch", batch), ("encode_ordinary_batch", ordinary)):
            bad = [i for i in range(len(all_docs)) if out[i] != ids(i).tolist()]
            if bad:
                raise RuntimeError(f"{name}: ids differ from phase 5's in documents {bad[:10]}")
        log(f"encode_batch {total_bytes / secs_b / 1e6:.2f} MB/s ({secs_b:.2f} s) against "
            f"encode_ordinary_batch {total_bytes / secs_o / 1e6:.2f} MB/s ({secs_o:.2f} s), "
            f"8 threads each, both equal phase 5's ids; {card}")
        for i in picks[:2]:
            if not np.array_equal(reg.encode_to_numpy(all_docs[i]), ids(i)):
                raise RuntimeError(f"encode_to_numpy differs from phase 5's ids (document {i})")
        per_doc = [ids(i) for i in range(len(all_docs))]
        if reg.decode_batch(per_doc) != all_docs:
            raise RuntimeError("decode_batch did not give every document back")
        if reg.decode_bytes_batch(per_doc) != [d.encode() for d in all_docs]:
            raise RuntimeError("decode_bytes_batch did not give every document back")
        for i, d in enumerate(edge):
            toks = ids(i).tolist()
            text_i, offs = reg.decode_with_offsets(toks)
            spec = [min(len(d) - 1, len(reg.decode_bytes(toks[:j]).decode("utf-8", "ignore")))
                    for j in range(len(toks))]
            if text_i != d or offs != spec:
                raise RuntimeError(f"decode_with_offsets fails on edge document {i}")
        log(f"encode_to_numpy equals phase 5's ids on two 1 MB documents; decode_batch and "
            f"decode_bytes_batch give all {len(all_docs)} documents back; decode_with_offsets "
            f"holds on the {len(edge)} edge documents")

        # pickling
        payload = pickle.dumps(reg)
        if len(payload) > 200 or pickle.loads(payload).__dict__ is not reg.__dict__:
            raise RuntimeError("the registry's encoding does not pickle as its name")
        if not enc._engines:
            raise RuntimeError("phase 2's encoding has no CUDA engine to pickle past")
        payload2 = pickle.dumps(enc)
        copy = pickle.loads(payload2)
        got = copy.encode_corpus_to_numpy(edge, device="cuda", strategy="device")
        bad = same_ids(got, tokens[: offsets[len(edge)]], offsets[: len(edge) + 1])
        if bad:
            raise RuntimeError(f"the unpickled encoding's ids differ on edge documents {bad}")
        log(f"pickle: the registry's encoding as its name ({len(payload)} bytes); phase 2's "
            f"encoding whole ({len(payload2)} bytes), its copy's device ids equal phase 5's on "
            f"the {len(edge)} edge documents")

        # a device trace of one more main-path call
        trace_dir = os.path.join(tmp, "trace")
        torch.cuda.synchronize()
        with device_trace(trace_dir):
            t0 = time.perf_counter()
            got = reg.encode_corpus_to_numpy(all_docs, device="cuda", strategy="device")
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        if same_ids(got, tokens, offsets):
            raise RuntimeError("the traced api_v3 call's ids differ from phase 5's")
        tr = trace_summary(trace_dir, traced_s)
        log(f"device trace of api_v3 (torch.profiler): traced {traced_s:.4f} s, untraced "
            f"{secs:.4f} s; device busy share (union of kernel intervals / traced wall time) "
            f"{tr['busy_share']:.4f} ({tr['busy_ms']:.3f} ms busy, {tr['launches']} kernel "
            f"launches: the package's kernels {tr['package_ms']:.3f} ms, PyTorch's own "
            f"{tr['torch_ms']:.3f} ms); {card}")
        log("top kernels by device time: " + "; ".join(
            f"{n[:90]} {ms:.3f} ms / {c} launches" for n, ms, c in tr["top"]))
        log(f"engine_report(phase 2's encoding): {json.dumps(engine_report(enc))}; {card}")
    finally:
        if tmp in sys.path:
            sys.path.remove(tmp)
        shutil.rmtree(tmp, ignore_errors=True)


def hot_bin_grid(device) -> None:
    """``tt_pair_hist`` against ``pair_count.pair_hist`` (exact) at 2^12,
    2^20 and 2^26 bins on rows across several 2048-position tiles: one row
    of a single repeated pair, rows alive only at a few columns whose dead
    stretches cross tile boundaries (and a dead row between alive ones),
    and random rows."""
    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.pair_count import pair_hist

    rng = np.random.default_rng(11)
    B, K = 8, 3 * 4096 + 101
    tokens = rng.integers(0, 100_000, (B, K)).astype(np.int32)
    alive = np.ones((B, K), bool)
    piece_start = rng.random((B, K)) < 0.1
    piece_start[:, 0] = True
    tokens[0] = 7  # one pair, (7, 7), in every column
    piece_start[0, 1:] = False
    alive[1] = False
    alive[1, [5, 4100, 9000, K - 1]] = True
    alive[2] = np.arange(K) % 5000 == 17
    alive[3] = False
    grid = [torch.from_numpy(x).to(device) for x in (tokens, alive, piece_start)]
    for bits in (12, 20, 26):
        got, want = kernels.pair_hist(*grid, bits), pair_hist(*grid, bits)
        if not torch.equal(got, want):
            raise RuntimeError(f"tt_pair_hist differs from plain on the hot-bin grid at 2^{bits} "
                               "bins")
    log(f"hot-bin grid ({B} x {K}, {int(want.sum())} pairs): tt_pair_hist == plain at 2^12, 2^20 "
        "and 2^26 bins")


if __name__ == "__main__":
    sys.exit(main())
