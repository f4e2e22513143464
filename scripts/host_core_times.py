#!/usr/bin/env python3
"""Time the port's host-side phases on this machine's CPU (no GPU needed).

    python3 scripts/host_core_times.py          # from the repository root

On ``chip_smoke.py``'s 64 MB corpus (the bench corpus in 1 MB documents
plus its edge documents) with the 100,000-rank bench vocabulary and the
o200k pattern, median of three runs each:

- v3's row cutter: ``pack_corpus3`` with the native cutter
  (``native.pack_cuts3``) and with the numpy spec (``_doc_cuts_np``);
- v2's row walk, ``pack_documents`` (numpy, as in the JAX package);
- the native host core's ``encode_ordinary_batch_arrays`` at 1, 2, 4, ...
  threads up to ``os.cpu_count()``, in MB/s;
- the cold costs: the native core's g++ build (into a temporary build
  directory), the byte-level DFA's compile (in a temporary cache) and the
  core's construction.

Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def median_s(fn, rounds: int = 3) -> float:
    vals = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        vals.append(time.perf_counter() - t0)
    return statistics.median(vals)


def main() -> int:
    with tempfile.TemporaryDirectory() as cache, tempfile.TemporaryDirectory() as build:
        os.environ["TIKTOKEN_TPU_CACHE_DIR"] = cache
        print(json.dumps(measure(build)))
    return 0


def measure(build_dir: str) -> dict:
    import chip_smoke
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch import native
    from tiktoken_tpu_torch.ops import pipeline3
    from tiktoken_tpu_torch.ops.artifacts import cached_scanner_dfa
    from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, pack_documents

    docs = chip_smoke.bench_docs(chip_smoke.CORPUS_MB)
    edge = [chip_smoke.CJK * 40, "x" * 9000, "1a" * 600, chip_smoke.CJK, chip_smoke.CYR * 30,
            chip_smoke.ARABIC * 25]
    texts = edge + docs
    data = [t.encode() for t in texts]
    total = sum(len(d) for d in data)
    out: dict = {"corpus_bytes": total, "documents": len(texts), "cpu_count": os.cpu_count()}

    native.BUILD_DIR = build_dir
    t0 = time.perf_counter()
    native.load_library()
    out["native_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cached_scanner_dfa(tiktoken_tpu_torch.o200k_pat_str)
    out["byte_dfa_compile_s"] = time.perf_counter() - t0
    ranks = tiktoken_tpu_torch.load_tiktoken_bpe(
        os.path.join(REPO, "assets", "bench_vocab2_100000.tiktoken"))
    enc = tiktoken_tpu_torch.Encoding("bench_o200k", pat_str=tiktoken_tpu_torch.o200k_pat_str,
                                      mergeable_ranks=ranks,
                                      special_tokens={"<|endoftext|>": len(ranks)})
    t0 = time.perf_counter()
    core = enc._core_bpe.native_core()
    out["native_core_init_s"] = time.perf_counter() - t0

    utf8 = [True] * len(data)
    out["pack3_native_s"] = median_s(lambda: pipeline3.pack_corpus3(data, utf8=utf8))
    out["pack3_numpy_s"] = median_s(lambda: pipeline3.pack_corpus3(data, utf8=[False] * len(data)))
    out["pack2_numpy_s"] = median_s(lambda: pack_documents(data, DEFAULT_ROW), rounds=1)
    threads, n = [], 1
    while n < (os.cpu_count() or 1):
        threads.append(n)
        n *= 2
    threads.append(os.cpu_count() or 1)
    out["native_mb_s"] = {t: total / median_s(lambda: core.encode_ordinary_batch_arrays(texts, t))
                          / 1e6 for t in threads}
    return out


if __name__ == "__main__":
    sys.exit(main())
