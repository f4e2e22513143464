#!/usr/bin/env python3
"""Time the sharded engine across processes over the visible GPUs.

    python3 scripts/xproc_times.py            # from the repository root

Runs ``chip_smoke.py``'s phase 10 (``xproc_phase``) alone, after building
what it is held against: the bench encoding on ``cuda:0``, phase 5's v3
ids of the 64 MB corpus and its edge documents (``strategy="device"``),
phase 8's pair histogram. Then 2 ranks and, where there are 4 GPUs, 4
ranks: over NCCL with rank r on ``cuda:r``, or with fewer GPUs than ranks
every rank on ``cuda:0`` over gloo. Each run checks every rank's ids,
rows and histogram as phase 10 does. Prints the card line and, last, one
JSON line: MB/s, seconds and each rank's host-clock phases per rank
count, with the one-process v3 call's MB/s on ``cuda:0`` beside them.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("xproc_times: CUDA is not available", file=sys.stderr)
        return 1
    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.parallel import corpus_pair_counts

    card = cs.card_line()
    cs.log(f"card: {card}")
    kernels.build()
    enc = cs.bench_encoding()
    enc.warmup()
    eng = enc.engine("cuda")
    all_docs = cs.edge_docs() + cs.bench_docs(cs.CORPUS_MB)
    total_bytes = sum(len(d.encode("utf-8")) for d in all_docs)
    stats0 = dict(eng.stats)
    t0 = time.perf_counter()
    tokens, offsets = enc.encode_corpus_to_numpy(all_docs, device="cuda", strategy="device")
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    fallback_docs = eng.stats["fallback_docs"] - stats0["fallback_docs"]
    cs.log(f"one process, cuda:0: {total_bytes / one_s / 1e6:.2f} MB/s ({one_s:.3f} s); "
           f"{fallback_docs} host fallbacks")
    hist = corpus_pair_counts([torch.device("cuda", 0)], *cs.feed_grid(tokens, offsets))[0]
    words = cs.random_words(400_000, seed=11)
    runs = {}
    for n_ranks in (2, 4):
        if n_ranks > 2 and torch.cuda.device_count() < n_ranks:
            continue
        launches: dict = {}
        got = cs.xproc_phase(enc, eng, all_docs, tokens, offsets, fallback_docs, words, hist,
                             launches, n_ranks=n_ranks)
        runs[n_ranks] = {**got, "launches": {p: launches[p]["kernels"] for p in launches}}
    print(card)
    print(json.dumps({"one_process_mb_s": total_bytes / one_s / 1e6, "bytes": total_bytes,
                      "gpus": torch.cuda.device_count(), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
