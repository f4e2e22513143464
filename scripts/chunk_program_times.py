#!/usr/bin/env python3
"""Device time of one chunk program per path, for comparing two trees.

    python3 scripts/chunk_program_times.py [ROOT]

Imports ``tiktoken_tpu_torch`` from ROOT (default: this repository), builds
its kernels there, and times with CUDA events (``chip_smoke.gpu_ms``) the
kernel-phase chunks of ``chip_smoke.py``: one v3 chunk (C=32768, K=176) and
one v2 chunk (C=32768, K=256) under the char and the byte scanner, and the
v1 program on the same rows; and ``tt_grid_merge`` on the first 128 of
those rows (the chunk size of the sharded v2's overflow re-runs), by CUDA
events and on the host clock (the mean of 200 calls made back to back,
enqueue included). Prints one JSON line {"root", "card", "v3", "v2",
"v2_byte", "v1", "grid_merge_128", "grid_merge_128_host"} in ms. Run a
parent tree unpacked under ``build/`` and this one in turns inside one call
(parent, change, change, parent) to compare them on one card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else REPO
    sys.path.insert(0, REPO)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("chunk_program_times: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch.ops import kernels, pipeline3
    from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, pack_documents
    from tiktoken_tpu_torch.ops.pipeline2 import run_chunk2, run_rows1

    if not tiktoken_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {tiktoken_tpu_torch.__file__}, not from {root}")
    ranks = tiktoken_tpu_torch.load_tiktoken_bpe(
        os.path.join(REPO, "assets", "bench_vocab2_100000.tiktoken"))
    enc = tiktoken_tpu_torch.Encoding("bench_o200k", pat_str=tiktoken_tpu_torch.o200k_pat_str,
                                      mergeable_ranks=ranks,
                                      special_tokens={"<|endoftext|>": len(ranks)})
    eng = enc.engine("cuda")
    docs = chip_smoke.bench_docs(12)
    C = 32768
    K = pipeline3.K_DEFAULT
    KP, KL = pipeline3.row_geometry(K)
    S = -(-(C * KP + KL + 8) // 128) * 128
    sel, size = [], 0
    for d in docs:
        if size >= C * K * 1.1:
            break
        sel.append(d.encode())
        size += len(sel[-1])
    ins3 = eng.upload(pipeline3.chunk_inputs3(pipeline3.pack_corpus3(sel, K), 0, C - 1, C, S)[0])
    sel, n = [], 0
    for d in docs:
        if n >= C:
            break
        sel.append(d.encode())
        n += pack_documents(sel[-1:], DEFAULT_ROW).rows.shape[0]
    b = pack_documents(sel, DEFAULT_ROW)
    ins2 = eng.upload([b.rows[:C], b.n_payload[:C], b.n_total[:C]])
    tb = eng.byte_tables()
    out = {"root": root, "card": chip_smoke.card_line(),
           "v3": chip_smoke.gpu_ms(lambda: pipeline3.run_chunk(eng.tables, *ins3, K=K), reps=5),
           "v2": chip_smoke.gpu_ms(lambda: run_chunk2(eng.tables, *ins2), reps=5),
           "v2_byte": chip_smoke.gpu_ms(lambda: run_chunk2(tb, *ins2, scanner="byte"), reps=5),
           "v1": chip_smoke.gpu_ms(lambda: run_rows1(tb, *ins2), reps=3)}
    calls: list = []
    run_rows1(tb, *(x[:128] for x in ins2), ops=chip_smoke.recording_ops(kernels.KERNEL_OPS, calls))
    (_, args, kwargs, _), = [c for c in calls if c[0] == "grid_merge"]
    out["grid_merge_128"] = chip_smoke.gpu_ms(lambda: kernels.grid_merge(*args, **kwargs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        kernels.grid_merge(*args, **kwargs)
    torch.cuda.synchronize()
    out["grid_merge_128_host"] = (time.perf_counter() - t0) / 200 * 1e3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
