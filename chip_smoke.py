#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure exits non-zero; no phase's failure is caught):

1. the card's name and power limit; the build of the four CUDA kernels;
2. the bench vocabulary (assets/bench_vocab2_100000.tiktoken, 100,000
   ranks) with the o200k split pattern, its tables built and uploaded;
3. a seeded 64 MB synthetic corpus (the bench corpus recipe), cut into
   1 MB documents, plus edge documents;
4. per kernel, on one real chunk of that corpus at C=32768 rows, K=176:
   every entry point against its plain PyTorch version on the same
   inputs (integers, so exact equality), timed with CUDA events; then
   the whole chunk program with the kernels and with the plain versions;
5. the main path: ``Encoding.encode_corpus_to_numpy`` over the corpus on
   ``cuda``, with every kernel's launch count read around it;
6. every document decodes back to its bytes; the edge documents and four
   1 MB documents equal the host ``encode_ordinary``.

Before the last line it prints the card line and one JSON ``kernels``
line; the last line is ``{"ok": true, "device": {...}}``. Exits non-zero
without a result when CUDA is not available or the package is missing.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CORPUS_MB = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
INT32_OPS_PER_S = 67e12  # float32 non-tensor rate, as the 32-bit ALU proxy
KERNEL_OF = {
    "scan_rows": "scan_rows", "scan_validate": "scan_rows",
    "catalog": "compaction", "compact": "compaction", "compact_rows": "compaction",
    "route_right": "compaction", "expand_tokens": "compaction",
    "vocab_hit": "vocab_hit", "long_vocab_hit": "vocab_hit",
    "slot_merge": "slot_merge",
}
REPLACES = {
    "scan_rows": "tiktoken_tpu/ops/sweep_scan.py:233; tiktoken_tpu/ops/charclass.py:215; "
                 "tiktoken_tpu/ops/pipeline3.py:306; tiktoken_tpu/ops/pipeline3.py:410",
    "compaction": "tiktoken_tpu/ops/compaction.py:78; tiktoken_tpu/ops/compaction.py:164; "
                  "tiktoken_tpu/ops/pipeline3.py:327",
    "vocab_hit": "tiktoken_tpu/ops/pieces.py:354; tiktoken_tpu/ops/pieces.py:205",
    "slot_merge": "tiktoken_tpu/ops/slot_merge.py:62",
}
JAX_FUNCTIONS = {
    "scan_rows": ["pipeline3.row_gather", "charclass.make_byte_classes_fn",
                  "sweep_scan.make_char_scan_fn(handshake=True)",
                  "pipeline3 handshake validation"],
    "compaction": ["compaction.compact", "compaction.expand", "pipeline3.route_right",
                   "pipeline3 catalog lengths, too-long flags and word padding",
                   "pipeline3 slot prefix sums and token fetch"],
    "vocab_hit": ["pieces.make_vocab_hit_fn", "pieces.make_long_vocab_hit_fn"],
    "slot_merge": ["slot_merge.make_slot_merge_fn(W=16)", "slot_merge.make_slot_merge_fn(W=64)"],
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

    return SimpleNamespace(**{name: wrap(name) for name in KERNEL_OF})


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


def work_of(name, args, out) -> tuple[int, int]:
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
    elif name == "compact":
        valid, payloads, _ = args
        moved = valid.numel() + nbytes(outs) + sum(
            touched(valid, p[0].numel() * p.element_size()) for p in payloads)
        ops = valid.numel()
    elif name == "compact_rows":
        valid, vals = args
        moved = valid.numel() + touched(valid, vals.element_size()) + nbytes(outs)
        ops = valid.numel()
    elif name == "route_right":
        dst, values, _ = args
        moved = dst.nbytes + touched(dst >= 0, values.element_size()) + nbytes(outs)
        ops = dst.numel()
    elif name == "expand_tokens":
        counts, combo = args[:2]
        fetched = int(counts[combo >= 0].sum())  # tokens read back from the merges
        moved = nbytes([counts, combo]) + 4 * fetched + nbytes(outs)
        ops = counts.numel() + int(out[1])
    elif name in ("vocab_hit", "long_vocab_hit"):
        buckets, words, lens = args[:3]
        live = lens > 0
        row = buckets.shape[1] * 4
        moved = (touched(live, words[0].numel() * words.element_size()) + lens.nbytes
                 + nbytes(outs) + min(int(live.sum()) * row, buckets.nbytes))
        ops = int(live.sum()) * buckets.shape[1]
    elif name == "slot_merge":
        buckets, b2r, slot_bytes, lens = args[:4]
        _, alive = out
        L = lens.clamp(min=0).to(torch.int64)
        merges = L - alive.sum(dim=1)
        probes = int((L - 1).clamp(min=0).sum() + 2 * merges.sum())
        moved = (touched(lens > 0, slot_bytes.shape[1]) + nbytes([lens, b2r]) + nbytes(outs)
                 + min(probes * 128, buckets.nbytes))
        ops = probes * 8
    else:
        raise KeyError(name)
    return moved, ops


def library_call(name, args, out):
    """One PyTorch call computing the core of the entry point, where
    there is one, and whether it waits for the host (nonzero and
    masked_select read their count back)."""
    if name == "catalog":
        rows, mask3 = args[0], args[1]
        C, KP = mask3.shape
        flat_idx = (torch.arange(C, device=rows.device)[:, None] * rows.shape[1]
                    + torch.arange(KP, device=rows.device)[None, :]).to(torch.int32).reshape(-1)
        m = mask3.reshape(-1)
        return (lambda: torch.index_select(flat_idx, 0, torch.nonzero(m).squeeze(1))), True
    if name == "compact":
        valid, payloads = args[0], args[1]
        return (lambda: [torch.index_select(p, 0, torch.nonzero(valid).squeeze(1))
                         for p in payloads]), True
    if name == "compact_rows":
        valid, vals = args
        return (lambda: torch.masked_select(vals, valid)), True
    if name == "route_right":
        dst, values, out_size = args
        ok = dst >= 0
        return (lambda: torch.zeros(out_size, dtype=values.dtype, device=values.device).index_put_(
            (dst.clamp(min=0).to(torch.int64),), torch.where(ok, values, 0))), False
    if name == "expand_tokens":
        counts, combo = args[:2]
        total = int(out[1])
        return (lambda: torch.repeat_interleave(combo, counts, output_size=total)), False
    return None, False


def kernel_phase(enc, docs, device="cuda", C: int = 32768) -> dict:
    """Each kernel entry point on one real chunk vs its plain version."""
    from tiktoken_tpu_torch.ops import kernels, pipeline3

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
    for wc in (False, True):
        for lo in range(0, len(pe.row_off), Ce - 1):
            ins = eng.upload(pipeline3.chunk_inputs3(pe, lo, Ce - 1, Ce, Se)[0])
            tk, hk_ = pipeline3.run_chunk(eng.tables, *ins, K=K, worst_case=wc)
            tp, hp_ = pipeline3.run_chunk(eng.tables, *ins, K=K, worst_case=wc,
                                          ops=kernels.PLAIN_OPS)
            n = int(hk_[-2])
            if not (torch.equal(hk_, hp_) and torch.equal(tk[:n], tp[:n])):
                raise RuntimeError(f"edge chunk {lo} (worst_case={wc}): kernels and "
                                   "plain versions disagree")
    log("edge documents: chunk program with kernels == plain, normal and worst-case caps")
    chunk_ms = gpu_ms(lambda: pipeline3.run_chunk(eng.tables, *dev_inputs, K=K), reps=5)
    log(f"chunk program C={C} K={K}: kernels == plain (n_pieces={hk[-5]} "
        f"n_miss={hk[-4]} n_long={hk[-3]} n_tokens={nt}); device time with the "
        f"kernels {chunk_ms:.3f} ms")

    per = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_bound_ms=0.0, ops_bound_ms=0.0,
                   library_ms=None, max_abs_err=0, match=True, entries=[])
           for k in kernels.KERNELS}
    for name, args, kwargs, out in calls:
        kname = KERNEL_OF[name]
        k_fn = getattr(kernels.KERNEL_OPS, name)
        p_fn = getattr(kernels.PLAIN_OPS, name)
        want = flatten(p_fn(*args, **kwargs))
        got = flatten(out)
        err = 0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape:
                raise RuntimeError(f"{name}: shape {tuple(g.shape)} vs plain {tuple(w.shape)}")
            d = (g.to(torch.int64) - w.to(torch.int64)).abs()
            err = max(err, int(d.max()) if d.numel() else 0)
        ms = gpu_ms(lambda: k_fn(*args, **kwargs))
        plain_ms = wall_ms(lambda: p_fn(*args, **kwargs))
        moved, ops = work_of(name, args, out)
        b_ms, o_ms = moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        lib, syncs = library_call(name, args, out)
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
        e["entries"].append(dict(entry=name, ms=ms, plain_ms=plain_ms,
                                 bound_ms=max(b_ms, o_ms), library_ms=lib_ms, err=err))
        log(f"  {name:15s} err={err} ms={ms:.4f} plain_ms={plain_ms:.2f} "
            f"bound_ms={max(b_ms, o_ms):.4f} library_ms={lib_ms}")
    for k, e in per.items():
        if not e["match"]:
            raise RuntimeError(f"kernel {k} disagrees with its plain version "
                               f"(max abs err {e['max_abs_err']})")
        if not e["entries"]:
            raise RuntimeError(f"kernel {k} did not run in the chunk program")
    return per, chunk_ms


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch.ops import kernels

    # ---- 1: card and kernel build ------------------------------------------
    card = card_line()
    log(f"card: {card}")
    libs = kernels.build()
    log(f"kernels built in {libs.build_seconds:.1f} s")
    for name, report in sorted(libs.ptxas.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---- 2: vocabulary and tables ------------------------------------------
    t0 = time.perf_counter()
    ranks = tiktoken_tpu_torch.load_tiktoken_bpe(
        os.path.join(repo, "assets", "bench_vocab2_100000.tiktoken"))
    enc = tiktoken_tpu_torch.Encoding(
        "bench_o200k", pat_str=tiktoken_tpu_torch.o200k_pat_str, mergeable_ranks=ranks,
        special_tokens={"<|endoftext|>": len(ranks)},
    )
    eng = enc.engine("cuda")
    torch.cuda.synchronize()
    log(f"vocab {len(ranks)} ranks; tables built and uploaded in "
        f"{time.perf_counter() - t0:.1f} s; {eng.vocab_report}")

    # ---- 3: corpus ---------------------------------------------------------
    t0 = time.perf_counter()
    docs = bench_docs(CORPUS_MB)
    edge = [CJK * 40, "x" * 9000, "1a" * 600, CJK, CYR * 30, ARABIC * 25]
    all_docs = edge + docs
    total_bytes = sum(len(d.encode("utf-8")) for d in all_docs)
    log(f"corpus: {len(docs)} documents of 1 MB + {len(edge)} edge documents, "
        f"{total_bytes} bytes, built in {time.perf_counter() - t0:.1f} s")

    # ---- 4: every kernel against its plain version -------------------------
    per, chunk_ms = kernel_phase(enc, docs)

    # ---- 5: the main path --------------------------------------------------
    stats0 = dict(eng.stats)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tokens, offsets = enc.encode_corpus_to_numpy(all_docs, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launches)
    run = {k: eng.stats[k] - stats0[k] for k in eng.stats}
    log(f"main path: {total_bytes / secs / 1e6:.2f} MB/s ({secs:.2f} s, {len(tokens)} tokens); "
        f"chunks {run['chunks']}, worst-case re-runs {run['worst_case_chunks']}, "
        f"fallback documents {run['fallback_docs']}; launches {launches}")
    log("main path host-clock phases (s): " + ", ".join(
        f"{k}={v:.3f}" for k, v in eng.timing.items()))
    busy = (run["chunks"] + run["worst_case_chunks"]) * chunk_ms / 1e3
    log(f"device busy share of the main path: about {busy / secs:.3f} "
        f"({run['chunks'] + run['worst_case_chunks']} chunk programs x {chunk_ms:.3f} ms)")
    for k in kernels.KERNELS:
        if launches[k] <= 0:
            raise RuntimeError(f"kernel {k} was not launched on the main path")
    if run["worst_case_chunks"] <= 0 or run["fallback_docs"] <= 0:
        raise RuntimeError("the edge documents took neither the worst-case re-run "
                           "nor the host fallback")

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

    rows = []
    for k in kernels.KERNELS:
        e = per[k]
        rows.append(dict(
            name=k, route="cuda", source=f"tiktoken_tpu_torch/csrc/{k}.cu",
            replaces=REPLACES[k], jax_functions=JAX_FUNCTIONS[k], launches=launches[k],
            max_abs_err=e["max_abs_err"], match=e["match"], ms=e["ms"],
            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by="bytes" if e["bytes_bound_ms"] >= e["ops_bound_ms"] else "operations",
            library_ms=e["library_ms"],
        ))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
