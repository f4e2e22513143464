#!/usr/bin/env python3
"""The v1 front end (B11-B12: the window scan, the orbit and the row
flags) and the chunk's assembly (the per-piece counts and the expansion)
on one NVIDIA GPU: where the two-launch designs spend their time, and the
package's fused entries against them, in turns.

    python3 scripts/redesign_times.py OLD_ROOT   # from the repository root

OLD_ROOT is a tree whose ``tiktoken_tpu_torch/csrc`` still holds the
designs that the fused entries replaced (``tt_window_scan`` then
``tt_orbit`` in ``byte_scan.cu``; ``tt_piece_counts`` in ``slot_merge.cu``
then ``tt_expand_tokens_rows`` in ``compaction.cu``): the commit before
them, unpacked with ``git archive`` into a directory under ``build/``.
Its sources are built here into ``tiktoken_tpu_torch/build/profile/``,
whole and as copies patched as text, and called through ctypes.

On the v2 kernel-phase chunk of ``chip_smoke.py`` (C=32768 rows, K=256,
the bench vocabulary's byte-level o200k table), on its first 128 rows
(the chunk of the sharded v2's v1 re-runs) and on a chunk of the edge
documents (over the window scan's u_cap) it prints:

1. the front end's work: the table reads (one a walk step: every
   position walks until its match dies or W=48 bytes), their share from
   the hot states, the mean over warps of 32 neighbouring positions of
   the longest walk (the old window scan's chain), the same capped at
   W1=16 steps and summed per lane over a row's positions 32 apart (the
   fused entry's chain), the positions alive after 16 bytes, and the
   orbit's length per row;
2. the old design cut at its phases: the whole window scan, its walks
   without the stores of ``hop`` and ``unresolved``, its stores without
   the walks, the orbit, the orbit without its memset and the memset
   alone;
3. where the package has the fused entry (``kernels.window_orbit``): the
   old pair and the fused entry in turns (old, new, new, old) on each
   chunk, each held against the plain version first; then, on the
   32768-row chunk, copies of the package's ``csrc/byte_scan.cu`` cut at
   the fused entry's phases (no orbit, no walk, no chunk-wide cap) and
   patched to other geometries (its ``WO_MAX_WARPS``, ``WO_MAX_ROWS``),
   and the package's entry with no hot rows in shared memory;
4. where the package has the fused assembly (``kernels.assemble``): on
   the v3 and v2 kernel-phase chunks, the old ``tt_piece_counts`` +
   ``tt_expand_tokens_rows`` and the fused entry in turns, the token
   stream and the row counts held equal first; then copies of the
   package's ``csrc/compaction.cu`` with tiles of 2048 and 1024 pieces;
5. one JSON line of the numbers.

Times are CUDA-event medians (``chip_smoke.gpu_ms``). Nothing here is used
by the package.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PROFILE_DIR = os.path.join(REPO, "tiktoken_tpu_torch", "build", "profile")
NVCC = ("/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc",
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v")
W, W1 = 48, 16

# copies of OLD_ROOT's csrc/byte_scan.cu: name -> [(text, its replacement)]
FRONT_VARIANTS = {
    "old_byte_scan": [],
    # the walks and the u_cap pass, no store of hop and unresolved (a store
    # that never runs keeps the walk)
    "old_nostore": [("    hop_out[i] = hop;\n    unresolved[i] = alive;\n",
                     "    if (hop < -1000) hop_out[i] = hop + alive;\n")],
    # the stores and the u_cap pass, no walk
    "old_nowalk": [("    for (int o = 0; o < W; ++o) {\n      const int q = col + o;",
                    "    for (int o = 0; o < 0; ++o) {\n      const int q = col + o;")],
    # the orbit without its memset, and the memset alone
    "old_nomemset": [("  cudaError_t e = cudaMemsetAsync(piece_start, 0, static_cast<size_t>(C) * K, st);\n"
                      "  if (e != cudaSuccess) return static_cast<int>(e);\n", "")],
    "old_memsetonly": [("  orbit_kernel<<<blocks_of(C, 128), 128, 0, st>>>(", "  if (0) orbit_kernel<<<1, 1, 0, st>>>(")],
}


def build(name: str, src_path: str, include: str) -> subprocess.Popen:
    os.makedirs(PROFILE_DIR, exist_ok=True)
    return subprocess.Popen([*NVCC, "-I", include, "-o",
                             os.path.join(PROFILE_DIR, name + ".so"), src_path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def patched(csrc: str, src: str, name: str, edits) -> str:
    """csrc/src with each (text, replacement) made, written into the
    profile directory."""
    with open(os.path.join(csrc, src)) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{src} does not hold {old!r} once")
        text = text.replace(old, new)
    os.makedirs(PROFILE_DIR, exist_ok=True)
    path = os.path.join(PROFILE_DIR, name + ".cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def finish(name: str, proc: subprocess.Popen) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode:
        print(log)
        raise RuntimeError(f"nvcc failed for {name}")
    for line in log.splitlines():
        if "registers" in line:
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")
    return ctypes.CDLL(os.path.join(PROFILE_DIR, name + ".so"))


P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class OldFrontEnd:
    """OLD_ROOT's tt_window_scan + tt_orbit from one built library."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        lib.tt_window_scan.argtypes = [P, I, I, P, I, P, I, I, I, I, LL, P, P, P, P]
        lib.tt_orbit.argtypes = [P, P, P, I, I, P, P, P]
        lib.tt_window_scan.restype = lib.tt_orbit.restype = ctypes.c_int

    def outputs(self, rows, K):
        C = rows.shape[0]
        d = rows.device
        return dict(hop=torch.empty((C, K), dtype=torch.int32, device=d),
                    unres=torch.empty((C, K), dtype=torch.bool, device=d),
                    counter=torch.empty((), dtype=torch.int64, device=d),
                    mask=torch.empty((C, K), dtype=torch.bool, device=d),
                    bad=torch.empty(C, dtype=torch.bool, device=d))

    def window(self, packed, rows, n_total, K, o):
        C, KL = rows.shape
        u_cap = max(128, C * K // 32)
        err = self.lib.tt_window_scan(packed.data_ptr(), packed.shape[0], packed.shape[1],
                                      rows.data_ptr(), KL, n_total.data_ptr(), C, K, W, W1, u_cap,
                                      o["hop"].data_ptr(), o["unres"].data_ptr(),
                                      o["counter"].data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tt_window_scan: CUDA error {err}")

    def orbit(self, n_payload, o):
        C, K = o["hop"].shape
        err = self.lib.tt_orbit(o["hop"].data_ptr(), o["unres"].data_ptr(), n_payload.data_ptr(),
                                C, K, o["mask"].data_ptr(), o["bad"].data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tt_orbit: CUDA error {err}")

    def both(self, packed, rows, n_payload, n_total, K, o):
        self.window(packed, rows, n_total, K, o)
        self.orbit(n_payload, o)
        return o["mask"], o["bad"]


# copies of the package's csrc/byte_scan.cu with other most warps a block
# and rows a warp of tt_window_orbit (the package's are 32 and 4)
GEOMETRIES = {f"warps{w}_rows{r}": [("constexpr int WO_MAX_WARPS = 32;",
                                     f"constexpr int WO_MAX_WARPS = {w};"),
                                    ("constexpr int WO_MAX_ROWS = 4;",
                                     f"constexpr int WO_MAX_ROWS = {r};")]
              for w, r in ((8, 1), (8, 2), (8, 4), (8, 8), (16, 4), (32, 1), (32, 2), (32, 8))}
# copies of the package's csrc/compaction.cu with smaller tiles (items a
# thread; the package's are 16, 4096 items a tile)
TILE_VARIANTS = {f"tile{256 * n}": [("constexpr int IPT = 16;", f"constexpr int IPT = {n};")]
                 for n in (8, 4)}
# copies of the package's csrc/byte_scan.cu cut at tt_window_orbit's
# phases: no orbit; no walk (every hop 4, so every orbit takes K/4 steps);
# no chunk-wide cap at the end
FUSED_CUTS = {
    "fused_noorbit": [("    if (lane < nr) {\n      const long long r = r0 + lane;",
                       "    if (lane < nr && r0 < 0) {\n      const long long r = r0 + lane;")],
    "fused_nowalk": [("      n_alive += static_cast<unsigned>(__reduce_add_sync(\n"
                      "          0xffffffffu, walk_lane(hot_s, packed, hot, rb, end, K, W1, "
                      "hops + k * HS)));",
                      "      for (int p = lane; p < K; p += 32) hops[k * HS + p] = 4;")],
    "fused_notail": [("  if (!two_phase) return;", "  return;")],
}


def fused_variant(lib: ctypes.CDLL):
    """A call of a built copy's tt_window_orbit, as kernels.window_orbit
    makes it: (packed, hot, rows, n_payload, n_total, K) -> (mask,
    row_bad)."""
    from tiktoken_tpu_torch.ops import kernels

    lib.tt_window_orbit.argtypes = kernels._SIGNATURES["byte_scan"]["tt_window_orbit"]
    lib.tt_window_orbit.restype = ctypes.c_int

    def call(packed, hot, rows, pay, tot, K):
        C, KL = rows.shape
        mask = torch.empty((C, K), dtype=torch.bool, device=rows.device)
        bad = torch.empty(C, dtype=torch.bool, device=rows.device)
        err = lib.tt_window_orbit(packed.data_ptr(), packed.shape[0], packed.shape[1], hot,
                                  rows.data_ptr(), C, KL, K, pay.data_ptr(), tot.data_ptr(), W, W1,
                                  max(128, C * K // 32), mask.data_ptr(), bad.data_ptr(),
                                  kernels._scratch(rows.device),
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tt_window_orbit (a built copy): CUDA error {err}")
        return mask, bad

    return call


def front_work(packed, hot: int, rows, n_payload, n_total, K: int) -> dict:
    """The walks' table reads and chains, the positions alive after W1
    bytes and the orbit's length, from a lockstep walk on the card."""
    from tiktoken_tpu_torch.ops.window_scan import ACC_BITS, DEAD, START, byte_class_grid, orbit, \
        window_scan

    C = rows.shape[0]
    cls = byte_class_grid(rows, n_total, K + W)
    flat = packed.reshape(-1)
    nc = packed.shape[1]
    state = torch.full((C, K), START, dtype=torch.int64, device=rows.device)
    alive = torch.ones((C, K), dtype=torch.bool, device=rows.device)
    steps = torch.zeros((C, K), dtype=torch.int64, device=rows.device)
    hot_reads = 0
    alive_w1 = 0
    for o in range(W):
        steps += alive
        hot_reads += int((alive & (state < hot)).sum())
        v = flat[state * nc + cls[:, o: o + K]].to(torch.int64)
        state = torch.where(alive, v >> ACC_BITS, state)
        alive &= state != DEAD
        if o == W1 - 1:
            alive_w1 = int(alive.sum())
    reads = int(steps.sum())
    warp_max = steps.view(C, K // 32, 32).amax(dim=2).double().mean()
    capped = steps.clamp(max=W1)
    lane_sum = capped.view(C, K // 32, 32).sum(dim=1)  # lane l: positions l, l + 32, ...
    hop, unres = window_scan(packed, rows, n_total, K=K, window=W)
    mask, _ = orbit(hop, unres, n_payload)
    orb = mask.sum(dim=1).double()
    return dict(positions=C * K, table_reads=reads, hot_share=hot_reads / max(reads, 1),
                mean_steps=reads / (C * K), warp_chain_old=float(warp_max),
                lane_chain_fused=float(lane_sum.amax(dim=1).double().mean()),
                alive_after_w1=alive_w1, u_cap=max(128, C * K // 32),
                orbit_mean=float(orb.mean()), orbit_max=int(orb.max()))


class OldAssembly:
    """OLD_ROOT's tt_piece_counts (slot_merge.cu) then tt_expand_tokens_rows
    (compaction.cu)."""

    def __init__(self, slot_lib: ctypes.CDLL, comp_lib: ctypes.CDLL):
        self.slot, self.comp = slot_lib, comp_lib
        slot_lib.tt_piece_counts.argtypes = [I, P, P, P, P, P, P, P, P, I, P, I, P, P, P]
        comp_lib.tt_expand_tokens_rows.argtypes = [P, P, LL, P, LL, P, LL, LL, P, I, I, P, P, P,
                                                   P, P]
        comp_lib.tt_scratch_words.argtypes = [LL, LL]
        slot_lib.tt_piece_counts.restype = comp_lib.tt_expand_tokens_rows.restype = ctypes.c_int
        comp_lib.tt_scratch_words.restype = ctypes.c_int
        self.bufs = None

    def run(self, args, kwargs):
        """The old design on the fused entry's arguments -> (tokens, total,
        row counts)."""
        (n_pieces, lens, hit, words, b2r, mslot, lslot, m_count, l_count, m_tok, l_tok, starts,
         row_bad) = args[:13]
        p, C, t_cap = lens.shape[0], row_bad.shape[0], kwargs["t_cap"]
        d = lens.device
        if self.bufs is None or self.bufs[0].shape[0] != p or self.bufs[2].shape[0] != t_cap:
            words_n = self.comp.tt_scratch_words(p, 4 * C)
            self.bufs = (torch.empty(p, dtype=torch.int32, device=d),
                         torch.empty(p, dtype=torch.int32, device=d),
                         torch.empty(t_cap, dtype=torch.int32, device=d),
                         torch.empty((), dtype=torch.int32, device=d),
                         torch.empty(C, dtype=torch.int32, device=d),
                         torch.empty(words_n, dtype=torch.int64, device=d))
        counts, combo, tok, total, rows, scratch = self.bufs
        st = torch.cuda.current_stream().cuda_stream
        err = self.slot.tt_piece_counts(
            p, n_pieces.data_ptr(), lens.data_ptr(), hit.data_ptr(), words.data_ptr(),
            b2r.data_ptr(), mslot.data_ptr(), lslot.data_ptr(), m_count.data_ptr(),
            m_count.shape[0], l_count.data_ptr(), l_count.shape[0], counts.data_ptr(),
            combo.data_ptr(), st)
        err = err or self.comp.tt_expand_tokens_rows(
            counts.data_ptr(), combo.data_ptr(), p, m_tok.data_ptr(), m_tok.numel(),
            l_tok.data_ptr(), l_tok.numel(), t_cap, starts.data_ptr(), kwargs["K"], C,
            tok.data_ptr(), total.data_ptr(), rows.data_ptr(), scratch.data_ptr(), st)
        if err:
            raise RuntimeError(f"the old assembly: CUDA error {err}")
        return tok, total, rows


def assembly_calls(eng, docs, chip_smoke) -> dict:
    """The fused assembly's arguments on the v3 (C=32768, K=176) and v2
    (C=32768, K=256, char scanner) kernel-phase chunks of chip_smoke.py."""
    from tiktoken_tpu_torch.ops import kernels, pipeline3
    from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, pack_documents
    from tiktoken_tpu_torch.ops.pipeline2 import run_chunk2

    C, K = 32768, pipeline3.K_DEFAULT
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
    out = {}
    for prog, run in (("v3", lambda ops: pipeline3.run_chunk(eng.tables, *ins3, K=K, ops=ops)),
                      ("v2", lambda ops: run_chunk2(eng.tables, *ins2, ops=ops))):
        calls: list = []
        run(chip_smoke.recording_ops(kernels.KERNEL_OPS, calls))
        (_, args, kwargs, _), = [c for c in calls if c[0] == "assemble"]
        out[prog] = (args, kwargs)
    return out


def assemble_variant(lib: ctypes.CDLL):
    """A call of a built copy's tt_assemble, as kernels.assemble makes it:
    (args, kwargs) -> (tokens, header)."""
    from tiktoken_tpu_torch.ops import kernels

    lib.tt_assemble.argtypes = kernels._SIGNATURES["compaction"]["tt_assemble"]
    lib.tt_assemble.restype = ctypes.c_int
    lib.tt_scratch_words.argtypes = [LL, LL]
    lib.tt_scratch_words.restype = ctypes.c_int

    def call(args, kwargs):
        (n_pieces, lens, hit, words, b2r, mslot, lslot, m_count, l_count, m_tok, l_tok, starts,
         row_bad, n_miss, n_long, na_flag) = args
        p, C, t_cap = lens.shape[0], row_bad.shape[0], kwargs["t_cap"]
        d = lens.device
        tok = torch.empty(t_cap, dtype=torch.int32, device=d)
        header = torch.empty(2 * C + (5 if kwargs["full"] else 2), dtype=torch.int32, device=d)
        scratch = torch.empty(lib.tt_scratch_words(p, 4 * C), dtype=torch.int64, device=d)
        err = lib.tt_assemble(
            n_pieces.data_ptr(), lens.data_ptr(), hit.data_ptr(), words.data_ptr(),
            b2r.data_ptr(), mslot.data_ptr(), lslot.data_ptr(), p, m_count.data_ptr(),
            m_count.shape[0], l_count.data_ptr(), l_count.shape[0], m_tok.data_ptr(),
            l_tok.data_ptr(), t_cap, starts.data_ptr(), kwargs["K"], row_bad.data_ptr(), C,
            n_miss.data_ptr(), n_long.data_ptr(), None if na_flag is None else na_flag.data_ptr(),
            kwargs["p_limit"], kwargs["t_limit"], int(kwargs["full"]), tok.data_ptr(),
            header.data_ptr(), scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"tt_assemble (a built copy): CUDA error {err}")
        return tok, header

    return call


def turns(old_fn, new_fn) -> list[float]:
    import chip_smoke

    return [chip_smoke.gpu_ms(f) for f in (old_fn, new_fn, new_fn, old_fn)]


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__)
        return 2
    old_root = os.path.abspath(sys.argv[1])
    if not torch.cuda.is_available():
        print("redesign_times: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, pack_documents
    from tiktoken_tpu_torch.ops.window_scan import orbit, window_scan

    card = chip_smoke.card_line()
    print("card:", card)
    old_csrc = os.path.join(old_root, "tiktoken_tpu_torch", "csrc")
    procs = {name: build(name, patched(old_csrc, "byte_scan.cu", name, edits), old_csrc)
             for name, edits in FRONT_VARIANTS.items()}
    if hasattr(kernels, "assemble"):
        for src in ("slot_merge", "compaction"):
            procs[f"old_{src}"] = build(f"old_{src}", os.path.join(old_csrc, f"{src}.cu"), old_csrc)
        for name, edits in TILE_VARIANTS.items():
            procs[name] = build(name, patched(kernels.CSRC, "compaction.cu", name, edits),
                                kernels.CSRC)
    if hasattr(kernels, "window_orbit"):
        for name, edits in {**FUSED_CUTS, **GEOMETRIES}.items():
            procs[name] = build(name, patched(kernels.CSRC, "byte_scan.cu", name, edits),
                                kernels.CSRC)

    built = kernels.build()
    for name in ("byte_scan", "compaction", "scan_rows"):
        for line in built.ptxas.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas package {name}: {line.strip()}")
    enc = chip_smoke.bench_encoding()
    eng = enc.engine("cuda")
    docs = chip_smoke.bench_docs(12)
    C = 32768
    sel, n = [], 0
    for d in docs:
        if n >= C:
            break
        sel.append(d.encode())
        n += pack_documents(sel[-1:], DEFAULT_ROW).rows.shape[0]
    b = pack_documents(sel, DEFAULT_ROW)
    big = eng.upload([b.rows[:C], b.n_payload[:C], b.n_total[:C]])
    edge = pack_documents([x.encode() for x in chip_smoke.edge_docs()], DEFAULT_ROW)
    chunks = {"32768": big, "128": [x[:128] for x in big],
              "edge": eng.upload([edge.rows[:128], edge.n_payload[:128], edge.n_total[:128]])}
    tb = eng.byte_tables()
    packed, hot = tb.byte_scan, tb.byte_hot
    K = DEFAULT_ROW
    libs = {name: OldFrontEnd(finish(name, procs[name])) for name in FRONT_VARIANTS}
    out = {"card": card, "hot_states": hot, "states": packed.shape[0]}

    # 1: the work
    for name, (rows, pay, tot) in chunks.items():
        w = front_work(packed, hot, rows, pay, tot, K)
        out[f"work_{name}"] = w
        print(f"front end work, {name}: {json.dumps(w)}")

    # 2: the old design cut at its phases
    rows, pay, tot = big
    plain = orbit(*window_scan(packed, rows, tot, K=K, window=W), pay)
    old = libs["old_byte_scan"]
    o = old.outputs(rows, K)
    got = old.both(packed, rows, pay, tot, K, o)
    if not all(torch.equal(a, b_) for a, b_ in zip(got, plain)):
        raise RuntimeError("the old front end differs from the plain version")
    cut = {}
    for name in ("old_byte_scan", "old_nostore", "old_nowalk"):
        lib = libs[name]
        cut[f"window_{name}"] = chip_smoke.gpu_ms(lambda: lib.window(packed, rows, tot, K, o))
    for name in ("old_byte_scan", "old_nomemset", "old_memsetonly"):
        lib = libs[name]
        cut[f"orbit_{name}"] = chip_smoke.gpu_ms(lambda: lib.orbit(pay, o))
    cut["both"] = chip_smoke.gpu_ms(lambda: old.both(packed, rows, pay, tot, K, o))
    out["old_cut_32768"] = cut
    print(f"old front end cut at its phases (32768 rows, ms): {json.dumps(cut)}")

    # 3: the fused entry in turns with the old pair
    if hasattr(kernels, "window_orbit"):
        for name, (rows, pay, tot) in chunks.items():
            o = old.outputs(rows, K)
            want = orbit(*window_scan(packed, rows, tot, K=K, window=W), pay)
            new = kernels.window_orbit(packed, rows, pay, tot, K=K, window=W, hot=hot)
            got_old = old.both(packed, rows, pay, tot, K, o)
            for g, what in ((new, "fused"), (got_old, "old")):
                if not all(torch.equal(a, b_) for a, b_ in zip(g, want)):
                    raise RuntimeError(f"{what} front end differs from plain on chunk {name}")
            t = turns(lambda: old.both(packed, rows, pay, tot, K, o),
                      lambda: kernels.window_orbit(packed, rows, pay, tot, K=K, window=W, hot=hot))
            out[f"front_turns_{name}"] = t
            print(f"front end, chunk {name} (rows over u_cap: {int(want[1].sum())}): old / fused / "
                  f"fused / old ms {t}")
        # the fused entry's phases and knobs on the 32768-row chunk: warps a
        # block, rows a warp, the hot states in shared memory or not
        rows, pay, tot = big
        want = orbit(*window_scan(packed, rows, tot, K=K, window=W), pay)
        knobs = {}
        for name in FUSED_CUTS:
            call = fused_variant(finish(name, procs[name]))
            knobs[name] = chip_smoke.gpu_ms(lambda: call(packed, hot, rows, pay, tot, K))

        for name in GEOMETRIES:
            vlib = finish(name, procs[name])
            call = fused_variant(vlib)
            if not all(torch.equal(a, b_) for a, b_ in zip(call(packed, hot, rows, pay, tot, K),
                                                           want)):
                raise RuntimeError(f"the fused front end built {name} differs from plain")
            knobs[name] = chip_smoke.gpu_ms(lambda: call(packed, hot, rows, pay, tot, K))
        knobs["package"] = chip_smoke.gpu_ms(
            lambda: kernels.window_orbit(packed, rows, pay, tot, K=K, window=W, hot=hot))
        knobs["no_hot_rows"] = chip_smoke.gpu_ms(
            lambda: kernels.window_orbit(packed, rows, pay, tot, K=K, window=W, hot=0))
        out["fused_knobs_32768"] = knobs
        print(f"fused front end phases and geometries (32768 rows, ms; by the most warps a block "
              f"and rows a warp; the package: 32 and 4, {hot} hot states): "
              f"{json.dumps(knobs)}")
    # 4: the fused assembly in turns with the old piece counts + expansion
    if hasattr(kernels, "assemble"):
        asm = OldAssembly(finish("old_slot_merge", procs["old_slot_merge"]),
                          finish("old_compaction", procs["old_compaction"]))
        variant_libs: dict = {}
        for prog, (args, kwargs) in assembly_calls(eng, docs, chip_smoke).items():
            tok, header = kernels.assemble(*args, **kwargs)
            o_tok, o_total, o_rows = asm.run(args, kwargs)
            nt = int(header[-2])
            n_rows = args[12].shape[0]
            if not (nt == int(o_total) and torch.equal(tok[:nt], o_tok[:nt])
                    and torch.equal(header[:n_rows], o_rows)):
                raise RuntimeError(f"the fused assembly differs from the old design ({prog})")
            t = turns(lambda: asm.run(args, kwargs), lambda: kernels.assemble(*args, **kwargs))
            out[f"assembly_turns_{prog}"] = t
            for name in TILE_VARIANTS:
                if name not in variant_libs:
                    variant_libs[name] = finish(name, procs[name])
                call = assemble_variant(variant_libs[name])
                v_tok, v_header = call(args, kwargs)
                if not (torch.equal(v_header, header) and torch.equal(v_tok[:nt], tok[:nt])):
                    raise RuntimeError(f"the assembly built {name} differs from the package's")
                out[f"assembly_{name}_{prog}"] = chip_smoke.gpu_ms(lambda: call(args, kwargs))
            print(f"assembly, {prog}, smaller tiles (ms): " + json.dumps(
                {name: out[f"assembly_{name}_{prog}"] for name in TILE_VARIANTS}))
            print(f"assembly, {prog} chunk ({int(args[0])} of {args[1].shape[0]} catalog entries "
                  f"live, {nt} tokens): old (tt_piece_counts + tt_expand_tokens_rows) / fused / "
                  f"fused / old ms {t}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
