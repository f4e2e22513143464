#!/usr/bin/env python3
"""Where the slot merges spend their time on one NVIDIA GPU.

    python3 scripts/slot_merge_profile.py     # from the repository root

On the kernel-phase chunks of ``chip_smoke.py`` (v3: C=32768, K=176; v2:
C=32768, K=256, char scanner) it prints:

1. each slot merge's work: slots (the cap and the live count), mean piece
   length, merges and pair probes per live slot, long whole-piece hits;
2. device time by CUDA kernel of one v3 and one v2 chunk program, from
   ``torch.profiler``;
3. the one-thread-per-slot design that ``csrc/slot_merge.cu`` had before
   (each thread walks its piece serially in local memory, zero-fills its
   W lanes of tokens and alive flags over every slot of the cap, and a
   warp-ballot row compaction packs the alive lanes), built here into
   ``tiktoken_tpu_torch/build/profile/`` from the CUDA source below and
   cut at its phases: the first probes only; the merge rounds, no writes;
   the whole kernel; each over the cap (as it was launched) and over the
   live slots only; the row compaction after it, over the cap; and the
   whole kernel over the live slots with the package's probe (the
   bucket row's first 32-byte sector first);
4. the package's ``tt_slot_merge_packed`` and ``tt_assemble`` (the
   per-piece counts and combos folded into the expansion) on the same
   inputs, through its wrappers;
5. ``csrc/slot_merge.cu`` built with other lanes per slot
   (``TT_SLOT_LANES`` 16, 8, 4, 2, 1 for W=16, and 8 with a register cap
   for 6 or 8 resident blocks per SM; ``TT_LONG_SLOT_LANES`` 32, 16, 8, 4
   for W=64), all builds started together, each held against the
   package's output on the same inputs and timed.

Times are CUDA-event medians (``chip_smoke.gpu_ms``). Nothing here is used
by the package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# The design csrc/slot_merge.cu had before the group-of-lanes kernel, with
# a `stop` argument: 1 returns after the first probes, 2 after the merge
# rounds (each writing one word per slot so nothing is optimised out), 3
# runs the whole kernel; and the warp-ballot row compaction that followed
# it in the chunk programs.
CUDA_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr uint32_t RANK_MAX = 0xFFFFFFFFu;
__device__ __forceinline__ uint32_t mix_pair(uint32_t a, uint32_t b, uint32_t seed) {
  a ^= seed; uint32_t h = (a * 0x9E3779B1u) ^ (b + 0x85EBCA6Bu + (a << 6));
  h ^= h >> 15; h *= 0x2C1B3C6Du; h ^= h >> 12; return h; }
__device__ __forceinline__ uint32_t pair_rank(const uint32_t* __restrict__ buckets, uint32_t mask,
                                              uint32_t seed, uint32_t a, uint32_t b) {
  const uint32_t h = mix_pair(a, b, seed) & mask;
  const uint4* row = reinterpret_cast<const uint4*>(buckets + static_cast<long long>(h) * 32);
#pragma unroll
  for (int s = 0; s < 8; ++s) { const uint4 q = __ldg(row + s); if (q.x == a && q.y == b) return q.z; }
  return RANK_MAX; }
// the package's probe: the row's first sector, the rest only past two full slots
__device__ __forceinline__ uint32_t sector_rank(const uint32_t* __restrict__ buckets, uint32_t mask,
                                                uint32_t seed, uint32_t a, uint32_t b) {
  const uint4* row = reinterpret_cast<const uint4*>(buckets) +
                     static_cast<long long>(mix_pair(a, b, seed) & mask) * 8;
  const uint4 q0 = __ldg(row), q1 = __ldg(row + 1);
  if (q0.x == a && q0.y == b) return q0.z;
  if (q0.x == RANK_MAX) return RANK_MAX;
  if (q1.x == a && q1.y == b) return q1.z;
  if (q1.x == RANK_MAX) return RANK_MAX;
  uint4 q[6];
#pragma unroll
  for (int s = 0; s < 6; ++s) q[s] = __ldg(row + 2 + s);
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    if (q[s].x == a && q[s].y == b) return q[s].z;
    if (q[s].x == RANK_MAX) return RANK_MAX;
  }
  return RANK_MAX; }
template <bool SECTOR>
__device__ __forceinline__ uint32_t rank_of(const uint32_t* __restrict__ buckets, uint32_t mask,
                                            uint32_t seed, uint32_t a, uint32_t b) {
  return SECTOR ? sector_rank(buckets, mask, seed, a, b) : pair_rank(buckets, mask, seed, a, b); }
template <int W, bool SECTOR>
__global__ void old_kernel(const uint32_t* __restrict__ buckets, uint32_t mask, uint32_t seed,
                           const uint32_t* __restrict__ byte_to_rank,
                           const uint8_t* __restrict__ slot_bytes, const int* __restrict__ lens,
                           int M, int stop, uint32_t* __restrict__ tok_out,
                           uint8_t* __restrict__ alive_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const long long base = static_cast<long long>(m) * W;
  const int n0 = min(max(lens[m], 0), W);
  uint32_t tok[W]; uint32_t rank[W]; uint8_t lane[W];
  for (int i = 0; i < n0; ++i) { tok[i] = __ldg(byte_to_rank + slot_bytes[base + i]); lane[i] = i; }
  for (int i = 0; i + 1 < n0; ++i) rank[i] = rank_of<SECTOR>(buckets, mask, seed, tok[i], tok[i + 1]);
  if (stop == 1) { uint32_t x = 0; for (int i = 0; i + 1 < n0; ++i) x ^= rank[i];
                   tok_out[base] = x; return; }
  int n = n0;
  while (n > 1) {
    int k = 0;
    for (int i = 1; i + 1 < n; ++i) if (rank[i] < rank[k]) k = i;
    const uint32_t merged = rank[k];
    if (merged == RANK_MAX) break;
    tok[k] = merged;
    for (int i = k + 1; i + 1 < n; ++i) { tok[i] = tok[i + 1]; lane[i] = lane[i + 1]; rank[i] = rank[i + 1]; }
    --n;
    rank[k] = k + 1 < n ? rank_of<SECTOR>(buckets, mask, seed, merged, tok[k + 1]) : RANK_MAX;
    if (k > 0) rank[k - 1] = rank_of<SECTOR>(buckets, mask, seed, tok[k - 1], merged);
  }
  if (stop == 2) { tok_out[base] = n > 0 ? tok[0] + lane[n - 1] : 0u; return; }
  for (int i = 0; i < W; ++i) { tok_out[base + i] = 0; alive_out[base + i] = 0; }
  for (int i = 0; i < n; ++i) { tok_out[base + lane[i]] = tok[i]; alive_out[base + lane[i]] = 1; }
}
__global__ void compact_rows_kernel(const uint8_t* __restrict__ valid, const int* __restrict__ vals,
                                    int M, int W, int seg, int* __restrict__ out,
                                    int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long m = warp * (32 / seg) + lane / seg;
  const int sl = lane % seg;
  const unsigned seg_bits = (seg == 32 ? 0xffffffffu : (1u << seg) - 1) << (lane / seg * seg);
  const bool row_ok = m < M;
  const long long base = m * W;
  int c = 0;
  for (int c0 = 0; c0 < W; c0 += seg) {
    const int col = c0 + sl;
    const bool v = row_ok && col < W && valid[base + col];
    const unsigned b = __ballot_sync(0xffffffffu, v) & seg_bits;
    if (v) out[base + c + __popc(b & ((1u << lane) - 1))] = vals[base + col];
    c += __popc(b);
  }
  if (!row_ok) return;
  for (int col = c + sl; col < W; col += seg) out[base + col] = 0;
  if (sl == 0) counts[m] = c;
}
}  // namespace
#define OLD_ARGS (const uint32_t*)buckets, nb - 1, seed, (const uint32_t*)b2r, \
    (const uint8_t*)slot_bytes, (const int*)lens, M, stop, (uint32_t*)tok, (uint8_t*)alive
extern "C" int old_slot_merge(int W, const void* buckets, int nb, unsigned seed, const void* b2r,
                              const void* slot_bytes, const void* lens, int M, int stop,
                              int sector, void* tok, void* alive, void* stream) {
  const int tpb = W == 16 ? 128 : 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
  const unsigned g = (M + tpb - 1) / tpb;
  if (W == 16 && sector) old_kernel<16, true><<<g, tpb, 0, st>>>(OLD_ARGS);
  else if (W == 16) old_kernel<16, false><<<g, tpb, 0, st>>>(OLD_ARGS);
  else if (sector) old_kernel<64, true><<<g, tpb, 0, st>>>(OLD_ARGS);
  else old_kernel<64, false><<<g, tpb, 0, st>>>(OLD_ARGS);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int old_compact_rows(const void* valid, const void* vals, int M, int W, void* out,
                                void* counts, void* stream) {
  const int seg = (W < 32 && 32 % W == 0) ? W : 32;
  const long long warps = (static_cast<long long>(M) + 32 / seg - 1) / (32 / seg);
  compact_rows_kernel<<<(unsigned)((warps * 32 + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      (const uint8_t*)valid, (const int*)vals, M, W, seg, (int*)out, (int*)counts);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_lib() -> ctypes.CDLL:
    out = os.path.join(REPO, "tiktoken_tpu_torch", "build", "profile")
    os.makedirs(out, exist_ok=True)
    src, so = os.path.join(out, "old_slot_merge.cu"), os.path.join(out, "old_slot_merge.so")
    with open(src, "w") as f:
        f.write(CUDA_SRC)
    nvcc = "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc"
    res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src],
                         capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas:", line.strip())
    if res.returncode:
        raise RuntimeError("nvcc failed")
    lib = ctypes.CDLL(so)
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.old_slot_merge.argtypes = [I, P, I, U, P, P, P, I, I, I, P, P, P]
    lib.old_compact_rows.argtypes = [P, P, I, I, P, P, P]
    return lib


# (lanes per slot, least resident blocks per SM) by slot width
LANES = {16: ((16, 1), (8, 1), (8, 6), (8, 8), (4, 1), (2, 1), (1, 1)),
         64: ((32, 1), (16, 1), (8, 1), (4, 1))}


def build_lane_variants() -> dict:
    """{(W, G, B): the ``tt_slot_merge_packed`` of ``csrc/slot_merge.cu``
    built with G lanes per W-byte slot and at least B resident blocks per
    SM}, one nvcc each, started together."""
    out = os.path.join(REPO, "tiktoken_tpu_torch", "build", "profile")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(REPO, "tiktoken_tpu_torch", "csrc", "slot_merge.cu")
    nvcc = "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc"
    procs = {}
    for W, lanes in LANES.items():
        for G, B in lanes:
            so = os.path.join(out, f"slot_merge_w{W}_g{G}_b{B}.so")
            macro = "TT_SLOT_LANES" if W == 16 else "TT_LONG_SLOT_LANES"
            procs[W, G, B] = so, subprocess.Popen(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-D{macro}={G}",
                 f"-DTT_SLOT_MIN_BLOCKS={B}", "-o", so, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (W, G, B), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log)
            raise RuntimeError(f"nvcc failed for W={W} G={G} B={B}")
        # ptxas -v: the register and stack lines of this width's kernel
        fn, info = "", []
        for ln in log.splitlines():
            if "Compiling entry function" in ln or "Function properties for" in ln:
                fn = ln
            elif f"slot_merge_packed_kernelILi{W}E" in fn and ("registers" in ln or "stack" in ln):
                info.append(ln.split(":", 1)[-1].strip())
        print(f"  built W={W} G={G} B={B}: {'; '.join(info)}")
        lib = ctypes.CDLL(so)
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.tt_slot_merge_packed.argtypes = [I, P, I, U, P, P, P, I, P, P, P, P, P]
        libs[W, G, B] = lib
    return libs


def merge_calls(eng, docs):
    """The slot merges and piece counts of one v3 and one v2 (char) chunk
    program, as (program, name, args, kwargs, out)."""
    import chip_smoke
    from tiktoken_tpu_torch.ops import kernels, pipeline3
    from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, pack_documents
    from tiktoken_tpu_torch.ops.pipeline2 import run_chunk2

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
    out, programs = [], {}
    for prog, run in (("v3", lambda ops: pipeline3.run_chunk(eng.tables, *ins3, K=K, ops=ops)),
                      ("v2", lambda ops: run_chunk2(eng.tables, *ins2, ops=ops))):
        calls: list = []
        run(chip_smoke.recording_ops(kernels.KERNEL_OPS, calls))
        programs[prog] = lambda run=run: run(kernels.KERNEL_OPS)
        out += [(prog, *c) for c in calls if c[0] in ("slot_merge_packed", "assemble")]
    return out, programs


def main() -> int:
    if not torch.cuda.is_available():
        print("slot_merge_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.slot_merge import slot_merge

    print("card:", chip_smoke.card_line())
    ranks = tiktoken_tpu_torch.load_tiktoken_bpe(
        os.path.join(REPO, "assets", "bench_vocab2_100000.tiktoken"))
    enc = tiktoken_tpu_torch.Encoding("bench_o200k", pat_str=tiktoken_tpu_torch.o200k_pat_str,
                                      mergeable_ranks=ranks,
                                      special_tokens={"<|endoftext|>": len(ranks)})
    eng = enc.engine("cuda")
    t = eng.tables
    calls, programs = merge_calls(eng, chip_smoke.bench_docs(chip_smoke.CORPUS_MB))

    # 1: the work
    merges = [c for c in calls if c[1] == "slot_merge_packed"]
    for prog, _name, args, kwargs, (tok_p, count) in merges:
        slot_bytes, lens, n_real = args[2], args[3], args[5]
        hit = kwargs.get("hit")
        M, W = slot_bytes.shape
        n = min(int(n_real), M)
        L = lens[:n].to(torch.int64)
        n_hit = int((hit[:n] != -1).sum()) if hit is not None else 0
        merging = torch.ones(n, dtype=torch.bool, device=L.device) if hit is None else hit[:n] == -1
        Lm = torch.where(merging, L, 0)
        mg = int((Lm - torch.where(merging, count[:n].to(torch.int64), 0)).sum())
        probes = int((Lm - 1).clamp(min=0).sum()) + 2 * mg
        print(f"{prog} W={W}: {M} slots, {n} live ({n_hit} whole-piece hits); mean length "
              f"{float(Lm.sum()) / max(int(merging.sum()), 1):.2f}, merges {mg}, probes {probes} "
              f"({probes / max(int(merging.sum()), 1):.2f} a merging slot)")

    # 2: device time by kernel
    from torch.profiler import ProfilerActivity, profile

    for prog, fn in programs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()

        def dev_us(e):
            return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

        evs = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
        evs.sort(key=lambda e: -dev_us(e))
        total = sum(dev_us(e) for e in evs) / 5 / 1e3
        print(f"{prog} chunk program: device time by kernel, per chunk (sum {total:.4f} ms, "
              f"{sum(e.count for e in evs) // 5} launches):")
        for e in evs[:30]:
            print(f"  {dev_us(e) / 5 / 1e3:9.4f} ms  x{e.count // 5:3d}  {e.key[:100]}")

    # 3, 4: the one-thread-per-slot design cut at its phases, and the package's kernels
    lib = build_lib()
    P = ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    nb = t.pair_buckets.shape[0]
    for prog, _name, args, kwargs, _out in merges:
        slot_bytes, lens, n_real = args[2], args[3], args[5]
        hit = kwargs.get("hit")
        M, W = slot_bytes.shape
        n = min(int(n_real), M)
        # the old glue's lengths: zero past the count and for the long hits
        L = torch.where(torch.arange(M, device=lens.device) < n, lens, 0)
        if hit is not None:
            L = torch.where(hit != -1, 0, L)
        L = L.contiguous()
        tok = torch.empty((M, W), dtype=torch.int32, device="cuda")
        alive = torch.empty((M, W), dtype=torch.uint8, device="cuda")
        packed = torch.empty((M, W), dtype=torch.int32, device="cuda")
        cnt = torch.empty(M, dtype=torch.int32, device="cuda")

        def old(stop, rows, sector=0):
            err = lib.old_slot_merge(W, P(t.pair_buckets.data_ptr()), nb, t.pair_seed,
                                     P(t.byte_to_rank.data_ptr()), P(slot_bytes.data_ptr()),
                                     P(L.data_ptr()), rows, stop, sector, P(tok.data_ptr()),
                                     P(alive.data_ptr()), P(stream))
            if err:
                raise RuntimeError(f"old_slot_merge error {err}")

        old(3, M)
        torch.cuda.synchronize()
        want_tok, want_alive = slot_merge(t.pair_buckets, t.byte_to_rank, slot_bytes, L,
                                          t.pair_seed)
        same = torch.equal(alive.bool(), want_alive) and torch.equal(tok, want_tok)
        line = [f"{prog} W={W} one thread per slot (equal to plain: {same}), ms:"]
        for stop, label in ((1, "first probes"), (2, "+ merge rounds"), (3, "whole")):
            line.append(f"{label} over the cap {chip_smoke.gpu_ms(lambda: old(stop, M)):.4f}, "
                        f"live slots only {chip_smoke.gpu_ms(lambda: old(stop, n)):.4f};")

        def compact():
            err = lib.old_compact_rows(P(alive.data_ptr()), P(tok.data_ptr()), M, W,
                                       P(packed.data_ptr()), P(cnt.data_ptr()), P(stream))
            if err:
                raise RuntimeError(f"old_compact_rows error {err}")

        old(3, M)
        line.append(f"row compaction over the cap {chip_smoke.gpu_ms(compact):.4f};")
        line.append(f"whole, live slots only, with the package's sector-first probe "
                    f"{chip_smoke.gpu_ms(lambda: old(3, n, 1)):.4f}")
        print(" ".join(line))
        new_ms = chip_smoke.gpu_ms(lambda: kernels.slot_merge_packed(*args, **kwargs))
        print(f"{prog} W={W} tt_slot_merge_packed (group of lanes per slot, left-packed, live "
              f"slots only): {new_ms:.4f} ms")
    # 5: lanes per slot
    libs = build_lane_variants()
    for prog, _name, args, kwargs, (want_tok, want_cnt) in merges:
        slot_bytes, lens, n_real = args[2], args[3], args[5]
        hit = kwargs.get("hit")
        M, W = slot_bytes.shape
        n = min(int(n_real), M)
        below = torch.arange(W, device="cuda")[None, :] < want_cnt[:n, None]
        times = []
        for G, B in LANES[W]:
            tok = torch.empty((M, W), dtype=torch.int32, device="cuda")
            cnt = torch.empty(M, dtype=torch.int32, device="cuda")

            def run(lib=libs[W, G, B], tok=tok, cnt=cnt):
                err = lib.tt_slot_merge_packed(
                    W, P(t.pair_buckets.data_ptr()), nb, t.pair_seed,
                    P(t.byte_to_rank.data_ptr()), P(slot_bytes.data_ptr()), P(lens.data_ptr()),
                    M, P(n_real.data_ptr()), P(None if hit is None else hit.data_ptr()),
                    P(tok.data_ptr()), P(cnt.data_ptr()), P(stream))
                if err:
                    raise RuntimeError(f"tt_slot_merge_packed error {err}")

            run()
            torch.cuda.synchronize()
            same = (torch.equal(cnt[:n], want_cnt[:n])
                    and torch.equal(torch.where(below, tok[:n], 0),
                                    torch.where(below, want_tok[:n], 0)))
            if not same:
                raise RuntimeError(f"{prog} W={W} with {G} lanes per slot differs from the package")
            times.append(f"{G} lanes{f' (>= {B} blocks/SM)' if B > 1 else ''} "
                         f"{chip_smoke.gpu_ms(run):.4f}")
        print(f"{prog} W={W} tt_slot_merge_packed by lanes per slot (equal outputs), ms: "
              + ", ".join(times))
    for prog, _name, args, kwargs, _out in calls:
        if _name == "assemble":
            ms = chip_smoke.gpu_ms(lambda: kernels.assemble(*args, **kwargs))
            print(f"{prog} tt_assemble over {int(args[0])} of {args[1].shape[0]} catalog "
                  f"entries: {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
