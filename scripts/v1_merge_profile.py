#!/usr/bin/env python3
"""Where the v1 greedy merge (``tt_grid_merge``) spends its time on one NVIDIA GPU.

    python3 scripts/v1_merge_profile.py     # from the repository root

On the v2 kernel-phase chunk of ``chip_smoke.py`` (C=32768 rows, K=256;
its piece starts from the package's ``tt_window_orbit``) it
prints:

1. the work: pieces, merges and pair probes per chunk (a piece of n bytes
   makes n - 1 probes up front and 2 per merge), pieces by length, and the
   mean over groups of g consecutive pieces of the most merges in the
   group, in row order and with the pieces sorted by length;
2. the one-lane-per-piece design that ``csrc/grid_merge.cu`` had before
   (a warp per row, each lane walking its pieces serially over shared
   memory, every probe a serial early-exit loop over the bucket row),
   built here into ``tiktoken_tpu_torch/build/profile/`` from the CUDA
   source below and cut at its phases: the piece heads only; then the
   first probes; then the merge rounds; then the packing (the whole
   kernel);
3. the package's ``tt_grid_merge`` on the same inputs, through its
   wrapper, and the device time of each of its launches
   (``torch.profiler``);
4. the probe floor: as many independent 32-byte reads at random rows of
   the pair table as the chunk makes probes, as a ``torch.take`` of
   random int32 indices (each index at a bucket row's first word) and as
   ``chip_smoke.probe_floor_ms`` (``scripts/floor_kernels.cu``: rows
   hashed from each read's index, no index array; one or two 16-byte
   loads a read); the same reads over the table's first 4 MiB (resident
   in L2);
5. copies of ``csrc/grid_merge.cu`` with other constants, patched as text
   and built here: the least resident blocks per SM of its two merge
   launches (``MINB_SHORT``, ``MINB_WIDE``: register caps), both loads of
   a probe's first sector up front (``ONE_LOAD = false``), all builds
   started together, each held against the package's output and timed.

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
PROFILE_DIR = os.path.join(REPO, "tiktoken_tpu_torch", "build", "profile")
NVCC = ("/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc",
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The design csrc/grid_merge.cu had before the lane-group merge, with a
# `stop` argument: 1 returns after the piece heads (the head count per
# row written), 2 after the first probes (their ranks folded into one
# word per row), 3 after the merge rounds (the survivor counts per row),
# 4 runs the whole kernel.
CUDA_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr uint32_t RANK_MAX = 0xFFFFFFFFu;
constexpr int WARPS = 4;
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
__host__ __device__ inline size_t warp_smem(int K) {
  return (static_cast<size_t>(12) * K + 15) & ~static_cast<size_t>(15); }
__global__ void __launch_bounds__(WARPS * 32) old_kernel(
    const uint32_t* __restrict__ buckets, uint32_t mask, uint32_t seed,
    const uint32_t* __restrict__ byte_to_rank, const uint8_t* __restrict__ rows, int KL,
    const uint8_t* __restrict__ piece_start, const int* __restrict__ n_payload, int C, int K,
    int stop, uint32_t* __restrict__ packed_out, int* __restrict__ counts_out,
    int* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= C) return;
  unsigned char* mine = smem + warp * warp_smem(K);
  uint32_t* tok = reinterpret_cast<uint32_t*>(mine);
  uint32_t* rank = tok + K;
  uint16_t* head = reinterpret_cast<uint16_t*>(rank + K);
  uint16_t* cnt = head + K;
  const long long base = static_cast<long long>(row) * K;
  const uint8_t* ps = piece_start + base;
  const uint8_t* bytes = rows + static_cast<long long>(row) * KL;
  const int nv = min(max(n_payload[row], 0), K);
  int nh = 0;
  for (int c0 = 0; c0 < nv; c0 += 32) {
    const int k = c0 + lane;
    const bool is_head = k < nv && (k == 0 || ps[k]);
    const unsigned m = __ballot_sync(0xffffffffu, is_head);
    if (is_head) head[nh + __popc(m & ((1u << lane) - 1))] = static_cast<uint16_t>(k);
    nh += __popc(m);
  }
  __syncwarp();
  if (stop == 1) { if (lane == 0) counts_out[row] = nh; return; }
  int most = 0;
  uint32_t fold = 0;
  int alive_sum = 0;
  for (int pi = lane; pi < nh; pi += 32) {
    const int h = head[pi];
    int e = h + 1;
    while (e < nv && !ps[e]) ++e;
    uint32_t* t = tok + h;
    uint32_t* r = rank + h;
    int n = e - h;
    for (int i = 0; i < n; ++i) t[i] = __ldg(byte_to_rank + bytes[h + i]);
    for (int i = 0; i + 1 < n; ++i) r[i] = pair_rank(buckets, mask, seed, t[i], t[i + 1]);
    if (stop == 2) { for (int i = 0; i + 1 < n; ++i) fold ^= r[i]; continue; }
    int merges = 0;
    while (n > 1) {
      int k = 0;
      for (int i = 1; i + 1 < n; ++i) if (r[i] < r[k]) k = i;
      const uint32_t merged = r[k];
      if (merged == RANK_MAX) break;
      t[k] = merged;
      for (int i = k + 1; i + 1 < n; ++i) { t[i] = t[i + 1]; r[i] = r[i + 1]; }
      --n; ++merges;
      r[k] = k + 1 < n ? pair_rank(buckets, mask, seed, merged, t[k + 1]) : RANK_MAX;
      if (k > 0) r[k - 1] = pair_rank(buckets, mask, seed, t[k - 1], merged);
    }
    cnt[pi] = static_cast<uint16_t>(n);
    alive_sum += n;
    most = max(most, merges);
  }
  if (stop == 2) { if (fold) atomicXor(reinterpret_cast<unsigned*>(counts_out + row), fold); return; }
  if (stop == 3) { if (alive_sum) atomicAdd(counts_out + row, alive_sum); return; }
  __syncwarp();
  int carry = 0;
  for (int p0 = 0; p0 < nh; p0 += 32) {
    const int pi = p0 + lane;
    const int c = pi < nh ? cnt[pi] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (pi < nh) {
      const int h = head[pi];
      const int off = carry + incl - c;
      for (int i = 0; i < c; ++i) packed_out[base + off + i] = tok[h + i];
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  for (int k = carry + lane; k < K; k += 32) packed_out[base + k] = 0;
  if (lane == 0) counts_out[row] = carry;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) most = max(most, __shfl_xor_sync(0xffffffffu, most, o));
  if (lane == 0 && most > 0) atomicMax(rounds_out, most);
}
}  // namespace
extern "C" int old_grid_merge(const void* buckets, int nb, unsigned seed, const void* b2r,
                              const void* rows, int KL, const void* ps, const void* n_payload,
                              int C, int K, int stop, void* packed, void* counts, void* rounds,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = WARPS * warp_smem(K);
  cudaError_t e = cudaMemsetAsync(rounds, 0, sizeof(int), st);
  if (e == cudaSuccess && stop != 4) e = cudaMemsetAsync(counts, 0, sizeof(int) * C, st);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(old_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  old_kernel<<<(C + WARPS - 1) / WARPS, WARPS * 32, smem, st>>>(
      (const uint32_t*)buckets, (uint32_t)(nb - 1), seed, (const uint32_t*)b2r,
      (const uint8_t*)rows, KL, (const uint8_t*)ps, (const int*)n_payload, C, K, stop,
      (uint32_t*)packed, (int*)counts, (int*)rounds);
  return (int)cudaGetLastError();
}
"""

CSRC = os.path.join(REPO, "tiktoken_tpu_torch", "csrc")
# copies of csrc/grid_merge.cu: name -> (line of the source, its replacement)
VARIANTS = {"two_loads": ("constexpr bool ONE_LOAD = true;", "constexpr bool ONE_LOAD = false;"),
            "short4": ("constexpr int MINB_SHORT = 3;", "constexpr int MINB_SHORT = 4;"),
            "wide3": ("constexpr int MINB_WIDE = 4;", "constexpr int MINB_WIDE = 3;"),
            "wide5": ("constexpr int MINB_WIDE = 4;", "constexpr int MINB_WIDE = 5;")}


def build(name: str, src: str) -> subprocess.Popen:
    os.makedirs(PROFILE_DIR, exist_ok=True)
    return subprocess.Popen([*NVCC, "-I", CSRC, "-o", os.path.join(PROFILE_DIR, name + ".so"),
                             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def variant_src(name: str) -> str:
    """csrc/grid_merge.cu with the variant's one line replaced, written into
    the profile directory (its headers found through -I csrc)."""
    with open(os.path.join(CSRC, "grid_merge.cu")) as f:
        text = f.read()
    old, new = VARIANTS[name]
    if text.count(old) != 1:
        raise RuntimeError(f"csrc/grid_merge.cu does not hold {old!r} once")
    return _write_src(f"grid_merge_{name}.cu", text.replace(old, new))


def ptxas_lines(name: str, log: str) -> None:
    """Each kernel's registers and stack from nvcc's -Xptxas -v report."""
    fn = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "error" in line:
            print(f"  ptxas {name} {fn[:60]}: {line.split(':', 1)[-1].strip()}")


def finish(name: str, proc: subprocess.Popen) -> ctypes.CDLL:
    log, _ = proc.communicate()
    ptxas_lines(name, log)
    if proc.returncode:
        print(log)
        raise RuntimeError(f"nvcc failed for {name}")
    return ctypes.CDLL(os.path.join(PROFILE_DIR, name + ".so"))


def merge_call(eng, docs):
    """The grid_merge call of the v1 program on the v2 kernel-phase chunk
    rows: (args, kwargs, out)."""
    import chip_smoke
    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, pack_documents
    from tiktoken_tpu_torch.ops.pipeline2 import run_rows1

    C = 32768
    sel, n = [], 0
    for d in docs:
        if n >= C:
            break
        sel.append(d.encode())
        n += pack_documents(sel[-1:], DEFAULT_ROW).rows.shape[0]
    b = pack_documents(sel, DEFAULT_ROW)
    rows, pay, tot = eng.upload([b.rows[:C], b.n_payload[:C], b.n_total[:C]])
    calls: list = []
    tb = eng.byte_tables()
    run_rows1(tb, rows, pay, tot, ops=chip_smoke.recording_ops(kernels.KERNEL_OPS, calls))
    (_, args, kwargs, out), = [c for c in calls if c[0] == "grid_merge"]
    return args, kwargs, out, (lambda: run_rows1(tb, rows, pay, tot))


def piece_stats(args) -> dict:
    """Pieces, their lengths and merges (from the plain merge's alive grid),
    probes, and the most merges among g consecutive pieces."""
    from tiktoken_tpu_torch.ops import merge

    buckets, b2r, rows, piece_start, n_payload, seed = args
    C, K = piece_start.shape
    valid = torch.arange(K, device=rows.device)[None, :] < n_payload[:, None]
    heads = valid & piece_start
    heads[:, 0] |= valid[:, 0]
    _tok, alive, _r = merge.merge(buckets, b2r, rows[:, :K], piece_start, valid, seed)
    pid = torch.cumsum(heads.reshape(-1).to(torch.int64), 0) - 1
    v = valid.reshape(-1)
    n = int(heads.sum())
    length = torch.zeros(n, dtype=torch.int64, device=rows.device).scatter_add_(
        0, pid[v], torch.ones_like(pid[v]))
    count = torch.zeros(n, dtype=torch.int64, device=rows.device).scatter_add_(
        0, pid[v], alive.reshape(-1)[v].to(torch.int64))
    merges = length - count
    probes = int((length - 1).sum() + 2 * merges.sum())
    out = dict(pieces=n, bytes=int(length.sum()), merges=int(merges.sum()), probes=probes,
               one_token=float((count == 1).double().mean()), most_merges=int(merges.max()),
               by_length={int(L): int((length == L).sum()) for L in torch.unique(length)})
    order = torch.argsort(length, stable=True)
    for g in (1, 2, 4, 8, 32):
        m = torch.cat([merges, merges.new_zeros((-n) % g)])
        s = torch.cat([merges[order], merges.new_zeros((-n) % g)])
        out[f"max_merges_of_{g}"] = (float(m.view(-1, g).amax(1).double().mean()),
                                     float(s.view(-1, g).amax(1).double().mean()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("v1_merge_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch.ops import kernels

    print("card:", chip_smoke.card_line())
    procs = {"old_grid_merge": build("old_grid_merge", _write_src("old_grid_merge.cu", CUDA_SRC))}
    for name in VARIANTS:
        procs[f"grid_merge_{name}"] = build(f"grid_merge_{name}", variant_src(name))
    floors = chip_smoke.start_floor_build()
    ranks = tiktoken_tpu_torch.load_tiktoken_bpe(
        os.path.join(REPO, "assets", "bench_vocab2_100000.tiktoken"))
    enc = tiktoken_tpu_torch.Encoding("bench_o200k", pat_str=tiktoken_tpu_torch.o200k_pat_str,
                                      mergeable_ranks=ranks,
                                      special_tokens={"<|endoftext|>": len(ranks)})
    eng = enc.engine("cuda")
    args, kwargs, (want_p, want_c, want_r), rows1 = merge_call(
        eng, chip_smoke.bench_docs(chip_smoke.CORPUS_MB))
    buckets, b2r, rows, piece_start, n_payload, seed = args
    C, K = piece_start.shape
    KL = rows.shape[1]

    # 1: the work
    st = piece_stats(args)
    print(f"work per chunk (C={C}, K={K}): {st['pieces']} pieces over {st['bytes']} bytes, "
          f"{st['merges']} merges, {st['probes']} probes; {st['one_token']:.4f} of the pieces "
          f"end in one token; most merges of a piece {st['most_merges']}")
    print("  pieces by length: " + ", ".join(f"{L}: {c}" for L, c in st["by_length"].items()))
    print("  mean over groups of g consecutive pieces of the most merges (row order, sorted by "
          "length): " + ", ".join(f"g={g}: {st[f'max_merges_of_{g}'][0]:.2f}, "
                                   f"{st[f'max_merges_of_{g}'][1]:.2f}" for g in (1, 2, 4, 8, 32)))

    # 2: the old design cut at its phases
    libs = {name: finish(name, p) for name, p in procs.items()}
    old = libs["old_grid_merge"]
    chip_smoke.floor_lib(floors)
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    old.old_grid_merge.argtypes = [P, I, U, P, P, I, P, P, I, I, I, P, P, P, P]
    stream = torch.cuda.current_stream().cuda_stream
    nb = buckets.shape[0]
    packed = torch.empty((C, K), dtype=torch.int32, device="cuda")
    counts = torch.empty(C, dtype=torch.int32, device="cuda")
    rounds = torch.empty((), dtype=torch.int32, device="cuda")

    def run_old(stop):
        err = old.old_grid_merge(P(buckets.data_ptr()), nb, seed, P(b2r.data_ptr()),
                                 P(rows.data_ptr()), KL, P(piece_start.data_ptr()),
                                 P(n_payload.data_ptr()), C, K, stop, P(packed.data_ptr()),
                                 P(counts.data_ptr()), P(rounds.data_ptr()), P(stream))
        if err:
            raise RuntimeError(f"old_grid_merge error {err}")

    run_old(4)
    torch.cuda.synchronize()
    same = (torch.equal(packed, want_p) and torch.equal(counts, want_c)
            and torch.equal(rounds, want_r))
    line = [f"old tt_grid_merge (one lane per piece; equal to the package: {same}), ms:"]
    for stop, label in ((1, "heads"), (2, "+ first probes"), (3, "+ merge rounds"),
                        (4, "+ packing (whole)")):
        line.append(f"{label} {chip_smoke.gpu_ms(lambda: run_old(stop)):.4f};")
    print(" ".join(line))

    # 3: the package's kernel, and its launches
    ptxas_lines("package", kernels.build().ptxas.get("grid_merge", ""))
    new_ms = chip_smoke.gpu_ms(lambda: kernels.grid_merge(*args, **kwargs))
    print(f"package tt_grid_merge: {new_ms:.4f} ms; the v1 program "
          f"{chip_smoke.gpu_ms(rows1, reps=3):.4f} ms")
    from torch.profiler import ProfilerActivity, profile

    kernels.grid_merge(*args, **kwargs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kernels.grid_merge(*args, **kwargs)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    evs = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    evs.sort(key=lambda e: -dev_us(e))
    print(f"package tt_grid_merge by launch (torch.profiler, per call; sum "
          f"{sum(dev_us(e) for e in evs) / 5 / 1e3:.4f} ms):")
    for e in evs:
        print(f"  {dev_us(e) / 5 / 1e3:9.4f} ms  x{e.count // 5:2d}  {e.key[:90]}")

    # 4: the probe floor
    n = st["probes"]
    row_words = buckets.shape[1]
    flat = buckets.reshape(-1)
    g = torch.Generator(device="cuda").manual_seed(5)
    idx = torch.randint(0, nb, (n,), device="cuda", generator=g) * row_words
    small = max(1, (4 << 20) // (row_words * 4))
    idx_small = torch.randint(0, small, (n,), device="cuda", generator=g) * row_words
    take_ms = chip_smoke.gpu_ms(lambda: torch.take(flat, idx))
    take_small_ms = chip_smoke.gpu_ms(lambda: torch.take(flat, idx_small))
    hashed_ms = chip_smoke.probe_floor_ms(buckets, n, loads=2)
    hashed_small_ms = chip_smoke.probe_floor_ms(buckets, n, loads=2, rows=small)
    one_ms = chip_smoke.probe_floor_ms(buckets, n)
    table_mib = buckets.nbytes / 2**20
    print(f"probe floor, {n} random 32-byte reads: torch.take over the {table_mib:.0f} MiB table "
          f"{take_ms:.4f} ms (index array {idx.nbytes / 1e6:.0f} MB), over its first 4 MiB "
          f"{take_small_ms:.4f} ms; hashed rows, no index array, two 16-byte loads a read: "
          f"{hashed_ms:.4f} ms, over 4 MiB {hashed_small_ms:.4f} ms; one 16-byte load a read "
          f"{one_ms:.4f} ms")
    moved, ops = chip_smoke.work_of("grid_merge", args, kwargs, (want_p, want_c, want_r))
    print(f"bound: {moved} bytes over 3.35 TB/s = {moved / chip_smoke.HBM_BYTES_PER_S * 1e3:.5f} "
          f"ms; {ops} operations over 67 T/s = {ops / chip_smoke.INT32_OPS_PER_S * 1e3:.5f} ms")

    # 5: positions per lane: each build in the package's place in turn
    loaded = kernels.build().libs
    package = loaded["grid_merge"]
    times = []
    try:
        for name in VARIANTS:
            lib = libs[f"grid_merge_{name}"]
            for fn, argtypes in kernels._SIGNATURES["grid_merge"].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            loaded["grid_merge"] = lib
            out = kernels.grid_merge(*args, **kwargs)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, (want_p, want_c, want_r))):
                raise RuntimeError(f"the {name} build differs from the package")
            times.append(f"{name}: "
                         f"{chip_smoke.gpu_ms(lambda: kernels.grid_merge(*args, **kwargs)):.4f}")
    finally:
        loaded["grid_merge"] = package
    print("tt_grid_merge built with other constants (equal outputs), ms: "
          + ", ".join(times))
    return 0


def _write_src(name: str, text: str) -> str:
    os.makedirs(PROFILE_DIR, exist_ok=True)
    path = os.path.join(PROFILE_DIR, name)
    with open(path, "w") as f:
        f.write(text)
    return path


if __name__ == "__main__":
    sys.exit(main())
