#!/usr/bin/env python3
"""Where the training step's pair histogram (``tt_pair_hist``) spends its
time on one NVIDIA GPU.

    python3 scripts/pair_hist_profile.py     # from the repository root

On the feed of ``chip_smoke.py``'s phase 8 (the v3 ids of its 64 MB corpus,
one document per row: 70 rows of up to 166,794 tokens, a piece start at
each row's front, 2^20 bins) it prints:

1. the feed: positions, pairs, distinct bins, the hottest bin's count,
   and the mean number of distinct bins among 32 consecutive pairs;
2. the device time of each launch of the package's ``tt_pair_hist``
   (``torch.profiler``);
3. the three-pass design that ``csrc/pair_count.cu`` had before (a
   memset, tile summaries of the first alive column, a warp per row
   scanning them, and a pass that hashes each pair and adds one to its bin
   with ``atomicAdd``), built here into ``tiktoken_tpu_torch/build/profile/``
   from the CUDA source below, each launch timed alone; its last pass
   also with the ``atomicAdd`` replaced by a plain store at the same
   address, and with no histogram access at all;
4. the atomic floor: one ``atomicAdd`` per pair on the feed's bins
   (computed beforehand by the plain ``pair_count.pair_bins``) into a
   2^20-bin table, by ``chip_smoke.atomic_floor_ms``
   (``scripts/floor_kernels.cu``), in the feed's order, shuffled, and for
   as many uniform random bins (no hot bin); and ``index_add_`` of the
   feed's bins, a yardstick the package never calls;
5. the package's ``tt_pair_hist`` through its wrapper, beside its bound.

Times are CUDA-event medians (``chip_smoke.gpu_ms``). Nothing here is used
by the package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PROFILE_DIR = os.path.join(REPO, "tiktoken_tpu_torch", "build", "profile")

# The three-pass design of csrc/pair_count.cu before the redesign, each
# pass its own entry; the last pass takes `mode`: 0 atomicAdd (as it
# was), 1 a plain store at the same address, 2 no histogram access (the
# bins folded into a word that is almost never stored).
CUDA_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr int TPB = 256, IPT = 8, TILE = TPB * IPT, NWARP = TPB / 32;
constexpr unsigned FULL = 0xffffffffu;
__device__ __forceinline__ uint32_t mix_pair(uint32_t a, uint32_t b, uint32_t seed) {
  a ^= seed; uint32_t h = (a * 0x9E3779B1u) ^ (b + 0x85EBCA6Bu + (a << 6));
  h ^= h >> 15; h *= 0x2C1B3C6Du; h ^= h >> 12; return h; }
__device__ __forceinline__ int first_alive(const uint8_t* row, int col0, int K, uint8_t* a) {
  int first = K;
#pragma unroll
  for (int i = IPT - 1; i >= 0; --i) {
    const int c = col0 + i;
    a[i] = c < K ? row[c] : 0;
    if (a[i]) first = c;
  }
  return first;
}
__global__ void tile_first_kernel(const uint8_t* __restrict__ alive, int K, int nt,
                                  int* __restrict__ tile_first) {
  __shared__ int warp_min[NWARP];
  const long long tile = blockIdx.x;
  const long long b = tile / nt;
  const int t = static_cast<int>(tile % nt);
  uint8_t a[IPT];
  int v = first_alive(alive + b * K, t * TILE + threadIdx.x * IPT, K, a);
  v = __reduce_min_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = warp_min[0];
    for (int w = 1; w < NWARP; ++w) m = min(m, warp_min[w]);
    tile_first[tile] = m;
  }
}
__global__ void tile_next_kernel(const int* __restrict__ tile_first, int B, int K, int nt,
                                 int* __restrict__ tile_next) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  const int* f = tile_first + row * nt;
  int* out = tile_next + row * nt;
  int carry = K;
  for (int base = ((nt - 1) / 32) * 32; base >= 0; base -= 32) {
    const int t = base + lane;
    int v = t < nt ? f[t] : K;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(FULL, v, o);
      if (lane + o < 32) v = min(v, y);
    }
    int after = __shfl_down_sync(FULL, v, 1);
    if (lane == 31) after = K;
    if (t < nt) out[t] = min(after, carry);
    carry = min(carry, __shfl_sync(FULL, v, 0));
  }
}
__global__ void pair_hist_kernel(const uint32_t* __restrict__ tokens,
                                 const uint8_t* __restrict__ alive,
                                 const uint8_t* __restrict__ piece_start, int K, int nt,
                                 const int* __restrict__ tile_next, uint32_t mask, int mode,
                                 int* __restrict__ hist) {
  __shared__ int warp_min[NWARP];
  const long long tile = blockIdx.x;
  const long long rbase = tile / nt * K;
  const int col0 = static_cast<int>(tile % nt) * TILE + threadIdx.x * IPT;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  uint8_t a[IPT];
  int v = first_alive(alive + rbase, col0, K, a);
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(FULL, v, o);
    if (lane + o < 32) v = min(v, y);
  }
  if (lane == 0) warp_min[wid] = v;
  int nxt = __shfl_down_sync(FULL, v, 1);
  if (lane == 31) nxt = K;
  __syncthreads();
  for (int w = wid + 1; w < NWARP; ++w) nxt = min(nxt, warp_min[w]);
  nxt = min(nxt, tile_next[tile]);
  uint32_t fold = 0;
#pragma unroll
  for (int i = IPT - 1; i >= 0; --i) {
    if (!a[i]) continue;
    const int c = col0 + i;
    if (nxt < K && !piece_start[rbase + nxt]) {
      const uint32_t h = mix_pair(tokens[rbase + c], tokens[rbase + nxt], 0u) & mask;
      if (mode == 0) atomicAdd(hist + h, 1);
      else if (mode == 1) hist[h] = 1;
      else fold ^= h;
    }
    nxt = c;
  }
  if (mode == 2 && fold == 0x7fffffffu) hist[0] = 1;
}
}  // namespace
extern "C" int old_tiles(int K) { return (K + TILE - 1) / TILE; }
extern "C" int old_memset(void* hist, int bits, void* s) {
  return (int)cudaMemsetAsync(hist, 0, sizeof(int) << bits, (cudaStream_t)s);
}
extern "C" int old_tile_first(const void* alive, int B, int K, void* tile_first, void* s) {
  const int nt = old_tiles(K);
  tile_first_kernel<<<(unsigned)((long long)B * nt), TPB, 0, (cudaStream_t)s>>>(
      (const uint8_t*)alive, K, nt, (int*)tile_first);
  return (int)cudaGetLastError();
}
extern "C" int old_tile_next(const void* tile_first, int B, int K, void* tile_next, void* s) {
  tile_next_kernel<<<(B + 3) / 4, 128, 0, (cudaStream_t)s>>>((const int*)tile_first, B, K,
                                                            old_tiles(K), (int*)tile_next);
  return (int)cudaGetLastError();
}
extern "C" int old_pairs(const void* tokens, const void* alive, const void* ps, int B, int K,
                         const void* tile_next, int bits, int mode, void* hist, void* s) {
  const int nt = old_tiles(K);
  pair_hist_kernel<<<(unsigned)((long long)B * nt), TPB, 0, (cudaStream_t)s>>>(
      (const uint32_t*)tokens, (const uint8_t*)alive, (const uint8_t*)ps, K, nt,
      (const int*)tile_next, (1u << bits) - 1u, mode, (int*)hist);
  return (int)cudaGetLastError();
}
"""


def build_lib() -> ctypes.CDLL:
    os.makedirs(PROFILE_DIR, exist_ok=True)
    src = os.path.join(PROFILE_DIR, "old_pair_count.cu")
    so = os.path.join(PROFILE_DIR, "old_pair_count.so")
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
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.old_tiles.argtypes = [I]
    lib.old_memset.argtypes = [P, I, P]
    lib.old_tile_first.argtypes = [P, I, I, P, P]
    lib.old_tile_next.argtypes = [P, I, I, P, P]
    lib.old_pairs.argtypes = [P, P, P, I, I, P, I, I, P, P]
    return lib


def feed(enc, all_docs):
    """Phase 8's feed: the v3 ids, one document per row, as numpy."""
    tokens, offsets = enc.encode_corpus_to_numpy(all_docs, device="cuda")
    lens = np.diff(offsets)
    B, K = len(lens), int(lens.max())
    grid = np.zeros((B, K), np.uint32)
    alive = np.arange(K)[None, :] < lens[:, None]
    grid[alive] = tokens
    piece_start = np.zeros((B, K), bool)
    piece_start[:, 0] = True
    return grid, alive, piece_start


def main() -> int:
    if not torch.cuda.is_available():
        print("pair_hist_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.pair_count import pair_bins
    from tiktoken_tpu_torch.parallel import HIST_BITS

    print("card:", chip_smoke.card_line())
    floors = chip_smoke.start_floor_build()
    lib = build_lib()
    chip_smoke.floor_lib(floors)
    ranks = tiktoken_tpu_torch.load_tiktoken_bpe(
        os.path.join(REPO, "assets", "bench_vocab2_100000.tiktoken"))
    enc = tiktoken_tpu_torch.Encoding("bench_o200k", pat_str=tiktoken_tpu_torch.o200k_pat_str,
                                      mergeable_ranks=ranks,
                                      special_tokens={"<|endoftext|>": len(ranks)})
    docs = chip_smoke.bench_docs(chip_smoke.CORPUS_MB)
    edge = [chip_smoke.CJK * 40, "x" * 9000, "1a" * 600, chip_smoke.CJK, chip_smoke.CYR * 30,
            chip_smoke.ARABIC * 25]
    grid, alive, piece_start = feed(enc, edge + docs)
    tok, al, ps = (torch.from_numpy(x).cuda() for x in (grid.view(np.int32), alive, piece_start))
    B, K = tok.shape
    bits = HIST_BITS

    # 1: the feed
    bins = pair_bins(tok, al, ps, bits)
    n = bins.numel()
    uniq, cnt = torch.unique(bins, return_counts=True)
    m32 = bins[: n - n % 32].view(-1, 32)
    distinct32 = float(torch.tensor([torch.unique(r).numel() for r in m32[:4096]]).double().mean())
    print(f"feed: {B} x {K} = {B * K} positions, {int(al.sum())} alive, {n} pairs, "
          f"{uniq.numel()} distinct bins of {1 << bits}; hottest bin {int(cnt.max())} pairs "
          f"({int(cnt.max()) / n:.4f}); distinct bins among 32 consecutive pairs {distinct32:.2f} "
          f"(first 4096 groups)")

    # 2: the package's launches
    for line in kernels.build().ptxas.get("pair_count", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas package:", line.strip()[:120])
    from torch.profiler import ProfilerActivity, profile

    kernels.pair_hist(tok, al, ps, bits)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kernels.pair_hist(tok, al, ps, bits)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    evs = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    evs.sort(key=lambda e: -dev_us(e))
    print(f"package tt_pair_hist by launch (torch.profiler, per call; sum "
          f"{sum(dev_us(e) for e in evs) / 5 / 1e3:.4f} ms):")
    for e in evs:
        print(f"  {dev_us(e) / 5 / 1e3:9.4f} ms  x{e.count // 5:2d}  {e.key[:90]}")

    # 3: the old design, launch by launch
    P = ctypes.c_void_p
    s = P(torch.cuda.current_stream().cuda_stream)
    nt = lib.old_tiles(K)
    tf = torch.empty(B * nt, dtype=torch.int32, device="cuda")
    tn = torch.empty(B * nt, dtype=torch.int32, device="cuda")
    hist = torch.empty(1 << bits, dtype=torch.int32, device="cuda")

    def ok(err):
        if err:
            raise RuntimeError(f"CUDA error {err}")

    def memset():
        ok(lib.old_memset(P(hist.data_ptr()), bits, s))

    def first():
        ok(lib.old_tile_first(P(al.data_ptr()), B, K, P(tf.data_ptr()), s))

    def nxt():
        ok(lib.old_tile_next(P(tf.data_ptr()), B, K, P(tn.data_ptr()), s))

    def pairs(mode):
        ok(lib.old_pairs(P(tok.data_ptr()), P(al.data_ptr()), P(ps.data_ptr()), B, K,
                         P(tn.data_ptr()), bits, mode, P(hist.data_ptr()), s))

    memset()
    first()
    nxt()
    pairs(0)
    torch.cuda.synchronize()
    want = kernels.pair_hist(tok, al, ps, bits)
    same = torch.equal(hist, want)
    times = dict(memset=chip_smoke.gpu_ms(memset), tile_first=chip_smoke.gpu_ms(first),
                 tile_next=chip_smoke.gpu_ms(nxt), pairs_atomic=chip_smoke.gpu_ms(lambda: pairs(0)),
                 pairs_store=chip_smoke.gpu_ms(lambda: pairs(1)),
                 pairs_no_hist=chip_smoke.gpu_ms(lambda: pairs(2)))
    print(f"old design ({nt} tiles of 2048 columns per row; equal to the package: {same}), ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))

    # 4: the atomic floor
    at_ms = chip_smoke.atomic_floor_ms(bins, bits, want)
    g = torch.Generator(device="cuda").manual_seed(3)
    sh_ms = chip_smoke.atomic_floor_ms(bins[torch.randperm(n, device="cuda", generator=g)], bits)
    un_ms = chip_smoke.atomic_floor_ms(
        torch.randint(0, 1 << bits, (n,), device="cuda", generator=g, dtype=torch.int32), bits)
    ones = torch.ones(n, dtype=torch.int32, device="cuda")
    ia_ms = chip_smoke.gpu_ms(lambda: torch.zeros(1 << bits, dtype=torch.int32,
                                                  device="cuda").index_add_(0, bins, ones))
    print(f"atomic floor (its adds equal the histogram): {n} atomicAdds on the feed's bins into "
          f"2^{bits} bins {at_ms:.4f} ms ({n / (at_ms * 1e-3) / 1e9:.1f} G atomics/s; the bins "
          f"read {4 * n / 1e6:.1f} MB); the same bins shuffled {sh_ms:.4f} ms; as many uniform "
          f"random bins {un_ms:.4f} ms; index_add_ of the feed's bins (with its zeros) "
          f"{ia_ms:.4f} ms")

    # 5: the package
    pk_ms = chip_smoke.gpu_ms(lambda: kernels.pair_hist(tok, al, ps, bits))
    moved, ops = chip_smoke.work_of("pair_hist", (tok, al, ps, bits), {}, want)
    print(f"package tt_pair_hist {pk_ms:.4f} ms; bound {moved} bytes / 3.35 TB/s = "
          f"{moved / chip_smoke.HBM_BYTES_PER_S * 1e3:.5f} ms, {ops} operations / 67 T/s = "
          f"{ops / chip_smoke.INT32_OPS_PER_S * 1e3:.5f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
