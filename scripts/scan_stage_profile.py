#!/usr/bin/env python3
"""Where the char-DFA scans spend their time on one NVIDIA GPU.

    python3 scripts/scan_stage_profile.py     # from the repository root

A design study of the one-thread-per-row scan (one thread classifies its
row serially, then walks it). On the kernel-phase chunks of
``chip_smoke.py`` (v3: C=32768, K=176; v2: C=32768, K=256) it prints:

1. the plain walk's step counts per row: mean, maximum, and the mean of
   each warp's maximum (32 consecutive rows), for both chunks;
2. device time by CUDA kernel of one v3 and one v2 (char) chunk program,
   from ``torch.profiler``;
3. cut-down copies of the serial design, built here into
   ``tiktoken_tpu_torch/build/profile/`` from the CUDA source below, timed
   with CUDA events: rows staged only; staged and classified; the whole
   scan; each at 32, 64, 128 and 256 rows per block. The v2 copy stages
   rows in shared memory (as ``tt_char_scan`` did); the v3 copy gathers
   rows to device memory and classifies into a per-thread local array,
   with byte stores of the mask (as ``tt_scan_rows`` did);
4. the cycles of one dependent walk step: one block of 32 rows (one warp
   alone on its SM) walking with ``clock64`` around the walk, and the
   same under the full launch;
5. the scan entries of the package itself at each rows-per-block;
6. the package's own scan design (``csrc/scan_rows.cu``) cut at its
   phases: copies of the source built here with a return before the
   classification, before the walk and before the mask's write-out,
   each timed through the package's wrappers against the whole kernel.

Nothing here is used by the package.
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

CUDA_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr int N_PAGES = 0x110000 >> 7;
constexpr int MIXED_FLAG = 1 << 13;
constexpr int KL_MAX = 512;
constexpr int FIRE_BIT = 1 << 5, REW_BIT = 1 << 6;
struct Tab { const uint16_t* page; const uint8_t* mixed; const uint32_t* consts;
             int n_words, skip_cls, cont_cls, eof_cls, na_cap; };
__host__ __device__ size_t tsmem(int S, int NW, int NM) {
  return N_PAGES * 2 + (size_t)S * NW * 4 + (size_t)NM * 128; }
__device__ Tab load(unsigned char* sm, const int* pe, const uint8_t* mx, int NM,
                    const uint32_t* cs, int S, int NW, int sk, int co, int eo, int cap) {
  uint16_t* p = (uint16_t*)sm; uint32_t* c = (uint32_t*)(sm + N_PAGES * 2);
  uint8_t* m = (uint8_t*)(c + S * NW);
  for (int i = threadIdx.x; i < N_PAGES; i += blockDim.x) p[i] = (uint16_t)pe[i];
  for (int i = threadIdx.x; i < S * NW; i += blockDim.x) c[i] = cs[i];
  for (int i = threadIdx.x; i < NM * 128; i += blockDim.x) m[i] = mx[i];
  return Tab{p, m, c, NW, sk, co, eo, cap}; }
__device__ __forceinline__ int cls_cp(const Tab& t, int cp) {
  int e = t.page[cp >> 7];
  return (e & MIXED_FLAG) ? t.mixed[(e & (MIXED_FLAG - 1)) * 128 + (cp & 127)] : e; }
__device__ __forceinline__ int ulen(int b) {
  if (b < 0x80) return 1; if (b >= 0xC2 && b <= 0xDF) return 2;
  if (b >= 0xE0 && b <= 0xEF) return 3; if (b >= 0xF0 && b <= 0xF4) return 4; return 0; }
__device__ __forceinline__ int char_class(const Tab& t, int b, int b1, int b2, int b3,
                                          bool past, int& n_na) {
  if (past) return t.eof_cls;
  bool c0 = (b & 0xC0) == 0x80, c1 = (b1 & 0xC0) == 0x80, c2 = (b2 & 0xC0) == 0x80,
       c3 = (b3 & 0xC0) == 0x80;
  int k = c0 ? (c1 ? (c2 ? (c3 ? 4 : 3) : 2) : 1) : 0;
  int lead = k == 0 ? b : (k == 1 ? b1 : (k == 2 ? b2 : b3));
  if (!(k < 4 && ulen(lead) == k + 1)) return c0 ? t.cont_cls : t.skip_cls;
  if (!c0) return cls_cp(t, b);
  int cp = k == 1 ? (((lead & 0x1F) << 6) | (b & 0x3F))
         : k == 2 ? (((lead & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b & 0x3F))
         : (((lead & 0x07) << 18) | ((b2 & 0x3F) << 12) | ((b1 & 0x3F) << 6) | (b & 0x3F));
  cp = min(max(cp, 0x80), 0x10FFFF);
  return n_na++ < t.na_cap ? cls_cp(t, cp) : 0; }
template <bool HS, typename Mark>
__device__ __forceinline__ bool walk(const Tab& t, const uint8_t* cls, int KL, int K, int nt,
                                     int npay, bool dend, Mark mark, int& steps) {
  bool bad = false, done = npay <= 0;
  int p = 0, s = 1, ms = 0, lend = -1, cs = 0; const int cap = 3 * (KL + 2);
  steps = 0;
  for (int it = 0; it < cap && !done && !bad; ++it) {
    ++steps;
    int c = cls[min(p, KL)];
    int v = (t.consts[s * t.n_words + (c >> 2)] >> ((c & 3) * 8)) & 0xFF;
    int s2 = v & 31;
    if (v & FIRE_BIT) lend = (v & REW_BIT) ? (c == t.eof_cls ? p : cs) : p + 1;
    bool eofd = p >= nt;
    if (s2 == 0 || eofd || (c == t.cont_cls && p == ms)) {
      bool eb = HS && eofd && !dend; if (eb) bad = true;
      if (ms < npay && ms < K) mark(ms);
      bool np = lend <= ms, fin = lend >= npay;
      if (np && !fin) bad = true;
      if (fin || np) done = true; else { p = lend; s = 1; ms = lend; cs = lend; lend = -1; }
    } else { if (c < t.skip_cls) cs = p + 1; ++p; s = s2; }
  }
  return bad || !done; }
__host__ __device__ int stride_of(int KL) { return (((KL + 4) / 4) | 1) * 4; }

// v2 design: rows staged in shared memory, classified in place serially by
// each thread, walked, the mask written out coalesced
template <int STAGE>
__global__ void v2_kernel(const uint8_t* rows, int C, int KL, int K, const int* npay,
                          const int* ntot, const int* pe, const uint8_t* mx, int NM,
                          const uint32_t* cs, int S, int NW, int sk, int co, int eo, int cap,
                          uint8_t* mask, uint8_t* out, long long* cyc, int* stp) {
  extern __shared__ __align__(16) unsigned char sm[];
  const Tab t = load(sm, pe, mx, NM, cs, S, NW, sk, co, eo, cap);
  const int R = blockDim.x, st = stride_of(KL), KW = (K + 31) / 32;
  uint8_t* srows = sm + (tsmem(S, NW, NM) + 15) / 16 * 16;
  uint32_t* smask = (uint32_t*)(srows + R * st);
  const int r0 = blockIdx.x * R, nr = min(R, C - r0);
  const uint32_t* s32 = (const uint32_t*)(rows + (long long)r0 * KL);
  const int kw = KL >> 2;
  for (int i = threadIdx.x; i < nr * kw; i += R) {
    int rr = i / kw; ((uint32_t*)srows)[rr * (st >> 2) + (i - rr * kw)] = s32[i]; }
  for (int i = threadIdx.x; i < nr * KW; i += R) smask[i] = 0;
  __syncthreads();
  if (threadIdx.x < nr) {
    const int r = r0 + threadIdx.x;
    uint8_t* row = srows + threadIdx.x * st;
    uint32_t* row32 = (uint32_t*)row;
    int n_na = 0, chk = 0;
    if (STAGE >= 1) {
      const int end = min(ntot[r], KL);
      int b1 = 0, b2 = 0, b3 = 0;
      for (int w = 0; w < (KL + 3) / 4; ++w) {
        uint32_t word = row32[w], o = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int b = (word >> (8 * j)) & 0xFF;
          o |= (uint32_t)char_class(t, b, b1, b2, b3, 4 * w + j >= end, n_na) << (8 * j);
          b3 = b2; b2 = b1; b1 = b; }
        row32[w] = o; chk ^= o; }
      row[KL] = (uint8_t)eo;
    } else { chk = row32[threadIdx.x % kw]; }
    int steps = 0;
    if (STAGE >= 2) {
      uint32_t* mw = smask + threadIdx.x * KW;
      long long c0 = clock64();
      chk = walk<false>(t, row, KL, K, ntot[r], npay[r], false,
                        [&](int m) { mw[m >> 5] |= 1u << (m & 31); }, steps);
      if (cyc) { cyc[r] = clock64() - c0; stp[r] = steps; }
    }
    out[r] = (uint8_t)(chk ^ n_na);
  }
  __syncthreads();
  uint8_t* dst = mask + (long long)r0 * K;
  for (int i = threadIdx.x; i < nr * K; i += R) {
    int rr = i / K, col = i - rr * K;
    dst[i] = (smask[rr * KW + (col >> 5)] >> (col & 31)) & 1u; }
}

// v3 design: rows gathered to device memory, each thread classifies its
// row into a local array (reading it byte by byte) and walks it with
// byte stores of its mask
template <int STAGE>
__global__ void v3_kernel(const uint8_t* flat, long long fs, const int* off, const int* npay,
                          const int* ntot, const uint8_t* dend, int C, int KL, int KP,
                          const int* pe, const uint8_t* mx, int NM, const uint32_t* cs, int S,
                          int NW, int sk, int co, int eo, int cap, uint8_t* rows,
                          uint8_t* mask, uint8_t* out) {
  extern __shared__ __align__(16) unsigned char sm[];
  const Tab t = load(sm, pe, mx, NM, cs, S, NW, sk, co, eo, cap);
  const int R = blockDim.x, r0 = blockIdx.x * R, nr = min(R, C - r0);
  for (int i = threadIdx.x; i < nr * KL; i += R) {
    int rr = i / KL, col = i - rr * KL; long long src = (long long)off[r0 + rr] + col;
    rows[(long long)(r0 + rr) * KL + col] = (src >= 0 && src < fs) ? flat[src] : 0; }
  __syncthreads();
  const int r = r0 + threadIdx.x;
  if (r >= C) return;
  const uint8_t* row = rows + (long long)r * KL;
  uint8_t cls[KL_MAX + 1];
  int n_na = 0, chk = 0;
  if (STAGE >= 1) {
    int b1 = 0, b2 = 0, b3 = 0, nt = ntot[r];
    for (int p = 0; p < KL; ++p) {
      int b = row[p];
      cls[p] = (uint8_t)char_class(t, b, b1, b2, b3, p >= nt, n_na);
      b3 = b2; b2 = b1; b1 = b; chk ^= cls[p]; }
    cls[KL] = (uint8_t)eo;
  }
  if (STAGE >= 2) {
    uint8_t* mrow = mask + (long long)r * KP;
    for (int i = 0; i < KP; ++i) mrow[i] = 0;
    int steps;
    chk = walk<true>(t, cls, KL, KP, ntot[r], npay[r], dend[r] != 0,
                     [&](int m) { mrow[m] = 1; }, steps);
  }
  out[r] = (uint8_t)(chk ^ n_na);
}
}  // namespace

extern "C" int prof_v2(int stage, int R, const void* rows, int C, int KL, int K,
                       const void* npay, const void* ntot, const void* pe, const void* mx, int NM,
                       const void* cs, int S, int NW, int sk, int co, int eo, int cap,
                       void* mask, void* out, void* cyc, void* stp, int blocks, void* stream) {
  size_t smem = (tsmem(S, NW, NM) + 15) / 16 * 16 + (size_t)R * (stride_of(KL) + 4 * ((K + 31) / 32));
  if (smem > 232448 || (KL & 3)) return (int)cudaErrorInvalidValue;
  if (blocks <= 0) blocks = (C + R - 1) / R;
  cudaStream_t st = (cudaStream_t)stream;
#define ARGS (const uint8_t*)rows, C, KL, K, (const int*)npay, (const int*)ntot, (const int*)pe, \
  (const uint8_t*)mx, NM, (const uint32_t*)cs, S, NW, sk, co, eo, cap, (uint8_t*)mask, \
  (uint8_t*)out, (long long*)cyc, (int*)stp
  if (stage == 0) {
    cudaFuncSetAttribute(v2_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    v2_kernel<0><<<blocks, R, smem, st>>>(ARGS);
  } else if (stage == 1) {
    cudaFuncSetAttribute(v2_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    v2_kernel<1><<<blocks, R, smem, st>>>(ARGS);
  } else {
    cudaFuncSetAttribute(v2_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    v2_kernel<2><<<blocks, R, smem, st>>>(ARGS);
  }
#undef ARGS
  return (int)cudaGetLastError();
}

extern "C" int prof_v3(int stage, int R, const void* flat, long long fs, const void* off,
                       const void* npay, const void* ntot, const void* dend, int C, int KL, int KP,
                       const void* pe, const void* mx, int NM, const void* cs, int S, int NW,
                       int sk, int co, int eo, int cap, void* rows, void* mask, void* out,
                       void* stream) {
  size_t smem = tsmem(S, NW, NM);
  if (KL > KL_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int blocks = (C + R - 1) / R;
#define ARGS (const uint8_t*)flat, fs, (const int*)off, (const int*)npay, (const int*)ntot, \
  (const uint8_t*)dend, C, KL, KP, (const int*)pe, (const uint8_t*)mx, NM, (const uint32_t*)cs, \
  S, NW, sk, co, eo, cap, (uint8_t*)rows, (uint8_t*)mask, (uint8_t*)out
  if (stage == 0) {
    cudaFuncSetAttribute(v3_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    v3_kernel<0><<<blocks, R, smem, st>>>(ARGS);
  } else if (stage == 1) {
    cudaFuncSetAttribute(v3_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    v3_kernel<1><<<blocks, R, smem, st>>>(ARGS);
  } else {
    cudaFuncSetAttribute(v3_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    v3_kernel<2><<<blocks, R, smem, st>>>(ARGS);
  }
#undef ARGS
  return (int)cudaGetLastError();
}
"""

STAGES = ("staged", "staged+classified", "whole scan")
ROWS_PER_BLOCK = (32, 64, 128, 256)


def build_lib() -> ctypes.CDLL:
    out = os.path.join(REPO, "tiktoken_tpu_torch", "build", "profile")
    os.makedirs(out, exist_ok=True)
    src, so = os.path.join(out, "scan_stages.cu"), os.path.join(out, "scan_stages.so")
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
    return ctypes.CDLL(so)


# the phases of csrc/scan_rows.cu's scan_kernel, by the comment that opens each
PHASE_MARKS = ("  // 2. classify", "  // 3. walk", "  // 4. the mask out")
PHASES = ("tables + staging", "+ classification", "+ walk", "whole kernel")


def build_phase_libs() -> list[ctypes.CDLL]:
    """csrc/scan_rows.cu built three times, returning before phase 2, 3
    and 4 of the kernel; entry points as the package's."""
    from tiktoken_tpu_torch.ops import kernels

    out = os.path.join(REPO, "tiktoken_tpu_torch", "build", "profile")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(kernels.CSRC, "scan_rows.cu")) as f:
        src = f.read()
    libs = []
    for stop, mark in enumerate(PHASE_MARKS):
        if src.count(mark) != 1:
            raise RuntimeError(f"scan_rows.cu: phase mark {mark!r} not found once")
        cut = src.replace(mark, "  return;\n" + mark)
        path = os.path.join(out, f"scan_rows_stop{stop}.cu")
        with open(path, "w") as f:
            f.write(cut)
        so = path[:-3] + ".so"
        nvcc = "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc"
        res = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-o", so, path],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on {path}:\n{res.stdout}{res.stderr}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in kernels._SIGNATURES["scan_rows"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs.append(lib)
    return libs


def warp_stats(steps: torch.Tensor) -> str:
    s = steps.to(torch.float64)
    pad = (-s.numel()) % 32
    w = torch.cat([s, s.new_zeros(pad)]).view(-1, 32).amax(dim=1)
    return (f"mean {float(s.mean()):.2f}, max {int(s.max())}, mean of each warp's max "
            f"{float(w.mean()):.2f} (rows {s.numel()})")


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_stage_profile: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch.ops import kernels, pipeline3, sweep_scan
    from tiktoken_tpu_torch.ops.charclass import na_cap
    from tiktoken_tpu_torch.ops.engine import DEFAULT_ROW, pack_documents
    from tiktoken_tpu_torch.ops.pipeline2 import NA_FRAC, run_chunk2

    print("card:", chip_smoke.card_line())
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print("sm clock now, max:", clk)
    ranks = tiktoken_tpu_torch.load_tiktoken_bpe(
        os.path.join(REPO, "assets", "bench_vocab2_100000.tiktoken"))
    enc = tiktoken_tpu_torch.Encoding("bench_o200k", pat_str=tiktoken_tpu_torch.o200k_pat_str,
                                      mergeable_ranks=ranks,
                                      special_tokens={"<|endoftext|>": len(ranks)})
    eng = enc.engine("cuda")
    docs = chip_smoke.bench_docs(chip_smoke.CORPUS_MB)
    C = 32768

    # the v3 chunk (as chip_smoke.kernel_phase)
    K = pipeline3.K_DEFAULT
    KP, KL3 = pipeline3.row_geometry(K)
    S = -(-(C * KP + KL3 + 8) // 128) * 128
    sel, size = [], 0
    for d in docs:
        if size >= C * K * 1.1:
            break
        sel.append(d.encode())
        size += len(sel[-1])
    pc = pipeline3.pack_corpus3(sel, K)
    flat, off, pay3, tot3, dend, prev, emit = eng.upload(
        pipeline3.chunk_inputs3(pc, 0, C - 1, C, S)[0])
    # the v2 chunk (as chip_smoke.kernel_phase2)
    sel, n = [], 0
    for d in docs:
        if n >= C:
            break
        sel.append(d.encode())
        n += pack_documents(sel[-1:], DEFAULT_ROW).rows.shape[0]
    b = pack_documents(sel, DEFAULT_ROW)
    rows2, pay2, tot2 = eng.upload([b.rows[:C], b.n_payload[:C], b.n_total[:C]])
    KL2 = rows2.shape[1]
    K2 = KL2 - 16
    t = eng.tables.scan

    # 1: step counts of the plain walk
    rows3 = sweep_scan.row_gather(flat, off, KL3)
    cls3, _ = sweep_scan.row_classes(t, rows3, tot3, 8)
    st3 = sweep_scan.walk_steps(t, cls3, pay3, tot3, dend)
    cls2, _ = sweep_scan.row_classes(t, rows2, tot2, NA_FRAC)
    st2 = sweep_scan.walk_steps(t, cls2, pay2, tot2)
    print(f"walk steps v3 (KL={KL3}, cap {3 * (KL3 + 2)}): {warp_stats(st3)}")
    print(f"walk steps v2 (KL={KL2}, cap {3 * (KL2 + 2)}): {warp_stats(st2)}")
    print(f"payload bytes per row: v3 mean {float(pay3.float().mean()):.1f}, "
          f"v2 mean {float(pay2.float().mean()):.1f}")

    # 2: device time by kernel under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    for name, fn in (("v3 chunk", lambda: pipeline3.run_chunk(
            eng.tables, flat, off, pay3, tot3, dend, prev, emit, K=K)),
            ("v2 chunk (char)", lambda: run_chunk2(eng.tables, rows2, pay2, tot2))):
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
        print(f"{name}: device time by kernel, per chunk (sum {total:.4f} ms, "
              f"{sum(e.count for e in evs) // 5} launches):")
        for e in evs[:40]:
            print(f"  {dev_us(e) / 5 / 1e3:9.4f} ms  x{e.count // 5:3d}  {e.key[:110]}")

    # 3, 4: cut-down copies of the serial design
    lib = build_lib()
    P = ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    S_, NW = t.consts.shape
    NM = t.mixed_rows.shape[0]
    tabs2 = [t.page_entry.data_ptr(), t.mixed_rows.data_ptr(), NM, t.consts.data_ptr(), S_, NW,
             t.skip_class, t.cont_class, t.eof_class]
    mask2 = torch.empty((C, K2), dtype=torch.uint8, device="cuda")
    out = torch.empty(C, dtype=torch.uint8, device="cuda")
    rows3o = torch.empty((C, KL3), dtype=torch.uint8, device="cuda")
    mask3 = torch.empty((C, KP), dtype=torch.uint8, device="cuda")

    def v2(stage, R, blocks=0, cyc=None, stp=None):
        err = lib.prof_v2(stage, R, P(rows2.data_ptr()), C, KL2, K2, P(pay2.data_ptr()),
                          P(tot2.data_ptr()), P(tabs2[0]), P(tabs2[1]), NM, P(tabs2[3]), S_, NW,
                          *tabs2[6:], na_cap(KL2, NA_FRAC), P(mask2.data_ptr()),
                          P(out.data_ptr()), P(cyc), P(stp), blocks, P(stream))
        if err:
            raise RuntimeError(f"prof_v2 error {err}")

    def v3(stage, R):
        err = lib.prof_v3(stage, R, P(flat.data_ptr()), ctypes.c_longlong(flat.numel()),
                          P(off.data_ptr()), P(pay3.data_ptr()), P(tot3.data_ptr()),
                          P(dend.data_ptr()), C, KL3, KP, P(tabs2[0]), P(tabs2[1]), NM,
                          P(tabs2[3]), S_, NW, *tabs2[6:], na_cap(KL3, 8),
                          P(rows3o.data_ptr()), P(mask3.data_ptr()), P(out.data_ptr()),
                          P(stream))
        if err:
            raise RuntimeError(f"prof_v3 error {err}")

    v2(2, 128)
    torch.cuda.synchronize()
    want, _bad, _ = kernels.PLAIN_OPS.char_scan(t, rows2, pay2, tot2, K=K2, na_frac=NA_FRAC)
    print("v2 cut-down copy (whole scan) equals the plain mask:",
          torch.equal(mask2.bool(), want))
    for label, fn in (("v2 (rows staged in shared memory)", v2),
                      ("v3 (rows gathered, local class array)", v3)):
        for stage in range(3):
            line = []
            for R in ROWS_PER_BLOCK:
                line.append(f"{R}: {chip_smoke.gpu_ms(lambda: fn(stage, R)):.4f}")
            print(f"{label}, {STAGES[stage]}: ms by rows per block {', '.join(line)}")

    cyc = torch.zeros(C, dtype=torch.int64, device="cuda")
    stp = torch.zeros(C, dtype=torch.int32, device="cuda")
    for label, blocks in (("one warp alone (1 block of 32 rows)", 1), ("the full launch", 0)):
        cyc.zero_()
        stp.zero_()
        v2(2, 32 if blocks else 128, blocks, cyc.data_ptr(), stp.data_ptr())
        torch.cuda.synchronize()
        live = stp > 0
        cps = float(cyc[live].sum()) / float(stp[live].sum().to(torch.float64))
        print(f"walk cycles per step, {label}: {cps:.2f} ({int(live.sum())} rows)")

    # 5: the package's scan entries by rows per block, where they take it
    rpb = getattr(kernels, "SCAN_ROWS_PER_BLOCK", None)
    if rpb is not None:
        for R in ROWS_PER_BLOCK:
            kernels.SCAN_ROWS_PER_BLOCK = R
            a = chip_smoke.gpu_ms(lambda: kernels.scan_rows(t, flat, off, pay3, tot3, dend, KP=KP,
                                                            KL=KL3, na_frac=8))
            b2 = chip_smoke.gpu_ms(lambda: kernels.char_scan(t, rows2, pay2, tot2, K=K2,
                                                             na_frac=NA_FRAC))
            print(f"package scans at {R} rows per block: tt_scan_rows {a:.4f} ms, "
                  f"tt_char_scan {b2:.4f} ms")
        kernels.SCAN_ROWS_PER_BLOCK = rpb

    # 6: the package's design cut at its phases, through the package's wrappers
    libs = kernels._LIBS.load()
    whole = libs["scan_rows"]
    scans = (("tt_scan_rows (v3)", lambda: kernels.scan_rows(t, flat, off, pay3, tot3, dend, KP=KP,
                                                               KL=KL3, na_frac=8)),
             ("tt_char_scan (v2)", lambda: kernels.char_scan(t, rows2, pay2, tot2, K=K2,
                                                              na_frac=NA_FRAC)))
    try:
        for label, fn in scans:
            times = []
            for lib in [*build_phase_libs(), whole]:
                libs["scan_rows"] = lib
                times.append(chip_smoke.gpu_ms(fn))
            print(f"{label} at {kernels.SCAN_ROWS_PER_BLOCK} rows per block, ms by phase: "
                  + ", ".join(f"{p} {x:.4f}" for p, x in zip(PHASES, times)))
    finally:
        libs["scan_rows"] = whole
    return 0


if __name__ == "__main__":
    sys.exit(main())
