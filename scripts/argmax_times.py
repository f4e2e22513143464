#!/usr/bin/env python3
"""The first argmax of the training step's pair histogram
(``tt_hist_argmax``) on one NVIDIA GPU: the package's one-launch design
against the two-launch design it replaced.

    python3 scripts/argmax_times.py     # from the repository root

It prints the card's name and power limit, then:

1. the package's kernel against its plain version on ``chip_smoke``'s edge
   histograms (``argmax_edges``), and one call's launches
   (``argmax_one_launch``, ``torch.profiler``);
2. on a 2^20-bin histogram (the training step's size, seeded counts with a
   long tail) the times, in turns, of the old design (a partial kernel of
   ``ceil(n / 2048)`` blocks of 256 threads with scalar loads, then a
   one-block final kernel, built here into
   ``tiktoken_tpu_torch/build/profile/`` from the CUDA source below), the
   package's, the package's again and the old one again; beside them the
   bound (the histogram read once and 8 bytes written at 3.35 TB/s),
   ``torch.argmax`` and an empty one-block launch
   (``chip_smoke.launch_floor_ms``), all timed by ``chip_smoke.gpu_ms``;
3. copies of ``csrc/pair_count.cu`` patched as text (``VARIANTS``: other
   block shapes and loads, the tail that the running maximum replaced, no
   tail), built into the same directory, each checked against plain and
   timed in turns with the package's;
4. one JSON line of those times.

Nothing here is used by the package.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PROFILE_DIR = os.path.join(REPO, "tiktoken_tpu_torch", "build", "profile")

# csrc/pair_count.cu's argmax before the redesign, as it was
OLD_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr unsigned FULL = 0xffffffffu;
__device__ __forceinline__ unsigned long long arg_key(int count, unsigned bin) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(count) ^ 0x80000000u) << 32) |
         static_cast<unsigned>(~bin);
}
__device__ __forceinline__ unsigned long long block_max(unsigned long long v) {
  __shared__ unsigned long long warp_max[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_down_sync(FULL, v, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) v = max(v, warp_max[w]);
  return v;
}
__global__ void argmax_partial_kernel(const int* __restrict__ hist, int n,
                                      unsigned long long* __restrict__ partial) {
  unsigned long long best = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    best = max(best, arg_key(hist[i], static_cast<unsigned>(i)));
  best = block_max(best);
  if (threadIdx.x == 0) partial[blockIdx.x] = best;
}
__global__ void argmax_final_kernel(const unsigned long long* __restrict__ partial, int G,
                                    int* __restrict__ out) {
  unsigned long long best = 0;
  for (int i = threadIdx.x; i < G; i += blockDim.x) best = max(best, partial[i]);
  best = block_max(best);
  if (threadIdx.x == 0) {
    out[0] = static_cast<int>(~static_cast<unsigned>(best & 0xffffffffu));
    out[1] = static_cast<int>(static_cast<unsigned>(best >> 32) ^ 0x80000000u);
  }
}
}  // namespace
extern "C" int old_hist_argmax(const void* hist, int n, int G, void* partial, void* out,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  argmax_partial_kernel<<<G, 256, 0, s>>>(static_cast<const int*>(hist), n,
                                          static_cast<unsigned long long*>(partial));
  argmax_final_kernel<<<1, 1024, 0, s>>>(static_cast<const unsigned long long*>(partial), G,
                                         static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


RUNNING_MAX = """  if (threadIdx.x == 0) {
    atomicMax(best_key, best);
    // release: this block's atomicMax is seen by whoever takes a later
    // ticket; acquire: the last block sees every block's
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> t(*ticket);
    if (t.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1) {
      cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> k(*best_key);
      const unsigned long long b = k.exchange(0ull, cuda::memory_order_relaxed);
      out[0] = static_cast<int>(~static_cast<unsigned>(b & 0xffffffffu));
      out[1] = static_cast<int>(static_cast<unsigned>(b >> 32) ^ 0x80000000u);
      t.store(0u, cuda::memory_order_relaxed);  // for the next call on this stream
    }
  }
"""
# a key a block (best_key as an array), the ticket taken after a fence,
# and the last block reducing the keys: the design before the running
# maximum
PARTIALS = """  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    best_key[blockIdx.x] = best;
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  best = 0;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += ARG_TPB)
    best = max(best, __ldcg(best_key + i));
  best = block_max(best);
  if (threadIdx.x == 0) {
    out[0] = static_cast<int>(~static_cast<unsigned>(best & 0xffffffffu));
    out[1] = static_cast<int>(static_cast<unsigned>(best >> 32) ^ 0x80000000u);
    *ticket = 0;
  }
"""
# Copies of csrc/pair_count.cu patched as text (old text, new text): other
# block shapes, the tail that the running maximum replaced (with its two
# fences, or with the ticket taken by one acquire-release atomic), and no
# tail at all (each block writes its key and ends: what electing the last
# block and its reduction cost; not exact).
VARIANTS = {
    "tpb512": [("constexpr int ARG_TPB = 256;", "constexpr int ARG_TPB = 512;")],
    "vpt2": [("constexpr int ARG_VPT = 4;", "constexpr int ARG_VPT = 2;")],
    "vpt8": [("constexpr int ARG_VPT = 4;", "constexpr int ARG_VPT = 8;")],
    "partials": [(RUNNING_MAX, PARTIALS)],
    "partials_acq_rel": [(RUNNING_MAX, PARTIALS.replace("""    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (s_last) __threadfence();
""", """    cuda::atomic_ref<unsigned, cuda::thread_scope_device> t(*ticket);
    s_last = t.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
"""))],
    "no_tail": [(RUNNING_MAX, "  if (threadIdx.x == 0) best_key[blockIdx.x] = best;\n")],
}
# int32 words of every variant's scratch: the ticket, then a key per block
VARIANT_SCRATCH_WORDS = 4 + 2 * 4096


def build_variants() -> dict[str, ctypes.CDLL]:
    """Every variant of ``VARIANTS`` built at once, one nvcc each."""
    from tiktoken_tpu_torch.ops.kernels import CSRC, NVCC_FLAGS

    with open(os.path.join(CSRC, "pair_count.cu")) as f:
        base = f.read()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, patches in VARIANTS.items():
        text = base
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the text to patch is not found once")
            text = text.replace(old, new)
        src = os.path.join(PROFILE_DIR, f"pair_count_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = src[:-3] + ".so"
        procs[name] = (subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", so, src],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(so)
        lib.tt_hist_argmax.argtypes = [P, I, P, P, P]
        lib.tt_hist_argmax.restype = ctypes.c_int
        libs[name] = lib
    return libs


def build_old() -> ctypes.CDLL:
    from tiktoken_tpu_torch.ops.kernels import NVCC_FLAGS

    os.makedirs(PROFILE_DIR, exist_ok=True)
    src = os.path.join(PROFILE_DIR, "argmax_old.cu")
    so = os.path.join(PROFILE_DIR, "argmax_old.so")
    with open(src, "w") as f:
        f.write(OLD_SRC)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = subprocess.run([nvcc, *NVCC_FLAGS, "-o", so, src], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on the old argmax:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.old_hist_argmax.argtypes = [P, I, I, P, P, P]
    lib.old_hist_argmax.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("argmax_times: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from tiktoken_tpu_torch.ops import kernels, pair_count

    card = chip_smoke.card_line()
    chip_smoke.log(f"card: {card}")
    floors = chip_smoke.start_floor_build()
    kernels.build()
    chip_smoke.floor_lib(floors)
    os.makedirs(PROFILE_DIR, exist_ok=True)
    old = build_old()
    variants = build_variants()
    dev = torch.device("cuda", 0)

    chip_smoke.argmax_edges(dev)
    rng = np.random.default_rng(5)
    n = 1 << 20
    hist = torch.from_numpy((rng.pareto(1.2, n) * 3).astype(np.int32)).to(dev)
    chip_smoke.argmax_one_launch(hist)

    G = min(1024, -(-n // 2048))
    partial = torch.empty(G, dtype=torch.int64, device=dev)
    out_old = torch.empty(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run_old():
        err = old.old_hist_argmax(hist.data_ptr(), n, G, partial.data_ptr(), out_old.data_ptr(),
                                  stream)
        if err:
            raise RuntimeError(f"old_hist_argmax: CUDA error {err}")

    run_old()
    want = [int(x) for x in pair_count.hist_argmax(hist)]
    got = [int(x) for x in kernels.hist_argmax(hist)]
    if got != want or out_old.tolist() != want:
        raise RuntimeError(f"argmax: package {got}, old {out_old.tolist()}, plain {want}")

    times = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        times[which].append(chip_smoke.gpu_ms(run_old if which == "old" else
                                              lambda: kernels.hist_argmax(hist)))
    var_ms = {}
    for name, lib in variants.items():
        scratch = torch.zeros(VARIANT_SCRATCH_WORDS, dtype=torch.int32, device=dev)
        out_v = torch.empty(2, dtype=torch.int32, device=dev)

        def run_v(lib=lib, scratch=scratch, out_v=out_v):
            err = lib.tt_hist_argmax(hist.data_ptr(), n, scratch.data_ptr(), out_v.data_ptr(),
                                     stream)
            if err:
                raise RuntimeError(f"variant {name}: CUDA error {err}")

        run_v()
        if name != "no_tail" and out_v.tolist() != want:
            raise RuntimeError(f"variant {name}: {out_v.tolist()}, plain {want}")
        var_ms[name] = [chip_smoke.gpu_ms(lambda: kernels.hist_argmax(hist)),
                        chip_smoke.gpu_ms(run_v), chip_smoke.gpu_ms(run_v),
                        chip_smoke.gpu_ms(lambda: kernels.hist_argmax(hist))]
        chip_smoke.log(f"  variant {name}: {var_ms[name][1]:.5f} / {var_ms[name][2]:.5f} ms "
                       f"against the package's {var_ms[name][0]:.5f} / {var_ms[name][3]:.5f} ms "
                       "(in turns package, variant, variant, package)")
    argmax_ms = chip_smoke.gpu_ms(lambda: torch.argmax(hist))
    floor_ms = chip_smoke.launch_floor_ms(dev)
    bound_ms = (hist.nbytes + 8) / chip_smoke.HBM_BYTES_PER_S * 1e3
    chip_smoke.log(f"2^20 bins: old (two launches) {times['old'][0]:.5f} / {times['old'][1]:.5f} "
                   f"ms, the package's (one launch) {times['new'][0]:.5f} / {times['new'][1]:.5f} "
                   f"ms (in turns old, new, new, old); bound {bound_ms:.5f} ms, torch.argmax "
                   f"{argmax_ms:.5f} ms, an empty one-block launch {floor_ms:.5f} ms; {card}")
    print(json.dumps({"card": card, "n": n, "old_ms": times["old"], "new_ms": times["new"],
                      "bound_ms": bound_ms, "torch_argmax_ms": argmax_ms,
                      "launch_floor_ms": floor_ms, "variants_ms": var_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
