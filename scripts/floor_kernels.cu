// Floors timed beside two kernels of the port by chip_smoke.py and the
// profile scripts (yardsticks; the package never calls them):
// - probe_floor: n independent reads of a pair-table bucket row's first
//   32-byte sector, as one or two 16-byte loads, at rows hashed from the
//   read's index (no index array), 8 a thread issued together: the floor of
//   tt_grid_merge's pair probes, which random L2 requests bound;
// - atomics_only: one atomicAdd a precomputed bin into a histogram: the
//   floor of tt_pair_hist's adds;
// - empty_launch: one block of 32 threads that does nothing: the floor of a
//   one-launch kernel such as tt_hist_argmax, timed back to back.
// Built by chip_smoke.floor_lib() with nvcc for sm_90a.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t mix(uint32_t a, uint32_t b, uint32_t seed) {
  a ^= seed;
  uint32_t h = (a * 0x9E3779B1u) ^ (b + 0x85EBCA6Bu + (a << 6));
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h;
}

// bucket rows of 128 bytes (8 uint4)
__global__ void probe_floor_kernel(const uint4* __restrict__ buckets, uint32_t mask, long long n,
                                   int loads, uint32_t* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint4 q0[8], q1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long j = t * 8 + i;
    const uint32_t r = mix(static_cast<uint32_t>(j), 7u, 1u) & mask;
    const uint4* row = buckets + static_cast<long long>(r) * 8;
    q0[i] = q1[i] = make_uint4(0u, 0u, 0u, 0u);
    if (j < n) {
      q0[i] = __ldg(row);
      if (loads == 2) q1[i] = __ldg(row + 1);
    }
  }
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) x ^= q0[i].x ^ q0[i].z ^ q1[i].y ^ q1[i].w;
  if (x == 0x12345678u) out[0] = x;  // keeps the loads; almost never stores
}

__global__ void atomics_kernel(const int4* __restrict__ bins, long long n4,
                               int* __restrict__ hist) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int4 b = __ldg(bins + i);
    atomicAdd(hist + b.x, 1);
    atomicAdd(hist + b.y, 1);
    atomicAdd(hist + b.z, 1);
    atomicAdd(hist + b.w, 1);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// buckets: rows_pow2 rows of 128 bytes (16-byte aligned); loads 1 or 2
extern "C" int probe_floor(const void* buckets, int rows_pow2, long long n, int loads, void* out,
                           void* stream) {
  const long long threads = (n + 7) / 8;
  probe_floor_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buckets), static_cast<uint32_t>(rows_pow2 - 1), n, loads,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// bins: n4 int4 of bin indices (16-byte aligned), each added to hist
extern "C" int atomics_only(const void* bins, long long n4, void* hist, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  atomics_kernel<<<sms * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(bins), n4, static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
