// Vertex-degree histogram for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/degree_histogram/kernel.py:48
// `degree_histogram_kernel` (body `_hist_body`, kernel.py:29): the count of
// each source id in [0, V), ignoring -1 padding and ids >= V.
//
// What bounds it: memory, and on skewed graphs atomic contention.  The
// function reads E int32 and writes V int32.  The TPU kernel had no atomics
// and paid O(E * V / lanes) compares; here every edge is one global
// atomicAdd into a (V,) int32 array that the caller zeroes.  Integer sums are
// exact in any order, so the result is bitwise whatever the schedule.
// Hot vertices of a power-law graph serialise their atomics in L2; privatised
// per-block counts in shared memory for the hottest ids are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;
constexpr int kSms = 132;

__global__ void degree_histogram_kernel(const int32_t* __restrict__ src,
                                        int64_t e, int32_t* __restrict__ deg,
                                        int64_t v) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < e; i += step) {
    const int32_t s = src[i];
    if (s >= 0 && s < v) atomicAdd(deg + s, 1);
  }
}

}  // namespace

extern "C" int repro_degree_histogram(const void* src, int64_t e, void* deg,
                                      int64_t v, void* stream) {
  if (e <= 0 || v <= 0) return static_cast<int>(cudaSuccess);
  const int64_t want = (e + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(kSms) * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  degree_histogram_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), e, static_cast<int32_t*>(deg), v);
  return static_cast<int>(cudaGetLastError());
}
