// Exclusive int32 prefix sum plus its total, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/exclusive_scan/kernel.py:38
// `exclusive_scan_kernel` (body `_scan_body`, kernel.py:23): degrees -> CSR
// offsets, GVEL Alg. 2's exclusiveScan.  The total is the carry, so callers
// form V+1 offsets without a second reduction.
//
// What bounds it: memory.  The function reads N int32 and writes N int32;
// a scan does one add per element.
//
// Design.  The TPU kernel carries the running sum from one grid step to the
// next, which works because a TPU core runs its grid in order.  Blocks on
// Hopper run in no order, so the carry becomes three passes:
//   1. each block reduces its tile of kTile elements to one tile sum;
//   2. one block scans the tile sums in place (exclusive) and writes the
//      total;
//   3. each block scans its tile again and adds its tile's offset.
// Pass 3 reads the input a second time (8N + 4N bytes moved instead of 8N);
// a single-pass decoupled look-back scan would save that and is later work.
// Sums are uint32, so overflow wraps exactly like the reference's int32
// cumsum without signed-overflow undefined behaviour; the CSR builders refuse
// edge counts that could wrap before they get here.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive scan of one value per thread across the block; `total` gets the
// block's sum.  blockDim.x must be a multiple of 32.
__device__ uint32_t block_exclusive(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint32_t incl = warp_inclusive(v);
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const uint32_t s = lane < nwarps ? warp_sums[lane] : 0u;
    warp_sums[lane] = warp_inclusive(s);
  }
  __syncthreads();
  const uint32_t before = wid ? warp_sums[wid - 1] : 0u;
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - v;
}

__global__ void tile_reduce(const int32_t* __restrict__ x, int64_t n,
                            uint32_t* __restrict__ tile_sums) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  uint32_t s = 0u;
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const int64_t i = base + k;
    if (i < n) s += static_cast<uint32_t>(x[i]);
  }
  uint32_t total;
  block_exclusive(s, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void scan_tile_sums(uint32_t* __restrict__ tile_sums,
                               int64_t ntiles, int32_t* __restrict__ total) {
  uint32_t carry = 0u;
  for (int64_t c = 0; c < ntiles; c += kScanThreads) {
    const int64_t i = c + threadIdx.x;
    const uint32_t v = i < ntiles ? tile_sums[i] : 0u;
    uint32_t chunk;
    const uint32_t excl = block_exclusive(v, &chunk);
    if (i < ntiles) tile_sums[i] = carry + excl;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = static_cast<int32_t>(carry);
}

__global__ void tile_scan(const int32_t* __restrict__ x, int64_t n,
                          const uint32_t* __restrict__ tile_offsets,
                          int32_t* __restrict__ out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       static_cast<int64_t>(threadIdx.x) * kItems;
  uint32_t v[kItems];
  uint32_t s = 0u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    v[k] = i < n ? static_cast<uint32_t>(x[i]) : 0u;
    s += v[k];
  }
  uint32_t unused;
  uint32_t run = tile_offsets[blockIdx.x] + block_exclusive(s, &unused);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < n) out[i] = static_cast<int32_t>(run);
    run += v[k];
  }
}

}  // namespace

// Scratch the caller allocates for `tile_sums`: one uint32 per tile.
extern "C" int64_t repro_exclusive_scan_tiles(int64_t n) {
  return (n + kTile - 1) / kTile;
}

extern "C" int repro_exclusive_scan(const void* x, int64_t n, void* out,
                                    void* total, void* tile_sums,
                                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t ntiles = repro_exclusive_scan_tiles(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xin = static_cast<const int32_t*>(x);
  auto* sums = static_cast<uint32_t*>(tile_sums);
  tile_reduce<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(xin, n, sums);
  scan_tile_sums<<<1, kScanThreads, 0, s>>>(sums, ntiles,
                                            static_cast<int32_t*>(total));
  tile_scan<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      xin, n, sums, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
