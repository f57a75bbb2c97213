// Single-pass tile prefix with decoupled look-back, for Hopper (sm_90a).
//
// Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back" (NVIDIA, 2016).  Shared by `exclusive_scan.cu` (degrees ->
// CSR offsets) and `parse_edges.cu` (each tile's edge offset across a
// batch).  A kernel that uses it:
//
//   1. takes its tile index from `next_tile` (a global atomic counter, not
//      blockIdx, so a tile only ever waits on tiles that CTAs already
//      running took: the grid cannot deadlock when it is not all resident);
//   2. reduces its tile to one uint32 aggregate;
//   3. calls `warp_lookback` from one full warp, which publishes the
//      aggregate, walks back over its predecessors 32 at a time and
//      publishes the tile's inclusive prefix; every lane gets the exclusive
//      prefix.
//
// Scratch: `scratch_words(ntiles)` uint64 words, all zero at launch (the
// C entry points zero them with one cudaMemsetAsync on the caller's
// stream).  Word 0 holds the tile counter, words 1.. one status word per
// tile: a flag (invalid / aggregate / inclusive) in the high 32 bits and
// the value in the low 32, so flag and value are read together by one
// 64-bit load: release stores and acquire loads at device scope
// (`cuda::atomic_ref`).
// Values are uint32 and wrap, like the reference's int32 sums.
#pragma once

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace repro {

using u64 = unsigned long long;

constexpr uint32_t kStatusInvalid = 0u;
constexpr uint32_t kStatusAggregate = 1u;
constexpr uint32_t kStatusInclusive = 2u;

__host__ __device__ constexpr int64_t scratch_words(int64_t ntiles) {
  return ntiles + 1;
}

__device__ __forceinline__ void status_store(u64* p, uint32_t flag,
                                             uint32_t value) {
  cuda::atomic_ref<u64, cuda::thread_scope_device> word(*p);
  word.store((static_cast<u64>(flag) << 32) | value,
             cuda::memory_order_release);
}

__device__ __forceinline__ u64 status_load(u64* p) {
  cuda::atomic_ref<u64, cuda::thread_scope_device> word(*p);
  return word.load(cuda::memory_order_acquire);
}

__device__ __forceinline__ uint32_t status_flag(u64 w) {
  return static_cast<uint32_t>(w >> 32);
}

__device__ __forceinline__ uint32_t status_value(u64 w) {
  return static_cast<uint32_t>(w);
}

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's next tile index, from the counter in scratch word 0.  Every
// thread of the CTA must call it; `slot` is a __shared__ word.
__device__ __forceinline__ uint32_t next_tile(u64* scratch, uint32_t* slot) {
  __syncthreads();  // the previous tile's readers are done with `slot`
  if (threadIdx.x == 0) {
    *slot = atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  }
  __syncthreads();
  return *slot;
}

// Called by one full warp for tile `tile` with its `aggregate` (the same in
// every lane).  Publishes the tile's inclusive prefix and returns its
// exclusive prefix in every lane.
__device__ inline uint32_t warp_lookback(u64* scratch, uint32_t tile,
                                         uint32_t aggregate) {
  u64* status = scratch + 1;
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) status_store(status, kStatusInclusive, aggregate);
    return 0u;
  }
  if (lane == 0) status_store(status + tile, kStatusAggregate, aggregate);
  uint32_t exclusive = 0u;
  int64_t end = tile;  // this step reads predecessors [end - 32, end)
  for (;;) {
    const int64_t pred = end - 1 - lane;  // lane 0 is the nearest
    u64 word = pred >= 0 ? status_load(status + pred)
                         : (static_cast<u64>(kStatusInclusive) << 32);
    // a predecessor that is still invalid has been taken by a running CTA
    // (tiles are handed out in order), so it will publish
    while (__any_sync(0xffffffffu, status_flag(word) == kStatusInvalid)) {
      if (status_flag(word) == kStatusInvalid) word = status_load(status + pred);
    }
    const uint32_t inclusive = __ballot_sync(
        0xffffffffu, status_flag(word) == kStatusInclusive);
    uint32_t v = status_value(word);
    if (inclusive) {
      // sum the aggregates up to and including the nearest inclusive prefix
      if (lane > __ffs(static_cast<int>(inclusive)) - 1) v = 0u;
      exclusive += warp_sum(v);
      break;
    }
    exclusive += warp_sum(v);
    end -= 32;
  }
  if (lane == 0) {
    status_store(status + tile, kStatusInclusive, exclusive + aggregate);
  }
  return exclusive;
}

// One thread: the inclusive prefix of `tile`, once it is published.
__device__ __forceinline__ uint32_t wait_inclusive(u64* scratch,
                                                   uint32_t tile) {
  u64* status = scratch + 1;
  u64 word = status_load(status + tile);
  while (status_flag(word) != kStatusInclusive) {
    __nanosleep(64);
    word = status_load(status + tile);
  }
  return status_value(word);
}

}  // namespace repro
