// The staged CSR build's merge for Hopper (sm_90a): each sorted edge to its
// CSR slot in one pass.
//
// Replaces no TPU kernel.  The reference's staged build
// (src/repro/core/build.py::csr_staged, Algorithm 2's disjoint merge) leaves
// the merge to XLA: a rank per sorted edge (a searchsorted over the vertex
// ids and two gathers), a gather of the partition's base, a select, and a
// scatter through int64 indices -- each an array the length of the edges,
// written out in full.  Here one kernel computes each destination as it goes
// and stores only the targets.
//
// Input.  The sorted keys k = p * V + u of partition p's edges of source u
// (one radix sort over all partitions; keys >= num_keys are padding and ids
// outside [0, V), and sort last), their values, and the int32 table
//   delta[k] = offsets[u] + before[p][u] - start of k's run,
// with before[p][u] the edges of u in earlier partitions.  The sort is
// stable, so the element at sorted position i of k's run is p's edge of u of
// rank i - start, and its slot is offsets[u] + before[p][u] + rank =
// i + delta[k].  Padding fills the sorted tail [valid edges, n), which is
// the targets' tail too: padding at position i writes -1 (weight 0) to
// slot i, so every slot of the output is written exactly once.
//
// Values.  Unweighted, the value is the edge's destination id, stored as it
// is.  Weighted, the value is the edge's position, and the destination id and
// the weight are gathered from it.
//
// What bounds it: memory.  An edge reads its key and value (8 B) and writes
// its target (4 B), plus, weighted, 8 B gathered and 4 B written.  The table
// reads follow the sorted keys, so they are near-sequential, and a run's
// stores are consecutive.
//
// Design.  A CTA of 256 threads takes a tile of 2,048 sorted elements; each
// thread loads its 8 keys and values (coalesced, a CTA's width apart), then
// their 8 table entries, then stores, so each thread has 8 independent
// loads in flight at each step.  Index arithmetic is int64.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kItems;

template <bool kGather>
__global__ void __launch_bounds__(kThreads)
staged_merge_kernel(const uint32_t* __restrict__ keys,
                    const int32_t* __restrict__ vals, int64_t n,
                    const int32_t* __restrict__ delta, uint32_t num_keys,
                    const int32_t* __restrict__ dst,
                    const float* __restrict__ w,
                    int32_t* __restrict__ targets,
                    float* __restrict__ w_out) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTile +
                        threadIdx.x;
  uint32_t k[kItems];
  int32_t x[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = first + j * kThreads;
    k[j] = i < n ? __ldg(keys + i) : num_keys;
    x[j] = i < n ? __ldg(vals + i) : 0;
  }
  int64_t slot[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = first + j * kThreads;
    slot[j] = k[j] < num_keys ? i + __ldg(delta + k[j]) : i;
  }
  if (kGather) {
    float wx[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool valid = k[j] < num_keys;
      wx[j] = valid ? __ldg(w + x[j]) : 0.0f;
      x[j] = valid ? __ldg(dst + x[j]) : -1;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (first + j * kThreads < n) {
        targets[slot[j]] = x[j];
        w_out[slot[j]] = wx[j];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (first + j * kThreads < n) {
        targets[slot[j]] = k[j] < num_keys ? x[j] : -1;
      }
    }
  }
}

}  // namespace

// keys, vals: n sorted int32 pairs; delta: num_keys int32; targets: n int32.
// dst, w, w_out: null unweighted; else dst and w (n each) are gathered at the
// values and w_out (n float) is written beside the targets.  One kernel on
// `stream`.
extern "C" int repro_staged_merge(const void* keys, const void* vals,
                                  int64_t n, const void* delta,
                                  int64_t num_keys, const void* dst,
                                  const void* w, void* targets, void* w_out,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (num_keys < 0 || num_keys > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (n + kTile - 1) / kTile;
  if (grid >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nk = static_cast<uint32_t>(num_keys);
  if (dst != nullptr) {
    staged_merge_kernel<true><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(vals),
        n, static_cast<const int32_t*>(delta), nk,
        static_cast<const int32_t*>(dst), static_cast<const float*>(w),
        static_cast<int32_t*>(targets), static_cast<float*>(w_out));
  } else {
    staged_merge_kernel<false><<<static_cast<unsigned>(grid), kThreads, 0,
                                 s>>>(
        static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(vals),
        n, static_cast<const int32_t*>(delta), nk, nullptr, nullptr,
        static_cast<int32_t*>(targets), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
