// Vertex-degree histogram for Hopper (sm_90a), one row or a batch of rows.
//
// Replaces: src/repro/kernels/degree_histogram/kernel.py:48
// `degree_histogram_kernel` (body `_hist_body`, kernel.py:29): the count of
// each source id in [0, V), ignoring -1 padding and ids >= V.  The batch of
// rows is the staged build's `jax.vmap(local)` (src/repro/core/build.py:146):
// row r of a (rows, P) input counts into row r of a (rows, V) output.
//
// What bounds it: memory, and the atomics' throughput in L2.  The function
// reads rows * P int32 and writes rows * V int32.  The TPU kernel had no
// atomics and paid O(E * V / lanes) compares; here the counts are global
// atomics into an output that the caller zeroes.  Integer sums are exact in
// any order, so the result is bitwise whatever the schedule.
//
// Design.  One atomic per id serialises in L2 when neighbouring ids are
// equal, as they are in the staged build's sorted partitions (on an H100 the
// same ids ran 1.54x slower sorted than shuffled).  So runs are added up
// before any atomic:
//   * a CTA of 256 threads takes a tile of 4,096 ids of one row; the tiles
//     lie on 16-byte boundaries of the address space, so each thread loads
//     its 16 consecutive ids as four aligned int4 loads whatever the row's
//     alignment or length, and ids outside the row read as -1 (a chunk
//     that holds no id of the row is not loaded at all);
//   * each thread walks its ids and issues one atomic per run of equal ids,
//     except its first and last run;
//   * across the warp, a segmented scan over the lanes chains a last run
//     into the next lanes' runs of the same id, so a run that covers many
//     lanes costs one atomic per warp;
//   * a run of an invalid id (negative, or >= V, like the staged build's
//     padding key V) is dropped, never written.
// In stream order nearly every id is its own run: one atomic per id, as
// before.  Index arithmetic is int64.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;   // 4,096 ids
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add_run(int32_t* row_deg, int64_t v,
                                        int32_t id, uint32_t count) {
  if (id >= 0 && id < v) atomicAdd(row_deg + id, static_cast<int>(count));
}

__global__ void __launch_bounds__(kThreads)
degree_histogram_kernel(const int32_t* __restrict__ src, int64_t row_len,
                        int64_t tiles_per_row, int32_t* __restrict__ deg,
                        int64_t v) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) / tiles_per_row;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) % tiles_per_row;
  const int lane = threadIdx.x & 31;
  const int32_t* row_src = src + row * row_len;
  // the aligned view starts at the 16-byte boundary at or before the row;
  // its ids [lead, lead + row_len) are the row's
  const int64_t lead = (reinterpret_cast<uintptr_t>(row_src) & 15u) >> 2;
  const int32_t* aligned = row_src - lead;
  const int64_t pos = tile * kTile +
                      static_cast<int64_t>(threadIdx.x) * kPerThread;

  int32_t x[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    const int64_t i = pos + 4 * q - lead;    // row index of the chunk's .x
    int4 c = make_int4(-1, -1, -1, -1);
    if (i + 3 >= 0 && i < row_len) {
      c = __ldg(reinterpret_cast<const int4*>(aligned + pos + 4 * q));
    }
    x[4 * q + 0] = (i + 0 >= 0 && i + 0 < row_len) ? c.x : -1;
    x[4 * q + 1] = (i + 1 >= 0 && i + 1 < row_len) ? c.y : -1;
    x[4 * q + 2] = (i + 2 >= 0 && i + 2 < row_len) ? c.z : -1;
    x[4 * q + 3] = (i + 3 >= 0 && i + 3 < row_len) ? c.w : -1;
  }

  int32_t* row_deg = deg + row * v;
  // the thread's runs: the first (head) and the last (cur) are kept for the
  // warp; those in between are added here
  const int32_t head = x[0];
  uint32_t head_count = 0;
  int32_t cur = x[0];
  uint32_t count = 1;
  bool single = true;
#pragma unroll
  for (int j = 1; j < kPerThread; ++j) {
    if (x[j] == cur) {
      ++count;
    } else {
      if (single) {
        head_count = count;
        single = false;
      } else {
        add_run(row_deg, v, cur, count);
      }
      cur = x[j];
      count = 1;
    }
  }

  // lane L continues lane L-1's last run if its first id is that run's id;
  // a lane of one run passes the chain on.  total = the count of the chain
  // that ends in this lane's last run.
  const int32_t prev_last = __shfl_up_sync(kFull, cur, 1);
  const bool joins = lane > 0 && head == prev_last;
  uint32_t total = count;
  bool linked = single && joins;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t t_up = __shfl_up_sync(kFull, total, d);
    const bool l_up = __shfl_up_sync(kFull, linked, d);
    if (lane >= d) {
      if (linked) total += t_up;
      linked = linked && l_up;
    }
  }
  const uint32_t carry = __shfl_up_sync(kFull, total, 1);
  const bool next_joins = __shfl_down_sync(kFull, joins, 1);
  if (!single) add_run(row_deg, v, head, head_count + (joins ? carry : 0u));
  if (lane == 31 || !next_joins) add_run(row_deg, v, cur, total);
}

}  // namespace

// src: rows x row_len int32, contiguous (any 4-byte alignment); deg: rows x v
// int32, zeroed by the caller.  One kernel on `stream`.
extern "C" int repro_degree_histogram(const void* src, int64_t rows,
                                      int64_t row_len, void* deg, int64_t v,
                                      void* stream) {
  if (rows <= 0 || row_len <= 0 || v <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  // the aligned view adds at most 3 ids in front of the row
  const int64_t tiles_per_row = (row_len + 3 + kTile - 1) / kTile;
  const int64_t grid = rows * tiles_per_row;
  if (grid >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  degree_histogram_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), row_len, tiles_per_row,
      static_cast<int32_t*>(deg), v);
  return static_cast<int>(cudaGetLastError());
}
