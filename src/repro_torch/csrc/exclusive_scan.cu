// Exclusive int32 prefix sum plus its total, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/exclusive_scan/kernel.py:38
// `exclusive_scan_kernel` (body `_scan_body`, kernel.py:23): degrees -> CSR
// offsets, GVEL Alg. 2's exclusiveScan.  The total is the carry; here it is
// written at out[N], so out is the (N+1,) CSR offsets vector itself.
//
// What bounds it: memory.  The function reads N int32 and writes N+1 int32
// (8N + 4 bytes); a scan does one add per element.
//
// Design.  The TPU kernel carries the running sum from one grid step to the
// next, which works because a TPU core runs its grid in order.  Blocks on
// Hopper run in no order, so the carry crosses tiles by decoupled look-back
// (`lookback.cuh`), in one pass over the input:
//   * a CTA takes the next tile of kTile = 4,096 elements from the tile
//     counter; each warp owns 512 consecutive elements and loads them as
//     four coalesced int4 rows, so a lane holds 16 values in registers;
//   * four warp scans (one per row) and a scan of the 8 warp totals give
//     every value its prefix inside the tile and the tile's aggregate;
//   * warp 0 looks back for the tile's prefix across the array;
//   * the lanes add it and store their int4 rows; the last tile writes the
//     total at out[N].
// The input is read once (the three-pass scan this replaces read it twice
// and launched three kernels).  Sums are uint32, so overflow wraps exactly
// like the reference's int32 cumsum without signed-overflow undefined
// behaviour; the CSR builders refuse edge counts that could wrap.
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                       // int4 rows per warp
constexpr int kWarpItems = 32 * 4 * kRows;     // 512
constexpr int kTile = kWarps * kWarpItems;     // 4,096

__global__ void __launch_bounds__(kThreads)
exclusive_scan_kernel(const int32_t* __restrict__ x, int64_t n,
                      int32_t* __restrict__ out, repro::u64* scratch,
                      uint32_t ntiles, bool vector_io) {
  __shared__ uint32_t tile_slot;
  __shared__ uint32_t warp_prefix[kWarps];
  const uint32_t tile = repro::next_tile(scratch, &tile_slot);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t seg = static_cast<int64_t>(tile) * kTile +
                      static_cast<int64_t>(warp) * kWarpItems;
  const bool full = static_cast<int64_t>(tile + 1) * kTile <= n;

  // value j of row r of this lane is element seg + (r * 32 + lane) * 4 + j
  uint32_t v[kRows][4];
  if (full && vector_io) {
    const int4* xv = reinterpret_cast<const int4*>(x + seg);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int4 q = __ldg(xv + r * 32 + lane);
      v[r][0] = q.x; v[r][1] = q.y; v[r][2] = q.z; v[r][3] = q.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t i = seg + (r * 32 + lane) * 4 + j;
        v[r][j] = i < n ? static_cast<uint32_t>(x[i]) : 0u;
      }
    }
  }

  // prefix of each row vector inside the warp
  uint32_t before[kRows];
  uint32_t carry = 0u;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const uint32_t s = v[r][0] + v[r][1] + v[r][2] + v[r][3];
    const uint32_t incl = repro::warp_inclusive_sum(s);
    before[r] = carry + incl - s;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) warp_prefix[warp] = carry;  // the warp's total
  __syncthreads();
  if (warp == 0) {
    const uint32_t t = lane < kWarps ? warp_prefix[lane] : 0u;
    const uint32_t incl = repro::warp_inclusive_sum(t);
    const uint32_t aggregate = __shfl_sync(0xffffffffu, incl, kWarps - 1);
    const uint32_t prefix = repro::warp_lookback(scratch, tile, aggregate);
    __syncwarp();
    if (lane < kWarps) warp_prefix[lane] = prefix + incl - t;
    if (lane == 0 && tile == ntiles - 1) {
      out[n] = static_cast<int32_t>(prefix + aggregate);
    }
  }
  __syncthreads();
  const uint32_t base = warp_prefix[warp];

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    uint32_t o[4];
    uint32_t run = base + before[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = run;
      run += v[r][j];
    }
    const int64_t i0 = seg + (r * 32 + lane) * 4;
    if (full && vector_io) {
      reinterpret_cast<int4*>(out + i0)[0] =
          make_int4(static_cast<int>(o[0]), static_cast<int>(o[1]),
                    static_cast<int>(o[2]), static_cast<int>(o[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i0 + j < n) out[i0 + j] = static_cast<int32_t>(o[j]);
      }
    }
  }
}

}  // namespace

// Bytes of scratch the caller allocates: the tile counter and one status
// word per tile.  The entry point zeroes it.
extern "C" int64_t repro_exclusive_scan_scratch_bytes(int64_t n) {
  const int64_t ntiles = n > 0 ? (n + kTile - 1) / kTile : 0;
  return 8 * repro::scratch_words(ntiles);
}

// x: (n,) int32; out: (n + 1,) int32 -- the exclusive prefix in [0, n), the
// total at n.  One memset and one kernel on `stream`.
extern "C" int repro_exclusive_scan(const void* x, int64_t n, void* out,
                                    void* scratch, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t ntiles = (n + kTile - 1) / kTile;
  if (ntiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, repro_exclusive_scan_scratch_bytes(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vector_io = ((reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  exclusive_scan_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      static_cast<const int32_t*>(x), n, static_cast<int32_t*>(out),
      static_cast<repro::u64*>(scratch), static_cast<uint32_t>(ntiles),
      vector_io);
  return static_cast<int>(cudaGetLastError());
}
