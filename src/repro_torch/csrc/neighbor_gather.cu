// Batched fixed-width CSR row gather for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/neighbor_gather/kernel.py:49
// `neighbor_gather_kernel` (body `_gather_body`, kernel.py:26), held to its
// jnp oracle `neighbor_gather_ref` (ref.py:13).  For each vertex id u:
//   lo = offsets[idx(u)], hi = offsets[idx(u + 1)], deg = hi - lo,
//   out[i, j] = targets[lo + j] for 0 <= j < min(deg, width), else -1,
// where idx() indexes as JAX does: a negative int32 wraps once by V + 1,
// then clamps to [0, V]; u + 1 wraps in int32.
//
// What bounds it: memory.  Each vertex reads two offsets and min(deg, width)
// targets and writes `width` int32 plus its degree; there is no arithmetic to
// speak of.  The TPU kernel sliced a whole-array VMEM block per vertex and
// re-aligned it with a roll.
//
// Design.  A warp that owns one vertex runs three dependent loads (id, then
// offsets, then targets) before its first store, so the card holds too few
// rows in flight and latency sets the time.  Here:
//   * a warp takes a group of 32 consecutive ids; lane i loads id i and its
//     two offsets, 32 independent loads in flight, and writes degree i
//     (coalesced);
//   * the warp then walks its rows kRows at a time, broadcasting each row's
//     `lo` and degree by shuffle, and issues the target loads of all kRows
//     rows before any of their stores;
//   * when `width % 4 == 0` a lane stores 4 columns as one int4 (one store
//     instruction per warp for a 128-wide row); any other width stores
//     column by column in the same kernel.  `lo` has any alignment, so the
//     target reads stay 4-byte;
//   * the output is written with evict-first stores (st.global.cs), so it
//     does not push the offsets and the hot rows of a degree-biased batch
//     out of L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // rows whose loads go out together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t jax_index(int32_t u, int64_t n) {
  int64_t i = u < 0 ? static_cast<int64_t>(u) + n : static_cast<int64_t>(u);
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// targets[lo + j] if j < take and lo + j lies in targets, else -1; at < e
// and at >= 0 hold for a CSR's offsets and keep the read in bounds whatever
// the caller passes
__device__ __forceinline__ int32_t slot(const int32_t* __restrict__ targets,
                                        int64_t e, int64_t lo, int64_t take,
                                        int64_t j) {
  const int64_t at = lo + j;
  return (j < take && at >= 0 && at < e) ? __ldg(targets + at) : -1;
}

template <typename Off, bool kVector>
__global__ void __launch_bounds__(kThreads)
neighbor_gather_kernel(const int32_t* __restrict__ vertices, int64_t b,
                       const Off* __restrict__ offsets, int64_t n_off,
                       const int32_t* __restrict__ targets, int64_t e,
                       int32_t* __restrict__ out,
                       int32_t* __restrict__ degrees, int64_t width) {
  const int lane = threadIdx.x & 31;
  const int64_t group = (static_cast<int64_t>(blockIdx.x) * kWarps +
                         (threadIdx.x >> 5)) * 32;
  if (group >= b) return;                          // whole warps only
  const int rows = b - group < 32 ? static_cast<int>(b - group) : 32;

  int64_t lo = 0, deg = 0;
  if (lane < rows) {
    const int32_t u = vertices[group + lane];
    const int32_t u1 = static_cast<int32_t>(static_cast<uint32_t>(u) + 1u);
    lo = static_cast<int64_t>(offsets[jax_index(u, n_off)]);
    deg = static_cast<int64_t>(offsets[jax_index(u1, n_off)]) - lo;
    degrees[group + lane] = static_cast<int32_t>(deg);
  }

  for (int r0 = 0; r0 < rows; r0 += kRows) {
    int64_t row_lo[kRows], take[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      // r0 + k < 32; a row past `rows` reads a lane with lo = deg = 0
      row_lo[k] = __shfl_sync(kFull, lo, r0 + k);
      const int64_t d = __shfl_sync(kFull, deg, r0 + k);
      take[k] = d < width ? d : width;
    }
    if (kVector) {
      for (int64_t c = 4 * lane; c < width; c += 128) {
        int4 q[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          q[k] = make_int4(slot(targets, e, row_lo[k], take[k], c),
                           slot(targets, e, row_lo[k], take[k], c + 1),
                           slot(targets, e, row_lo[k], take[k], c + 2),
                           slot(targets, e, row_lo[k], take[k], c + 3));
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (r0 + k < rows) {
            __stcs(reinterpret_cast<int4*>(
                       out + (group + r0 + k) * width + c), q[k]);
          }
        }
      }
    } else {
      for (int64_t c = lane; c < width; c += 32) {
        int32_t q[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          q[k] = slot(targets, e, row_lo[k], take[k], c);
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (r0 + k < rows) __stcs(out + (group + r0 + k) * width + c, q[k]);
        }
      }
    }
  }
}

template <typename Off>
void launch(const int32_t* v, int64_t b, const Off* off, int64_t n_off,
            const int32_t* t, int64_t e, int32_t* o, int32_t* d,
            int64_t width, cudaStream_t s) {
  const int64_t groups = (b + 31) / 32;
  const unsigned grid = static_cast<unsigned>((groups + kWarps - 1) / kWarps);
  const bool vector = width % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(o) & 15u) == 0;
  if (vector) {
    neighbor_gather_kernel<Off, true><<<grid, kThreads, 0, s>>>(
        v, b, off, n_off, t, e, o, d, width);
  } else {
    neighbor_gather_kernel<Off, false><<<grid, kThreads, 0, s>>>(
        v, b, off, n_off, t, e, o, d, width);
  }
}

}  // namespace

// vertices (b,) int32; offsets (n_off,) int64 or int32; targets (e,) int32;
// out (b, width) and degrees (b,) int32, written in full.  One kernel.
extern "C" int repro_neighbor_gather(const void* vertices, int64_t b,
                                     const void* offsets, int64_t n_off,
                                     int64_t offsets_are_64, const void* targets,
                                     int64_t e, void* out, void* degrees,
                                     int64_t width, void* stream) {
  if (b <= 0) return static_cast<int>(cudaSuccess);
  if ((b + 31) / 32 / kWarps >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const int32_t*>(vertices);
  auto t = static_cast<const int32_t*>(targets);
  auto o = static_cast<int32_t*>(out);
  auto d = static_cast<int32_t*>(degrees);
  if (offsets_are_64) {
    launch(v, b, static_cast<const int64_t*>(offsets), n_off, t, e, o, d,
           width, s);
  } else {
    launch(v, b, static_cast<const int32_t*>(offsets), n_off, t, e, o, d,
           width, s);
  }
  return static_cast<int>(cudaGetLastError());
}
