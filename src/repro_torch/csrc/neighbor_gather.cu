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
// re-aligned it with a roll; here one warp owns one vertex, its lanes stride
// over the row, so the reads of `targets` (a contiguous CSR row) and the
// writes of the output row are coalesced.  Lane 0 writes the degree.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int64_t jax_index(int32_t u, int64_t n) {
  int64_t i = u < 0 ? static_cast<int64_t>(u) + n : static_cast<int64_t>(u);
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

template <typename Off>
__global__ void neighbor_gather_kernel(const int32_t* __restrict__ vertices,
                                       int64_t b,
                                       const Off* __restrict__ offsets,
                                       int64_t n_off,
                                       const int32_t* __restrict__ targets,
                                       int64_t e, int32_t* __restrict__ out,
                                       int32_t* __restrict__ degrees,
                                       int64_t width) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= b) return;
  const int32_t u = vertices[row];
  const int32_t u1 = static_cast<int32_t>(static_cast<uint32_t>(u) + 1u);
  const int64_t lo = static_cast<int64_t>(offsets[jax_index(u, n_off)]);
  const int64_t hi = static_cast<int64_t>(offsets[jax_index(u1, n_off)]);
  const int64_t deg = hi - lo;
  const int64_t take = deg < width ? deg : width;
  int32_t* dst = out + row * width;
  for (int64_t j = lane; j < width; j += 32) {
    const int64_t at = lo + j;
    // at < e and at >= 0 hold for a CSR's offsets; they keep the read in
    // bounds whatever the caller passes
    dst[j] = (j < take && at >= 0 && at < e) ? targets[at] : -1;
  }
  if (lane == 0) degrees[row] = static_cast<int32_t>(deg);
}

}  // namespace

extern "C" int repro_neighbor_gather(const void* vertices, int64_t b,
                                     const void* offsets, int64_t n_off,
                                     int64_t offsets_are_64, const void* targets,
                                     int64_t e, void* out, void* degrees,
                                     int64_t width, void* stream) {
  if (b <= 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = static_cast<unsigned>((b + kWarps - 1) / kWarps);
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const int32_t*>(vertices);
  auto t = static_cast<const int32_t*>(targets);
  auto o = static_cast<int32_t*>(out);
  auto d = static_cast<int32_t*>(degrees);
  if (offsets_are_64) {
    neighbor_gather_kernel<int64_t><<<grid, kThreads, 0, s>>>(
        v, b, static_cast<const int64_t*>(offsets), n_off, t, e, o, d, width);
  } else {
    neighbor_gather_kernel<int32_t><<<grid, kThreads, 0, s>>>(
        v, b, static_cast<const int32_t*>(offsets), n_off, t, e, o, d, width);
  }
  return static_cast<int>(cudaGetLastError());
}
