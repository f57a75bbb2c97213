// First-order linear recurrence h_t = a_t * h_{t-1} + b_t, for Hopper
// (sm_90a).
//
// Replaces: no Pallas kernel.  It stands where the reference runs XLA's
// `jax.lax.associative_scan` over each 256-token chunk of a recurrent
// layer (src/repro/models/mamba.py:61, src/repro/models/rglru.py:75), with
// the combine (a1*a2, b1*a2 + b2) and then h = cA*h0 + cB.  Both layers
// reduce to this recurrence: RG-LRU over its W channels, Mamba over
// d_inner * d_state channels (the read by C stays a torch product).
//
// What bounds it: memory.  It reads a and b and writes h once, 12 bytes an
// element (plus h0), and does one multiply and one add an element: 2 FLOPs
// over 12 bytes is far below the card's ratio of FLOPs to bytes.  At
// Mamba's chunk, (2, 256, 8192 * 16), that is 805 MB: 0.24 ms at 3.35
// TB/s.  RG-LRU at batch 1 has only W = 2,560 channels: 2,560 threads, 10
// blocks on 132 SMs, each walking all T steps in turn.  That is known and
// left for later; a fused selective-scan kernel (exp(dt * A) and dt * B * u
// made inside, C read inside, no (B, L, d_inner, d_state) tensor at all) is
// later work.
//
// Design (simple and right):
//   * one thread per (batch row, channel); it walks T in order (or from the
//     end, reversed) and keeps h in a register;
//   * neighbouring threads own neighbouring channels, so each warp's loads
//     of a_t and b_t and its store of h_t are 128 contiguous bytes;
//   * the time loop is unrolled by kUnroll: the loads of a group are issued
//     before the dependent chain of multiply-adds consumes them;
//   * a*h and then + b are rounded separately (__fmul_rn, __fadd_rn: nvcc
//     would otherwise contract them to one FMA), so the result is bitwise
//     the sequential torch loop `h = a[:, t] * h + b[:, t]`.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ h,
                   int64_t rows, int64_t steps, int64_t channels) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= rows * channels) return;
  const int64_t row = i / channels;
  const int64_t base = row * steps * channels + (i - row * channels);
  float state = h0[i];
  int64_t s = 0;
  for (; s + kUnroll <= steps; s += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t t = kReverse ? steps - 1 - (s + k) : s + k;
      av[k] = __ldg(a + base + t * channels);
      bv[k] = __ldg(b + base + t * channels);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t t = kReverse ? steps - 1 - (s + k) : s + k;
      state = __fadd_rn(__fmul_rn(av[k], state), bv[k]);
      h[base + t * channels] = state;
    }
  }
  for (; s < steps; ++s) {
    const int64_t t = kReverse ? steps - 1 - s : s;
    state = __fadd_rn(__fmul_rn(__ldg(a + base + t * channels), state),
                      __ldg(b + base + t * channels));
    h[base + t * channels] = state;
  }
}

}  // namespace

// a, b, h: (rows, steps, channels) f32, contiguous; h0: (rows, channels)
// f32.  h[r, t] = a[r, t] * h[r, t - 1] + b[r, t] from h[r, -1] = h0[r]
// (reverse: h[r, t] = a[r, t] * h[r, t + 1] + b[r, t] from h[r, steps] =
// h0[r]).  One kernel on `stream`; nothing is launched for an empty input.
extern "C" int repro_linear_scan(const void* a, const void* b,
                                 const void* h0, void* h, int64_t rows,
                                 int64_t steps, int64_t channels,
                                 int64_t reverse, void* stream) {
  if (rows <= 0 || steps <= 0 || channels <= 0)
    return static_cast<int>(cudaSuccess);
  const int64_t blocks = (rows * channels + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* av = static_cast<const float*>(a);
  const float* bv = static_cast<const float*>(b);
  const float* hv = static_cast<const float*>(h0);
  float* out = static_cast<float*>(h);
  if (reverse) {
    linear_scan_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(av, bv, hv, out, rows, steps, channels);
  } else {
    linear_scan_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(av, bv, hv, out, rows, steps, channels);
  }
  return static_cast<int>(cudaGetLastError());
}
