// Per-byte edgelist parse for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/parse_edges/kernel.py:125 `parse_bytes_kernel`
// (body `_parse_bytes_body`, kernel.py:40).  Same contract: for every byte of
// every block, `valid` says whether the byte is an owned newline that ends a
// well-formed edge line; at valid bytes `src`/`dst`/`w` hold that line's
// values.  `src`/`dst`/`w` are left unwritten elsewhere.
//
// What bounds it: memory.  Each input byte is read once from device memory
// (neighbouring threads read neighbouring bytes) and one `valid` byte is
// written per input byte; the values are written only at line ends.  The
// arithmetic per byte is a handful of compares, far below the card's rate.
//
// Design.  The TPU body runs a whole-block chain of cumulative sums and
// maxima, because a TPU core walks its block in order.  Here one thread owns
// one byte.  A thread whose byte is an owned newline walks back to the
// previous newline (or to byte 0 of its own block's buffer) and parses that
// one line left to right; every other thread writes `valid = 0` and exits.
// So lines of any length inside a block parse right, no tile needs a halo,
// and no state crosses threads.  The input is the flat staged span plus the
// row stride `beta`: block rows alias each other by `overlap` bytes, so the
// (nb, buf_len) view is never materialised.
//
// Numerics follow the reference exactly:
// * a token's value is sum(digit * 10^min(digits after it, 9)), wrapping in
//   32 bits; it is computed in uint32, because signed overflow is undefined;
// * a weight is float(value) / 10^(digits after the token's last dot), with
//   IEEE division (build without --use_fast_math), negated when the token
//   holds a minus anywhere; a missing weight is 1.0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDigits = 9;

__constant__ uint32_t kPow10U[kMaxDigits + 1] = {
    1u, 10u, 100u, 1000u, 10000u, 100000u, 1000000u, 10000000u,
    100000000u, 1000000000u};
// float32 powers of ten; every one of them is exact in float32
__constant__ float kPow10F[kMaxDigits + 1] = {
    1.0f, 10.0f, 100.0f, 1000.0f, 10000.0f, 100000.0f, 1000000.0f,
    10000000.0f, 100000000.0f, 1000000000.0f};

__device__ __forceinline__ bool is_digit(uint8_t c) { return c >= '0' && c <= '9'; }
__device__ __forceinline__ bool is_tok(uint8_t c) { return is_digit(c) || c == '.' || c == '-'; }
__device__ __forceinline__ bool is_ws(uint8_t c) { return c == ' ' || c == '\t' || c == '\r'; }

// Parse line bytes p[0, len) (no newline inside).  Returns whether the line
// is a well-formed edge: >= 2 tokens and only token, blank or CR bytes.
__device__ bool parse_line(const uint8_t* p, int64_t len, int32_t base,
                           bool weighted, int32_t* src, int32_t* dst,
                           float* w) {
  uint32_t val[3] = {0u, 0u, 0u};
  int frac = 0;
  bool neg = false;
  int ntok = 0;
  int64_t k = 0;
  while (k < len) {
    const uint8_t c = p[k];
    if (!is_tok(c)) {
      if (!is_ws(c)) return false;  // a bad byte spoils the line
      ++k;
      continue;
    }
    int64_t e = k;
    int nd = 0;
    while (e < len && is_tok(p[e])) {
      nd += is_digit(p[e]);
      ++e;
    }
    if (ntok < 3) {
      uint32_t v = 0u;
      int seen = 0, after_dot = 0;
      bool dot = false, minus = false;
      for (int64_t j = k; j < e; ++j) {
        const uint8_t cj = p[j];
        if (is_digit(cj)) {
          const int after = min(nd - seen - 1, kMaxDigits);
          v += static_cast<uint32_t>(cj - '0') * kPow10U[after];
          ++seen;
          ++after_dot;
        } else if (cj == '.') {
          dot = true;
          after_dot = 0;
        } else {
          minus = true;
        }
      }
      val[ntok] = v;
      if (ntok == 2) {
        frac = dot ? min(after_dot, kMaxDigits) : 0;
        neg = minus;
      }
    }
    ++ntok;
    k = e;
  }
  if (ntok < 2) return false;
  *src = static_cast<int32_t>(val[0] - static_cast<uint32_t>(base));
  *dst = static_cast<int32_t>(val[1] - static_cast<uint32_t>(base));
  if (weighted) {
    float wf = 1.0f;
    if (ntok >= 3) {
      wf = static_cast<float>(static_cast<int32_t>(val[2])) / kPow10F[frac];
      if (neg) wf = -wf;
    }
    *w = wf;
  }
  return true;
}

__global__ void parse_bytes_kernel(const uint8_t* __restrict__ bufs,
                                   int64_t row_stride, int64_t nb,
                                   int64_t buf_len, int64_t owned_start,
                                   int64_t owned_end, int32_t base,
                                   bool weighted, uint8_t* __restrict__ valid,
                                   int32_t* __restrict__ src,
                                   int32_t* __restrict__ dst,
                                   float* __restrict__ w) {
  const int64_t total = nb * buf_len;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const int64_t b = t / buf_len;
    const int64_t i = t - b * buf_len;
    const uint8_t* row = bufs + b * row_stride;
    bool ok = false;
    if (row[i] == '\n' && i >= owned_start && i < owned_end) {
      int64_t s = i;
      while (s > 0 && row[s - 1] != '\n') --s;
      ok = parse_line(row + s, i - s, base, weighted, src + t, dst + t,
                      weighted ? w + t : nullptr);
    }
    valid[t] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int repro_parse_bytes(const void* bufs, int64_t row_stride,
                                 int64_t nb, int64_t buf_len,
                                 int64_t owned_start, int64_t owned_end,
                                 int64_t base, int64_t weighted, void* valid,
                                 void* src, void* dst, void* w,
                                 void* stream) {
  const int64_t total = nb * buf_len;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const int64_t want = (total + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(want < (1LL << 30) ? want : (1LL << 30));
  parse_bytes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bufs), row_stride, nb, buf_len, owned_start,
      owned_end, static_cast<int32_t>(base), weighted != 0,
      static_cast<uint8_t*>(valid), static_cast<int32_t*>(src),
      static_cast<int32_t*>(dst), static_cast<float*>(w));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
