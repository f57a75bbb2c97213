// Edgelist parse for Hopper (sm_90a): the byte-domain parse, and the loader's
// fused parse + batch packing.
//
// Replaces: src/repro/kernels/parse_edges/kernel.py:125 `parse_bytes_kernel`
// (body `_parse_bytes_body`, kernel.py:40), and on the loader's path also the
// batch compaction the reference runs after it as XLA ops
// (src/repro/core/parse.py:232 `_compact_accumulate`, called by
// `parse_accumulate`, :301).  Two entry points share the tile machinery:
//
// * `repro_parse_bytes` keeps the kernel's contract: for every byte of every
//   block, `valid` says whether the byte is an owned newline that ends a
//   well-formed edge line; at valid bytes `src`/`dst`/`w` hold that line's
//   values.  `src`/`dst`/`w` are left unwritten elsewhere.
// * `repro_parse_accumulate` writes the batch's edges straight into the
//   packed accumulators at the device-resident running total: edge k of the
//   batch (row-major (block, byte) order) goes to slot total + k, edges with
//   k >= edge_bound are dropped, the window's other slots [total + count,
//   total + edge_bound) get the padding values -1 / -1 / 0.0, and
//   total + count goes to a separate 0-d output.  Bitwise the same as
//   `parse_bytes` followed by the compaction, for any accumulators.
//
// What bounds it: memory.  Each input byte is read once (plus a 256-byte
// halo per 3,840-byte tile); `parse_bytes` writes one `valid` byte per input
// byte and the values at line ends; `parse_accumulate` writes 8 (12
// weighted) bytes per window slot.  The arithmetic is a handful of compares
// per byte.
//
// Design.  The TPU body runs a whole-block chain of cumulative sums and
// maxima, because a TPU core walks its block in order.  Here a CTA of 256
// threads owns a tile of kTile = 3,840 bytes of one row:
//   * it copies the tile and the kHalo = 256 bytes before it into shared
//     memory, 16 bytes a thread (one int4 load where aligned); rows alias
//     each other by `overlap` bytes and are read through the row stride, so
//     the (nb, buf_len) view is never materialised;
//   * each thread finds the newlines among its 16 bytes; a block scan of
//     their counts writes the window's newline offsets, in order, to a
//     shared list;
//   * one thread per listed line end that lies in the tile and in the owned
//     range parses its line from shared memory (the previous list entry + 1
//     is the line's start).  A line that starts before the window (longer
//     than the halo) is found by walking back in global memory: slow, rare,
//     and right for a line of any length inside a block;
//   * `parse_bytes` marks the valid line ends in a shared flag array and
//     writes `valid` 16 bytes a thread;
//   * `parse_accumulate` ranks the tile's valid lines with a block scan and
//     stages their edges in shared memory (a valid line is at least 4 bytes
//     with its newline, so a tile holds at most 960), takes the tile's edge
//     offset across the batch from the decoupled look-back of
//     `lookback.cuh`, and writes the staged edges to consecutive slots.  Its
//     CTAs loop over tiles from the tile counter; once the counter is past
//     the last tile, every tile has been taken by a running CTA, so each
//     CTA may wait for the batch's count (the last tile's inclusive prefix)
//     and then writes its share of the padding.
//
// Numerics follow the reference exactly (`parse_line`):
// * a token's value is sum(digit * 10^min(digits after it, 9)), wrapping in
//   32 bits; it is computed in uint32, because signed overflow is undefined;
// * a weight is float(value) / 10^(digits after the token's last dot), with
//   IEEE division (build without --use_fast_math), negated when the token
//   holds a minus anywhere; a missing weight is 1.0.
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                   // bytes a thread loads and scans
constexpr int kWindow = kThreads * kChunk;   // 4,096 bytes in shared memory
constexpr int kHalo = 256;                   // bytes before the tile
constexpr int kTile = kWindow - kHalo;       // 3,840 bytes a CTA owns
constexpr int kMaxEdges = (kTile + 3) / 4;   // 960 valid lines per tile
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

// Parse line bytes p[0, len) (no newline inside; shared or global memory).
// Returns whether the line is a well-formed edge: >= 2 tokens and only
// token, blank or CR bytes.
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

// The batch's parse geometry: each row's byte region [lo, hi) is cut into
// tiles of kTile bytes, tiles numbered row-major.
struct Geometry {
  const uint8_t* bufs;
  int64_t row_stride, buf_len, lo, hi, tiles_per_row;
  int64_t owned_start, owned_end;
};

// One tile's place: its row, and the window [win_lo, win_lo + win_len) of
// row-local bytes in shared memory, whose tile part starts at tile_off.
struct Tile {
  const uint8_t* row;
  int64_t row_index, win_lo;
  int win_len, tile_off;
};

__device__ __forceinline__ Tile locate(const Geometry& g, uint32_t t) {
  Tile tile;
  tile.row_index = t / g.tiles_per_row;
  const int64_t tile_lo = g.lo + (t - tile.row_index * g.tiles_per_row) *
                                     static_cast<int64_t>(kTile);
  const int64_t tile_hi = tile_lo + kTile < g.hi ? tile_lo + kTile : g.hi;
  tile.row = g.bufs + tile.row_index * g.row_stride;
  tile.win_lo = tile_lo > kHalo ? tile_lo - kHalo : 0;
  tile.win_len = static_cast<int>(tile_hi - tile.win_lo);
  tile.tile_off = static_cast<int>(tile_lo - tile.win_lo);
  return tile;
}

// Exclusive scan of one value per thread across the CTA; `total` gets the
// sum.  `warp_tot` is __shared__ [kWarps].  Every thread must call it.
__device__ __forceinline__ uint32_t block_exclusive(uint32_t v,
                                                    uint32_t* warp_tot,
                                                    uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t incl = repro::warp_inclusive_sum(v);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  uint32_t before = 0u, all = 0u;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const uint32_t t = warp_tot[k];
    before += k < warp ? t : 0u;
    all += t;
  }
  __syncthreads();  // warp_tot is reused by the next call
  *total = all;
  return before + incl - v;
}

// Copy the tile's window to shared memory, 16 bytes a thread (zeros past
// win_len), and list its newline offsets in order.  Returns the number of
// newlines; the list is complete when it returns.
__device__ int load_and_find_newlines(const Tile& tile, uint8_t* bytes,
                                      uint16_t* nl, uint32_t* warp_tot) {
  const int c0 = threadIdx.x * kChunk;
  const uint8_t* g = tile.row + tile.win_lo + c0;
  uint4 q;
  if (c0 + kChunk <= tile.win_len &&
      (reinterpret_cast<uintptr_t>(g) & 15u) == 0) {
    q = __ldg(reinterpret_cast<const uint4*>(g));
  } else {
    uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (c0 + j < tile.win_len) {
        word[j >> 2] |= static_cast<uint32_t>(g[j]) << (8 * (j & 3));
      }
    }
    q = make_uint4(word[0], word[1], word[2], word[3]);
  }
  reinterpret_cast<uint4*>(bytes)[threadIdx.x] = q;
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
  uint32_t mask = 0u;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const uint32_t c = (words[j >> 2] >> (8 * (j & 3))) & 0xffu;
    if (c == '\n' && c0 + j < tile.win_len) mask |= 1u << j;
  }
  uint32_t total;
  uint32_t at = block_exclusive(__popc(mask), warp_tot, &total);
  while (mask) {
    nl[at++] = static_cast<uint16_t>(c0 + __ffs(mask) - 1);
    mask &= mask - 1u;
  }
  __syncthreads();
  return static_cast<int>(total);
}

// Parse list entry j when it is an owned line end inside the tile; returns
// whether it ends a well-formed edge line.
__device__ bool parse_entry(const Geometry& g, const Tile& tile,
                            const uint8_t* bytes, const uint16_t* nl, int j,
                            int32_t base, bool weighted, int32_t* src,
                            int32_t* dst, float* w) {
  const int pos = nl[j];
  const int64_t i = tile.win_lo + pos;
  if (pos < tile.tile_off || i < g.owned_start || i >= g.owned_end) {
    return false;
  }
  if (j > 0 || tile.win_lo == 0) {
    const int start = j > 0 ? nl[j - 1] + 1 : 0;
    return parse_line(bytes + start, pos - start, base, weighted, src, dst,
                      w);
  }
  // the line starts before the window: find its start in global memory
  int64_t s = tile.win_lo;
  while (s > 0 && tile.row[s - 1] != '\n') --s;
  return parse_line(tile.row + s, i - s, base, weighted, src, dst, w);
}

__global__ void __launch_bounds__(kThreads)
parse_bytes_kernel(Geometry g, int32_t base, bool weighted,
                   uint8_t* __restrict__ valid, int32_t* __restrict__ src,
                   int32_t* __restrict__ dst, float* __restrict__ w) {
  __shared__ __align__(16) uint8_t bytes[kWindow];
  __shared__ __align__(16) uint8_t ok[kWindow];
  __shared__ uint16_t nl[kWindow];
  __shared__ uint32_t warp_tot[kWarps];
  const Tile tile = locate(g, blockIdx.x);
  const int c0 = threadIdx.x * kChunk;
  reinterpret_cast<uint4*>(ok)[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  const int n_nl = load_and_find_newlines(tile, bytes, nl, warp_tot);

  const int64_t out_row = tile.row_index * g.buf_len + tile.win_lo;
  for (int j = threadIdx.x; j < n_nl; j += kThreads) {
    int32_t s, d;
    float wt;
    if (parse_entry(g, tile, bytes, nl, j, base, weighted, &s, &d, &wt)) {
      const int64_t at = out_row + nl[j];
      src[at] = s;
      dst[at] = d;
      if (weighted) w[at] = wt;
      ok[nl[j]] = 1;
    }
  }
  __syncthreads();

  // this thread's 16 bytes of `valid`, where they lie in the tile
  uint8_t* out = valid + out_row;
  if (c0 >= tile.tile_off && c0 + kChunk <= tile.win_len &&
      (reinterpret_cast<uintptr_t>(out + c0) & 15u) == 0) {
    reinterpret_cast<uint4*>(out + c0)[0] =
        reinterpret_cast<const uint4*>(ok)[threadIdx.x];
  } else {
    for (int p = max(c0, tile.tile_off); p < min(c0 + kChunk, tile.win_len);
         ++p) {
      out[p] = ok[p];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
parse_accumulate_kernel(Geometry g, int32_t base, bool weighted,
                        uint32_t ntiles, int32_t* __restrict__ acc_src,
                        int32_t* __restrict__ acc_dst,
                        float* __restrict__ acc_w, int64_t capacity,
                        const int32_t* __restrict__ total_in,
                        int32_t* __restrict__ total_out, int64_t edge_bound,
                        repro::u64* scratch) {
  __shared__ __align__(16) uint8_t bytes[kWindow];
  __shared__ uint16_t nl[kWindow];
  __shared__ int32_t staged_src[kMaxEdges];
  __shared__ int32_t staged_dst[kMaxEdges];
  __shared__ float staged_w[kMaxEdges];
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ uint32_t tile_slot, tile_prefix;
  const int64_t total = *total_in;

  for (;;) {
    const uint32_t t = repro::next_tile(scratch, &tile_slot);
    if (t >= ntiles) break;
    const Tile tile = locate(g, t);
    const int n_nl = load_and_find_newlines(tile, bytes, nl, warp_tot);

    // rank the tile's edges in line order, 256 list entries a round
    uint32_t kept = 0u;
    for (int r0 = 0; r0 < n_nl; r0 += kThreads) {
      const int j = r0 + threadIdx.x;
      int32_t s = 0, d = 0;
      float wt = 0.0f;
      const bool ok = j < n_nl && parse_entry(g, tile, bytes, nl, j, base,
                                              weighted, &s, &d, &wt);
      uint32_t round_total;
      const uint32_t k = kept + block_exclusive(ok ? 1u : 0u, warp_tot,
                                                &round_total);
      if (ok && k < kMaxEdges) {
        staged_src[k] = s;
        staged_dst[k] = d;
        staged_w[k] = wt;
      }
      kept += round_total;
    }

    // the tile's edge offset across the batch
    if (threadIdx.x < 32) {
      const uint32_t prefix = repro::warp_lookback(scratch, t, kept);
      if (threadIdx.x == 0) tile_prefix = prefix;
    }
    __syncthreads();
    const uint32_t prefix = tile_prefix;
    for (uint32_t k = threadIdx.x; k < kept && k < kMaxEdges; k += kThreads) {
      const int64_t dest = static_cast<int64_t>(prefix) + k;
      const int64_t slot = total + dest;
      if (dest < edge_bound && slot < capacity) {
        acc_src[slot] = staged_src[k];
        acc_dst[slot] = staged_dst[k];
        if (acc_w != nullptr) acc_w[slot] = staged_w[k];
      }
    }
  }

  // every tile has been taken by a running CTA: wait for the batch's count
  if (threadIdx.x == 0) {
    tile_prefix = ntiles ? repro::wait_inclusive(scratch, ntiles - 1) : 0u;
  }
  __syncthreads();
  const uint32_t count = tile_prefix;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *total_out = static_cast<int32_t>(static_cast<uint32_t>(total) + count);
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t dest = count + static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
       dest < edge_bound; dest += step) {
    const int64_t slot = total + dest;
    if (slot >= capacity) break;
    acc_src[slot] = -1;
    acc_dst[slot] = -1;
    if (acc_w != nullptr) acc_w[slot] = 0.0f;
  }
}

Geometry geometry(const void* bufs, int64_t row_stride, int64_t buf_len,
                  int64_t lo, int64_t hi, int64_t owned_start,
                  int64_t owned_end) {
  Geometry g;
  g.bufs = static_cast<const uint8_t*>(bufs);
  g.row_stride = row_stride;
  g.buf_len = buf_len;
  g.lo = lo < 0 ? 0 : lo;
  g.hi = hi > buf_len ? buf_len : hi;
  g.tiles_per_row = g.hi > g.lo ? (g.hi - g.lo + kTile - 1) / kTile : 0;
  g.owned_start = owned_start;
  g.owned_end = owned_end;
  return g;
}

// the loader's region of a row: only owned bytes can end an edge
Geometry owned_geometry(const void* bufs, int64_t row_stride, int64_t buf_len,
                        int64_t owned_start, int64_t owned_end) {
  return geometry(bufs, row_stride, buf_len, owned_start, owned_end,
                  owned_start, owned_end);
}

}  // namespace

extern "C" int repro_parse_bytes(const void* bufs, int64_t row_stride,
                                 int64_t nb, int64_t buf_len,
                                 int64_t owned_start, int64_t owned_end,
                                 int64_t base, int64_t weighted, void* valid,
                                 void* src, void* dst, void* w,
                                 void* stream) {
  if (nb <= 0 || buf_len <= 0) return static_cast<int>(cudaSuccess);
  // every byte of a row gets its `valid` byte, so the region is the row
  const Geometry g = geometry(bufs, row_stride, buf_len, 0, buf_len,
                              owned_start, owned_end);
  const int64_t ntiles = nb * g.tiles_per_row;
  if (ntiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  parse_bytes_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<int32_t>(base), weighted != 0,
      static_cast<uint8_t*>(valid), static_cast<int32_t*>(src),
      static_cast<int32_t*>(dst), static_cast<float*>(w));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of look-back scratch `repro_parse_accumulate` needs for a batch.
extern "C" int64_t repro_parse_accumulate_scratch_bytes(
    int64_t nb, int64_t buf_len, int64_t owned_start, int64_t owned_end) {
  const Geometry g = owned_geometry(nullptr, 0, buf_len, owned_start,
                                    owned_end);
  return 8 * repro::scratch_words(nb > 0 ? nb * g.tiles_per_row : 0);
}

// Parse a batch and pack its edges into acc_src/acc_dst/acc_w (capacity
// slots each; acc_w may be null) at *total_in; writes *total_in + count to
// *total_out.  One memset and one kernel on `stream`.
extern "C" int repro_parse_accumulate(
    const void* bufs, int64_t row_stride, int64_t nb, int64_t buf_len,
    int64_t owned_start, int64_t owned_end, int64_t base, int64_t weighted,
    void* acc_src, void* acc_dst, void* acc_w, int64_t capacity,
    const void* total_in, void* total_out, int64_t edge_bound, void* scratch,
    void* stream) {
  const Geometry g = owned_geometry(bufs, row_stride, buf_len, owned_start,
                                    owned_end);
  const int64_t ntiles = nb > 0 ? nb * g.tiles_per_row : 0;
  if (ntiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, repro_parse_accumulate_scratch_bytes(nb, buf_len,
                                                       owned_start, owned_end),
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a persistent grid: as many CTAs as fit at once, at most one per tile
  static int per_sm = 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, parse_accumulate_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t grid = ntiles < 1 ? 1 : (ntiles < resident ? ntiles : resident);
  parse_accumulate_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      g, static_cast<int32_t>(base), weighted != 0,
      static_cast<uint32_t>(ntiles), static_cast<int32_t*>(acc_src),
      static_cast<int32_t*>(acc_dst), static_cast<float*>(acc_w), capacity,
      static_cast<const int32_t*>(total_in), static_cast<int32_t*>(total_out),
      edge_bound, static_cast<repro::u64*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
