// The staged CSR build's pair sort on Hopper (sm_90a): CUB's radix sort of
// (key, value) pairs of 32 bits each, over the keys' low `end_bit` bits, in
// double buffers that the caller owns.
//
// Replaces no TPU kernel: the reference's staged build sorts each partition
// with jnp.argsort and leaves the sort to XLA, as the port leaves it to CUB.
// It is not a hand-written kernel, and it counts no launch.
//
// Why pairs in double buffers.  The build's keys are p * V + u, so one sort
// over ceil(log2(rho * V)) bits orders every partition at once (three 8-bit
// passes for rho = 4 and V = 2^22), and the value rides along in 4 bytes: no
// int64 permutation, no gathers after the sort.  CUB's DoubleBuffer mode
// ping-pongs between the two buffers the caller passes and reports which one
// holds the result, so the sort allocates nothing beyond its scratch (a few
// bytes an item for its histograms and look-back); the caller may pass
// storage it already holds, such as the loader's accumulators.  LSD radix
// sorting is stable: equal keys keep their order.
#include <cstdint>
#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>

// Scratch bytes for n pairs over end_bit bits, or -1 if CUB refuses.
extern "C" int64_t repro_sort_pairs_scratch_bytes(int64_t n,
                                                  int64_t end_bit) {
  if (n < 0 || n > INT32_MAX || end_bit < 1 || end_bit > 32) return -1;
  cub::DoubleBuffer<uint32_t> keys(nullptr, nullptr);
  cub::DoubleBuffer<int32_t> vals(nullptr, nullptr);
  size_t bytes = 0;
  const cudaError_t status = cub::DeviceRadixSort::SortPairs(
      nullptr, bytes, keys, vals, static_cast<int>(n), 0,
      static_cast<int>(end_bit));
  return status == cudaSuccess ? static_cast<int64_t>(bytes) : -1;
}

// Sorts n pairs of (keys0, vals0) by the keys' bits [0, end_bit), using
// keys1 and vals1 as the alternate buffers; *selector is 0 if the result is
// in (keys0, vals0), 1 if in (keys1, vals1).  Launches on `stream`.
extern "C" int repro_sort_pairs(void* keys0, void* keys1, void* vals0,
                                void* vals1, int64_t n, int64_t end_bit,
                                void* scratch, int64_t scratch_bytes,
                                int32_t* selector, void* stream) {
  *selector = 0;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n > INT32_MAX || end_bit < 1 || end_bit > 32 || scratch_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cub::DoubleBuffer<uint32_t> keys(static_cast<uint32_t*>(keys0),
                                   static_cast<uint32_t*>(keys1));
  cub::DoubleBuffer<int32_t> vals(static_cast<int32_t*>(vals0),
                                  static_cast<int32_t*>(vals1));
  size_t bytes = static_cast<size_t>(scratch_bytes);
  const cudaError_t status = cub::DeviceRadixSort::SortPairs(
      scratch, bytes, keys, vals, static_cast<int>(n), 0,
      static_cast<int>(end_bit), static_cast<cudaStream_t>(stream));
  if (status != cudaSuccess) return static_cast<int>(status);
  if (keys.selector != vals.selector) {
    return static_cast<int>(cudaErrorUnknown);
  }
  *selector = keys.selector;
  return static_cast<int>(cudaGetLastError());
}
