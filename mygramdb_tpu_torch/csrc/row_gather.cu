// P1: row gather, out[i, :] = src[ids[i], :].
//
// Replaces e2e/profile_gather.py::rows_pallas (kernel row_kern), the
// profiling probe's copy of R rows of the padded text matrix. It serves no
// query: mygramdb_tpu_torch/tools/profile_gather.py times it.
//
// What bounds it: device-memory bytes, R * row_bytes read and as many
// written; it does no arithmetic. One block copies one output row (blocks
// stride over the rows), each thread 16 bytes at a time, neighbouring
// threads on neighbouring addresses, so both sides coalesce. A row's base
// is a 64-bit product: ids[i] * row_bytes passes 2^31 for a matrix of a
// million rows of 2 KB. The TPU kernel's scalar-prefetched index map
// becomes one load of ids[i] per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // a 2 KB row is 128 16-byte vectors

// rv: row width in uint4 units (row_bytes / 16).
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ src, int64_t rv,
                   const int32_t* __restrict__ ids, int64_t R,
                   uint4* __restrict__ out) {
  for (int64_t i = blockIdx.x; i < R; i += gridDim.x) {
    const uint4* s = src + (int64_t)ids[i] * rv;
    uint4* d = out + i * rv;
    for (int64_t j = threadIdx.x; j < rv; j += blockDim.x) d[j] = __ldg(s + j);
  }
}

}  // namespace

// src (N, rowT) of any element type with row_bytes = rowT * itemsize a
// multiple of 16, ids (R,) int32 in [0, N), out (R, rowT); src and out
// contiguous and 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int mygram_gather_rows(const void* src, long long row_bytes,
                                  const void* ids, long long R, void* out,
                                  void* stream) {
  if (R > 0 && row_bytes > 0) {
    const unsigned grid = (unsigned)(R < (1LL << 30) ? R : (1LL << 30));
    gather_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)src, row_bytes / 16, (const int32_t*)ids, R,
        (uint4*)out);
  }
  return (int)cudaGetLastError();
}
