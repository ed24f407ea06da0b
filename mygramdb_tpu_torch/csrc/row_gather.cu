// P1: row gather, out[i, :] = src[ids[i], :].
//
// Replaces e2e/profile_gather.py::rows_pallas (kernel row_kern), the
// profiling probe's copy of R rows of the padded text matrix. It serves no
// query: mygramdb_tpu_torch/tools/profile_gather.py times it.
//
// What bounds it: device-memory bytes, R * row_bytes read and as many
// written; it does no arithmetic. The card needs about 3.35 TB/s x 1 us of
// bytes in flight (some 26 KB an SM) to reach that rate.
//
// Design: a persistent grid (the blocks the card holds at once, counted
// for each device) of warps, a warp per row: each lane issues all its
// 16-byte loads of a span of 32 * kUnroll vectors (a whole 2 KB row)
// before its stores, and the warp's next row id is loaded before the copy,
// so that its latency hides behind it. A row's base is a 64-bit product:
// ids[i] * row_bytes passes 2^31 for a matrix of a million rows of 2 KB.
// The TPU kernel's scalar-prefetched index map becomes that row-id load.
// A version that copied rows with the bulk copy engine (TMA: one lane a
// warp issuing cp.async.bulk loads into a ring of shared-memory stages and
// bulk stores out of them) measured 1-2% slower on the H100 and was not
// kept.

#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int kWarps = 8;    // rows in flight a block
constexpr int kUnroll = 4;   // 16-byte vectors a lane loads before storing

__global__ void __launch_bounds__(kWarps * 32)
gather_rows_kernel(const uint4* __restrict__ src, int64_t rv,
                   const int32_t* __restrict__ ids, int64_t R,
                   uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t nw = (int64_t)gridDim.x * kWarps;
  int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  int32_t id = i < R ? __ldg(ids + i) : 0;
  for (; i < R; i += nw) {
    const int32_t next = i + nw < R ? __ldg(ids + i + nw) : 0;
    const uint4* s = src + (int64_t)id * rv;
    uint4* d = out + i * rv;
    for (int64_t base = 0; base < rv; base += 32 * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = base + u * 32 + lane;
        if (j < rv) v[u] = __ldg(s + j);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = base + u * 32 + lane;
        if (j < rv) d[j] = v[u];
      }
    }
    id = next;
  }
}

// The persistent grid on each device: its SM count times the blocks an SM
// holds.
PerDevice<int> grid_blocks;

}  // namespace

// src (N, rowT) of any element type with row_bytes = rowT * itemsize a
// multiple of 16, ids (R,) int32 in [0, N), out (R, rowT); src and out
// contiguous and 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch (or the set-up's error).
extern "C" int mygram_gather_rows(const void* src, long long row_bytes,
                                  const void* ids, long long R, void* out,
                                  void* stream) {
  if (R <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  int grid = 0;
  const cudaError_t e = grid_blocks.with([&](int dev, int& blocks) {
    if (blocks == 0) {
      int sms = 0, optin = 0, per_sm = 0;
      cudaError_t err = device_limits(dev, &sms, &optin);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, gather_rows_kernel, kWarps * 32, 0);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      blocks = per_sm * sms;
    }
    grid = blocks;
    return cudaSuccess;
  });
  if (e != cudaSuccess) return (int)e;
  const long long want = (R + kWarps - 1) / kWarps;
  if (grid > want) grid = (int)want;
  gather_rows_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, row_bytes / 16, (const int32_t*)ids, R,
      (uint4*)out);
  return (int)cudaGetLastError();
}
