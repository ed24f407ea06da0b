// Warp collectives shared by the kernels: sums, scans, and lower bounds
// over a sorted int32 array in device memory that one warp finds together.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The first indices i in [lo, hi) with a[i] >= key1 and with a[i] >= key2
// (or hi), a[lo, hi) sorted ascending. All 32 lanes call it with the same
// arguments and get the same answers. Each round the lanes load 32 evenly
// spaced entries for each search still wider than a warp, and a ballot
// keeps the gap that holds the answer: a range of n entries takes about
// log33(n) + 1 dependent loads (4 for 65,536) instead of log2(n), and the
// two searches the latency of one.
__device__ __forceinline__ void warp_lower_bounds(
    const int32_t* __restrict__ a, int64_t lo, int64_t hi, int64_t key1,
    int64_t key2, int lane, int64_t* r1, int64_t* r2) {
  int64_t lo1 = lo, hi1 = hi, lo2 = lo, hi2 = hi;
  while (hi1 - lo1 > 32 || hi2 - lo2 > 32) {
    const bool w1 = hi1 - lo1 > 32, w2 = hi2 - lo2 > 32;
    const int64_t i1 = lo1 + ((hi1 - lo1) * (lane + 1)) / 33;
    const int64_t i2 = lo2 + ((hi2 - lo2) * (lane + 1)) / 33;
    const int32_t x1 = w1 ? __ldg(a + i1) : 0;
    const int32_t x2 = w2 ? __ldg(a + i2) : 0;
    if (w1) {
      const int c = __popc(__ballot_sync(kFullMask, (int64_t)x1 < key1));
      const int64_t below = __shfl_sync(kFullMask, i1, c > 0 ? c - 1 : 0);
      const int64_t above = __shfl_sync(kFullMask, i1, c < 32 ? c : 31);
      if (c > 0) lo1 = below + 1;
      if (c < 32) hi1 = above;
    }
    if (w2) {
      const int c = __popc(__ballot_sync(kFullMask, (int64_t)x2 < key2));
      const int64_t below = __shfl_sync(kFullMask, i2, c > 0 ? c - 1 : 0);
      const int64_t above = __shfl_sync(kFullMask, i2, c < 32 ? c : 31);
      if (c > 0) lo2 = below + 1;
      if (c < 32) hi2 = above;
    }
  }
  const bool l1 = lo1 + lane < hi1 && (int64_t)__ldg(a + lo1 + lane) < key1;
  const bool l2 = lo2 + lane < hi2 && (int64_t)__ldg(a + lo2 + lane) < key2;
  *r1 = lo1 + __popc(__ballot_sync(kFullMask, l1));
  *r2 = lo2 + __popc(__ballot_sync(kFullMask, l2));
}
