// K1: dense row-AND with NOT rows, filter rows, tombstones and popcount.
//
// Replaces mygramdb_tpu/ops/bitmap_ops.py::dense_query_pallas (kernels
// _dense_query_kernel_kop, _dense_query_kernel, _dense_query_kernel_blocked)
// and folds in the NOT and filter forms that the JAX package sends to
// bitmap_ops.py::dense_query instead. For each query b and word w:
//
//   res[b, w] = AND_k bm[rows[b, k], w]  &  ~OR_j bm[nrows[b, j], w]
//               & AND_f extra[f, w]  &  ~deleted[w]
//   count[b]  = popcount(res[b, :])
//
// Words are uint32 bit patterns (doc d = bit d % 32 of word d / 32); torch
// holds them as int32.
//
// What bounds it: device-memory bytes. It reads B * (K + Kn + F + 1) * W * 4
// bytes and writes B * W * 4; the AND and popcount are a few integer
// operations per 16 bytes. So each thread moves 16 bytes (uint4) per row,
// neighbouring threads on neighbouring addresses, and reduces in registers;
// the block keeps its query's row ids in shared memory. The TPU variants
// differ only in how a row is tiled into VMEM; there is no such limit here,
// so one kernel covers every K and every W that is a multiple of 4 words
// (DeviceIndex pads W to 1024). Counts meet in one atomicAdd per
// warp into count[b], which the caller zeroes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 band(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint4 bor(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint4 bandnot(uint4 a, uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}

// wv: row width in uint4 units (W / 4). grid (ceil(wv / kThreads),
// min(B, 65535)).
__global__ void __launch_bounds__(kThreads)
dense_and_kernel(const uint4* __restrict__ bm, int64_t wv,
                 const int32_t* __restrict__ rows, int K,
                 const int32_t* __restrict__ nrows, int Kn,
                 const uint4* __restrict__ extra, int F,
                 const uint4* __restrict__ deleted,
                 int32_t* __restrict__ count, uint4* __restrict__ res, int B) {
  extern __shared__ int32_t s_rows[];  // K row ids, then Kn NOT row ids
  const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // the previous query's row ids are no longer read
    for (int i = threadIdx.x; i < K; i += blockDim.x)
      s_rows[i] = rows[(int64_t)b * K + i];
    for (int i = threadIdx.x; i < Kn; i += blockDim.x)
      s_rows[K + i] = nrows[(int64_t)b * Kn + i];
    __syncthreads();
    int pc = 0;
    if (w < wv) {
      uint4 acc = make_uint4(~0u, ~0u, ~0u, ~0u);
      for (int k = 0; k < K; ++k)
        acc = band(acc, __ldg(bm + (int64_t)s_rows[k] * wv + w));
      if (Kn > 0) {
        uint4 nacc = make_uint4(0u, 0u, 0u, 0u);
        for (int k = 0; k < Kn; ++k)
          nacc = bor(nacc, __ldg(bm + (int64_t)s_rows[K + k] * wv + w));
        acc = bandnot(acc, nacc);
      }
      for (int f = 0; f < F; ++f)
        acc = band(acc, __ldg(extra + (int64_t)f * wv + w));
      acc = bandnot(acc, __ldg(deleted + w));
      res[(int64_t)b * wv + w] = acc;
      pc = __popc(acc.x) + __popc(acc.y) + __popc(acc.z) + __popc(acc.w);
    }
    for (int o = 16; o > 0; o >>= 1) pc += __shfl_down_sync(0xFFFFFFFFu, pc, o);
    if ((threadIdx.x & 31) == 0 && pc != 0) atomicAdd(count + b, pc);
  }
}

}  // namespace

// bm (V, W), rows (B, K), nrows (B, Kn), extra (F, W), deleted (W,),
// count (B,) zeroed by the caller, res (B, W); all int32, contiguous. W is a
// multiple of 4 and bm, extra, deleted and res are 16-byte aligned (the
// wrapper checks both). Returns cudaGetLastError() after the launch.
extern "C" int mygram_dense_and(const void* bm, long long W, const void* rows,
                                int K, const void* nrows, int Kn,
                                const void* extra, int F, const void* deleted,
                                void* count, void* res, int B, void* stream) {
  if (B > 0 && W > 0) {
    const int64_t wv = W / 4;
    const unsigned gx = (unsigned)((wv + kThreads - 1) / kThreads);
    const unsigned gy = (unsigned)(B < 65535 ? B : 65535);
    const size_t smem = (size_t)(K + Kn) * sizeof(int32_t);
    dense_and_kernel<<<dim3(gx, gy), kThreads, smem, (cudaStream_t)stream>>>(
        (const uint4*)bm, wv, (const int32_t*)rows, K, (const int32_t*)nrows,
        Kn, (const uint4*)extra, F, (const uint4*)deleted, (int32_t*)count,
        (uint4*)res, B);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mygram_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
