// K3: CSR slice gather into a padded (K, bucket) tile.
//
// Replaces mygramdb_tpu/ops/posting_ops.py::_gather_slices_pallas (kernel
// _slice_gather_kernel), whose semantics the TPU served with an XLA scan:
//
//   out[k, j] = postings[off[k] + j]  if j < len[k] and 0 <= off[k] + j < P
//               SENTINEL (2^31 - 1)    otherwise
//
// The loads are masked, so the postings array needs no pad tail: a dense
// term's offset points at P (its slice is not on the device) and reads only
// sentinels. Offsets and lengths are int64 (no 2^31-entry limit).
//
// What bounds it: the bytes it writes, K * bucket * 4 (the bytes read are
// at most as many). Neighbouring threads copy neighbouring entries of one
// slice, so both sides coalesce; one block row (blockIdx.y) per slice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kSentinel = 0x7FFFFFFF;

__global__ void __launch_bounds__(kThreads)
slice_gather_kernel(const int32_t* __restrict__ post, int64_t P,
                    const int64_t* __restrict__ offs,
                    const int64_t* __restrict__ lens, int K, int bucket,
                    int32_t* __restrict__ out) {
  for (int k = blockIdx.y; k < K; k += gridDim.y) {
    const int64_t off = offs[k];
    const int64_t len = lens[k];
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < bucket;
         j += (int64_t)gridDim.x * blockDim.x) {
      const int64_t p = off + j;
      out[(int64_t)k * bucket + j] =
          (j < len && p >= 0 && p < P) ? __ldg(post + p) : kSentinel;
    }
  }
}

}  // namespace

// postings (P,), offsets (K,) int64, lengths (K,) int64, out (K, bucket);
// returns cudaGetLastError() after the launch.
extern "C" int mygram_slice_gather(const void* postings, long long P,
                                   const void* offsets, const void* lengths,
                                   int K, int bucket, void* out, void* stream) {
  if (K > 0 && bucket > 0) {
    const int gx_need = (bucket + kThreads - 1) / kThreads;
    const unsigned gx = (unsigned)(gx_need < 1024 ? gx_need : 1024);
    const unsigned gy = (unsigned)(K < 65535 ? K : 65535);
    slice_gather_kernel<<<dim3(gx, gy), kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)postings, P, (const int64_t*)offsets,
        (const int64_t*)lengths, K, bucket, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
