// K4, K5, K6: window term frequencies over the device text pack.
//
// Replaces three Pallas kernels of mygramdb_tpu/ops/verify_ops.py with one
// family:
//   K4 tf_rows_flat_pallas        rows address the flat code-point pack
//   K5 tf_rows_flat_global_pallas rows packed across a batch into a live
//                                 prefix; each row names its needle set
//   K6 tf_rows_pallas             rows are rows of the padded matrix
//
// For row r (M rows) with needle set o = owner ? owner[r] : r / Kv:
//   cells c[p], p < win + cap: text[start[r] + p]; flat rows read the
//     sentinel past lens[r], padded rows read the matrix as it is
//   doc_len: lens[r] (flat) or the count of non-sentinel cells (padded)
//   tf_j = #{ p < win : for all k < min(nl_j, cap): c[p + k] == ndl[o][j][k]
//                      and (!use_range or p + nl_j <= doc_len) }
//          counted leftmost-greedy when nonoverlap (a match at p blocks
//          the starts before p + nl_j), 0 when nl_j == 0
//   out[r] = [tf_0 .. tf_{Nn-1} | doc_len]
// Rows with lens[r] <= 0 (dead candidates, empty docs) and rows at or past
// *live (K5) write zeros without reading the text.
//
// Compare domain: u16 cells widen to 0..0xFFFF (sentinel 0xFFFF), u32
// cells are their int32 bit pattern (sentinel 0xFFFFFFFF is -1); needles
// arrive in the same domain.
//
// What bounds it: the text bytes it reads, one window of win + cap cells
// per live row (2 or 4 bytes a cell), and the int32 compares, at most
// win * sum_j min(nl_j, cap) per live row, usually about one a start since
// a mismatch ends the start. The design stages each live row's window in
// shared memory once (coalesced, length-masked loads: no pad tail is
// needed past the pack, no window bleeds into the next document) with the
// row's needle table beside it, and every needle's starts are then tested
// from shared memory. A block walks rows grid-stride, so dead rows cost
// one length load each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ int32_t cell(const T* text, int64_t i);

template <>
__device__ __forceinline__ int32_t cell<uint16_t>(const uint16_t* text,
                                                  int64_t i) {
  return (int32_t)__ldg(text + i);
}

template <>
__device__ __forceinline__ int32_t cell<uint32_t>(const uint32_t* text,
                                                  int64_t i) {
  return (int32_t)__ldg(text + i);
}

// Sum of v over the block, returned to every thread.
__device__ __forceinline__ int block_sum(int v, int* s_red, int* s_total) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // s_red and s_total are free again
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += s_red[w];
    *s_total = t;
  }
  __syncthreads();
  return *s_total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tf_rows_kernel(const T* __restrict__ text, int64_t text_len,
               const int64_t* __restrict__ starts,
               const int32_t* __restrict__ lens,
               const int32_t* __restrict__ owner,
               const int32_t* __restrict__ live,
               const int32_t* __restrict__ ndl,
               const int32_t* __restrict__ nlen, int M, int Kv, int Nn,
               int cap, int win, int padded, int use_range, int nonoverlap,
               int32_t sentinel, int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int span = win + cap;
  int32_t* cells = smem;                        // span
  int32_t* s_ndl = cells + span;                // Nn * cap
  int32_t* s_nlen = s_ndl + Nn * cap;           // Nn
  unsigned* s_flags = (unsigned*)(s_nlen + Nn);  // (win + 31) / 32
  __shared__ int s_red[kWarps];
  __shared__ int s_total;

  const int n_live = live ? *live : M;
  for (int r = blockIdx.x; r < M; r += gridDim.x) {
    int32_t* orow = out + (int64_t)r * (Nn + 1);
    const int32_t len = lens[r];
    if (r >= n_live || len <= 0) {  // the whole block takes this branch
      for (int j = threadIdx.x; j <= Nn; j += kThreads) orow[j] = 0;
      continue;
    }
    const int o = owner ? owner[r] : r / Kv;
    const int64_t base = starts[r];
    __syncthreads();  // the previous row is done with shared memory
    for (int i = threadIdx.x; i < Nn * cap; i += kThreads)
      s_ndl[i] = ndl[(int64_t)o * Nn * cap + i];
    for (int i = threadIdx.x; i < Nn; i += kThreads)
      s_nlen[i] = nlen[(int64_t)o * Nn + i];
    int nonsent = 0;
    for (int p = threadIdx.x; p < span; p += kThreads) {
      const int64_t at = base + p;
      const bool ok = at >= 0 && at < text_len && (padded || p < len);
      const int32_t v = ok ? cell<T>(text, at) : sentinel;
      cells[p] = v;
      nonsent += v != sentinel;
    }
    const int doc_len = padded ? block_sum(nonsent, s_red, &s_total) : len;
    __syncthreads();  // cells and needles staged

    for (int j = 0; j < Nn; ++j) {
      const int nl = s_nlen[j];
      if (nl <= 0) {
        if (threadIdx.x == 0) orow[j] = 0;
        continue;
      }
      const int kmax = nl < cap ? nl : cap;
      const int32_t* nd = s_ndl + j * cap;
      if (nonoverlap) {
        for (int w = threadIdx.x; w < (win + 31) / 32; w += kThreads)
          s_flags[w] = 0u;
        __syncthreads();
      }
      int cnt = 0;
      for (int p = threadIdx.x; p < win; p += kThreads) {
        bool m = !use_range || p + nl <= doc_len;
        for (int k = 0; m && k < kmax; ++k) m = cells[p + k] == nd[k];
        if (m) {
          if (nonoverlap)
            atomicOr(&s_flags[p >> 5], 1u << (p & 31));
          else
            ++cnt;
        }
      }
      if (nonoverlap) {
        __syncthreads();
        if (threadIdx.x == 0) {
          int next = 0, c = 0;
          for (int w = 0; w < (win + 31) / 32; ++w) {
            unsigned bits = s_flags[w];
            while (bits) {
              const int p = w * 32 + __ffs(bits) - 1;
              bits &= bits - 1;
              if (p >= next) {
                ++c;
                next = p + nl;
              }
            }
          }
          orow[j] = c;
        }
        __syncthreads();  // the walk is done before the flags are reused
      } else {
        cnt = block_sum(cnt, s_red, &s_total);
        if (threadIdx.x == 0) orow[j] = cnt;
      }
    }
    if (threadIdx.x == 0) orow[Nn] = doc_len;
  }
}

}  // namespace

// text: the pack (u16 when elem_bytes == 2, u32 when 4), text_len cells;
// starts (M,) int64; lens (M,) int32; owner (M,) int32 or null (row / Kv);
// live (1,) int32 or null; ndl (B, Nn*cap) int32; nlen (B, Nn) int32;
// out (M, Nn+1) int32. Returns cudaGetLastError() after the launch.
extern "C" int mygram_tf_rows(const void* text, int elem_bytes,
                              long long text_len, const void* starts,
                              const void* lens, const void* owner,
                              const void* live, const void* ndl,
                              const void* nlen, int M, int Kv, int Nn,
                              int cap, int win, int padded, int use_range,
                              int nonoverlap, int sentinel, void* out,
                              void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  const size_t smem =
      sizeof(int32_t) * ((size_t)win + cap + (size_t)Nn * cap + Nn +
                         ((size_t)win + 31) / 32);
  const int grid = M < 132 * 32 ? M : 132 * 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2) {
    tf_rows_kernel<uint16_t><<<grid, kThreads, smem, s>>>(
        (const uint16_t*)text, text_len, (const int64_t*)starts,
        (const int32_t*)lens, (const int32_t*)owner, (const int32_t*)live,
        (const int32_t*)ndl, (const int32_t*)nlen, M, Kv, Nn, cap, win,
        padded, use_range, nonoverlap, sentinel, (int32_t*)out);
  } else if (elem_bytes == 4) {
    tf_rows_kernel<uint32_t><<<grid, kThreads, smem, s>>>(
        (const uint32_t*)text, text_len, (const int64_t*)starts,
        (const int32_t*)lens, (const int32_t*)owner, (const int32_t*)live,
        (const int32_t*)ndl, (const int32_t*)nlen, M, Kv, Nn, cap, win,
        padded, use_range, nonoverlap, sentinel, (int32_t*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
