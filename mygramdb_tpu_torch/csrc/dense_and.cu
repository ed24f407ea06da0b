// K1: dense row-AND with NOT rows, filter rows, tombstones, popcount and
// the first n matching doc ids, in one kernel; K2 (below it): the bare row
// reduce, AND or OR, with nothing folded in, and K2's boolean program: a
// whole tree of term bitmaps in one kernel.
//
// K1
// --
// Replaces mygramdb_tpu/ops/bitmap_ops.py::dense_query_pallas (kernels
// _dense_query_kernel_kop, _dense_query_kernel, _dense_query_kernel_blocked)
// and the top-n that follows it there (_topn_hierarchical, an XLA program),
// and folds in the NOT and filter forms that the JAX package sends to
// bitmap_ops.py::dense_query instead. For each query b:
//
//   res[b, w] = AND_k bm[rows[b, k], w]  &  ~OR_j bm[nrows[b, j], w]
//               & AND_f extra[f, w]  &  ~deleted[w]
//   out[b, 0] = popcount(res[b, :])
//   out[b, 1 + r] = the doc id of the r-th set bit of res[b] in doc-id
//                   order (largest first when descending), r < n; -1 past
//                   the count
//
// Words are uint32 bit patterns (doc d = bit d % 32 of word d / 32); torch
// holds them as int32. res is written only when the caller asks for it.
//
// What bounds it: device-memory bytes, each distinct row read once ((rows +
// 1) x W x 4 bytes over the batch; a row that queries share comes again
// from the L2 cache) and B x (n + 1) x 4 written. The AND and the popcount
// are a few integer operations per 16 bytes.
//
// Design: one thread-block cluster of CS blocks (8, or 16 where the card
// allows it) a query; block c owns a contiguous span of about W / CS words.
// - Pass 1: each thread ANDs 16-byte vectors of its block's span, the
//   query's row ids in shared memory, stages the result words in dynamic
//   shared memory (17 KB a block at W = 34,816 over 8 blocks, 77 KB at
//   313,344 over 16) and popcounts them; the block sums its count.
// - The cross-block rank: after a cluster barrier, lane c of warp 0 reads
//   block c's count through distributed shared memory; the counts of the
//   blocks before this one in direction order are its rank offset, and
//   their sum over the cluster is count[b]. No memset, no atomics.
// - Pass 2: in rounds of one vector a thread, in direction order, a block
//   scan of the vectors' popcounts gives each set bit its rank; ranks below
//   n write their doc id straight into out[b, 1 + rank]. A block stops at
//   the round that reaches n or its own last set bit, and a block whose
//   offset is past n skips the pass. Ranks from the count to n are written
//   as -1 by the whole cluster.
// - n = 0 counts only. A span too large for shared memory (W past some 28M
//   documents) is not staged: pass 2 recomputes its words.
// - Queries past the grid's y limit loop inside the cluster.
// The TPU kernel's tiling of a row into VMEM, and the two XLA select
// stages of the top-n, have no counterpart: one read of the rows, one
// write of the answer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"
#include "warp_ops.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;       // K2
constexpr int kTopnThreads = 256;   // K1
constexpr int kTopnWarps = kTopnThreads / 32;

__device__ __forceinline__ uint4 band(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint4 bor(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint4 bandnot(uint4 a, uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}
__device__ __forceinline__ int popc4(uint4 a) {
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
}

// The query's result vector w: s_rows holds its K row ids, then its Kn NOT
// row ids.
__device__ __forceinline__ uint4 result_vec(
    const uint4* __restrict__ bm, int64_t wv, const int32_t* s_rows, int K,
    int Kn, const uint4* __restrict__ extra, int F,
    const uint4* __restrict__ deleted, int64_t w) {
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
  return bandnot(acc, __ldg(deleted + w));
}

// Doc ids of the set bits of v (words word0 .. word0 + 3) in direction
// order, from rank on, while rank < n.
template <bool kDescending>
__device__ __forceinline__ void write_ids(int32_t* __restrict__ ids, uint4 v,
                                          int64_t word0, int rank, int n) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = kDescending ? 3 - i : i;
    uint32_t x = w[j];
    const int32_t base = (int32_t)((word0 + j) * 32);
    while (x != 0u && rank < n) {
      const int bit = kDescending ? 31 - __clz(x) : __ffs(x) - 1;
      ids[rank++] = base + bit;
      x &= ~(1u << bit);
    }
  }
}

// grid (CS, min(B, 65535)), clusters of (CS, 1, 1). span: vectors a block
// owns; staged: the dynamic shared memory holds span vectors before the
// row ids. out (B, n + 1); res (B, W) or null.
__global__ void __launch_bounds__(kTopnThreads)
dense_and_topn_kernel(const uint4* __restrict__ bm, int64_t wv,
                      const int32_t* __restrict__ rows, int K,
                      const int32_t* __restrict__ nrows, int Kn,
                      const uint4* __restrict__ extra, int F,
                      const uint4* __restrict__ deleted,
                      int32_t* __restrict__ out, int n, int descending,
                      uint4* __restrict__ res, int B, int64_t span,
                      int staged) {
  extern __shared__ uint4 s_dyn[];
  __shared__ int s_warp[kTopnWarps];
  __shared__ int s_total[2];                   // by query parity
  __shared__ int s_scan[2][kTopnWarps + 1];    // by round parity
  __shared__ int s_off, s_count;
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int crank = (int)cluster.block_rank();
  uint4* s_words = s_dyn;
  int32_t* s_rows = reinterpret_cast<int32_t*>(s_dyn + (staged ? span : 0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t lo = (int64_t)crank * span;
  const int64_t len = lo < wv ? (wv - lo < span ? wv - lo : span) : 0;
  int qpar = 0, rpar = 0;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // the previous query's rows and words are not read
    for (int i = tid; i < K; i += kTopnThreads)
      s_rows[i] = rows[(int64_t)b * K + i];
    for (int i = tid; i < Kn; i += kTopnThreads)
      s_rows[K + i] = nrows[(int64_t)b * Kn + i];
    __syncthreads();

    // pass 1: the words, staged, and the block's count
    int pc = 0;
    for (int64_t v = tid; v < len; v += kTopnThreads) {
      const uint4 acc = result_vec(bm, wv, s_rows, K, Kn, extra, F, deleted,
                                   lo + v);
      if (res != nullptr) res[(int64_t)b * wv + lo + v] = acc;
      if (staged) s_words[v] = acc;
      pc += popc4(acc);
    }
    pc = warp_sum(pc);
    if (lane == 0) s_warp[warp] = pc;
    __syncthreads();
    if (tid == 0) {
      int t = 0;
      for (int i = 0; i < kTopnWarps; ++i) t += s_warp[i];
      s_total[qpar] = t;
    }
    cluster.sync();

    // the rank offset of this block's first bit, and the query's count
    if (warp == 0) {
      const int t = lane < CS ? *cluster.map_shared_rank(&s_total[qpar], lane)
                              : 0;
      const bool before = descending ? lane > crank : lane < crank;
      const int off = warp_sum(before ? t : 0);
      const int cnt = warp_sum(t);
      if (lane == 0) {
        s_off = off;
        s_count = cnt;
      }
    }
    __syncthreads();
    const int count = s_count;
    const int off = s_off;
    const int end = n < off + s_total[qpar] ? n : off + s_total[qpar];
    qpar ^= 1;
    int32_t* o = out + (int64_t)b * (n + 1);
    if (crank == 0 && tid == 0) o[0] = count;
    for (int64_t r = (int64_t)count + (int64_t)crank * kTopnThreads + tid;
         r < n; r += (int64_t)CS * kTopnThreads)
      o[1 + r] = -1;

    // pass 2: rounds of one vector a thread in direction order; ranks
    // below n write their doc ids, until the block's last bit
    int base = off;
    for (int64_t r0 = 0; r0 < len && base < end; r0 += kTopnThreads) {
      const int64_t vd = r0 + tid;  // direction order within the span
      int64_t v = 0;
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      if (vd < len) {
        v = descending ? len - 1 - vd : vd;
        acc = staged ? s_words[v]
                     : result_vec(bm, wv, s_rows, K, Kn, extra, F, deleted,
                                  lo + v);
      }
      const int p = popc4(acc);
      const int incl = warp_inclusive_scan(p, lane);
      if (lane == 31) s_scan[rpar][warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int x = lane < kTopnWarps ? s_scan[rpar][lane] : 0;
        const int xi = warp_inclusive_scan(x, lane);
        if (lane < kTopnWarps) s_scan[rpar][lane] = xi - x;
        if (lane == 31) s_scan[rpar][kTopnWarps] = xi;
      }
      __syncthreads();
      const int rank = base + s_scan[rpar][warp] + incl - p;
      if (p != 0 && rank < n) {
        if (descending)
          write_ids<true>(o + 1, acc, (lo + v) * 4, rank, n);
        else
          write_ids<false>(o + 1, acc, (lo + v) * 4, rank, n);
      }
      base += s_scan[rpar][kTopnWarps];
      rpar ^= 1;
    }
  }
  cluster.sync();  // no block leaves while another reads its count
}

// K2: row gather + AND / OR reduce.
//
// Replaces mygramdb_tpu/ops/bitmap_ops.py::_reduce_rows_pallas (kernel
// _reduce_rows_kernel). For each query b and word w:
//
//   out[b, w] = AND_k bm[rows[b, k], w]     (kAnd; pad rows with all-ones)
//   out[b, w] = OR_k  bm[rows[b, k], w]     (else; pad rows with all-zeros)
//
// No tombstones, no filter rows and no count: the boolean tree applies
// those itself, after combining its leaves. K is at least 1.
//
// What bounds it: device-memory bytes, B * K * W * 4 read (rows that repeat
// come from the L2 cache) and B * W * 4 written; one integer operation per
// word read. As in K1 each thread moves 16 bytes per row and reduces the K
// rows in registers, neighbouring threads on neighbouring addresses, the
// query's row ids in shared memory. The TPU kernel's grid axis over K (an
// accumulator tile revisited K times) becomes the loop over k.
template <bool kAnd>
__global__ void __launch_bounds__(kThreads)
reduce_rows_kernel(const uint4* __restrict__ bm, int64_t wv,
                   const int32_t* __restrict__ rows, int K,
                   uint4* __restrict__ out, int B) {
  extern __shared__ int32_t s_rows[];  // K row ids
  const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // the previous query's row ids are no longer read
    for (int i = threadIdx.x; i < K; i += blockDim.x)
      s_rows[i] = rows[(int64_t)b * K + i];
    __syncthreads();
    if (w < wv) {
      uint4 acc = __ldg(bm + (int64_t)s_rows[0] * wv + w);
      for (int k = 1; k < K; ++k) {
        const uint4 v = __ldg(bm + (int64_t)s_rows[k] * wv + w);
        acc = kAnd ? band(acc, v) : bor(acc, v);
      }
      out[(int64_t)b * wv + w] = acc;
    }
  }
}


// K2 as the boolean program: a whole tree of term bitmaps in one launch.
//
// Replaces what mygramdb_tpu/index/device_index.py::_ast_words_program
// compiles around _reduce_rows_pallas: the tree's leaves are term bitmaps
// (bitmap_ops.term_bitmap: the AND of a term's dense rows and of its
// sparse grams' posting slices scattered into words), combined by AND, OR
// and NOT against `universe`, then cleared of tombstones:
//
//   leaf[t][w] = AND_k bm[rows[t, k], w]
//                & AND_s (lens[t, s] > 0 ? words of slice (offs, lens)[t, s]
//                         : real[t, s] ? 0 : ~0)
//   out[w]     = tree(leaf, universe)[w] & ~deleted[w]
//
// A slice is gathered as K3 gathers it: its first min(len, bucket) entries,
// masked at P; ids outside [0, 32 W) set no bit. The JAX package clears the
// tombstones from each leaf as well; every operation is bitwise, so a bit
// that the last step clears never needs clearing before it.
//
// The tree arrives as a postfix program: op >= 0 pushes leaf op, kOpAnd and
// kOpOr combine the two top entries, kOpNot replaces the top x with
// universe & ~x. The host emits each n-ary node left to right, combining
// as it goes, so the stack holds at most the tree's depth + 1 entries
// (`depth`; the parser bounds trees at 32 levels).
//
// What bounds it: bytes. Each leaf's K rows over W words, each slice's
// entries once, `universe` and `deleted` once, W words written. The TPU
// program wrote every leaf's words, a (T x S, W + 1) scatter tensor and
// every node's words to device memory; here a block takes a span of
// span_v 16-byte vectors (one a thread) and keeps everything in shared
// memory:
// - the stack, depth x span_v vectors; each thread only ever touches its
//   own vector of each entry, so the word algebra needs no barrier;
// - a leaf's dense rows: K 16-byte loads a thread, unrolled so they are in
//   flight together;
// - a slice: its entries in the span's doc range, found by two warp-wide
//   lower bounds (computed for up to `cached` slices at once, before the
//   program runs, by all warps), set into a span of scratch words with
//   shared-memory atomicOr, then AND'ed into the thread's vector.
// Spans loop over the grid; a deep tree shrinks span_v so that its stack
// fits, it is never refused.
constexpr int kAstThreads = 128;
constexpr int kAstWarps = kAstThreads / 32;
constexpr int kOpAnd = -1, kOpOr = -2, kOpNot = -3;

__device__ __forceinline__ void slice_window(
    const int32_t* __restrict__ post, int64_t P, int64_t off, int64_t len,
    int64_t bucket, int64_t doc_lo, int64_t doc_hi, int lane, int64_t* a,
    int64_t* z) {
  const int64_t s = off < 0 ? 0 : off;
  int64_t e = off + (len < bucket ? len : bucket);
  if (e > P) e = P;
  if (e < s) e = s;
  warp_lower_bounds(post, s, e, doc_lo, doc_hi, lane, a, z);
}

// args: rows (T, K), offs (T, S), lens (T, S), real (T, S), prog (nprog),
// all int64, one after the other.
__global__ void __launch_bounds__(kAstThreads)
ast_words_kernel(const uint4* __restrict__ bm, int64_t wv,
                 const int32_t* __restrict__ post, int64_t P,
                 const uint4* __restrict__ deleted,
                 const uint4* __restrict__ universe,
                 const int64_t* __restrict__ args, int T, int K, int S,
                 int nprog, int depth, int64_t bucket, int span_v,
                 int cached, uint4* __restrict__ out) {
  extern __shared__ uint4 s_ast[];
  uint4* s_stack = s_ast;                                  // depth x span_v
  uint32_t* s_tmp = reinterpret_cast<uint32_t*>(s_stack + (int64_t)depth *
                                                span_v);  // span_v x 4
  int64_t* s_win = reinterpret_cast<int64_t*>(s_tmp + span_v * 4);
  __shared__ int64_t s_one[2];
  const int64_t* rows = args;
  const int64_t* offs = rows + (int64_t)T * K;
  const int64_t* lens = offs + (int64_t)T * S;
  const int64_t* real = lens + (int64_t)T * S;
  const int64_t* prog = real + (int64_t)T * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4* s_tmp4 = reinterpret_cast<uint4*>(s_tmp);
  for (int64_t v0 = (int64_t)blockIdx.x * span_v; v0 < wv;
       v0 += (int64_t)gridDim.x * span_v) {
    const int m = (int)(wv - v0 < span_v ? wv - v0 : span_v);
    const bool own = tid < m;
    const int64_t v = v0 + tid;
    const int64_t doc_lo = v0 * 128, doc_hi = (v0 + m) * 128;
    __syncthreads();  // the previous span's scratch and windows are not read
    for (int i = tid; i < span_v * 4; i += kAstThreads) s_tmp[i] = 0u;
    for (int sl = warp; sl < cached; sl += kAstWarps) {
      int64_t a = 0, z = 0;
      if (__ldg(lens + sl) > 0)
        slice_window(post, P, __ldg(offs + sl), __ldg(lens + sl), bucket,
                     doc_lo, doc_hi, lane, &a, &z);
      if (lane == 0) {
        s_win[2 * sl] = a;
        s_win[2 * sl + 1] = z;
      }
    }
    __syncthreads();
    int sp = 0;
    for (int pc = 0; pc < nprog; ++pc) {
      const int op = (int)__ldg(prog + pc);
      uint4* top = s_stack + (int64_t)(sp - 1) * span_v + tid;
      if (op == kOpNot) {
        if (own) *top = bandnot(__ldg(universe + v), *top);
        continue;
      }
      if (op == kOpAnd || op == kOpOr) {
        if (own) top[-span_v] = op == kOpAnd ? band(top[-span_v], *top)
                                             : bor(top[-span_v], *top);
        --sp;
        continue;
      }
      uint4 acc = make_uint4(~0u, ~0u, ~0u, ~0u);
      if (own) {
        const int64_t* r = rows + (int64_t)op * K;
#pragma unroll 8
        for (int k = 0; k < K; ++k)
          acc = band(acc, __ldg(bm + __ldg(r + k) * wv + v));
      }
      for (int s = 0; s < S; ++s) {
        const int sl = op * S + s;
        if (__ldg(lens + sl) == 0) {
          if (__ldg(real + sl) != 0) acc = zero;
          continue;
        }
        int64_t a, z;
        if (sl < cached) {
          a = s_win[2 * sl];
          z = s_win[2 * sl + 1];
        } else {
          if (warp == 0) {
            slice_window(post, P, __ldg(offs + sl), __ldg(lens + sl),
                         bucket, doc_lo, doc_hi, lane, &a, &z);
            if (lane == 0) {
              s_one[0] = a;
              s_one[1] = z;
            }
          }
          __syncthreads();
          a = s_one[0];
          z = s_one[1];
        }
        for (int64_t p = a + tid; p < z; p += kAstThreads) {
          const int64_t d = __ldg(post + p) - doc_lo;
          atomicOr(&s_tmp[d >> 5], 1u << (d & 31));
        }
        __syncthreads();
        if (own) acc = band(acc, s_tmp4[tid]);
        if (tid < span_v) s_tmp4[tid] = zero;
        __syncthreads();  // cleared before the next slice, s_one read
      }
      if (own) s_stack[(int64_t)sp * span_v + tid] = acc;
      ++sp;
    }
    if (own) out[v] = bandnot(s_stack[tid], __ldg(deleted + v));
  }
}

// Each device's set-up of K1: its SM count, the dynamic shared memory a
// block may use (raised on the kernel), and whether a cluster of 16 blocks
// launches there (a non-portable size).
struct TopnSetup {
  int sms;   // 0 until the device's first launch
  int optin;
  bool allow16;
};

PerDevice<TopnSetup> topn_setup;

cudaError_t topn_limits(TopnSetup* out) {
  return topn_setup.with([&](int dev, TopnSetup& s) {
    if (s.sms == 0) {
      int sms = 0, optin = 0, dynamic_max = 0;
      cudaError_t e = device_limits(dev, &sms, &optin);
      if (e == cudaSuccess)
        e = raise_smem_limit(dense_and_topn_kernel, optin, &dynamic_max);
      if (e != cudaSuccess) return e;
      bool allow16 =
          cudaFuncSetAttribute(dense_and_topn_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1) == cudaSuccess;
      if (allow16) {
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = 16;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(16, 1, 1);
        cfg.blockDim = dim3(kTopnThreads, 1, 1);
        cfg.dynamicSmemBytes = (size_t)dynamic_max;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        allow16 = cudaOccupancyMaxActiveClusters(
                      &clusters, dense_and_topn_kernel, &cfg) == cudaSuccess
                  && clusters > 0;
      }
      cudaGetLastError();  // a refused size is an answer, not a fault
      s.sms = sms;
      s.optin = dynamic_max;
      s.allow16 = allow16;
    }
    *out = s;
    return cudaSuccess;
  });
}

// Each device's dynamic shared-memory limit of the boolean program.
PerDevice<int> ast_optin;

cudaError_t ast_limit(int* out) {
  return ast_optin.with([&](int dev, int& optin) {
    if (optin == 0) {
      int sms = 0, max_optin = 0;
      cudaError_t e = device_limits(dev, &sms, &max_optin);
      if (e == cudaSuccess)
        e = raise_smem_limit(ast_words_kernel, max_optin, &optin);
      if (e != cudaSuccess) return e;
    }
    *out = optin;
    return cudaSuccess;
  });
}

}  // namespace

// bm (V, W), rows (B, K), nrows (B, Kn), extra (F, W), deleted (W,), out
// (B, n + 1), res (B, W) or null; all int32, contiguous. W is a multiple of
// 4 and bm, extra, deleted and res are 16-byte aligned (the wrapper checks
// both). out[b] = [count, the first n doc ids in doc-id order (descending:
// largest first), -1 padded]. Returns cudaGetLastError() after the launch
// (or the set-up's error).
extern "C" int mygram_dense_and_topn(const void* bm, long long W,
                                     const void* rows, int K,
                                     const void* nrows, int Kn,
                                     const void* extra, int F,
                                     const void* deleted, void* out, int n,
                                     int descending, void* res, int B,
                                     void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaGetLastError();
  TopnSetup s;
  cudaError_t e = topn_limits(&s);
  if (e != cudaSuccess) return (int)e;
  const int64_t wv = W / 4;
  const size_t row_bytes = (size_t)(K + Kn) * sizeof(int32_t);
  const auto span_of = [&](int cs) { return (wv + cs - 1) / cs; };
  const auto fits = [&](int cs) {
    return (size_t)span_of(cs) * 16 + row_bytes <= (size_t)s.optin;
  };
  // 16 blocks a query where the batch alone would leave most SMs idle, or
  // where 8 blocks could not stage their spans
  const int CS =
      s.allow16 && (B * 8 < 2 * s.sms || (n > 0 && !fits(8))) ? 16 : 8;
  const int64_t span = span_of(CS);
  const int staged = n > 0 && fits(CS);
  const size_t smem = (staged ? (size_t)span * 16 : 0) + row_bytes;
  if (smem > (size_t)s.optin) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(CS, B < 65535 ? B : 65535, 1);
  cfg.blockDim = dim3(kTopnThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, dense_and_topn_kernel, (const uint4*)bm, wv,
      (const int32_t*)rows, K, (const int32_t*)nrows, Kn,
      (const uint4*)extra, F, (const uint4*)deleted, (int32_t*)out, n,
      descending, (uint4*)res, B, span, staged);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// bm (V, W), rows (B, K) with K >= 1, out (B, W); all int32, contiguous. W
// is a multiple of 4 and bm and out are 16-byte aligned (the wrapper checks
// both). op_and != 0 reduces with AND, else with OR. Returns
// cudaGetLastError() after the launch.
extern "C" int mygram_reduce_rows(const void* bm, long long W, const void* rows,
                                  int K, int op_and, void* out, int B,
                                  void* stream) {
  if (B > 0 && W > 0 && K > 0) {
    const int64_t wv = W / 4;
    const dim3 grid((unsigned)((wv + kThreads - 1) / kThreads),
                    (unsigned)(B < 65535 ? B : 65535));
    const size_t smem = (size_t)K * sizeof(int32_t);
    if (op_and)
      reduce_rows_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          (const uint4*)bm, wv, (const int32_t*)rows, K, (uint4*)out, B);
    else
      reduce_rows_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          (const uint4*)bm, wv, (const int32_t*)rows, K, (uint4*)out, B);
  }
  return (int)cudaGetLastError();
}

// bm (V, W), deleted (W,), universe (W,), out (W,) int32 words, W a
// multiple of 4 and each 16-byte aligned; postings (P,) int32; args int64:
// rows (T, K), offs (T, S), lens (T, S), real (T, S) (0 or 1) and the
// postfix program (nprog ops), whose stack needs `depth` entries. Returns
// cudaGetLastError() after the launch (or the set-up's error).
extern "C" int mygram_ast_words(const void* bm, long long W,
                                const void* postings, long long P,
                                const void* deleted, const void* universe,
                                const void* args, int T, int K, int S,
                                int nprog, int depth, long long bucket,
                                void* out, void* stream) {
  if (W <= 0 || nprog <= 0) return (int)cudaGetLastError();
  int optin = 0;
  cudaError_t e = ast_limit(&optin);
  if (e != cudaSuccess) return (int)e;
  const int64_t wv = W / 4;
  // the widest span whose stack and scratch fit beside the windows of as
  // many slices as fit (all of them, as a rule)
  int64_t cached = (int64_t)T * S;
  int span_v = kAstThreads;
  const auto smem = [&](int sv, int64_t c) {
    return ((size_t)depth + 1) * sv * 16 + (size_t)c * 16;
  };
  if (cached > 1024) cached = 1024;
  while (span_v > 1 && smem(span_v, cached) > (size_t)optin) span_v >>= 1;
  while (cached > 0 && smem(span_v, cached) > (size_t)optin) cached >>= 1;
  if (smem(span_v, cached) > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (wv + span_v - 1) / span_v;
  ast_words_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535),
                     kAstThreads, smem(span_v, cached),
                     (cudaStream_t)stream>>>(
      (const uint4*)bm, wv, (const int32_t*)postings, P,
      (const uint4*)deleted, (const uint4*)universe, (const int64_t*)args, T,
      K, S, nprog, depth, bucket, span_v, (int)cached, (uint4*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* mygram_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
