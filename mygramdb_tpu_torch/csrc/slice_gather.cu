// K3: the CSR slice gather, and the sparse candidate probe built on it.
//
// Both replace mygramdb_tpu/ops/posting_ops.py::_gather_slices_pallas
// (kernel _slice_gather_kernel; the TPU served it with an XLA scan):
//
//   gather[k, j] = postings[off[k] + j]  if j < len[k] and 0 <= off[k] + j < P
//                  SENTINEL (2^31 - 1)    otherwise
//
// mygram_slice_gather writes that (K, bucket) tile; the threshold programs
// and the posting scatter take it as it is. mygram_sparse_probe is the
// whole sparse program of a batch (the JAX package's _sparse_query_batch
// and the mask and compaction of _sparse_search_verify_topn_batch, XLA
// programs around the gather there) in one launch.
//
// The loads are masked, so the postings array needs no pad tail: a dense
// term's offset points at P (its slice is not on the device) and reads only
// sentinels. Offsets and lengths are int64 (no 2^31-entry limit).
//
// The gather
// ----------
// What bounds it: the bytes it writes, K * bucket * 4 (the bytes read are
// at most as many). Neighbouring threads copy neighbouring entries of one
// slice, so both sides coalesce; one block row (blockIdx.y) per slice.
//
// The sparse probe
// ----------------
// For query b, with q[b] = [d_off, d_len, sp_off[Ks], sp_len[Ks],
// sp_inv[Ks], dn_rows[Kd], dn_inv[Kd]] (int64):
//
//   cand[j]  = gather of the driver slice (d_off, d_len) at j < C
//   mask[j]  = cand[j] != SENTINEL and the tombstone bit of cand[j] is 0
//              and for k < Ks: (cand[j] in the first min(sp_len[k], Cmax)
//                               entries of slice k (masked at P)) ^ sp_inv[k]
//              and for k < Kd: bit cand[j] of bm[dn_rows[k]] ^ dn_inv[k]
//              and for f < F:  bit cand[j] of extra[f]
//   (bits are read at cand clamped to [0, 32 W); probes & 1 and probes & 2
//    switch the sparse and the dense probes on)
//
// and one of three outputs: the count and the first `width` candidates
// with mask set in doc-id order (largest first when descending), -1 padded
// (top-n, as posting_ops.mask_to_topn); the count and the first `width`
// ascending, SENTINEL padded (compaction, as fused.compact_first_k); or
// the count and where(mask, cand, SENTINEL) over all C (masked). Each probe
// slice is a posting list: sorted ascending, no repeats.
//
// What bounds it: bytes. The driver slice (C x 4), the part of each probe
// slice that falls in the candidates' doc-id range, one 32-bit word a live
// candidate for each tombstone, filter and dense row, and the output. The
// TPU program materialised (B, C) masks and a (Ks x B, Cmax) probe tile in
// device memory and searched it candidate by candidate; here none of that
// leaves the SM:
// - One thread-block cluster a query, a block for every 256 candidates up
//   to CS = 8 (the largest cluster that launches, checked per device with
//   cudaOccupancyMaxActiveClusters): one query alone still spreads over 8
//   SMs. Block c owns a span of C / CS candidates (rounded up to 32) and
//   stages them at most kChunk at a time in shared memory: 65,536
//   candidates (256 KB) would not fit one block's 227 KB, and a chunk of
//   at most 4,096 keeps a block under 40 KB, so several share an SM.
// - Tombstones, filter rows and dense rows are one word load a live
//   candidate each, issued together as the candidates arrive (coalesced)
//   from the driver.
// - Sparse probes, 32 slices at a time: one warp per slice finds the
//   slice's window over the chunk's doc-id range [first, last] with two
//   warp-wide lower bounds searched together (about 4 dependent loads). A
//   window of at most kCandRatio entries a live candidate is read entry by
//   entry, coalesced, every slice of the group at once (prefix sums map a
//   flat item index to its slice), kEntryItems loads a thread in flight:
//   the chunk's live candidates stand in an open-addressing hash table in
//   shared memory (doc id -> position, twice the chunk's size), so an
//   entry finds its candidate without a search. A longer window is
//   searched by each live candidate instead, through L2, a thread's
//   searches in lockstep so that each step's loads are in flight
//   together. Latency, not bytes, is what a query of a few thousand
//   candidates waits for: no step waits on a chain longer than a search.
//   Hits set bit k of the candidate's word (shared-memory atomicOr), and a
//   fold keeps the candidates whose bits, XOR the slices' NOT flags, are
//   all set.
// - The mask becomes one bit a candidate (a ballot a warp), kept in shared
//   memory for the whole span (C / 8 bytes over the cluster).
// - Ranks: the block's count goes to the cluster; lane c of warp 0 reads
//   block c's count over distributed shared memory, so each block knows the
//   rank of its first survivor (in direction order) and the query's count.
//   Then rounds of one mask word a thread with a block scan give each
//   survivor its rank, and ids are written where they land, re-read from
//   the driver slice (L2). No memset, no global atomics, one launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"
#include "warp_ops.cuh"

namespace cg = cooperative_groups;

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

constexpr int kProbeThreads = 256;
constexpr int kProbeWarps = kProbeThreads / 32;
constexpr int kChunk = 4096;       // candidates staged at a time, at most
constexpr int kProbeItems = 4;     // searches a thread has in flight
constexpr int kEntryItems = 16;    // window entries a thread has in flight
constexpr int kCandRatio = 4;      // window entries a live candidate past
                                   // which candidates search the window
constexpr int32_t kEmpty = -1;     // an empty hash slot (ids are >= 0)
constexpr int kMaxCluster = 8;     // the portable cluster size
enum { kFormTopn = 0, kFormCompact = 1, kFormMasked = 2 };

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// A doc id's first slot in a hash table of tmask + 1 (a power of two)
// slots: Fibonacci hashing, the product's high bits.
__device__ __forceinline__ uint32_t hash_slot(int32_t x, int tmask) {
  return (uint32_t)(((uint64_t)((uint32_t)x * 2654435761u) *
                     (uint64_t)(tmask + 1)) >> 32);
}

// Dynamic shared memory of a launch: s_cand and s_hits (chunk words
// each), the query's dense rows (Kd words), the span's mask (span / 32
// words), the hash table (tslots keys and halves), s_ok (chunk bytes).
__host__ __device__ inline size_t probe_smem(int chunk, int Kd,
                                             int64_t span, int tslots) {
  return (size_t)chunk * 9 + (size_t)Kd * 4 + (size_t)(span / 32) * 4 +
         (size_t)tslots * 6;
}

// grid (CS, min(B, 65535)), clusters of (CS, 1, 1); span a multiple of 32.
// cnt[b * cnt_ld] is the count; ids + b * ids_ld the row of width entries
// (C of them in the masked form).
template <int kForm>
__global__ void __launch_bounds__(kProbeThreads)
sparse_probe_kernel(const int32_t* __restrict__ post, int64_t P,
                    const uint32_t* __restrict__ bm, int64_t W,
                    const uint32_t* __restrict__ deleted,
                    const uint32_t* __restrict__ extra, int F,
                    const int64_t* __restrict__ q, int Ks, int Kd,
                    int probes, int C, int Cmax, int64_t span, int chunk,
                    int tmask, int32_t* __restrict__ cnt, int64_t cnt_ld,
                    int32_t* __restrict__ ids, int64_t ids_ld, int width,
                    int descending, int B) {
  extern __shared__ int32_t s_dyn[];
  int32_t* s_cand = s_dyn;
  uint32_t* s_hits = reinterpret_cast<uint32_t*>(s_dyn + chunk);
  uint32_t* s_dn = s_hits + chunk;  // row id, NOT flag in bit 31
  uint32_t* s_mask = s_dn + Kd;
  int32_t* s_hkey = reinterpret_cast<int32_t*>(s_mask + span / 32);
  uint16_t* s_hval = reinterpret_cast<uint16_t*>(s_hkey + tmask + 1);
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_hval + tmask + 1);
  __shared__ int64_t s_wa[32], s_wb[32], s_pref[33];
  __shared__ int64_t s_epref[33];
  __shared__ uint32_t s_inv, s_grp, s_side;
  __shared__ int s_warp[kProbeWarps];
  __shared__ int s_total[2];                    // by query parity
  __shared__ int s_scan[2][kProbeWarps + 1];    // by round parity
  __shared__ int s_off, s_count;
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int crank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = 2 + 3 * Ks + 2 * Kd;
  const int64_t lo = (int64_t)crank * span;
  const int64_t len = clamp64((int64_t)C - lo, 0, span);
  const int64_t nbits = W * 32;
  int qpar = 0, rpar = 0;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const int64_t* qa = q + (int64_t)b * Q;
    const int64_t d_off = __ldg(qa), d_len = __ldg(qa + 1);
    // positions that gather a posting: [v0, v1)
    const int64_t v0 = clamp64(-d_off, 0, C);
    int64_t v1 = d_len < P - d_off ? d_len : P - d_off;
    v1 = clamp64(v1, v0, C);
    __syncthreads();  // the previous query's shared state is not read
    if (probes & 2)
      for (int k = tid; k < Kd; k += kProbeThreads)
        s_dn[k] = (uint32_t)__ldg(qa + 2 + 3 * Ks + k) |
                  ((__ldg(qa + 2 + 3 * Ks + Kd + k) != 0) ? 0x80000000u : 0u);
    int pc = 0;  // lane 0: the warp's survivors
    for (int64_t c0 = 0; c0 < len; c0 += chunk) {
      const int m = (int)(len - c0 < chunk ? len - c0 : chunk);
      const int64_t base = lo + c0;
      const int a0 = (int)clamp64(v0 - base, 0, m);
      const int a1 = (int)clamp64(v1 - base, a0, m);
      __syncthreads();  // s_dn written; the previous chunk is not read
      // the candidates, and every one-word probe: kProbeItems candidates a
      // thread at a time, each step's loads independent, so in flight
      // together
      for (int i0 = tid; i0 < m; i0 += kProbeItems * kProbeThreads) {
        int32_t c[kProbeItems];
        uint32_t acc[kProbeItems];
        int64_t w[kProbeItems];
        bool v[kProbeItems];
#pragma unroll
        for (int j = 0; j < kProbeItems; ++j) {
          const int i = i0 + j * kProbeThreads;
          v[j] = i >= a0 && i < a1;
          c[j] = v[j] ? __ldg(post + d_off + base + i) : kSentinel;
        }
#pragma unroll
        for (int j = 0; j < kProbeItems; ++j) {
          const int i = i0 + j * kProbeThreads;
          if (i < m) {
            s_cand[i] = c[j];
            s_hits[i] = 0u;
          }
          w[j] = clamp64(c[j], 0, nbits - 1) >> 5;
          acc[j] = v[j] ? ~__ldg(deleted + w[j]) : 0u;
        }
        for (int f = 0; f < F; ++f)
#pragma unroll
          for (int j = 0; j < kProbeItems; ++j)
            if (v[j]) acc[j] &= __ldg(extra + (int64_t)f * W + w[j]);
        if (probes & 2)
          for (int k = 0; k < Kd; ++k) {
            const uint32_t r = s_dn[k];  // a NOT row flips its word
            const uint32_t* row = bm + (int64_t)(r & 0x7FFFFFFFu) * W;
#pragma unroll
            for (int j = 0; j < kProbeItems; ++j)
              if (v[j]) acc[j] &= __ldg(row + w[j]) ^ (0u - (r >> 31));
          }
#pragma unroll
        for (int j = 0; j < kProbeItems; ++j) {
          const int i = i0 + j * kProbeThreads;
          if (i < m)
            s_ok[i] = (uint8_t)((acc[j] >> (clamp64(c[j], 0, nbits - 1) &
                                            31)) & 1u);
        }
      }
      __syncthreads();
      if ((probes & 1) && Ks > 0 && a1 > a0) {
        const int64_t first = s_cand[a0], last = s_cand[a1 - 1];
        const int64_t live = a1 - a0;
        // the chunk's live candidates in an open-addressing hash table
        // (doc id -> position), twice the chunk's size
        for (int h = tid; h <= tmask; h += kProbeThreads) s_hkey[h] = kEmpty;
        __syncthreads();
        for (int i = a0 + tid; i < a1; i += kProbeThreads) {
          if (!s_ok[i]) continue;
          for (uint32_t h = hash_slot(s_cand[i], tmask);; h = (h + 1) & tmask)
            if (atomicCAS(&s_hkey[h], kEmpty, s_cand[i]) == kEmpty) {
              s_hval[h] = (uint16_t)i;
              break;
            }
        }
        __syncthreads();
        for (int g0 = 0; g0 < Ks; g0 += 32) {
          const int gk = Ks - g0 < 32 ? Ks - g0 : 32;
          // each slice's entries in [first, last]: [s_wa, s_wb)
          for (int l = warp; l < gk; l += kProbeWarps) {
            const int64_t off = __ldg(qa + 2 + g0 + l);
            const int64_t ln = __ldg(qa + 2 + Ks + g0 + l);
            const int64_t s = off < 0 ? 0 : off;
            const int64_t e =
                clamp64(off + (ln < Cmax ? ln : (int64_t)Cmax), s,
                        P > s ? P : s);
            int64_t a, z;
            warp_lower_bounds(post, s, e, first, last + 1, lane, &a, &z);
            if (lane == 0) {
              s_wa[l] = a;
              s_wb[l] = z;
            }
          }
          __syncthreads();
          // a slice whose window holds more than kCandRatio entries a live
          // candidate is searched candidate by candidate; the others are
          // read entry by entry
          if (warp == 0) {
            int64_t n = 0;
            bool by_cand = false;
            if (lane < gk) {
              by_cand = s_wb[lane] - s_wa[lane] > kCandRatio * live;
              n = by_cand ? live : 0;
            }
            for (int o = 1; o < 32; o <<= 1) {
              const int64_t y = __shfl_up_sync(kFullMask, n, o);
              if (lane >= o) n += y;
            }
            s_pref[lane + 1] = n;
            const unsigned side = __ballot_sync(kFullMask, by_cand);
            const unsigned iv = __ballot_sync(
                kFullMask, lane < gk && __ldg(qa + 2 + 2 * Ks + g0 + lane));
            if (lane == 0) {
              s_pref[0] = 0;
              s_side = side;
              s_inv = iv;
              s_grp = gk == 32 ? kFullMask : (1u << gk) - 1u;
            }
          }
          __syncthreads();
          const uint32_t side = s_side;
          // candidates of the long windows: lower bounds in lockstep, so
          // that each step's loads are in flight together
          const int64_t total = s_pref[gk];
          for (int64_t it0 = tid; it0 < total;
               it0 += (int64_t)kProbeItems * kProbeThreads) {
            int sl[kProbeItems], ci[kProbeItems];
            int64_t pos[kProbeItems], n[kProbeItems];
            int32_t key[kProbeItems];
            bool more = false;
#pragma unroll
            for (int j = 0; j < kProbeItems; ++j) {
              const int64_t it = it0 + (int64_t)j * kProbeThreads;
              sl[j] = ci[j] = 0;
              pos[j] = n[j] = 0;
              key[j] = 0;
              if (it >= total) continue;
              int l2 = 0, h2 = gk;  // s_pref[l2] <= it < s_pref[l2 + 1]
              while (h2 - l2 > 1) {
                const int mid = (l2 + h2) >> 1;
                if (s_pref[mid] <= it) l2 = mid; else h2 = mid;
              }
              sl[j] = l2;
              ci[j] = a0 + (int)(it - s_pref[l2]);
              if (!s_ok[ci[j]]) continue;
              key[j] = s_cand[ci[j]];
              pos[j] = s_wa[l2];
              n[j] = s_wb[l2] - pos[j];
              more |= n[j] > 0;
            }
            while (more) {
              more = false;
#pragma unroll
              for (int j = 0; j < kProbeItems; ++j) {
                if (n[j] > 0) {
                  const int64_t half = n[j] >> 1;
                  if (__ldg(post + pos[j] + half) < key[j]) {
                    pos[j] += half + 1;
                    n[j] -= half + 1;
                  } else {
                    n[j] = half;
                  }
                  more |= n[j] > 0;
                }
              }
            }
#pragma unroll
            for (int j = 0; j < kProbeItems; ++j) {
              const int64_t it = it0 + (int64_t)j * kProbeThreads;
              if (it < total && s_ok[ci[j]] && pos[j] < s_wb[sl[j]] &&
                  __ldg(post + pos[j]) == key[j])
                atomicOr(&s_hits[ci[j]], 1u << sl[j]);
            }
          }
          // the other windows, entry by entry, every slice at once: an
          // entry finds its candidate in the chunk's hash table
          if (side != s_grp) {
            for (int l = warp; l < gk; l += kProbeWarps)
              if (lane == 0)
                s_epref[l + 1] = (side >> l) & 1u ? 0 : s_wb[l] - s_wa[l];
            __syncthreads();
            if (warp == 0) {
              int64_t x = lane < gk ? s_epref[lane + 1] : 0;
              for (int o = 1; o < 32; o <<= 1) {
                const int64_t y = __shfl_up_sync(kFullMask, x, o);
                if (lane >= o) x += y;
              }
              s_epref[lane + 1] = x;
              if (lane == 0) s_epref[0] = 0;
            }
            __syncthreads();
            const int64_t etotal = s_epref[gk];
            for (int64_t it0 = tid; it0 < etotal;
                 it0 += (int64_t)kEntryItems * kProbeThreads) {
              int sl[kEntryItems];
              int32_t x[kEntryItems];
#pragma unroll
              for (int j = 0; j < kEntryItems; ++j) {
                const int64_t it = it0 + (int64_t)j * kProbeThreads;
                sl[j] = -1;
                x[j] = 0;
                if (it >= etotal) continue;
                int l2 = 0, h2 = gk;  // s_epref[l2] <= it < s_epref[l2 + 1]
                while (h2 - l2 > 1) {
                  const int mid = (l2 + h2) >> 1;
                  if (s_epref[mid] <= it) l2 = mid; else h2 = mid;
                }
                sl[j] = l2;
                x[j] = __ldg(post + s_wa[l2] + (it - s_epref[l2]));
              }
#pragma unroll
              for (int j = 0; j < kEntryItems; ++j) {
                if (sl[j] < 0) continue;
                for (uint32_t h = hash_slot(x[j], tmask);; h = (h + 1) & tmask) {
                  const int32_t k = s_hkey[h];
                  if (k == x[j]) {
                    atomicOr(&s_hits[s_hval[h]], 1u << sl[j]);
                    break;
                  }
                  if (k == kEmpty) break;
                }
              }
            }
          }
          __syncthreads();
          const uint32_t inv = s_inv, grp = s_grp;
          for (int i = tid; i < m; i += kProbeThreads) {
            if (s_ok[i] && ((s_hits[i] ^ inv) & grp) != grp) s_ok[i] = 0;
            s_hits[i] = 0u;
          }
          __syncthreads();  // folded before the next group's windows
        }
      }
      // the chunk's mask bits, a ballot a word
      const int nq = (m + 31) >> 5;
      for (int qi = warp; qi < nq; qi += kProbeWarps) {
        const int i = qi * 32 + lane;
        const unsigned word = __ballot_sync(kFullMask, i < m && s_ok[i]);
        if (lane == 0) {
          s_mask[(c0 >> 5) + qi] = word;
          pc += __popc(word);
        }
      }
    }
    if (lane == 0) s_warp[warp] = pc;
    __syncthreads();
    if (tid == 0) {
      int t = 0;
      for (int i = 0; i < kProbeWarps; ++i) t += s_warp[i];
      s_total[qpar] = t;
    }
    cluster.sync();

    // the rank of this block's first survivor, and the query's count
    if (warp == 0) {
      const int t =
          lane < CS ? *cluster.map_shared_rank(&s_total[qpar], lane) : 0;
      const bool before = descending ? lane > crank : lane < crank;
      const int off = warp_sum(before ? t : 0);
      const int total = warp_sum(t);
      if (lane == 0) {
        s_off = off;
        s_count = total;
      }
    }
    __syncthreads();
    const int count = s_count, off = s_off, mine = s_total[qpar];
    qpar ^= 1;
    if (crank == 0 && tid == 0) cnt[(int64_t)b * cnt_ld] = count;
    int32_t* o = ids + (int64_t)b * ids_ld;
    // a span of one chunk still has its candidates staged
    const bool staged = len <= chunk;
    if (kForm == kFormMasked) {
      for (int64_t i = tid; i < len; i += kProbeThreads)
        o[lo + i] = ((s_mask[i >> 5] >> (i & 31)) & 1u)
                        ? (staged ? s_cand[i] : __ldg(post + d_off + lo + i))
                        : kSentinel;
      continue;
    }
    const int32_t fill = kForm == kFormTopn ? -1 : kSentinel;
    for (int64_t r = (int64_t)count + (int64_t)crank * kProbeThreads + tid;
         r < width; r += (int64_t)CS * kProbeThreads)
      o[r] = fill;
    // rounds of one mask word a thread in direction order; ranks below
    // width write their ids, until the block's last survivor
    const int end = width < off + mine ? width : off + mine;
    const int64_t nw = (len + 31) >> 5;
    int rank0 = off;
    for (int64_t r0 = 0; r0 < nw && rank0 < end; r0 += kProbeThreads) {
      const int64_t wd = r0 + tid;
      int64_t qi = 0;
      uint32_t word = 0u;
      if (wd < nw) {
        qi = descending ? nw - 1 - wd : wd;
        word = s_mask[qi];
      }
      const int p = __popc(word);
      const int incl = warp_inclusive_scan(p, lane);
      if (lane == 31) s_scan[rpar][warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int x = lane < kProbeWarps ? s_scan[rpar][lane] : 0;
        const int xi = warp_inclusive_scan(x, lane);
        if (lane < kProbeWarps) s_scan[rpar][lane] = xi - x;
        if (lane == 31) s_scan[rpar][kProbeWarps] = xi;
      }
      __syncthreads();
      int rank = rank0 + s_scan[rpar][warp] + incl - p;
      while (word != 0u && rank < width) {
        const int bit = descending ? 31 - __clz(word) : __ffs(word) - 1;
        o[rank++] = staged ? s_cand[qi * 32 + bit]
                           : __ldg(post + d_off + lo + qi * 32 + bit);
        word &= ~(1u << bit);
      }
      rank0 += s_scan[rpar][kProbeWarps];
      rpar ^= 1;
    }
  }
  cluster.sync();  // no block leaves while another reads its count
}

// Each device's set-up of the probe: the dynamic shared memory a block may
// use (raised on the three forms) and the largest cluster, up to 8, that
// launches there with a typical chunk's shared memory.
struct ProbeSetup {
  int optin;   // 0 until the device's first launch
  int max_cs;
};

PerDevice<ProbeSetup> probe_setup;

template <int kForm>
cudaError_t raise_probe(int optin, int* dynamic_max) {
  return raise_smem_limit(sparse_probe_kernel<kForm>, optin, dynamic_max);
}

cudaError_t probe_limits(ProbeSetup* out) {
  return probe_setup.with([&](int dev, ProbeSetup& s) {
    if (s.optin == 0) {
      int sms = 0, optin = 0, d0 = 0, d1 = 0, d2 = 0;
      cudaError_t e = device_limits(dev, &sms, &optin);
      if (e == cudaSuccess) e = raise_probe<kFormTopn>(optin, &d0);
      if (e == cudaSuccess) e = raise_probe<kFormCompact>(optin, &d1);
      if (e == cudaSuccess) e = raise_probe<kFormMasked>(optin, &d2);
      if (e != cudaSuccess) return e;
      int cs = kMaxCluster;
      for (; cs > 1; cs >>= 1) {
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = cs;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(cs, 1, 1);
        cfg.blockDim = dim3(kProbeThreads, 1, 1);
        cfg.dynamicSmemBytes = probe_smem(1024, 32, 8192, 2048);
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        if (cudaOccupancyMaxActiveClusters(
                &clusters, sparse_probe_kernel<kFormTopn>, &cfg) ==
                cudaSuccess && clusters > 0)
          break;
      }
      cudaGetLastError();  // a refused size is an answer, not a fault
      s.optin = d0 < d1 ? (d0 < d2 ? d0 : d2) : (d1 < d2 ? d1 : d2);
      s.max_cs = cs;
    }
    *out = s;
    return cudaSuccess;
  });
}

template <int kForm>
cudaError_t launch_probe(cudaLaunchConfig_t* cfg, const int32_t* post,
                         int64_t P, const uint32_t* bm, int64_t W,
                         const uint32_t* deleted, const uint32_t* extra,
                         int F, const int64_t* q, int Ks, int Kd, int probes,
                         int C, int Cmax, int64_t span, int chunk,
                         int tmask, int32_t* cnt, int64_t cnt_ld,
                         int32_t* ids, int64_t ids_ld, int width,
                         int descending, int B) {
  return cudaLaunchKernelEx(cfg, sparse_probe_kernel<kForm>, post, P, bm, W,
                            deleted, extra, F, q, Ks, Kd, probes, C, Cmax,
                            span, chunk, tmask, cnt, cnt_ld, ids, ids_ld,
                            width, descending, B);
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

// postings (P,) int32; bm (V, W), deleted (W,) and extra (F, W) int32
// words; q (B, 2 + 3 Ks + 2 Kd) int64 (the layout above); form 0 top-n, 1
// compaction, 2 masked (width == C); probes: 1 sparse, 2 dense. The count
// of query b goes to cnt[b * cnt_ld], its ids to ids[b * ids_ld ...].
// Returns cudaGetLastError() after the launch (or the set-up's error).
extern "C" int mygram_sparse_probe(const void* postings, long long P,
                                   const void* bm, long long W,
                                   const void* deleted, const void* extra,
                                   int F, const void* q, int Ks, int Kd,
                                   int probes, int C, int Cmax, int form,
                                   void* cnt, long long cnt_ld, void* ids,
                                   long long ids_ld, int width,
                                   int descending, int B, void* stream) {
  if (B <= 0 || C <= 0) return (int)cudaGetLastError();
  ProbeSetup s;
  cudaError_t e = probe_limits(&s);
  if (e != cudaSuccess) return (int)e;
  // a block for every 256 candidates (one a thread), up to the cluster
  int CS = (C + 255) / 256;
  if (CS > s.max_cs) CS = s.max_cs;
  const int64_t span = (((int64_t)C + CS - 1) / CS + 31) / 32 * 32;
  const int chunk = span < kChunk ? (int)span : kChunk;
  int tslots = 64;  // a power of two, at least twice the chunk
  while (tslots < 2 * chunk) tslots <<= 1;
  const size_t smem = probe_smem(chunk, Kd, span, tslots);
  if (smem > (size_t)s.optin) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(CS, B < 65535 ? B : 65535, 1);
  cfg.blockDim = dim3(kProbeThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto* post = (const int32_t*)postings;
  const auto* words = (const uint32_t*)bm;
  const auto* del = (const uint32_t*)deleted;
  const auto* ext = (const uint32_t*)extra;
  const auto* qa = (const int64_t*)q;
  auto* c_out = (int32_t*)cnt;
  auto* i_out = (int32_t*)ids;
  if (form == kFormTopn)
    e = launch_probe<kFormTopn>(&cfg, post, P, words, W, del, ext, F, qa, Ks,
                                Kd, probes, C, Cmax, span, chunk,
                                tslots - 1, c_out, cnt_ld, i_out, ids_ld,
                                width, descending, B);
  else if (form == kFormCompact)
    e = launch_probe<kFormCompact>(&cfg, post, P, words, W, del, ext, F, qa,
                                   Ks, Kd, probes, C, Cmax, span, chunk,
                                   tslots - 1, c_out, cnt_ld, i_out,
                                   ids_ld, width, 0, B);
  else
    e = launch_probe<kFormMasked>(&cfg, post, P, words, W, del, ext, F, qa,
                                  Ks, Kd, probes, C, Cmax, span, chunk,
                                  tslots - 1, c_out, cnt_ld, i_out,
                                  ids_ld, C, 0, B);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
