// K4, K5, K6: window term frequencies over the device text pack.
//
// Replaces three Pallas kernels of mygramdb_tpu/ops/verify_ops.py with one
// kernel and three addressings:
//   K4 tf_rows_flat_pallas (:669)        rows address the flat code-point
//                                        pack
//   K5 tf_rows_flat_global_pallas (:875) rows packed across a batch into a
//                                        live prefix; each row names its
//                                        needle set
//   K6 tf_rows_pallas (:489)             rows are rows of the padded matrix
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
// What bounds it on the H100: the bytes of each live row's window, win +
// cap cells of 2 or 4 bytes (the text store's call, 65,536 whole rows of
// 1,056 u16 cells, reads 138 MB: 0.041 ms at 3.35 TB/s), and, for the
// short rows of K4, K5 and K6's fused shape, the latency of each row's
// scattered loads. The compares are about one a start.
//
// The design: a warp per row, and no block barrier.
// - A block holds kWarps warps; each walks its own rows, warp-stride over
//   a persistent grid of as many blocks as fit on the card at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), so every SM
//   keeps dozens of rows' loads in flight. Lanes meet only in __syncwarp
//   and warp collectives. A warp issues the next row's loads (and its
//   needle table's) before it counts the current row, and loads row
//   metadata two rows ahead.
// - Each warp stages its row in its own slice of shared memory, in the
//   pack's own type. Slot s of the slice holds the text's 16-byte vector
//   floor(start / E) + s (E cells a vector), so any row start is staged
//   with aligned 16-byte loads and stores: a vector wholly inside the
//   row's valid cells is one load, the ragged first and last vectors are
//   masked scalar loads (no cell outside [0, text_len) or past a flat
//   row's length is read), vectors outside are sentinel.
// - doc_len of a padded row: each lane counts the non-sentinel cells of
//   its vectors, then one __reduce_add_sync; one __reduce_max_sync finds
//   the last slot holding text, past which no start can match a needle
//   that does not begin with the sentinel (the row is still read whole).
// - Counting: lane l takes the E starts of slots l, l + 32, ...; the
//   needle's first two cells sit in registers and are tested against all
//   E starts of a vector at once (for u16 cells, three integer operations
//   a word: __vcmpeq2 is emulated in several on this card); the cells
//   past the second are read only for the rare starts whose first two
//   match. All starts: one __reduce_add_sync per needle. Leftmost-greedy:
//   a __ballot_sync over 32 slots names the lanes with matches; every lane
//   walks their bits alike, skipping the starts the last match blocks, so
//   no flags are shared and no atomics are needed.
// - Starts at or past the last cell that can hold text (a flat row's
//   length, the pack's end, a padded row's last slot with text) see only
//   sentinel cells and are skipped unless the needle starts with the
//   sentinel; with the range mask the starts end at doc_len - nl_j. Both
//   cuts leave the counts as defined above.
// - Dead rows cost one length load and write zeros.

#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int kWarps = 8;  // rows a block works on at once
constexpr int kThreads = 32 * kWarps;
// 16-byte loads a lane has in flight for the next row: 32 * kBatch slots
// hold a whole row of 1,056 u16 cells (132 slots) or 1,280 u32 cells
constexpr int kBatch = 5;
constexpr int kMinBlocks = 4;  // 32 warps an SM: at most 64 registers
// needle-table words a lane has in flight for the next row: 32 *
// kTableRegs cover Nn * cap needle cells + Nn lengths up to 64
constexpr int kTableRegs = 2;
constexpr unsigned kAll = 0xffffffffu;

// 16-byte slots of one warp's slice: any start shift (< E cells) + span.
__host__ __device__ __forceinline__ int slots_of(int span, int E) {
  return (span + 2 * E - 2) / E;
}

// Bytes of one warp's slice: the row's slots, then its needle table
// (Nn * cap cells, Nn lengths) in whole 16-byte slots.
__host__ __device__ __forceinline__ int warp_bytes(int span, int E, int Nn,
                                                   int cap) {
  return 16 * slots_of(span, E) + 16 * ((4 * (Nn * cap + Nn) + 15) / 16);
}

// Bit 15 of each 16-bit half set where that half of x is zero, every other
// bit clear: three integer operations (no carry crosses a half), where the
// __vcmpeq2 intrinsic is emulated in several on this card.
__device__ __forceinline__ uint32_t zero_halves(uint32_t x) {
  return ~(((x & 0x7FFF7FFFu) + 0x7FFF7FFFu) | x | 0x7FFF7FFFu);
}

// non-sentinel cells of a vector
__device__ __forceinline__ int live_cells(uint4 v, uint16_t sent) {
  const uint32_t pat = sent * 0x10001u;
  return 8 - __popc(zero_halves(v.x ^ pat)) - __popc(zero_halves(v.y ^ pat)) -
         __popc(zero_halves(v.z ^ pat)) - __popc(zero_halves(v.w ^ pat));
}

__device__ __forceinline__ int live_cells(uint4 v, uint32_t sent) {
  return (v.x != sent) + (v.y != sent) + (v.z != sent) + (v.w != sent);
}

// A row's metadata, loaded two rows ahead of its use.
struct Meta {
  int64_t base;  // start of the row's window in the pack, in cells
  int32_t len;   // 0: a dead row (or no row)
  int32_t o;     // its needle set
};

__device__ __forceinline__ Meta load_meta(int r, int M,
                                          const int64_t* __restrict__ starts,
                                          const int32_t* __restrict__ lens,
                                          const int32_t* __restrict__ owner,
                                          int Kv) {
  Meta m = {0, 0, 0};
  if (r < M) {
    m.len = lens[r];
    m.base = starts[r];
    m.o = owner ? owner[r] : r / Kv;
  }
  return m;
}

// Where a row's window lies in the pack and in its warp's slice. Every
// offset but abase is in cells from abase, so a slot's tests are int
// compares.
struct Window {
  int64_t abase;  // the pack cell of slot 0, a multiple of E
  int lo, hi;     // the cells that may hold text: [lo, hi)
  int shift;      // the row's start: the slice cell of start 0
  int nslots;     // 16-byte slots covering the window
};

template <int E>
__device__ __forceinline__ Window window_of(const Meta& m, int span,
                                            int padded, int64_t text_len) {
  Window w;
  w.shift = (int)(((m.base % E) + E) % E);
  w.abase = m.base - w.shift;
  w.nslots = (w.shift + span + E - 1) / E;
  const int64_t top = w.shift + span;
  int64_t hi = m.base + (padded || m.len > span ? span : m.len);
  if (hi > text_len) hi = text_len;
  const int64_t lo = (m.base > 0 ? m.base : 0) - w.abase;
  hi -= w.abase;
  w.lo = (int)(lo < top ? lo : top);
  w.hi = (int)(hi < w.lo ? w.lo : hi < top ? hi : top);
  return w;
}

// Slot s of a window: one 16-byte load when the vector lies wholly inside
// [lo, hi), masked scalar loads for a ragged first or last vector, the
// sentinel outside (slots past nslots lie past hi); no cell outside [lo,
// hi) is read.
template <typename T>
__device__ __forceinline__ uint4 load_slot(const T* __restrict__ text,
                                           const Window& w, int s,
                                           uint4 fill, T sent) {
  constexpr int E = 16 / sizeof(T);
  const int c = s * E;
  if (c + E <= w.lo || c >= w.hi) return fill;
  const T* at = text + w.abase + c;
  if (c >= w.lo && c + E <= w.hi)
    return __ldg(reinterpret_cast<const uint4*>(at));
  union {
    uint4 v;
    T c[E];
  } x;
#pragma unroll
  for (int t = 0; t < E; ++t)
    x.c[t] = c + t >= w.lo && c + t < w.hi ? __ldg(at + t) : sent;
  return x.v;
}

// Word e of needle set o's table: Nn * cap needle cells, then Nn lengths.
__device__ __forceinline__ int32_t table_word(
    const int32_t* __restrict__ ndl, const int32_t* __restrict__ nlen,
    int o, int Nn, int cap, int e) {
  const int cells = Nn * cap;
  if (e < cells) return __ldg(ndl + (int64_t)o * cells + e);
  if (e < cells + Nn) return __ldg(nlen + (int64_t)o * Nn + e - cells);
  return 0;
}

// Bit t set for each cell t of slot s of the warp's slice at which the
// needle's first cell n0 stands and, when kmax > 1, its second cell n1
// follows: the E starts of a vector at once, the second cells read as the
// vector shifted by one cell (the next slot's first cell last).
__device__ __forceinline__ unsigned pair_hits(const uint4* slice, int s,
                                              int32_t n0, int32_t n1,
                                              int kmax, uint16_t) {
  if ((uint32_t)n0 > 0xFFFFu) return 0u;  // no u16 cell widens to it
  const uint4 v = slice[s];
  const uint32_t p0 = (uint32_t)n0 * 0x10001u;
  uint32_t a = zero_halves(v.x ^ p0), b = zero_halves(v.y ^ p0),
           c = zero_halves(v.z ^ p0), d = zero_halves(v.w ^ p0);
  if ((a | b | c | d) == 0u) return 0u;  // most vectors stop here
  if (kmax > 1) {
    if ((uint32_t)n1 > 0xFFFFu) return 0u;
    const uint32_t p1 = (uint32_t)n1 * 0x10001u;
    const uint32_t nx = reinterpret_cast<const uint32_t*>(slice + s + 1)[0];
    a &= zero_halves(__funnelshift_r(v.x, v.y, 16) ^ p1);
    b &= zero_halves(__funnelshift_r(v.y, v.z, 16) ^ p1);
    c &= zero_halves(__funnelshift_r(v.z, v.w, 16) ^ p1);
    d &= zero_halves(__funnelshift_r(v.w, nx, 16) ^ p1);
  }
  // bit 15 of a word is its even cell, bit 31 its odd one
  return (a >> 15 & 1u) | (a >> 30 & 2u) | (b >> 13 & 4u) | (b >> 28 & 8u) |
         (c >> 11 & 16u) | (c >> 26 & 32u) | (d >> 9 & 64u) |
         (d >> 24 & 128u);
}

__device__ __forceinline__ unsigned pair_hits(const uint4* slice, int s,
                                              int32_t n0, int32_t n1,
                                              int kmax, uint32_t) {
  const uint4 v = slice[s];
  const uint32_t c0 = (uint32_t)n0;
  const unsigned h = (v.x == c0) | (v.y == c0) << 1 | (v.z == c0) << 2 |
                     (v.w == c0) << 3;
  if (h == 0u || kmax < 2) return h;
  const uint32_t c1 = (uint32_t)n1;
  const uint32_t nx = reinterpret_cast<const uint32_t*>(slice + s + 1)[0];
  return h & ((v.y == c1) | (v.z == c1) << 1 | (v.w == c1) << 2 |
              (nx == c1) << 3);
}

// Bit t set for each cell t of slot s at which the needle matches: its
// start p = s * E + t - shift lies in [0, pend) and every cell k < kmax
// equals nd[k] (cells and needle from the warp's slice). Cells past the
// second are read only for the rare starts whose first two match.
template <typename T>
__device__ __forceinline__ unsigned slot_matches(const uint4* slice, int s,
                                                 int shift, int pend,
                                                 const int32_t* nd,
                                                 int32_t n0, int32_t n1,
                                                 int kmax) {
  constexpr int E = 16 / sizeof(T);
  unsigned bits = pair_hits(slice, s, n0, n1, kmax, T());
  if (bits == 0u) return 0u;
  const int p0 = s * E - shift;  // the start of bit 0
  if (p0 < 0) bits &= ~0u << -p0;
  if (p0 + E > pend) bits &= pend > p0 ? (1u << (pend - p0)) - 1u : 0u;
  const T* cells = reinterpret_cast<const T*>(slice) + shift;
  for (unsigned left = kmax > 2 ? bits : 0u; left; left &= left - 1) {
    const int t = __ffs(left) - 1;
    for (int k = 2; k < kmax; ++k)
      if ((int32_t)cells[p0 + t + k] != nd[k]) {
        bits &= ~(1u << t);
        break;
      }
  }
  return bits;
}

// tf of one needle over a staged row. Lane l tests slots l, l + 32, ...
// (E starts each, the first two cells tested a vector at a time). All
// starts: one __reduce_add_sync. Leftmost-greedy: for each 32 slots, a
// __ballot_sync names the lanes with matches; every lane walks them in
// order alike (their bits by __shfl_sync), skipping the starts the last
// match blocks.
template <typename T>
__device__ __forceinline__ int needle_tf(const uint4* slice, int shift,
                                         int pend, const int32_t* nd,
                                         int kmax, int nl, int nonoverlap,
                                         int lane) {
  constexpr int E = 16 / sizeof(T);
  const int nsl = pend > 0 ? (shift + pend + E - 1) / E : 0;
  const int32_t n0 = nd[0], n1 = nd[1];  // nd[1] is used when kmax > 1
  if (!nonoverlap) {
    int cnt = 0;
    for (int s = lane; s < nsl; s += 32)
      cnt += __popc(
          slot_matches<T>(slice, s, shift, pend, nd, n0, n1, kmax));
    return __reduce_add_sync(kAll, cnt);
  }
  int cnt = 0, next = 0;  // the same in every lane
  for (int s0 = 0; s0 < nsl; s0 += 32) {
    const int s = s0 + lane;
    const unsigned m =
        s < nsl ? slot_matches<T>(slice, s, shift, pend, nd, n0, n1, kmax)
                : 0u;
    unsigned lanes = __ballot_sync(kAll, m != 0u);
    while (lanes) {
      const int l = __ffs(lanes) - 1;
      lanes &= lanes - 1;
      unsigned bits = __shfl_sync(kAll, m, l);
      const int p0 = (s0 + l) * E - shift;  // the start of bit 0
      while (bits) {
        const int p = p0 + __ffs(bits) - 1;
        bits &= bits - 1;
        if (p >= next) {
          ++cnt;
          next = p + nl;
        }
      }
    }
  }
  return cnt;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tf_rows_kernel(const T* __restrict__ text, int64_t text_len,
               const int64_t* __restrict__ starts,
               const int32_t* __restrict__ lens,
               const int32_t* __restrict__ owner,
               const int32_t* __restrict__ live,
               const int32_t* __restrict__ ndl,
               const int32_t* __restrict__ nlen, int M, int Kv, int Nn,
               int cap, int win, int padded, int use_range, int nonoverlap,
               int32_t sentinel, int32_t* __restrict__ out) {
  constexpr int E = 16 / sizeof(T);  // cells a 16-byte vector
  extern __shared__ uint4 smem[];
  const int span = win + cap;
  const int lane = threadIdx.x & 31;
  uint4* slice =
      smem + (threadIdx.x >> 5) * (warp_bytes(span, E, Nn, cap) / 16);
  int32_t* table = reinterpret_cast<int32_t*>(slice + slots_of(span, E));
  const int nd_cells = Nn * cap, table_len = nd_cells + Nn;
  const T sent = (T)sentinel;
  union {
    uint4 v;
    T c[E];
  } fill;
#pragma unroll
  for (int t = 0; t < E; ++t) fill.c[t] = sent;

  const int n_live = live ? *live : M;
  const int stride = gridDim.x * kWarps;
  int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  // the pipeline: row r is staged and counted while the first kBatch
  // slots of each lane and its needle table for row r + stride are in
  // flight, and the metadata of row r + 2 * stride
  Meta cur = load_meta(r, M, starts, lens, owner, Kv);
  Meta nxt = load_meta(r + stride, M, starts, lens, owner, Kv);
  uint4 x[kBatch];
  int32_t tw[kTableRegs];
  if (r < n_live && cur.len > 0) {
    const Window w = window_of<E>(cur, span, padded, text_len);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      x[u] = load_slot(text, w, 32 * u + lane, fill.v, sent);
#pragma unroll
    for (int i = 0; i < kTableRegs; ++i)
      tw[i] = table_word(ndl, nlen, cur.o, Nn, cap, 32 * i + lane);
  }
  for (; r < M; r += stride) {
    int32_t* orow = out + (int64_t)r * (Nn + 1);
    const bool alive = r < n_live && cur.len > 0;  // the same in the warp
    Window w;
    // starts at or past text_end see only sentinel cells
    int doc_len = 0, text_end = 0;
    if (alive) {
      w = window_of<E>(cur, span, padded, text_len);
      __syncwarp();  // every lane is done with the previous row's cells
      int nonsent = 0, last = -1;  // padded: the last slot with text
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = 32 * u + lane;
        if (s < w.nslots) {
          slice[s] = x[u];
          if (padded) {
            const int n = live_cells(x[u], sent);
            nonsent += n;
            if (n) last = s;
          }
        }
      }
      // a window past 32 * kBatch slots: the rest, kBatch loads a lane
      // before their stores
      for (int s0 = 32 * kBatch; s0 < w.nslots; s0 += 32 * kBatch) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          x[u] = load_slot(text, w, s0 + 32 * u + lane, fill.v, sent);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int s = s0 + 32 * u + lane;
          if (s < w.nslots) {
            slice[s] = x[u];
            if (padded) {
              const int n = live_cells(x[u], sent);
              nonsent += n;
              if (n) last = s;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTableRegs; ++i)
        if (32 * i + lane < table_len) table[32 * i + lane] = tw[i];
      for (int e = 32 * kTableRegs + lane; e < table_len; e += 32)
        table[e] = table_word(ndl, nlen, cur.o, Nn, cap, e);
      __syncwarp();  // the row and its needles are staged
      if (padded) {
        // a padded row is read whole; past its last slot with text every
        // cell is the sentinel
        doc_len = __reduce_add_sync(kAll, nonsent);
        text_end = (__reduce_max_sync(kAll, last) + 1) * E - w.shift;
      } else {
        doc_len = cur.len;
        text_end = w.hi - w.shift;
      }
      if (text_end < 0) text_end = 0;
    }
    // start the next row's loads before this row's counting
    const Meta after = load_meta(r + 2 * stride, M, starts, lens, owner, Kv);
    if (r + stride < n_live && nxt.len > 0) {
      const Window wn = window_of<E>(nxt, span, padded, text_len);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        x[u] = load_slot(text, wn, 32 * u + lane, fill.v, sent);
#pragma unroll
      for (int i = 0; i < kTableRegs; ++i)
        tw[i] = table_word(ndl, nlen, nxt.o, Nn, cap, 32 * i + lane);
    }
    if (!alive) {
      for (int j = lane; j <= Nn; j += 32) orow[j] = 0;
    } else {
      for (int j = 0; j < Nn; ++j) {
        const int nl = table[nd_cells + j];
        int tf = 0;
        if (nl > 0) {
          const int32_t* nd = table + j * cap;
          int pend = win;
          if (use_range && doc_len - nl + 1 < pend) pend = doc_len - nl + 1;
          if (nd[0] != sentinel && text_end < pend) pend = text_end;
          tf = needle_tf<T>(slice, w.shift, pend, nd, nl < cap ? nl : cap,
                            nl, nonoverlap, lane);
        }
        if (lane == 0) orow[j] = tf;
      }
      if (lane == 0) orow[Nn] = doc_len;
    }
    cur = nxt;
    nxt = after;
  }
}

// Blocks of tf_rows_kernel<T> that the current device holds at once with
// smem bytes of dynamic shared memory each. Each device keeps its SM count,
// its raised shared-memory limit and the last answer (consecutive calls
// mostly share a window).
struct Resident {
  int sms;       // 0 until the device's first launch set the attribute
  size_t smem;   // the memo: blocks for smem bytes a block
  int blocks;
};

template <typename T>
cudaError_t resident_blocks(size_t smem, int* blocks) {
  static PerDevice<Resident> state;
  return state.with([&](int dev, Resident& r) {
    if (r.sms == 0) {
      int sms = 0, optin = 0, dynamic_max = 0;
      cudaError_t e = device_limits(dev, &sms, &optin);
      // the most any launch may ask for; never lowered, so a launch never
      // races another thread's setting
      if (e == cudaSuccess)
        e = raise_smem_limit(tf_rows_kernel<T>, optin, &dynamic_max);
      if (e != cudaSuccess) return e;
      r.sms = sms;
    }
    if (r.blocks == 0 || r.smem != smem) {
      int per_sm = 0;
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tf_rows_kernel<T>, kThreads, smem);
      if (e != cudaSuccess) return e;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      r.smem = smem;
      r.blocks = per_sm * r.sms;
    }
    *blocks = r.blocks;
    return cudaSuccess;
  });
}

template <typename T>
int launch(const void* text, long long text_len, const void* starts,
           const void* lens, const void* owner, const void* live,
           const void* ndl, const void* nlen, int M, int Kv, int Nn, int cap,
           int win, int padded, int use_range, int nonoverlap, int sentinel,
           void* out, void* stream) {
  const size_t smem =
      (size_t)kWarps * warp_bytes(win + cap, 16 / sizeof(T), Nn, cap);
  int grid = 0;
  const cudaError_t e = resident_blocks<T>(smem, &grid);
  if (e != cudaSuccess) return (int)e;
  const int want = (M + kWarps - 1) / kWarps;
  if (grid > want) grid = want;
  tf_rows_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)text, text_len, (const int64_t*)starts, (const int32_t*)lens,
      (const int32_t*)owner, (const int32_t*)live, (const int32_t*)ndl,
      (const int32_t*)nlen, M, Kv, Nn, cap, win, padded, use_range,
      nonoverlap, sentinel, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// text: the pack (u16 when elem_bytes == 2, u32 when 4), text_len cells,
// 16-byte aligned; starts (M,) int64; lens (M,) int32; owner (M,) int32 or
// null (row / Kv); live (1,) int32 or null; ndl (B, Nn*cap) int32; nlen
// (B, Nn) int32; out (M, Nn+1) int32. Dynamic shared memory: kWarps *
// warp_bytes(win + cap, 16 / elem_bytes, Nn, cap) bytes a block (the
// wrapper refuses a window that needs more than a block may have). Returns
// cudaGetLastError() after the launch.
extern "C" int mygram_tf_rows(const void* text, int elem_bytes,
                              long long text_len, const void* starts,
                              const void* lens, const void* owner,
                              const void* live, const void* ndl,
                              const void* nlen, int M, int Kv, int Nn,
                              int cap, int win, int padded, int use_range,
                              int nonoverlap, int sentinel, void* out,
                              void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if (elem_bytes == 2)
    return launch<uint16_t>(text, text_len, starts, lens, owner, live, ndl,
                            nlen, M, Kv, Nn, cap, win, padded, use_range,
                            nonoverlap, sentinel, out, stream);
  if (elem_bytes == 4)
    return launch<uint32_t>(text, text_len, starts, lens, owner, live, ndl,
                            nlen, M, Kv, Nn, cap, win, padded, use_range,
                            nonoverlap, sentinel, out, stream);
  return (int)cudaErrorInvalidValue;
}
