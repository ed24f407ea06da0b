"""Text-window verify and BM25 term frequencies on PyTorch (port of
``mygramdb_tpu.ops.verify_ops``).

The normalized corpus lives on the device as one flat code-point pack
(``(P,)``, per-doc int64 offset + length) or a padded ``(N, rowT)`` matrix
(sentinel-filled past each doc's end). A needle of length ``nl`` matches at
start ``p`` of a candidate's window when

    AND_k<min(nl, cap) ( text[p + k] == needle[k] )   [and p + nl <= doc_len]

and a term frequency counts such starts (all of them, or leftmost-greedy
non-overlapping ones).

Compare domain: u16 packs are stored as int16 tensors and compared as
0..0xFFFF (sentinel 0xFFFF); u32 packs are stored as int32 and compared as
their int32 bit pattern (sentinel 0xFFFFFFFF is -1). Needle code points
that do not fit a u16 pack clamp to its sentinel, which never equals a
real text cell, so such needles fail unless ``use_range`` is off and the
window runs into the sentinel fill: callers keep ``use_range`` on for them
(``fused._needles_need_range``).

Every TF on the card goes through one hand-written CUDA kernel family,
``csrc/verify_tf.cu``, behind three wrappers:

- ``tf_rows_flat`` (K4, replaces ``tf_rows_flat_pallas``): rows address
  the flat pack; each row's needle set is ``row // Kv``;
- ``tf_rows_flat_global`` (K5, replaces ``tf_rows_flat_global_pallas``):
  rows packed across a batch into a live prefix of device length ``v``,
  each with its owner's needle set; rows past ``v`` are zero;
- ``tf_rows_padded`` (K6, replaces ``tf_rows_pallas``): rows are rows of
  the padded matrix; doc_len is the count of non-sentinel cells in the
  row's ``width`` prefix.

Each returns (M, Nn+1) int32 ``[tf | doc_len]``. ``_tf_rows_plain`` is the
family's plain PyTorch version; a wrapper takes it only for CPU tensors.
Rows whose length is 0 (dead candidates, empty or unpacked docs) write
zeros in every variant.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import runtime

NEEDLE_CAP = 32  # needles longer than this fall back to host verification
_CAP_BUCKETS = (4, 8, 16, 32)
U16_SENTINEL = 0xFFFF
# the kernel's rows a block (kWarps in csrc/verify_tf.cu), each staged in
# its warp's own slice of shared memory
_TF_WARPS = 8
# shared memory a block may have on the H100 (227 KB, opted in above 48 KB)
_SMEM_LIMIT = 232_448


def needle_cap_bucket(max_len: int) -> int:
    """Compare-loop bound: a 2-char CJK needle must not pay the 32-cell
    cap."""
    for c in _CAP_BUCKETS:
        if max_len <= c:
            return c
    return NEEDLE_CAP


def has_self_overlap(term: str) -> bool:
    """True when the term has a proper border (prefix == suffix), i.e. the
    all-positions count can exceed the non-overlapping count."""
    n = len(term)
    return any(term[:i] == term[n - i:] for i in range(1, n))


def pack_sentinel(codepoints: torch.Tensor) -> int:
    """The padding sentinel of a pack in the compare domain."""
    return U16_SENTINEL if codepoints.dtype == torch.int16 else -1


def cells_i32(t: torch.Tensor) -> torch.Tensor:
    """Pack cells (int16 for u16 packs, int32 for u32) -> compare domain."""
    if t.dtype == torch.int16:
        return t.to(torch.int32) & U16_SENTINEL
    return t.to(torch.int32)


def cast_needles_i32(needles, dtype, cap: int) -> np.ndarray:
    """(..., Nn, CAP) uint32 -> (..., Nn*cap) int32 in the compare domain:
    clamped to the u16 sentinel for u16 packs (``dtype`` np.uint16),
    plain widening for u32 packs (code points <= 0x10FFFF stay positive,
    so they never alias the u32 sentinel's -1)."""
    ndl = np.asarray(needles, dtype=np.uint32)[..., :cap]
    if dtype == np.uint16:
        ndl = np.minimum(ndl, np.uint32(U16_SENTINEL))
    lead = ndl.shape[:-2]
    return ndl.astype(np.int32).reshape(*lead, -1)


# ---------------------------------------------------------------------------
# The XLA path of the JAX package, as torch
# ---------------------------------------------------------------------------

def gather_text(codepoints: torch.Tensor, offsets: torch.Tensor,
                lengths: torch.Tensor, cand_ids: torch.Tensor, maxT: int,
                cap: int = NEEDLE_CAP, need_len: bool = True):
    """Candidate text windows in the compare domain -> (text (C, win+cap)
    int32, doc_len (C,) int32 or None, win).

    Flat pack: cells [off, off + maxT + cap), sentinel past each doc's
    length; win = maxT. Padded matrix: whole rows (rowT >= maxT + cap, the
    store bakes the cap columns in); win = rowT - cap and doc_len is the
    non-sentinel count."""
    ids = cand_ids.clamp(min=0).long()
    if codepoints.dim() == 2:
        rows = cells_i32(codepoints[ids])
        sent = pack_sentinel(codepoints)
        doc_len = ((rows != sent).sum(1, dtype=torch.int32)
                   if need_len else None)
        return rows, doc_len, codepoints.shape[1] - cap
    sent = pack_sentinel(codepoints)
    doc_len = lengths[ids].to(torch.int32)
    pos = torch.arange(maxT + cap, dtype=torch.int64,
                       device=codepoints.device)
    idx = offsets[ids].to(torch.int64)[:, None] + pos[None, :]
    valid = (pos[None, :] < doc_len[:, None]) & (idx < codepoints.shape[0])
    text = cells_i32(codepoints[torch.where(valid, idx, 0)])
    return torch.where(valid, text, sent), doc_len, maxT


def _match_at(text: torch.Tensor, ndl: torch.Tensor, nlen: torch.Tensor,
              maxT: int, cap: int) -> torch.Tensor:
    """(C, maxT) bool: needle ``ndl`` (cap,) of length ``nlen`` (scalar or
    (C, 1)) matches at each start of text (C, maxT+cap)."""
    m = None
    for k in range(cap):
        cmp = (k >= nlen) | (text[:, k:k + maxT] == ndl[..., k, None])
        m = cmp if m is None else m & cmp
    return m


def _hits(text, doc_len, ndl, nlen, win, cap, use_range):
    m = _match_at(text, ndl, nlen, win, cap)
    if use_range:
        starts = torch.arange(win, dtype=torch.int32, device=text.device)
        m = m & (starts[None, :] + nlen <= doc_len[:, None])
    return m


def contains_all(text, doc_len, needles, needle_lens, maxT: int, Nn: int,
                 cap: int, use_range: bool = True) -> torch.Tensor:
    """(C,) bool: text contains every non-empty needle. needles (Nn, cap)
    int32 in the compare domain (``cast_needles_i32``), needle_lens (Nn,)."""
    acc = None
    for j in range(Nn):
        nl = needle_lens[j]
        found = _hits(text, doc_len, needles[j], nl, maxT, cap,
                      use_range).any(1) | (nl == 0)
        acc = found if acc is None else acc & found
    return acc


def tf_matrix(text, doc_len, needles, needle_lens, maxT: int, Nn: int,
              cap: int, use_range: bool = True) -> torch.Tensor:
    """(C, Nn) int32 all-positions match counts."""
    cols = []
    for j in range(Nn):
        nl = needle_lens[j]
        count = _hits(text, doc_len, needles[j], nl, maxT, cap,
                      use_range).sum(1, dtype=torch.int32)
        cols.append(torch.where(nl == 0, 0, count))
    return torch.stack(cols, 1)


def _greedy_count(hits: torch.Tensor, nlen: torch.Tensor) -> torch.Tensor:
    """Leftmost-greedy count of the set flags of hits (C, L), a match
    blocking the next nlen (C,) starts."""
    C, L = hits.shape
    nextf = torch.zeros(C, dtype=torch.int64, device=hits.device)
    cnt = torch.zeros(C, dtype=torch.int32, device=hits.device)
    nl = nlen.to(torch.int64)
    for p in range(L):
        take = hits[:, p] & (p >= nextf)
        cnt += take.to(torch.int32)
        nextf = torch.where(take, p + nl, nextf)
    return cnt


def tf_matrix_nonoverlap(text, doc_len, needles, needle_lens, maxT: int,
                         Nn: int, cap: int,
                         use_range: bool = True) -> torch.Tensor:
    """(C, Nn) int32 non-overlapping (leftmost-greedy) counts: the
    reference's CountTermOccurrences ("aa" in "aaaa" -> 2)."""
    cols = []
    C = text.shape[0]
    for j in range(Nn):
        nl = needle_lens[j]
        hits = _hits(text, doc_len, needles[j], nl, maxT, cap, use_range)
        count = _greedy_count(hits, nl.expand(C))
        cols.append(torch.where(nl == 0, 0, count))
    return torch.stack(cols, 1)


def _tf_candidates(codepoints, offsets, lengths, cand_ids, ndl_i32, nlen,
                   *, maxT: int, cap: int, use_range: bool,
                   nonoverlap: bool = False) -> torch.Tensor:
    """One needle set (Nn, CAP) over C candidates through the kernel
    family -> (C, Nn+1) [tf | doc_len]; candidates < 0 give zeros."""
    alive = cand_ids >= 0
    ids = torch.where(alive, cand_ids, 0).long()
    lens = torch.where(alive, lengths[ids], 0).to(torch.int32)
    C = cand_ids.shape[0]
    if codepoints.dim() == 2:
        return tf_rows_padded(codepoints, ids, lens, ndl_i32[None],
                              nlen[None], Kv=max(C, 1), cap=cap,
                              width=codepoints.shape[1],
                              use_range=use_range, nonoverlap=nonoverlap)
    return tf_rows_flat(codepoints, offsets[ids], lens, ndl_i32[None],
                        nlen[None], Kv=max(C, 1), cap=cap, win=maxT,
                        use_range=use_range, nonoverlap=nonoverlap)


def _needle_tensors(codepoints, needles, needle_lens, cap):
    dtype = np.uint16 if codepoints.dtype == torch.int16 else np.uint32
    dev = codepoints.device
    ndl = torch.from_numpy(cast_needles_i32(needles, dtype, cap)).to(dev)
    nlen = torch.as_tensor(np.asarray(needle_lens, dtype=np.int32)
                           ).to(dev)
    return ndl, nlen


def substring_verify_device(codepoints, offsets, lengths, cand_ids,
                            needles, needle_lens, *, C: int, maxT: int,
                            Nn: int, cap: int = NEEDLE_CAP,
                            use_range: bool = True) -> torch.Tensor:
    """-> (C,) bool: candidate text contains ALL needles. needles (Nn,
    NEEDLE_CAP) uint32 numpy (0 padded), needle_lens (Nn,); cand_ids (C,)
    int tensor, -1 padded."""
    ndl, nlen = _needle_tensors(codepoints, needles, needle_lens, cap)
    out = _tf_candidates(codepoints, offsets, lengths, cand_ids, ndl, nlen,
                         maxT=maxT, cap=cap, use_range=use_range)
    ok = (out[:, :Nn] > 0) | (nlen[None, :] == 0)
    return ok.all(1) & (cand_ids >= 0)


def substring_masks_device(codepoints, offsets, lengths, cand_ids,
                           needles, needle_lens, *, C: int, maxT: int,
                           Nn: int, cap: int = NEEDLE_CAP,
                           use_range: bool = True) -> torch.Tensor:
    """-> (C, Nn) bool per-needle contains columns."""
    ndl, nlen = _needle_tensors(codepoints, needles, needle_lens, cap)
    out = _tf_candidates(codepoints, offsets, lengths, cand_ids, ndl, nlen,
                         maxT=maxT, cap=cap, use_range=use_range)
    ok = (out[:, :Nn] > 0) | (nlen[None, :] == 0)
    return ok & (cand_ids >= 0)[:, None]


def count_occurrences_device(codepoints, offsets, lengths, cand_ids,
                             needles, needle_lens, *, C: int, maxT: int,
                             Nn: int, cap: int = NEEDLE_CAP,
                             nonoverlap: bool = False):
    """BM25 TF -> (tf (C, Nn) int32, doc_len (C,) int32), zero for dead
    candidates. The range mask is always on (doc_len exists anyway)."""
    ndl, nlen = _needle_tensors(codepoints, needles, needle_lens, cap)
    out = _tf_candidates(codepoints, offsets, lengths, cand_ids, ndl, nlen,
                         maxT=maxT, cap=cap, use_range=True,
                         nonoverlap=nonoverlap)
    return out[:, :Nn], out[:, Nn]


def bm25_scores(tf, doc_len, idf, k1, b, avgdl) -> torch.Tensor:
    """(..., C) float32 BM25 from tf (..., C, Nn), doc_len (..., C) and
    idf (..., Nn) (reference bm25_scorer.h:41)."""
    # float32 scalars, as the JAX package computes them
    k1, b, avgdl = (torch.tensor(float(x), dtype=torch.float32,
                                 device=tf.device) for x in (k1, b, avgdl))
    tff = tf.to(torch.float32)
    norm = k1 * (1.0 - b + b * doc_len.to(torch.float32)[..., None]
                 / torch.clamp(avgdl, min=1e-9))
    return (idf[..., None, :] * tff * (k1 + 1.0)
            / torch.clamp(tff + norm, min=1e-9)).sum(-1)


def sort_by_score(ids: torch.Tensor, score: torch.Tensor):
    """Two-key sort along the last axis: score descending, then doc id
    descending -> (ids, scores) reordered."""
    by_id, order = torch.sort(ids, dim=-1, descending=True, stable=True)
    sc = torch.gather(score, -1, order)
    sc, order2 = torch.sort(sc, dim=-1, descending=True, stable=True)
    return torch.gather(by_id, -1, order2), sc


def bm25_topk_device(codepoints, offsets, lengths, cand_ids, needles,
                     needle_lens, idf, k1, b, avgdl, *, C: int, maxT: int,
                     Nn: int, n: int, cap: int = NEEDLE_CAP,
                     nonoverlap: bool = False):
    """TF -> score -> top-n: (top_ids (n,) int32 -1 padded, top_scores (n,)
    float32), score desc, ties doc id desc. idf (Nn,) float32."""
    tf, dl = count_occurrences_device(
        codepoints, offsets, lengths, cand_ids, needles, needle_lens, C=C,
        maxT=maxT, Nn=Nn, cap=cap, nonoverlap=nonoverlap)
    idf_t = torch.as_tensor(np.asarray(idf, dtype=np.float32)
                            ).to(codepoints.device)
    score = bm25_scores(tf, dl, idf_t, float(k1), float(b), avgdl)
    score = torch.where(cand_ids >= 0, score, -torch.inf)
    ids, sc = sort_by_score(cand_ids.to(torch.int32), score)
    return ids[:n], sc[:n]


# ---------------------------------------------------------------------------
# K4-K6: the window-TF kernel family
# ---------------------------------------------------------------------------

def _tf_rows_plain(text: torch.Tensor, starts: torch.Tensor,
                   lens: torch.Tensor, owner: Optional[torch.Tensor],
                   live: Optional[torch.Tensor], ndl: torch.Tensor,
                   nlen: torch.Tensor, *, Kv: int, cap: int, win: int,
                   padded: bool, use_range: bool,
                   nonoverlap: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel family (``mygram_tf_rows``).

    text: the flat pack (P,) or the padded matrix viewed flat; starts (M,)
    int64 cell offsets of each row; lens (M,) int32 doc lengths (0 = dead
    row); owner (M,) int32 needle-set index or None (row // Kv); live ()
    or (1,) int32 live-prefix length or None; ndl (B, Nn*cap) int32;
    nlen (B, Nn) int32. Rows read cells [0, win+cap): flat rows mask
    cells past their length to the sentinel, padded rows read the matrix
    as it is and count doc_len as its non-sentinel cells."""
    flat = text.reshape(-1)
    M = starts.shape[0]
    Nn = nlen.shape[1]
    dev = text.device
    out = torch.zeros((M, Nn + 1), dtype=torch.int32, device=dev)
    if M == 0:
        return out
    sent = pack_sentinel(text)
    span = win + cap
    pos = torch.arange(span, dtype=torch.int64, device=dev)
    idx = starts.to(torch.int64)[:, None] + pos[None, :]
    inside = (idx >= 0) & (idx < flat.shape[0])
    valid = inside if padded else inside & (pos[None, :] < lens[:, None])
    cells = torch.where(valid, cells_i32(flat[torch.where(valid, idx, 0)]),
                        sent)
    doc_len = ((cells != sent).sum(1, dtype=torch.int32) if padded
               else lens.to(torch.int32))
    rows = torch.arange(M, device=dev)
    own = owner.long() if owner is not None else rows // Kv
    nd = ndl[own].reshape(M, Nn, -1)[:, :, :cap]
    nl = nlen[own].to(torch.int32)
    cols = []
    for j in range(Nn):
        nlj = nl[:, j, None]
        hits = _hits(cells, doc_len, nd[:, j], nlj, win, cap, use_range)
        cnt = (_greedy_count(hits, nl[:, j]) if nonoverlap
               else hits.sum(1, dtype=torch.int32))
        cols.append(torch.where(nl[:, j] == 0, 0, cnt))
    res = torch.cat([torch.stack(cols, 1), doc_len[:, None]], 1)
    alive = lens > 0
    if live is not None:
        alive &= rows < live.reshape(()).to(torch.int64)
    return torch.where(alive[:, None], res, out)


def _tf_smem_bytes(span: int, itemsize: int, Nn: int, cap: int) -> int:
    """Dynamic shared memory of one block of the kernel: each warp's slice
    holds ``span`` cells at any start shift and the row's needle table, in
    16-byte slots (``warp_bytes`` in csrc/verify_tf.cu)."""
    per_vec = 16 // itemsize
    slots = (span + 2 * per_vec - 2) // per_vec
    table = (4 * (Nn * cap + Nn) + 15) // 16
    return _TF_WARPS * 16 * (slots + table)


def _tf_rows_launch(name: str, text: torch.Tensor, starts, lens, owner,
                    live, ndl, nlen, *, Kv: int, cap: int, win: int,
                    padded: bool, use_range: bool,
                    nonoverlap: bool) -> torch.Tensor:
    """Check the inputs and launch ``mygram_tf_rows`` for a CUDA text."""
    parts = [t for t in (text, starts, lens, owner, live, ndl, nlen)
             if t is not None]
    runtime.require_cuda(name, *parts)
    if text.dtype not in (torch.int16, torch.int32):
        raise runtime.kernel_error(f"{name}: the pack must be int16 (u16) "
                                   f"or int32 (u32), got {text.dtype}")
    if starts.dtype != torch.int64 or any(
            t.dtype != torch.int32 for t in (lens, owner, live, ndl, nlen)
            if t is not None):
        raise runtime.kernel_error(f"{name}: starts int64; lens, owner, "
                                   "live, needles and lengths int32")
    if not all(t.is_contiguous() for t in parts):
        raise runtime.kernel_error(f"{name}: tensors must be contiguous")
    M = starts.shape[0]
    B, Nn = nlen.shape
    if (lens.shape != (M,) or (owner is not None and owner.shape != (M,))
            or (live is not None and live.numel() != 1)
            or ndl.shape != (B, Nn * cap) or Nn < 1
            or (owner is None and Kv < 1)):
        raise runtime.kernel_error(f"{name}: shape mismatch")
    if cap < 1 or cap > NEEDLE_CAP or win < 1:
        raise runtime.kernel_error(f"{name}: cap {cap} or window {win} out "
                                   "of range")
    if text.data_ptr() % 16:
        raise runtime.kernel_error(f"{name}: the pack must be 16-byte "
                                   "aligned (the kernel loads 16-byte "
                                   "vectors)")
    smem = _tf_smem_bytes(win + cap, text.element_size(), Nn, cap)
    if smem > _SMEM_LIMIT:
        raise runtime.kernel_error(f"{name}: window {win} + cap {cap} with "
                                   f"{Nn} needles needs {smem} bytes of "
                                   "shared memory a block")
    out = torch.empty((M, Nn + 1), dtype=torch.int32, device=text.device)
    if M == 0:
        return out
    err = runtime.launch_on(
        text, runtime.kernels().mygram_tf_rows,
        text.data_ptr(), text.element_size(), text.numel(),
        starts.data_ptr(), lens.data_ptr(),
        None if owner is None else owner.data_ptr(),
        None if live is None else live.data_ptr(),
        ndl.data_ptr(), nlen.data_ptr(), M, max(Kv, 1), Nn, cap, win,
        int(padded), int(use_range), int(nonoverlap), pack_sentinel(text),
        out.data_ptr())
    forms = ["tf_rows.nonoverlap"] if nonoverlap else []
    if padded and win + cap == text.shape[-1]:
        forms.append("tf_rows_padded.whole_rows")  # the text store's calls
    runtime.check_launch(err, name, forms)
    return out


def _tf_flat_plain(codepoints, starts, lens, ndl_i32, nlen_i32, *, Kv,
                   cap, win, use_range, nonoverlap=False):
    """Plain PyTorch version of K4 (same signature as ``tf_rows_flat``)."""
    return _tf_rows_plain(codepoints, starts, lens, None, None, ndl_i32,
                          nlen_i32, Kv=Kv, cap=cap, win=win, padded=False,
                          use_range=use_range, nonoverlap=nonoverlap)


def tf_rows_flat(codepoints: torch.Tensor, starts: torch.Tensor,
                 lens: torch.Tensor, ndl_i32: torch.Tensor,
                 nlen_i32: torch.Tensor, *, Kv: int, cap: int, win: int,
                 use_range: bool, nonoverlap: bool = False) -> torch.Tensor:
    """K4 wrapper: M = B*Kv rows of the flat pack codepoints (P,); row r
    reads cells [starts[r], starts[r] + win + cap), sentinel past lens[r],
    counts needle set r // Kv over starts p < win -> (M, Nn+1) int32
    [tf | doc_len]. starts int64, lens int32; ndl_i32 (B, Nn*cap) and
    nlen_i32 (B, Nn) int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if codepoints.device.type == "cpu":
        return _tf_flat_plain(codepoints, starts, lens, ndl_i32, nlen_i32,
                              Kv=Kv, cap=cap, win=win, use_range=use_range,
                              nonoverlap=nonoverlap)
    return _tf_rows_launch("tf_rows_flat", codepoints, starts, lens, None,
                           None, ndl_i32, nlen_i32, Kv=Kv, cap=cap, win=win,
                           padded=False, use_range=use_range,
                           nonoverlap=nonoverlap)


def _tf_flat_global_plain(codepoints, starts, lens, owner, live, ndl_i32,
                          nlen_i32, *, cap, win, use_range,
                          nonoverlap=False):
    """Plain PyTorch version of K5 (same signature as
    ``tf_rows_flat_global``)."""
    return _tf_rows_plain(codepoints, starts, lens, owner, live, ndl_i32,
                          nlen_i32, Kv=1, cap=cap, win=win, padded=False,
                          use_range=use_range, nonoverlap=nonoverlap)


def tf_rows_flat_global(codepoints: torch.Tensor, starts: torch.Tensor,
                        lens: torch.Tensor, owner: torch.Tensor,
                        live: torch.Tensor, ndl_i32: torch.Tensor,
                        nlen_i32: torch.Tensor, *, cap: int, win: int,
                        use_range: bool,
                        nonoverlap: bool = False) -> torch.Tensor:
    """K5 wrapper: K4 over rows packed across a batch. owner (M,) int32
    picks each row's needle set; live (1,) int32 on the device is the
    live-prefix length (rows >= live write zeros, read by the kernel, so
    the host never waits for it)."""
    if codepoints.device.type == "cpu":
        return _tf_flat_global_plain(codepoints, starts, lens, owner, live,
                                     ndl_i32, nlen_i32, cap=cap, win=win,
                                     use_range=use_range,
                                     nonoverlap=nonoverlap)
    return _tf_rows_launch("tf_rows_flat_global", codepoints, starts, lens,
                           owner, live, ndl_i32, nlen_i32, Kv=1, cap=cap,
                           win=win, padded=False, use_range=use_range,
                           nonoverlap=nonoverlap)


def _padded_starts(padded: torch.Tensor, ids: torch.Tensor, width: int,
                   cap: int) -> torch.Tensor:
    N, rowT = padded.shape
    if width > rowT or width <= cap:
        raise ValueError(f"width {width} must lie in (cap, rowT={rowT}]")
    return ids.to(torch.int64).clamp(0, max(N - 1, 0)) * rowT


def _tf_padded_plain(padded, ids, lens, ndl_i32, nlen_i32, *, Kv, cap,
                     width, use_range, nonoverlap=False):
    """Plain PyTorch version of K6 (same signature as
    ``tf_rows_padded``)."""
    starts = _padded_starts(padded, ids, width, cap)
    return _tf_rows_plain(padded, starts, lens, None, None, ndl_i32,
                          nlen_i32, Kv=Kv, cap=cap, win=width - cap,
                          padded=True, use_range=use_range,
                          nonoverlap=nonoverlap)


def tf_rows_padded(padded: torch.Tensor, ids: torch.Tensor,
                   lens: torch.Tensor, ndl_i32: torch.Tensor,
                   nlen_i32: torch.Tensor, *, Kv: int, cap: int, width: int,
                   use_range: bool, nonoverlap: bool = False) -> torch.Tensor:
    """K6 wrapper: rows ids (M,) of the padded matrix (N, rowT); each reads
    its ``width``-cell prefix (every candidate's length must be <= width
    - cap), doc_len = the prefix's non-sentinel cells, starts p < width -
    cap; lens (M,) int32 marks dead rows (0); needle set r // Kv."""
    if padded.device.type == "cpu":
        return _tf_padded_plain(padded, ids, lens, ndl_i32, nlen_i32,
                                Kv=Kv, cap=cap, width=width,
                                use_range=use_range, nonoverlap=nonoverlap)
    try:
        starts = _padded_starts(padded, ids, width, cap)
    except ValueError as e:
        raise runtime.kernel_error(f"tf_rows_padded: {e}") from e
    return _tf_rows_launch("tf_rows_padded", padded, starts, lens, None,
                           None, ndl_i32, nlen_i32, Kv=Kv, cap=cap,
                           win=width - cap, padded=True,
                           use_range=use_range, nonoverlap=nonoverlap)
