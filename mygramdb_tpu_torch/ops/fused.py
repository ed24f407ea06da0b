"""Fused verified search on PyTorch (port of ``mygramdb_tpu.ops.fused``):
match -> compact -> window TF -> verify -> count or BM25 -> top-n, one
program per batch.

1. dense AND over bitmap rows (K1), or the rarest sparse term's CSR slice
   probed by the other grams (K3's probe entry);
2. compact the first Kv matching candidates (in the same launch as step
   1: K1 takes the first ids, K3's probe compacts); ``pre`` is the match
   count before the verify, and pre > Kv means the compaction clipped:
   the caller re-runs that query on the exact path;
3. per-candidate, per-needle window term frequencies through the kernel
   family of ``csrc/verify_tf.cu``: the flat pack rows (K4), the flat pack
   packed across the batch into a live prefix (K5), or the padded matrix
   (K6). Verify = every present needle has tf > 0;
4. verified count and the top n by doc id, or by BM25 (score descending,
   then doc id descending).

Only (pre, count, n ids [, n scores]) per query come back to the host,
in one pull; the batch's host arguments go up in one upload each.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import runtime
from .bitmap_ops import dense_and_topn
from .posting_ops import (SENTINEL, compact_first_k,  # noqa: F401
                          mask_to_topn, pack_sparse_args, sparse_probe,
                          split_selection)
from .verify_ops import (bm25_scores, cast_needles_i32, needle_cap_bucket,
                         sort_by_score, tf_rows_flat, tf_rows_flat_global,
                         tf_rows_padded)

# The live-prefix kernel (K5) takes a batch once its candidate slots pass
# one chunk of this many rows; below that the per-slot kernel does the
# same work without the packing pass. The JAX package's value, kept so
# both packages route alike until it is re-measured on the card.
_SCAN_CHUNK = 16384


def _reduce_from_tf(sel, tf, doc_len, needle_lens, idf, k1, b, avgdl, *,
                    n: int, descending: bool, score_mode: bool,
                    require_match: bool):
    """Batched tail over the TF matrix: sel (B, Kv), tf (B, Kv, Nn),
    doc_len (B, Kv), needle_lens (B, Nn), idf (B, Nn) ->
    (count (B,), ids (B, n), scores (B, n) or None).

    Verify mask = every present needle has tf > 0. require_match=False
    (score mode only) keeps every candidate: scoring a query that needs no
    verify must not drop gram matches whose text lacks the term."""
    alive = sel != SENTINEL
    absent = (needle_lens <= 0)[:, None, :]
    matched = ((tf > 0) | absent).all(dim=2)
    if not score_mode:
        count, ids = mask_to_topn(sel, matched & alive, n, descending)
        return count, ids, None
    vmask = matched & alive if require_match else alive
    count = vmask.sum(dim=1, dtype=torch.int32)
    score = bm25_scores(tf, doc_len, idf, k1, b, avgdl)
    score = torch.where(vmask, score, -torch.inf)
    ids, sc = sort_by_score(torch.where(alive, sel, -1), score)
    ids, sc = ids[:, :n], sc[:, :n]
    return count, torch.where(torch.isfinite(sc), ids, -1), sc


def _pack_live(sel_all: torch.Tensor, Mp: int):
    """Pack the batch's live candidates (B, Kv) into a prefix of Mp rows ->
    (src (Mp,) flat slot of each packed row, live (Mp,) bool, V (1,) int32
    count of live candidates), all on the device: the host never waits."""
    flat = sel_all.reshape(-1)
    BK = flat.shape[0]
    valid = flat != SENTINEL
    pos = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(valid, pos.long(), BK)
    src = torch.zeros(BK + 1, dtype=torch.int64, device=flat.device)
    src.scatter_(0, tgt, torch.arange(BK, device=flat.device))
    V = valid.sum(dtype=torch.int32).reshape(1)
    live = torch.arange(Mp, device=flat.device) < V
    return torch.where(live, src[:Mp], 0), live, V


def _verify_stage(sel_all, store, ndl, nlen, idf, k1, b, avgdl, *, Kv: int,
                  n: int, Nn: int, maxT: int, cap: int, descending: bool,
                  score_mode: bool, nonoverlap: bool, require_match: bool,
                  use_range: bool, global_pack: int = 0):
    """Batched verify tail: sel_all (B, Kv) compacted candidates, ndl
    (B, Nn*cap) and nlen (B, Nn) int32 needles in the compare domain, idf
    (B, Nn) float32 -> (count (B,), ids (B, n), scores (B, n) or None).

    Routing, as the JAX package's kernel branch: a flat pack with a packed
    width (``global_pack``) runs K5 over the batch's live candidates; a
    flat pack otherwise runs K4 over every slot; the padded matrix runs
    K6 over every slot, reading the row prefix that covers ``maxT``."""
    cp, offsets, lengths = store.codepoints, store.offsets, store.lengths
    B = sel_all.shape[0]
    BK = B * Kv
    rng = bool(score_mode or use_range)
    alive = sel_all != SENTINEL
    if cp.dim() == 1 and global_pack:
        Mp = min(global_pack, BK)
        src, live, V = _pack_live(sel_all, Mp)
        ids = torch.where(live, sel_all.reshape(-1)[src], 0).long()
        lens = torch.where(live, lengths[ids], 0).to(torch.int32)
        owner = torch.where(live, src // Kv, 0).to(torch.int32)
        out = tf_rows_flat_global(cp, offsets[ids], lens, owner, V, ndl,
                                  nlen, cap=cap, win=maxT, use_range=rng,
                                  nonoverlap=nonoverlap)
        back = torch.where(live, src, BK)  # dead rows land in a spare row
        full = torch.zeros((BK + 1, Nn + 1), dtype=torch.int32,
                           device=cp.device)
        full.index_copy_(0, back, out)
        out = full[:BK]
    else:
        ids = torch.where(alive, sel_all, 0).reshape(-1).long()
        lens = torch.where(alive.reshape(-1), lengths[ids], 0
                           ).to(torch.int32)
        if cp.dim() == 2:
            width = min(cp.shape[1], maxT + cap)
            out = tf_rows_padded(cp, ids, lens, ndl, nlen, Kv=Kv, cap=cap,
                                 width=width, use_range=rng,
                                 nonoverlap=nonoverlap)
        else:
            out = tf_rows_flat(cp, offsets[ids], lens, ndl, nlen, Kv=Kv,
                               cap=cap, win=maxT, use_range=rng,
                               nonoverlap=nonoverlap)
    tf = out[:, :Nn].reshape(B, Kv, Nn)
    dl = out[:, Nn].reshape(B, Kv)
    return _reduce_from_tf(sel_all, tf, dl, nlen, idf, k1, b, avgdl, n=n,
                           descending=descending, score_mode=score_mode,
                           require_match=require_match)


def _search_verify_topn_batch(bitmaps, rows, deleted, extra, store, ndl,
                              nlen, idf, k1, b, avgdl, *, C: int, Kv: int,
                              n: int, Nn: int, maxT: int, descending: bool,
                              score_mode: bool, cap: int,
                              nonoverlap: bool = False,
                              require_match: bool = True,
                              use_range: bool = True,
                              global_pack: int = 0):
    """Batched dense-driver fused verified search: rows (B, K) AND'ed by
    K1 (with the filter rows ``extra`` (F, W) or None), the first C
    matching ids ascending become the candidates. -> (pre, count, ids,
    scores or None) tensors; pre > C means the extraction clipped."""
    # one K1 launch: the count and the first min(Kv, C) ids ascending
    out, _ = dense_and_topn(bitmaps, rows, None, extra, deleted, min(Kv, C),
                            False)
    pre, cand = out[:, 0], out[:, 1:]
    sel_all = torch.where(cand >= 0, cand, SENTINEL)
    count, ids, scores = _verify_stage(
        sel_all, store, ndl, nlen, idf, k1, b, avgdl, Kv=min(Kv, C), n=n,
        Nn=Nn, maxT=maxT, cap=cap, descending=descending,
        score_mode=score_mode, nonoverlap=nonoverlap,
        require_match=require_match, use_range=use_range,
        global_pack=global_pack)
    return pre, count, ids, scores


def _sparse_search_verify_topn_batch(postings, bitmaps, deleted, args,
                                     extra, store, ndl, nlen, idf, k1, b,
                                     avgdl, *, Ks: int, Kd: int, C: int,
                                     Cmax: int, Kv: int, n: int, Nn: int,
                                     maxT: int,
                                     descending: bool, score_mode: bool,
                                     n_words: int, cap: int,
                                     nonoverlap: bool = False,
                                     use_dense_probes: bool = True,
                                     require_match: bool = True,
                                     use_range: bool = True,
                                     global_pack: int = 0):
    """Sparse-driver fused verified search, batched: each query's rarest
    term's CSR slice is its candidate vector, probed by the other grams
    and compacted to the first Kv survivors (one launch of K3's probe
    entry; ``args`` is ``pack_sparse_args``'s matrix on the device), then
    verified.

    Probe-free: when the slice fits the verify width, the dense probes
    are off and the verify filters (require_match), the window verify
    subsumes every gram probe (text containing a term contains each of
    its grams), so no probe runs; filter rows and tombstones still apply.
    use_dense_probes=False with C > Kv still runs the sparse probes, so
    that fewer candidates clip. Where the verify does not filter (a score
    query whose terms are each one gram), every probe runs: nothing else
    would apply the other terms.
    -> (pre, count, ids, scores or None); pre > Kv means the compaction
    clipped and that query must take the exact path."""
    dense_probes = use_dense_probes or not require_match
    probeless = (not dense_probes) and C <= Kv
    # probeless at Kv == C: the driver slice is the candidate vector
    form = "masked" if probeless and Kv == C else "compact"
    buf = sparse_probe(postings, bitmaps, deleted, extra, args, Ks=Ks,
                       Kd=Kd, C=C, Cmax=Cmax, n_words=n_words, form=form,
                       width=Kv, sparse_probes=not probeless,
                       dense_probes=dense_probes)
    pre, sel_all = split_selection(buf, args.shape[0])
    count, ids, scores = _verify_stage(
        sel_all, store, ndl, nlen, idf, k1, b, avgdl, Kv=Kv, n=n, Nn=Nn,
        maxT=maxT, cap=cap, descending=descending, score_mode=score_mode,
        nonoverlap=nonoverlap, require_match=require_match,
        use_range=use_range, global_pack=global_pack)
    return pre, count, ids, scores


def _needles_need_range(text_store, needles) -> bool:
    """True when the in-range window mask is needed for correctness: only
    for a u16 pack with a needle code point that clamps to the 0xFFFF
    padding sentinel (that cell would otherwise match the fill past a
    document's end). u32 packs use a sentinel that is no code point."""
    if getattr(text_store, "dtype", None) != np.uint16:
        return False
    return bool(np.size(needles)) and int(np.max(needles)) >= 0xFFFF


def _global_pack_policy(text_store, B: int, Kv: int, nonoverlap: bool,
                        vbound: Optional[int] = None) -> int:
    """Packed width M of the live-prefix kernel (K5), 0 = off: flat packs
    only, for batches past one scan chunk, not for the non-overlapping
    count. vbound, a host-known bound on the batch's live candidates (sum
    of min(driver df, Kv)), buckets M to a power of two >= 4096 instead of
    B*Kv."""
    if nonoverlap or B * Kv <= _SCAN_CHUNK:
        return 0
    if text_store.codepoints.dim() != 1:
        return 0
    bk = B * Kv
    m = bk if vbound is None else max(min(bk, int(vbound)), 1)
    M = 4096
    while M < m:
        M <<= 1
    return min(M, bk)


def _needle_tensors(store, needles, needle_lens, idf, cap: int, dev):
    """(B, Nn, CAP) uint32 needles, (B, Nn) lengths and idf (numpy) ->
    (ndl (B, Nn*cap) int32, nlen (B, Nn) int32, idf (B, Nn) float32) on
    the device, views of one upload."""
    ndl = cast_needles_i32(needles, store.dtype, cap)
    nlen = np.asarray(needle_lens, dtype=np.int32)
    idf = np.ascontiguousarray(idf, dtype=np.float32)
    buf = runtime.to_device(np.concatenate(
        [ndl.ravel(), nlen.ravel(), idf.view(np.int32).ravel()]), dev)
    a, c = ndl.size, ndl.size + nlen.size
    return (buf[:a].view(ndl.shape), buf[a:c].view(nlen.shape),
            buf[c:].view(torch.float32).view(idf.shape))


def _to_host(pre, count, ids, scores, score_mode: bool):
    """The batch's (pre, count, ids[, scores]) in one pull (scores travel
    as their int32 bit pattern)."""
    parts = [pre[:, None], count[:, None], ids.to(torch.int32)]
    if score_mode:
        parts.append(scores.view(torch.int32))
    out = torch.cat(parts, dim=1).cpu().numpy()
    n = ids.shape[1]
    res = [out[:, 0], out[:, 1], out[:, 2:2 + n]]
    if score_mode:
        res.append(out[:, 2 + n:].view(np.float32))
    return tuple(res)


def sparse_search_verify_topn_batch(postings, bitmaps, deleted, d_off,
                                    d_len, sp_off, sp_len, sp_inv, dn_rows,
                                    dn_inv, text_store, C: int, Cmax: int,
                                    n: int, needles, needle_lens,
                                    n_words: int, descending: bool = True,
                                    Kv: int = 0, maxT: int = 0, idf=None,
                                    k1: float = 1.2, b: float = 0.75,
                                    avgdl: float = 1.0,
                                    score_mode: bool = False,
                                    nonoverlap: bool = False,
                                    use_dense_probes: bool = True,
                                    require_match: bool = True,
                                    extra=None):
    """numpy wrapper of ``_sparse_search_verify_topn_batch``: probe arrays
    (B, ...) numpy with int64 offsets and lengths; needles (B, Nn, CAP)
    uint32; extra (F, W) filter rows on the device or None.
    -> numpy (pre, count, ids[, scores if score_mode])."""
    Kv = Kv or min(C, 4096)
    maxT = maxT or text_store.maxT
    d_len = np.asarray(d_len, dtype=np.int64)
    B, Nn = d_len.shape[0], needles.shape[1]
    if idf is None:
        idf = np.zeros((B, Nn), dtype=np.float32)
    runtime.dispatches.bump()
    cap = needle_cap_bucket(max(int(np.max(needle_lens)), 1))
    dev = postings.device
    ndl, nlen, idf_t = _needle_tensors(text_store, needles, needle_lens, idf,
                                       cap, dev)
    vbound = int(np.minimum(d_len, Kv).sum())
    args = pack_sparse_args(d_off, d_len, sp_off, sp_len, sp_inv, dn_rows,
                            dn_inv)
    res = _sparse_search_verify_topn_batch(
        postings, bitmaps, deleted, runtime.to_device(args, dev), extra,
        text_store, ndl, nlen, idf_t, k1, b, avgdl,
        Ks=np.asarray(sp_off).reshape(B, -1).shape[1],
        Kd=np.asarray(dn_rows).reshape(B, -1).shape[1], C=C, Cmax=Cmax,
        Kv=Kv, n=n, Nn=Nn, maxT=maxT,
        descending=descending, score_mode=score_mode, n_words=n_words,
        cap=cap, nonoverlap=nonoverlap, use_dense_probes=use_dense_probes,
        require_match=require_match,
        use_range=_needles_need_range(text_store, needles),
        global_pack=_global_pack_policy(text_store, B, Kv, nonoverlap,
                                        vbound))
    return _to_host(*res, score_mode)


def search_verify_topn_batch(bitmaps, rows, deleted, extra, text_store,
                             cand_bucket: int, n: int, needles, needle_lens,
                             descending: bool = True, maxT: int = 0,
                             idf=None, k1: float = 1.2, b: float = 0.75,
                             avgdl: float = 1.0, score_mode: bool = False,
                             nonoverlap: bool = False,
                             require_match: bool = True,
                             vbound: Optional[int] = None):
    """Batched dense-driver verified search: rows (B, K) int32 on the
    device, extra (F, W) filter rows or None, needles (B, Nn, CAP) uint32.
    vbound: host-known bound on the batch's AND survivors (sum of each
    query's least dense df), the packed width bound of K5.
    -> numpy (pre, count, ids[, scores]); pre > cand_bucket means the
    extraction clipped (the caller re-runs that query exactly)."""
    maxT = maxT or text_store.maxT
    B, Nn = rows.shape[0], needles.shape[1]
    if idf is None:
        idf = np.zeros((B, Nn), dtype=np.float32)
    runtime.dispatches.bump()
    cap = needle_cap_bucket(max(int(np.max(needle_lens)), 1))
    ndl, nlen, idf_t = _needle_tensors(text_store, needles, needle_lens, idf,
                                       cap, bitmaps.device)
    res = _search_verify_topn_batch(
        bitmaps, rows, deleted, extra, text_store, ndl, nlen, idf_t, k1, b,
        avgdl, C=cand_bucket, Kv=cand_bucket, n=n, Nn=Nn, maxT=maxT,
        descending=descending, score_mode=score_mode, cap=cap,
        nonoverlap=nonoverlap, require_match=require_match,
        use_range=_needles_need_range(text_store, needles),
        global_pack=_global_pack_policy(text_store, B, cand_bucket,
                                        nonoverlap, vbound))
    return _to_host(*res, score_mode)
