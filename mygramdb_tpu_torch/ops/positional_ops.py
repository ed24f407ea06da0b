"""Positional verification: substring verify without text gathers (port of
``mygramdb_tpu.ops.positional_ops``).

For every (term, doc) posting the positional index stores the positions of
the gram's occurrences in the normalized text (``index/positional.py``). A
query term with grams g_i at in-term offsets o_i matches doc d at anchor
position p iff every (d, p + o_i - o_drv) is an occurrence of g_i. When the
grams cover every position of the term, anchored gram equality pins every
code point, so this is exactly substring containment, and the anchor count
is the all-positions term frequency the BM25 scorer needs.

The program of a batch (``positional_verify_topn_batch``) is torch ops
around the CSR slice gather K3 (``posting_ops.gather_slices``, masked, int64
offsets): the driver's and the probes' occurrence doc ids and positions,
and with ``use_doc_probes`` their CSR slices, each one launch for the
batch. Pair membership is one batched ``torch.searchsorted`` over int64
keys ``doc * 2^32 + pos``: each term's (doc, pos) pairs are unique and
sorted, so the search is exact (the JAX package's hierarchical blocked
rank is a workaround for the TPU's data-dependent gathers). The JAX
package's other public helpers (``blocked_take``, ``blocked_rank_le``,
``membership_pairs``, ``segmented_cumsum``, ``gather_rows_u16``,
``gather_slices_u16``) are plain torch functions with the same results.
"""

from __future__ import annotations

import numpy as np
import torch

from . import runtime
from .bitmap_ops import bit_member
from .posting_ops import (SENTINEL, _gather_slices_plain, gather_slices,
                          mask_to_topn, membership_rows)

BLK = 128
# the K3 launch form of this program's gathers (runtime.launch_forms)
FORM = "slice_gather.positional"


# ---------------------------------------------------------------------------
# The JAX package's helpers, as plain torch functions
# ---------------------------------------------------------------------------

def gather_slices_u16(arr: torch.Tensor, offsets: torch.Tensor,
                      lengths: torch.Tensor, bucket: int,
                      fill: int = 0) -> torch.Tensor:
    """(K,) u16 slices [off, off + len) -> (K, bucket) int32, pad ``fill``.
    arr: (P,) uint16 values as torch uint16, int16 bits or int32."""
    vals = arr.to(torch.int32)
    if arr.dtype in (torch.int16, torch.uint16):
        vals &= 0xFFFF
    lengths = lengths.to(torch.int64)
    out = _gather_slices_plain(vals, offsets.to(torch.int64), lengths,
                               bucket)
    j = torch.arange(bucket, device=arr.device)
    return torch.where(j[None, :] < lengths[:, None], out, fill)


def gather_rows_u16(arr8: torch.Tensor, base8: torch.Tensor,
                    lengths: torch.Tensor, bucket: int,
                    fill: int = -1) -> torch.Tensor:
    """Row-aligned slice gather: arr8 a (R, 128) view of an occurrence
    array whose term regions start 128-aligned; slice k starts at row
    base8[k]. -> (K, bucket) int32, entries >= length -> ``fill``."""
    return gather_slices_u16(arr8.reshape(-1), base8.to(torch.int64) * BLK,
                             lengths, bucket, fill)


def blocked_take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[idx] with out-of-range indices clamped."""
    return values[idx.to(torch.int64).clamp(0, values.shape[0] - 1)]


def blocked_rank_le(sorted_vals: torch.Tensor,
                    queries: torch.Tensor) -> torch.Tensor:
    """Count of sorted_vals <= q per query -> int32."""
    return torch.searchsorted(sorted_vals.contiguous(), queries.contiguous(),
                              right=True).to(torch.int32)


def pair_keys(doc: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """int64 keys ``doc * 2^32 + pos``: lexicographic (doc, pos) order for
    any int32 doc and any |pos| < 2^31, so no two pairs alias."""
    return doc.to(torch.int64) * (1 << 32) + pos.to(torch.int64)


def membership_pairs(pair_doc: torch.Tensor, pair_pos: torch.Tensor,
                     q_doc: torch.Tensor, q_pos: torch.Tensor
                     ) -> torch.Tensor:
    """(q_doc, q_pos) in the lexicographically sorted (pair_doc, pair_pos)
    list -> (N,) bool. Pairs are unique; pads carry pair_doc = 2^31 - 1."""
    keys = pair_keys(pair_doc, pair_pos)
    return membership_rows(keys[None, :],
                           pair_keys(q_doc, q_pos)[None, :])[0]


def segmented_cumsum(values: torch.Tensor,
                     seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the last axis, restarting where
    seg_start is set."""
    c = torch.cumsum(values, dim=-1)
    n = values.shape[-1]
    # the last start at or before each cell (0 before the first start,
    # where c - values is 0 too)
    last = torch.cummax(torch.where(
        seg_start.bool(), torch.arange(n, device=values.device), 0),
        dim=-1).values
    return (c - torch.gather(c - values, -1, last)).to(values.dtype)


# ---------------------------------------------------------------------------
# The positional verified search
# ---------------------------------------------------------------------------

def positional_verify_topn_batch(
        postings, occ_doc, occ_pos, deleted, extra, doc_len,
        d_off, d_len, d_start, d_olen,
        p_off, p_len, p_start, p_olen, p_delta, p_valid,
        idf, k1, b, avgdl,
        *, C: int, Co: int, C2: int, Co2: int, G: int, n: int,
        n_words: int, descending: bool, score_mode: bool,
        require_match: bool = True, use_doc_probes: bool = False):
    """Batched single-term verified search over the positional index, one
    program for B queries sharing a shape bucket.

    Per query the term's rarest gram (the driver) gives the candidate docs
    and the anchor positions; every other gram (probe g, at offset
    delta_g from the driver) must occur at (doc, anchor + delta_g).
    Anchors that survive every probe are term occurrences; their count per
    candidate is the term's TF.

    postings (P,) int32 full CSR; occ_doc/occ_pos (O,) int32; deleted (W,)
    and extra (F, W) or None int32 words; doc_len (capacity,) int32. Per
    query (device tensors): d_off/d_len (B,) the driver's CSR slice
    (``use_doc_probes`` only); d_start/d_olen (B,) its occurrences; p_*
    (B, G) the probes' equivalents, p_delta (B, G) anchor offsets, p_valid
    (B, G) bool; idf (B, 1) float32. Offsets and lengths are int64.

    -> (B, 3 + n [+ n]) int32 ``[pre | count | 1 | ids (n) | scores
    (n, float32 bits)]``: pre is the live gram-AND count with
    ``use_doc_probes``, else the driver's doc count."""
    B = d_start.shape[0]
    dev = occ_doc.device
    # K3: driver and probe occurrences, SENTINEL past each length
    a_doc = gather_slices(occ_doc, d_start, d_olen, Co, FORM)
    d_pos = gather_slices(occ_pos, d_start, d_olen, Co, FORM)
    ps = p_start.reshape(-1).contiguous()
    pl = p_olen.reshape(-1).contiguous()
    p_doc = gather_slices(occ_doc, ps, pl, Co2, FORM)
    p_pos = gather_slices(occ_pos, ps, pl, Co2, FORM)
    a_valid = (torch.arange(Co, dtype=torch.int64, device=dev)[None, :]
               < d_olen[:, None])
    # each probe's sorted pair keys (pads sort last: doc SENTINEL, pos
    # SENTINEL) against the anchors' targets; a masked anchor's target is
    # -1 and its position is never added to a delta
    keys = pair_keys(p_doc, p_pos)                          # (B G, Co2)
    target = torch.where(a_valid[:, None, :],
                         d_pos[:, None, :] + p_delta[:, :, None], -1)
    q = pair_keys(a_doc[:, None, :].expand(B, G, Co), target)
    hit = membership_rows(keys, q.reshape(B * G, Co)).reshape(B, G, Co)
    anchor_ok = a_valid & (hit | ~p_valid[:, :, None]).all(dim=1)
    # segments: runs of equal anchor doc (the candidates)
    edge = torch.full((B, 1), -2, dtype=torch.int32, device=dev)
    seg_start = a_valid & (a_doc != torch.cat([edge, a_doc[:, :-1]], 1))
    seg_last = a_valid & (a_doc != torch.cat([a_doc[:, 1:], edge], 1))
    if use_doc_probes:
        cands = gather_slices(postings, d_off, d_len, C, FORM)
        psl = gather_slices(postings, p_off.reshape(-1).contiguous(),
                            p_len.reshape(-1).contiguous(), C2, FORM)
        cclip = torch.where(cands != SENTINEL, cands, 0).clamp(
            0, n_words * 32 - 1)
        pre_mask = (cands != SENTINEL) & ~bit_member(deleted, cclip)
        dochit = membership_rows(
            psl, cands[:, None, :].expand(B, G, C).reshape(B * G, C)
            .contiguous()).reshape(B, G, C)
        pre_mask &= (dochit | ~p_valid[:, :, None]).all(dim=1)
        pre = pre_mask.sum(dim=1, dtype=torch.int32)
    else:
        pre = seg_start.sum(dim=1, dtype=torch.int32)
    tf = torch.where(seg_last, segmented_cumsum(anchor_ok.to(torch.int32),
                                                seg_start), 0)
    ids_stream = torch.where(seg_last, a_doc, SENTINEL)
    clip_doc = torch.where(seg_last, a_doc, 0).clamp(0, n_words * 32 - 1)
    ok = seg_last & ~bit_member(deleted, clip_doc)
    if extra is not None:
        for f in range(extra.shape[0]):
            ok &= bit_member(extra[f], clip_doc)
    vmask = ok & (tf > 0) if require_match else ok
    count = vmask.sum(dim=1, dtype=torch.int32)
    cols = [pre[:, None], count[:, None],
            torch.ones((B, 1), dtype=torch.int32, device=dev)]
    if score_mode:
        from .verify_ops import bm25_scores, sort_by_score
        dl = doc_len[clip_doc.to(torch.int64)]
        score = bm25_scores(tf[..., None], dl, idf, k1, b, avgdl)
        score = torch.where(vmask, score, -torch.inf)
        ids_s, score_s = sort_by_score(
            torch.where(vmask, ids_stream, -1), score)
        ids_s, score_s = ids_s[:, :n], score_s[:, :n]
        cols += [torch.where(torch.isfinite(score_s), ids_s, -1),
                 score_s.contiguous().view(torch.int32)]
    else:
        _, ids = mask_to_topn(torch.where(vmask, ids_stream, SENTINEL),
                              vmask, n, descending)
        cols.append(ids)
    return torch.cat(cols, dim=1)


def positional_verify_batch(postings, occ_doc, occ_pos, deleted, doc_len,
                            plans, n: int, n_words: int, descending: bool,
                            score_mode: bool = False, idf=None,
                            k1: float = 1.2, b: float = 0.75,
                            avgdl: float = 1.0, require_match: bool = True,
                            use_doc_probes: bool = False, extra=None):
    """Host wrapper over ``positional_verify_topn_batch``: stack B plans
    (dicts from ``DeviceIndex.plan_positional``, all of one shape bucket
    tuple), upload them at once, run the program once, pull once.
    -> (pre (B,), counts (B,), ids (B, n) [, scores (B, n)])."""
    B = len(plans)
    p0 = plans[0]
    C, Co, C2, Co2, G = (p0["C"], p0["Co"], p0["C2"], p0["Co2"], p0["G"])
    dev = occ_doc.device
    scal = np.asarray([[p[k] for k in ("d_off", "d_len", "d_start",
                                       "d_olen")] for p in plans],
                      dtype=np.int64)
    vec = np.asarray([[p[k] for k in ("p_off", "p_len", "p_start", "p_olen",
                                      "p_delta", "p_valid")]
                      for p in plans], dtype=np.int64)     # (B, 6, G)
    args = runtime.to_device(np.concatenate(
        [scal, vec.reshape(B, 6 * G)], axis=1), dev)
    d_off, d_len, d_start, d_olen = (args[:, i].contiguous()
                                     for i in range(4))
    p = args[:, 4:].reshape(B, 6, G)
    if idf is None:
        idf = np.zeros((B, 1), dtype=np.float32)
    runtime.dispatches.bump()
    out = positional_verify_topn_batch(
        postings, occ_doc, occ_pos, deleted, extra, doc_len,
        d_off, d_len, d_start, d_olen,
        p[:, 0], p[:, 1], p[:, 2], p[:, 3], p[:, 4], p[:, 5] != 0,
        runtime.to_device(np.asarray(idf, dtype=np.float32), dev),
        k1, b, avgdl, C=C, Co=Co, C2=C2, Co2=Co2, G=G, n=n,
        n_words=n_words, descending=descending, score_mode=score_mode,
        require_match=require_match,
        use_doc_probes=use_doc_probes).cpu().numpy()
    pre, count, ids = out[:, 0], out[:, 1], out[:, 3:3 + n]
    if score_mode:
        return pre, count, ids, out[:, 3 + n:3 + 2 * n].copy().view(
            np.float32)
    return pre, count, ids
