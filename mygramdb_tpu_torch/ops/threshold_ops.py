"""Threshold-count merge: the FUZZY search backbone (port of
``mygramdb_tpu.ops.threshold_ops``).

Reference Index::SearchByThreshold (index.cpp:448-528) k-way heap-merges G
posting lists and keeps doc ids appearing in >= t of them. Here, as in the
JAX package: concatenate the padded posting slices, sort the flat vector
and rank-count runs with two vectorized binary searches; or, with dense
terms among them, accumulate per-document counts lane by lane. Both are
torch ops around the slice gather (K3); the JAX package has no Pallas
kernel here either.
"""

from __future__ import annotations

import torch

from .bitmap_ops import _select_first_k
from .posting_ops import SENTINEL, gather_slices


def threshold_count_bitmap(bitmaps: torch.Tensor, rows: torch.Tensor,
                           postings: torch.Tensor, offs: torch.Tensor,
                           lens: torch.Tensor, min_count,
                           deleted: torch.Tensor, *, g_sparse: int,
                           c_bucket: int) -> torch.Tensor:
    """Mixed dense+sparse threshold count, fully on the device.

    Counts, per doc, how many of the given posting sets contain it and
    returns the ``count >= min_count`` result as a packed (W,) int32
    bitmap with tombstones cleared.

    bitmaps: (R, W) dense rows; rows: (G,) int32 row indices (a padding
    entry must point at the all-zeros row). postings/offs/lens: g_sparse
    CSR slices, offsets and lengths int64 (g_sparse=0 is the dense-only
    form: no slice gather). Dense counts accumulate per (word, bit) lane,
    one row at a time; sparse ids scatter-add into the flat per-doc
    counter, pads and out-of-range ids into an extra slot that is cut
    off."""
    W = bitmaps.shape[1]
    n_docs = W * 32
    shifts = torch.arange(32, dtype=torch.int32, device=bitmaps.device)
    flat = torch.zeros(n_docs + 1, dtype=torch.int32, device=bitmaps.device)
    cnt = flat[:n_docs].view(W, 32)
    for i in range(rows.shape[0]):
        cnt += (bitmaps[rows[i]][:, None] >> shifts) & 1
    if g_sparse:
        ids = gather_slices(postings, offs, lens, c_bucket).reshape(-1)
        ids = torch.where((ids >= 0) & (ids < n_docs), ids, n_docs)
        flat.scatter_add_(0, ids.long(), torch.ones_like(ids))
    ok = (cnt >= min_count).to(torch.int32)
    words = (ok << shifts).sum(dim=1, dtype=torch.int32)
    return words & ~deleted


def threshold_merge(padded_slices: torch.Tensor, min_count, max_out: int):
    """padded_slices: (G, C2) int32 (SENTINEL padded, each row sorted).

    Returns (count, (max_out,) doc ids ascending, -1 padded) of doc ids
    whose multiplicity across rows >= min_count; max_out is clamped to
    G * C2."""
    flat = torch.sort(padded_slices.reshape(-1)).values
    n = flat.shape[0]
    max_out = min(max_out, n)
    left = torch.searchsorted(flat, flat, right=False)
    right = torch.searchsorted(flat, flat, right=True)
    is_first = left == torch.arange(n, device=flat.device)
    ok = ((right - left) >= min_count) & is_first & (flat != SENTINEL)
    total = ok.sum(dtype=torch.int32)
    # flat is ascending, so the first max_out flagged positions hold the
    # max_out smallest matching ids
    pos, valid = _select_first_k(ok[None, :], max_out)
    ids = torch.where(valid[0], flat[pos[0]], -1)
    return total, ids.to(torch.int32)
