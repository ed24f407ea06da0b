"""Sparse posting-list ops (port of ``mygramdb_tpu.ops.posting_ops``).

Sparse terms live in one packed, per-term-sorted int32 doc-id array (CSR:
``postings`` + int64 ``offsets``/``lengths``). A query gathers the rarest
term's slice as its candidates and probes every other term against them.

The slice gather is the hand-written CUDA kernel K3
(``csrc/slice_gather.cu``) behind ``gather_slices``;
``_gather_slices_plain`` is its plain PyTorch version. Its loads are
masked, so the device CSR carries no sentinel pad tail. Membership is
``torch.searchsorted`` over the sorted rows (the JAX package's blocked
probe is a TPU workaround for a data-dependent gather).
"""

from __future__ import annotations

import torch

from .._not_ported import not_ported
from . import runtime
from .bitmap_ops import _select_first_k

SENTINEL = 2 ** 31 - 1  # pads posting slices; sorts after any doc id


def _gather_slices_plain(postings: torch.Tensor, offsets: torch.Tensor,
                         lengths: torch.Tensor, bucket: int) -> torch.Tensor:
    """Plain PyTorch version of K3 (same signature as ``gather_slices``)."""
    P = postings.shape[0]
    pos = torch.arange(bucket, dtype=torch.int64, device=postings.device)
    idx = offsets.to(torch.int64)[:, None] + pos[None, :]
    valid = ((pos[None, :] < lengths.to(torch.int64)[:, None])
             & (idx >= 0) & (idx < P))
    if P == 0:
        return torch.full(idx.shape, SENTINEL, dtype=torch.int32,
                          device=postings.device)
    vals = postings[torch.where(valid, idx, 0)]
    return torch.where(valid, vals, SENTINEL)


def gather_slices(postings: torch.Tensor, offsets: torch.Tensor,
                  lengths: torch.Tensor, bucket: int) -> torch.Tensor:
    """K3 wrapper: K CSR slices -> a (K, bucket) int32 tile.
    ``out[k, j] = postings[off[k] + j]`` when ``j < len[k]`` and
    ``off[k] + j < P``, else SENTINEL. postings (P,) int32; offsets and
    lengths (K,) int64.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if postings.device.type == "cpu":
        return _gather_slices_plain(postings, offsets, lengths, bucket)
    runtime.require_cuda("gather_slices", postings, offsets, lengths)
    if postings.dtype != torch.int32 or offsets.dtype != torch.int64 \
            or lengths.dtype != torch.int64:
        raise runtime.kernel_error("gather_slices: postings int32, "
                                   "offsets and lengths int64")
    if not (postings.is_contiguous() and offsets.is_contiguous()
            and lengths.is_contiguous()):
        raise runtime.kernel_error("gather_slices: tensors must be "
                                   "contiguous")
    K = offsets.shape[0]
    if lengths.shape != (K,) or postings.dim() != 1:
        raise runtime.kernel_error("gather_slices: shape mismatch")
    out = torch.empty((K, bucket), dtype=torch.int32, device=postings.device)
    if K == 0 or bucket == 0:
        return out
    err = runtime.launch_on(
        postings, runtime.kernels().mygram_slice_gather, postings.data_ptr(),
        postings.shape[0], offsets.data_ptr(), lengths.data_ptr(), K, bucket,
        out.data_ptr())
    runtime.check_launch(err, "slice_gather")
    return out


def membership_rows(rows: torch.Tensor,
                    candidates: torch.Tensor) -> torch.Tensor:
    """candidates (K, C) in the sorted rows (K, C2), row by row -> (K, C)."""
    c2 = rows.shape[-1]
    pos = torch.searchsorted(rows, candidates).clamp_(max=c2 - 1)
    return torch.gather(rows, 1, pos) == candidates


def membership_sorted(padded: torch.Tensor,
                      candidates: torch.Tensor) -> torch.Tensor:
    """candidates (C,) in each sorted row of padded (K, C2) -> (K, C) bool."""
    return membership_rows(padded.contiguous(), candidates.to(
        padded.dtype).expand(padded.shape[0], -1).contiguous())


def bitmap_membership(bitmaps: torch.Tensor, rows: torch.Tensor,
                      candidates: torch.Tensor) -> torch.Tensor:
    """candidates against dense bitmap rows: rows (K,) and candidates (C,)
    -> (K, C) bool; or one row per lane, rows (B,) and candidates (B, C)
    -> (B, C)."""
    w = (candidates >> 5).long()
    words = bitmaps[rows.long()[:, None], w if w.dim() == 2 else w[None]]
    return ((words >> (candidates & 31)) & 1) == 1


def mask_to_topn(candidates: torch.Tensor, mask: torch.Tensor, n: int,
                 descending: bool = True):
    """(..., C) candidates + (..., C) bool -> (count (...), ids (..., n)).

    Candidates are ascending doc ids (SENTINEL padded), so the top n in
    doc-id order are the first (or last) n flagged positions. -1 pads."""
    lead = candidates.shape[:-1]
    C = candidates.shape[-1]
    cands = candidates.reshape(-1, C)
    ok = (mask.reshape(-1, C) & (cands != SENTINEL))
    count = ok.sum(dim=-1, dtype=torch.int32)
    flags = ok.flip(-1) if descending else ok
    pos, valid = _select_first_k(flags, min(n, C))
    idx = (C - 1 - pos) if descending else pos
    ids = torch.where(valid, torch.gather(cands, 1, idx), -1)
    if n > C:
        ids = torch.cat([ids, torch.full((ids.shape[0], n - C), -1,
                                         dtype=ids.dtype,
                                         device=ids.device)], dim=1)
    return count.reshape(lead), ids.to(torch.int32).reshape(*lead, n)


# exported by the JAX package and never called there
intersect_candidates = not_ported(__name__, "intersect_candidates",
                                  "'not carried into the port'")
