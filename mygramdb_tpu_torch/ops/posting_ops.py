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

The whole sparse program of a batch (driver gather, probes, tombstones,
filter rows, then the top-n or the compaction) is K3's second entry,
``sparse_probe``, one launch on the card; ``_sparse_probe_plain`` is its
plain version: ``_sparse_mask`` then ``mask_to_topn``,
``compact_first_k`` or ``where``. Its per-query arguments travel as one
int64 matrix (``pack_sparse_args``), so a batch uploads them at once.
"""

from __future__ import annotations

import numpy as np
import torch

from . import runtime
from .bitmap_ops import _select_first_k, bit_member

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
                  lengths: torch.Tensor, bucket: int,
                  form: str = "") -> torch.Tensor:
    """K3 wrapper: K CSR slices -> a (K, bucket) int32 tile.
    ``out[k, j] = postings[off[k] + j]`` when ``j < len[k]`` and
    ``off[k] + j < P``, else SENTINEL. postings (P,) int32; offsets and
    lengths (K,) int64. ``form`` names a launch form the launch also
    counts under (``"slice_gather.positional"``: the positional program's
    gathers).

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
    runtime.check_launch(err, "slice_gather", (form,) if form else ())
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


def compact_first_k(cands: torch.Tensor, mask: torch.Tensor, Kv: int):
    """First Kv masked candidates of each row (input order), SENTINEL
    padded, by a rank scatter. cands/mask (B, C) -> (sel (B, Kv) int32,
    pre (B,) int32)."""
    B = cands.shape[0]
    m = mask.to(torch.int32)
    rank = torch.cumsum(m, dim=1, dtype=torch.int32) - 1
    pre = m.sum(dim=1, dtype=torch.int32)
    idx = torch.where(mask & (rank < Kv), rank, Kv).long()
    sel = torch.full((B, Kv + 1), SENTINEL, dtype=torch.int32,
                     device=cands.device)
    sel.scatter_(1, idx, cands.to(torch.int32))  # slot Kv takes the rest
    return sel[:, :Kv], pre


# ---------------------------------------------------------------------------
# The sparse program: K3's probe entry
# ---------------------------------------------------------------------------

def _sparse_mask(postings, bitmaps, deleted, extra, d_off, d_len, sp_off,
                 sp_len, sp_inv, dn_rows, dn_inv, *, C: int, Cmax: int,
                 n_words: int, sparse_probes: bool = True,
                 dense_probes: bool = True):
    """Candidate-probe mask for B queries -> (cands (B, C), mask (B, C)).

    d_off/d_len (B,) int64: the driver slices (K3 gathers the candidates).
    sp_* (B, Ks): sparse probe slices, membership XOR sp_inv (NOT terms;
    a zero-length inverted slot is all-true padding). dn_* (B, Kd): dense
    rows probed by bit, XOR dn_inv. extra (F, W) or None: filter rows.
    Covered-exact queries switch both probes off; the fused verified
    search may switch off the dense probes alone."""
    B = d_off.shape[0]
    cands = gather_slices(postings, d_off, d_len, C)
    clip = cands.clamp(0, n_words * 32 - 1)
    mask = (cands != SENTINEL) & ~bit_member(deleted, clip)
    if sparse_probes:
        Ks = sp_off.shape[1]
        # one gather for all probe slices, probe-major so each is contiguous
        sp = gather_slices(postings, sp_off.t().contiguous().reshape(-1),
                           sp_len.t().contiguous().reshape(-1), Cmax
                           ).reshape(Ks, B, Cmax)
        for k in range(Ks):
            mask &= membership_rows(sp[k], cands) ^ sp_inv[:, k, None]
    if dense_probes:
        for k in range(dn_rows.shape[1]):
            mask &= (bitmap_membership(bitmaps, dn_rows[:, k], clip)
                     ^ dn_inv[:, k, None])
    if extra is not None:
        for f in range(extra.shape[0]):
            mask &= bit_member(extra[f], clip)
    return cands, mask


def pack_sparse_args(d_off, d_len, sp_off, sp_len, sp_inv, dn_rows,
                     dn_inv) -> np.ndarray:
    """The sparse program's per-query arguments as one host matrix:
    (B, 2 + 3 Ks + 2 Kd) int64, each row ``[d_off, d_len, sp_off[Ks],
    sp_len[Ks], sp_inv[Ks], dn_rows[Kd], dn_inv[Kd]]`` (flags as 0/1)."""
    d_off = np.asarray(d_off, dtype=np.int64).reshape(-1, 1)
    B = d_off.shape[0]

    def cols(a):
        return np.asarray(a, dtype=np.int64).reshape(B, -1)
    return np.concatenate([d_off, cols(d_len), cols(sp_off), cols(sp_len),
                           cols(sp_inv), cols(dn_rows), cols(dn_inv)],
                          axis=1)


def unpack_sparse_args(args: torch.Tensor, Ks: int, Kd: int):
    """``pack_sparse_args``'s matrix (a tensor) -> (d_off, d_len, sp_off,
    sp_len, sp_inv, dn_rows, dn_inv) in ``_sparse_mask``'s types."""
    s = 2 + 3 * Ks
    cols = (args[:, 0], args[:, 1], args[:, 2:2 + Ks],
            args[:, 2 + Ks:2 + 2 * Ks], args[:, 2 + 2 * Ks:s] != 0,
            args[:, s:s + Kd].to(torch.int32), args[:, s + Kd:s + 2 * Kd] != 0)
    return tuple(c.contiguous() for c in cols)


_FORMS = ("topn", "compact", "masked")


def split_selection(buf, B: int):
    """A compaction's or masked output's flat buffer (torch or numpy) ->
    (pre (B,), sel (B, width)) views."""
    return buf[:B], buf[B:].reshape(B, -1)


def _sparse_probe_plain(postings, bitmaps, deleted, extra, args, *, Ks: int,
                        Kd: int, C: int, Cmax: int, n_words: int, form: str,
                        width: int, descending: bool = False,
                        sparse_probes: bool = True,
                        dense_probes: bool = True):
    """Plain PyTorch version of the sparse probe (same signature as
    ``sparse_probe``): ``_sparse_mask``, then ``mask_to_topn``,
    ``compact_first_k`` or ``where``."""
    cands, mask = _sparse_mask(
        postings, bitmaps, deleted, extra, *unpack_sparse_args(args, Ks, Kd),
        C=C, Cmax=Cmax, n_words=n_words, sparse_probes=sparse_probes,
        dense_probes=dense_probes)
    if form == "topn":
        count, ids = mask_to_topn(cands, mask, width, descending)
        return torch.cat([count[:, None], ids], dim=1)
    if form == "compact":
        sel, pre = compact_first_k(cands, mask, width)
    else:
        sel = torch.where(mask, cands, SENTINEL)
        pre = mask.sum(dim=1, dtype=torch.int32)
    return torch.cat([pre, sel.reshape(-1)])


def sparse_probe(postings, bitmaps, deleted, extra, args, *, Ks: int,
                 Kd: int, C: int, Cmax: int, n_words: int, form: str,
                 width: int, descending: bool = False,
                 sparse_probes: bool = True, dense_probes: bool = True):
    """K3's probe entry: the sparse program of B queries in one launch.

    postings (P,) int32; bitmaps (V, W), deleted (W,) and extra (F, W) or
    None int32 words; args (B, 2 + 3 Ks + 2 Kd) int64 from
    ``pack_sparse_args``. Query b's candidates are the first C entries of
    its driver slice, kept where ``_sparse_mask`` keeps them (the probe
    slices are posting lists: sorted, no repeats). Output by ``form``:

    - ``"topn"``: (B, width + 1) int32, ``[count, first width ids in
      doc-id order (largest first when descending), -1 padded]``
      (``mask_to_topn``; width 0 counts only);
    - ``"compact"``: the first ``width`` ids ascending, SENTINEL padded,
      and the count (``compact_first_k``);
    - ``"masked"``: ``where(mask, cands, SENTINEL)`` (width = C) and the
      count.

    The last two return one flat int32 buffer, the B counts then the B
    rows (``split_selection``), so a caller pulls it at once.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (every tensor contiguous)."""
    if form not in _FORMS:
        raise ValueError(f"sparse_probe: form must be one of {_FORMS}")
    if form == "masked" and width != C:
        raise ValueError("sparse_probe: the masked form is C wide")
    kw = dict(Ks=Ks, Kd=Kd, C=C, Cmax=Cmax, n_words=n_words, form=form,
              width=width, descending=descending,
              sparse_probes=sparse_probes, dense_probes=dense_probes)
    if postings.device.type == "cpu":
        return _sparse_probe_plain(postings, bitmaps, deleted, extra, args,
                                   **kw)
    parts = [t for t in (postings, bitmaps, deleted, extra, args)
             if t is not None]
    runtime.require_cuda("sparse_probe", *parts)
    B = args.shape[0]
    W = bitmaps.shape[1]
    if (postings.dtype != torch.int32 or args.dtype != torch.int64
            or any(t.dtype != torch.int32 for t in (bitmaps, deleted, extra)
                   if t is not None)):
        raise runtime.kernel_error("sparse_probe: postings and words int32, "
                                   "args int64")
    if not all(t.is_contiguous() for t in parts):
        raise runtime.kernel_error("sparse_probe: tensors must be "
                                   "contiguous")
    if (args.dim() != 2 or args.shape[1] != 2 + 3 * Ks + 2 * Kd
            or deleted.shape != (W,)
            or (extra is not None and extra.shape[1] != W)):
        raise runtime.kernel_error("sparse_probe: shape mismatch")
    if not (0 < C < 2 ** 31 and 0 < Cmax < 2 ** 31
            and 0 <= width < 2 ** 31 - 1):
        raise runtime.kernel_error(
            f"sparse_probe: C={C}, Cmax={Cmax}, width={width}")
    dev = postings.device
    if form == "topn":
        out = torch.empty((B, width + 1), dtype=torch.int32, device=dev)
        cnt, cnt_ld, ids, ids_ld = out, width + 1, out[:, 1:], width + 1
    else:
        out = torch.empty(B * (width + 1), dtype=torch.int32, device=dev)
        cnt, cnt_ld = out, 1
        ids, ids_ld = out[B:], width
    if B == 0:
        return out
    probes = (1 if sparse_probes else 0) | (2 if dense_probes else 0)
    F = 0 if extra is None else extra.shape[0]
    err = runtime.launch_on(
        postings, runtime.kernels().mygram_sparse_probe, postings.data_ptr(),
        postings.shape[0], bitmaps.data_ptr(), W, deleted.data_ptr(),
        None if extra is None else extra.data_ptr(), F, args.data_ptr(), Ks,
        Kd, probes, C, Cmax, _FORMS.index(form), cnt.data_ptr(), cnt_ld,
        ids.data_ptr(), ids_ld, width, int(descending), B)
    runtime.check_launch(
        err, "sparse_probe", [f"sparse_probe.{form}"]
        + ([] if probes else ["sparse_probe.probe_free"]),
        shape=(form, B, C, Ks, Kd, width, probes))
    return out


def intersect_candidates(cand_mask: torch.Tensor, probe_masks: torch.Tensor,
                         probe_valid: torch.Tensor) -> torch.Tensor:
    """AND candidate mask (C,) with probe rows (K, C) where probe_valid (K,).

    Invalid probe rows (padding terms) are treated as all-true."""
    rows = torch.where(probe_valid[:, None], probe_masks, True)
    return cand_mask & rows.all(dim=0)
