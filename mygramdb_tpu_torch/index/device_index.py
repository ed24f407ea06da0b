"""Device-resident n-gram index on PyTorch (port of the single-device part
of ``mygramdb_tpu.index.device_index``).

Layout, as in the JAX package:

- **Dense terms** (df/N >= dense_df_ratio, capped by count and by bytes,
  chosen by df rank): one bitmap row each in a (D+2, W) int32 matrix. Row D
  is all-ones (AND identity), row D+1 all-zeros (OR identity).
- **Sparse terms**: a packed CSR of sorted int32 doc ids. Dense terms'
  slices are dropped from the device copy; their device offset is P (the
  CSR's length), and the slice gather masks loads past P, so an accidental
  gather reads sentinels. Offsets and lengths are int64 end to end.
- **Tombstones**: one (W,) word row, AND-NOT'ed into every query.

All-dense AND queries run the row-AND kernel (K1); any sparse term makes
the rarest sparse term's slice the candidate vector (K3 gathers it) and
every other term probes it.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._overlay import not_ported
from ..ops import bitmap_ops, runtime
from ..ops.bitmap_ops import bit_member
from ..ops.posting_ops import (SENTINEL, bitmap_membership, gather_slices,
                               mask_to_topn, membership_rows)
from .builder import BuiltIndex

WBLOCK_WORDS = 1024  # W is padded to a multiple of this (32768 docs)

# Shape buckets of the JAX package, kept so both packages pick the same
# candidate widths and result widths (and so the same answers).
_LIMIT_BUCKETS = (128, 1024)
_PROBE_K_BUCKETS = (8, 32)


def _bucket_of(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    big = buckets[-1]
    return ((value + big - 1) // big) * big


def _k_bucket(k: int) -> int:
    return _bucket_of(max(k, 1), _PROBE_K_BUCKETS)


def _sparse_mask(postings, bitmaps, deleted, extra, d_off, d_len, sp_off,
                 sp_len, sp_inv, dn_rows, dn_inv, *, C: int, Cmax: int,
                 n_words: int, probe_free: bool):
    """Candidate-probe mask for B queries -> (cands (B, C), mask (B, C)).

    d_off/d_len (B,) int64: the driver slices (K3 gathers the candidates).
    sp_* (B, Ks): sparse probe slices, membership XOR sp_inv (NOT terms;
    a zero-length inverted slot is all-true padding). dn_* (B, Kd): dense
    rows probed by bit, XOR dn_inv. extra (F, W) or None: filter rows.
    probe_free skips the sparse and dense probes (covered-exact queries)."""
    B = d_off.shape[0]
    cands = gather_slices(postings, d_off, d_len, C)
    clip = cands.clamp(0, n_words * 32 - 1)
    mask = (cands != SENTINEL) & ~bit_member(deleted, clip)
    if not probe_free:
        Ks = sp_off.shape[1]
        # one gather for all probe slices, probe-major so each is contiguous
        sp = gather_slices(postings, sp_off.t().contiguous().reshape(-1),
                           sp_len.t().contiguous().reshape(-1), Cmax
                           ).reshape(Ks, B, Cmax)
        for k in range(Ks):
            mask &= membership_rows(sp[k], cands) ^ sp_inv[:, k, None]
        for k in range(dn_rows.shape[1]):
            mask &= (bitmap_membership(bitmaps, dn_rows[:, k], clip)
                     ^ dn_inv[:, k, None])
    if extra is not None:
        for f in range(extra.shape[0]):
            mask &= bit_member(extra[f], clip)
    return cands, mask


def _sparse_query_batch(postings, bitmaps, deleted, d_off, d_len,
                        sp_off, sp_len, sp_inv, dn_rows, dn_inv, extra,
                        *, C: int, Cmax: int, limit_b: int, descending: bool,
                        n_words: int, has_extra: bool = False,
                        probe_free: bool = False):
    """Batched sparse candidate-probe query: B concurrent queries sharing a
    shape bucket in one program. extra (F, W) is shared by the batch.
    -> (counts (B,) int32, ids (B, limit_b) int32, -1 padded)."""
    cands, mask = _sparse_mask(
        postings, bitmaps, deleted, extra if has_extra else None, d_off,
        d_len, sp_off, sp_len, sp_inv, dn_rows, dn_inv, C=C, Cmax=Cmax,
        n_words=n_words, probe_free=probe_free)
    return mask_to_topn(cands, mask, limit_b, descending)


def _sparse_query(postings, bitmaps, deleted, extra, d_off, d_len,
                  sp_off, sp_len, sp_inv, dn_rows, dn_inv, has_extra,
                  *, C: int, Cmax: int, limit_b: int, descending: bool,
                  n_words: int):
    """One sparse candidate-probe query (d_off/d_len scalars, probe arrays
    1-D). -> (count, top ids (limit_b,) or (1,) zeros when limit_b == 0,
    mask (C,), candidates (C,))."""
    cands, mask = _sparse_mask(
        postings, bitmaps, deleted, extra if has_extra else None,
        d_off.reshape(1), d_len.reshape(1), sp_off[None], sp_len[None],
        sp_inv[None], dn_rows[None], dn_inv[None], C=C, Cmax=Cmax,
        n_words=n_words, probe_free=False)
    count = mask.sum(dtype=torch.int32)
    if limit_b > 0:
        _, ids = mask_to_topn(cands, mask, limit_b, descending)
        ids = ids[0]
    else:
        ids = torch.zeros(1, dtype=torch.int32, device=cands.device)
    return count, ids, mask[0], cands[0]


@dataclass
class SearchOptions:
    limit: int = 0            # 0 = count/materialize all
    descending: bool = True   # doc-id (PK) order
    count_only: bool = False  # COUNT fast path: skip id materialization


def host_state(built: BuiltIndex, dense_df_ratio: float = 0.01,
               max_dense_terms: int = 8192) -> dict:
    """The index's arrays, built on the host: bitmaps (D+2, W) uint32,
    postings (P,) int32 without dense slices, offsets int64, lengths,
    dense_row, deleted (W,) uint32 and the scalar layout fields."""
    V = built.n_terms
    n_docs_capacity = DeviceIndex._capacity(built.max_doc_id)
    n_words = n_docs_capacity // 32
    df = built.lengths
    dense_min_df = max(int(dense_df_ratio * max(built.n_docs, 1)), 1)
    dense = np.flatnonzero(df >= dense_min_df)
    # The bitmap matrix is capped by bytes as well as rows. The default
    # budget is the JAX package's (sized for a 16 GB TPU), kept so both
    # packages classify the same terms; it has to be re-derived for 80 GB.
    budget = int(os.environ.get("MYGRAM_DENSE_BUDGET_MB", "1536")) << 20
    row_cap = max(int(budget // max(n_words * 4, 1)), 64)
    cap = min(max_dense_terms, row_cap)
    if dense.size > cap:
        order = np.argsort(df[dense])[::-1]
        dense = dense[order[:cap]]
        dense.sort()
    n_dense = int(dense.size)
    dense_row = np.full(V, -1, dtype=np.int32)
    dense_row[dense] = np.arange(n_dense, dtype=np.int32)

    bm = np.zeros((n_dense + 2, n_words), dtype=np.uint32)
    if n_dense:
        lens = built.lengths[dense].astype(np.int64)
        ids = np.concatenate([built.postings_of(int(t)) for t in dense]
                             ).astype(np.int64)
        row = np.repeat(np.arange(n_dense, dtype=np.int64), lens)
        np.bitwise_or.at(bm.reshape(-1), row * n_words + (ids >> 5),
                         np.left_shift(np.uint32(1),
                                       (ids & 31).astype(np.uint32)))
        del ids, row
    bm[n_dense] = np.uint32(0xFFFFFFFF)

    postings = np.asarray(built.postings, dtype=np.int32)
    offsets = np.asarray(built.offsets, dtype=np.int64)
    if n_dense:
        keep = np.ones(V, dtype=bool)
        keep[dense] = False
        postings = postings[np.repeat(keep, built.lengths)]
        dev_len = np.where(keep, built.lengths, 0).astype(np.int64)
        offsets = np.zeros(V, dtype=np.int64)
        np.cumsum(dev_len[:-1], out=offsets[1:])
        offsets[dense] = postings.size  # past the end: gathers sentinels
    return {"bitmaps": bm, "postings": postings, "offsets": offsets,
            "lengths": np.asarray(built.lengths), "dense_row": dense_row,
            "deleted": np.zeros(n_words, dtype=np.uint32),
            "ones_row": n_dense, "zeros_row": n_dense + 1,
            "n_words": n_words, "n_docs_capacity": n_docs_capacity}


class DeviceIndex:
    """Immutable compiled index segment resident on one torch device."""

    def __init__(self, built: BuiltIndex, dense_df_ratio: float = 0.01,
                 max_dense_terms: int = 8192,
                 candidate_buckets=(2048, 8192, 32768, 65536),
                 device=None, mesh_shards: int = 1):
        if mesh_shards > 1:
            not_ported(__name__, "DeviceIndex(mesh_shards > 1)", "13")()
        self._setup(built, host_state(built, dense_df_ratio,
                                      max_dense_terms),
                    candidate_buckets, device)

    @classmethod
    def from_state(cls, state: dict, built: BuiltIndex, device=None,
                   candidate_buckets=(2048, 8192, 32768, 65536)
                   ) -> "DeviceIndex":
        """Build from a ``host_state``-shaped dict (for example one read
        from a JAX ``DeviceIndex`` by ``mygramdb_tpu_torch.convert``)."""
        self = cls.__new__(cls)
        self._setup(built, state, candidate_buckets, device)
        return self

    def _setup(self, built, state, candidate_buckets, device) -> None:
        self.built = built
        self.candidate_buckets = tuple(candidate_buckets)
        dev = torch.device(device) if device is not None else runtime.device()
        if dev.type == "cuda":
            runtime.kernels()  # build now: a failure fails construction
        self._device = dev
        self.n_words = int(state["n_words"])
        self.n_docs_capacity = int(state["n_docs_capacity"])
        self.dense_row = np.asarray(state["dense_row"], dtype=np.int32)
        self.ones_row = int(state["ones_row"])
        self.zeros_row = int(state["zeros_row"])
        self.n_dense = self.ones_row
        self.lengths = np.asarray(state["lengths"])
        self.dev_offsets = np.asarray(state["offsets"], dtype=np.int64)
        self.bitmaps = runtime.to_device(state["bitmaps"], dev)
        self.postings = runtime.to_device(
            np.asarray(state["postings"], dtype=np.int32), dev)
        self.deleted_host = np.array(state["deleted"], dtype=np.uint32)
        self.deleted = runtime.to_device(self.deleted_host, dev)
        self._ones_words = torch.full((self.n_words,), -1, dtype=torch.int32,
                                      device=dev)
        self._del_lock = threading.Lock()
        self.batcher = None  # optional MicroBatcher (server attaches)
        # single-device port: no mesh, no sharded CSR, no positional engine
        self.mesh = None
        self._row_sharding = None
        self.postings_sh = None
        self.positional = None
        self.text_doc_sharding = None

    def state(self) -> dict:
        """The index's arrays read back to the host (``host_state`` keys)."""
        return {"bitmaps": self.bitmaps.cpu().numpy().view(np.uint32),
                "postings": self.postings.cpu().numpy(),
                "offsets": self.dev_offsets.copy(),
                "lengths": self.lengths.copy(),
                "dense_row": self.dense_row.copy(),
                "deleted": self.deleted.cpu().numpy().view(np.uint32),
                "ones_row": self.ones_row, "zeros_row": self.zeros_row,
                "n_words": self.n_words,
                "n_docs_capacity": self.n_docs_capacity}

    def _tensor(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype
                               ).to(self._device)

    # ------------------------------------------------------------------
    @staticmethod
    def _capacity(max_doc_id: int) -> int:
        need_words = (max_doc_id + 1 + 31) // 32
        words = max(
            ((need_words + WBLOCK_WORDS - 1) // WBLOCK_WORDS) * WBLOCK_WORDS,
            WBLOCK_WORDS)
        return words * 32

    def accepts_doc_id(self, doc_id: int) -> bool:
        return 0 < doc_id < self.n_docs_capacity

    # ------------------------------------------------------------------
    # Tombstones (the host copy is authoritative; each change re-uploads
    # a fresh row, so a query in flight keeps the row it started with)
    # ------------------------------------------------------------------
    def _set_deleted(self, doc_ids: Sequence[int], on: bool) -> None:
        ids = np.asarray([d for d in doc_ids if 0 < d < self.n_docs_capacity],
                         dtype=np.int64)
        if ids.size == 0:
            return
        bits = np.left_shift(np.uint32(1), (ids & 31).astype(np.uint32))
        with self._del_lock:
            if on:
                np.bitwise_or.at(self.deleted_host, ids >> 5, bits)
            else:
                np.bitwise_and.at(self.deleted_host, ids >> 5,
                                  np.bitwise_not(bits))
            self.deleted = runtime.to_device(self.deleted_host, self._device)

    def mark_deleted(self, doc_ids: Sequence[int]) -> None:
        self._set_deleted(doc_ids, True)

    def unmark_deleted(self, doc_ids: Sequence[int]) -> None:
        self._set_deleted(doc_ids, False)

    def deleted_count(self) -> int:
        return int(np.sum(np.unpackbits(self.deleted_host.view(np.uint8))))

    # ------------------------------------------------------------------
    # Planning helpers
    # ------------------------------------------------------------------
    def classify(self, tids: Sequence[int]) -> Tuple[List[int], List[int]]:
        """-> (dense_rows, sparse_tids)"""
        dense, sparse = [], []
        for t in tids:
            r = int(self.dense_row[t])
            if r >= 0:
                dense.append(r)
            else:
                sparse.append(t)
        return dense, sparse

    def df_of(self, tid: int) -> int:
        return int(self.lengths[tid])

    def postings_of(self, tid: int) -> np.ndarray:
        return self.built.postings_of(tid)

    def _cand_bucket(self, n: int) -> int:
        return _bucket_of(max(n, 1), self.candidate_buckets)

    # ------------------------------------------------------------------
    # Core search
    # ------------------------------------------------------------------
    def search_and(self, tids: Sequence[int], not_tids: Sequence[int] = (),
                   extra_words: Optional[List[torch.Tensor]] = None,
                   opts: SearchOptions = SearchOptions()
                   ) -> Tuple[int, np.ndarray]:
        """AND of terms minus NOT terms, AND'ed with extra word rows.

        Returns (total, doc_ids). With opts.limit > 0, doc_ids is the
        top-limit by doc id in the requested order; otherwise ALL matching
        ids sorted ascending."""
        if not tids:
            return 0, np.empty(0, dtype=np.int32)
        dense_rows, sparse_tids = self.classify(list(tids))
        if any(self.lengths[t] == 0 for t in sparse_tids):
            return 0, np.empty(0, dtype=np.int32)
        nd_rows, ns_tids = self.classify(list(not_tids))
        if sparse_tids:
            return self._sparse_and_path(sparse_tids, dense_rows, ns_tids,
                                         nd_rows, extra_words or [], opts)
        return self._dense_and_path(dense_rows, ns_tids, nd_rows,
                                    extra_words or [], opts)

    # ---------------- dense path ----------------
    def _dense_and_path(self, dense_rows, ns_tids, nd_rows, extra_words,
                        opts):
        # micro-batched: plain dense AND with a limit shares one program
        # with concurrent queries. More rows than the batcher's ceiling
        # take the unbatched path (dropping rows would drop constraints).
        from ..server.microbatch import MAX_K
        if (self.batcher is not None and opts.limit > 0 and not ns_tids
                and not nd_rows and len(dense_rows) <= MAX_K):
            limit_b = min(_bucket_of(opts.limit, _LIMIT_BUCKETS),
                          self.n_docs_capacity)
            total, ids = self.batcher.submit(list(dense_rows), limit_b,
                                             opts.descending,
                                             extra=tuple(extra_words or ()))
            ids = ids[ids >= 0][:opts.limit]
            return total, ids.astype(np.int32)
        runtime.count_route("dense_unbatched")
        rows = list(dense_rows)
        nrows = list(nd_rows)
        if ns_tids:
            # sparse NOT terms: a host-built bitmap row, AND'ed in inverted
            ids = np.concatenate([self.postings_of(t) for t in ns_tids])
            nb = bitmap_ops.make_bitmap_from_ids(ids, self.n_words)
            extra_words = list(extra_words) + [
                runtime.to_device(np.bitwise_not(nb), self._device)]
        has_not = bool(nrows)
        if not nrows:
            nrows = [self.zeros_row]
        extra = self._pack_extra(extra_words)
        F = len(extra_words)
        rows_t = self._tensor([rows], torch.int32)
        nrows_t = self._tensor([nrows], torch.int32)
        if not opts.count_only and opts.limit > 0:
            n = min(_bucket_of(opts.limit, _LIMIT_BUCKETS),
                    self.n_docs_capacity)
            count, ids = bitmap_ops.dense_search_topn(
                self.bitmaps, rows_t, nrows_t, self.deleted, extra,
                has_not, F > 0, n, opts.descending)
            ids = ids[0].cpu().numpy()
            return int(count[0]), ids[ids >= 0][:opts.limit].astype(np.int32)
        count, res = bitmap_ops.dense_query_auto(
            self.bitmaps, rows_t, nrows_t, self.deleted, extra,
            has_not=has_not, has_extra=F > 0)
        if opts.count_only:
            return int(count[0]), np.empty(0, dtype=np.int32)
        return int(count[0]), self._bitmap_to_ids(res[0].cpu().numpy())

    def _pack_extra(self, extra_words) -> torch.Tensor:
        """Stack extra AND-filter rows (an all-ones row when there are
        none, which is the AND identity). A row of another width was made
        for another segment: a swap raced the query, and the RuntimeError
        sends the pipeline to its exact host path."""
        if not extra_words:
            return self._ones_words[None, :]
        if any(w.shape != (self.n_words,) for w in extra_words):
            raise RuntimeError(
                f"filter rows of widths {[tuple(w.shape) for w in extra_words]}"
                f" for an index of {self.n_words} words")
        return torch.stack(list(extra_words))

    @staticmethod
    def _bitmap_to_ids(words: np.ndarray) -> np.ndarray:
        bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                             bitorder="little")
        return np.flatnonzero(bits).astype(np.int32)

    # ---------------- sparse candidate path ----------------
    def _sparse_and_path(self, sparse_tids, dense_rows, ns_tids, nd_rows,
                         extra_words, opts):
        # the rarest sparse term drives; every other term probes it
        sparse_tids = sorted(sparse_tids, key=lambda t: int(self.lengths[t]))
        driver = sparse_tids[0]
        dlen = int(self.lengths[driver])
        if dlen == 0:
            return 0, np.empty(0, dtype=np.int32)
        C = self._cand_bucket(dlen)
        sp_off, sp_len, sp_inv = [], [], []
        for t, inv in ([(t, False) for t in sparse_tids[1:]]
                       + [(t, True) for t in ns_tids]):
            sp_off.append(int(self.dev_offsets[t]))
            sp_len.append(int(self.lengths[t]))
            sp_inv.append(inv)
        Ks = _k_bucket(len(sp_off)) if sp_off else 1
        Cmax = self._cand_bucket(max([1] + sp_len))
        while len(sp_off) < Ks:
            sp_off.append(0)
            sp_len.append(0)
            sp_inv.append(True)  # length 0 + invert -> all-true
        dn_rows = list(dense_rows) + list(nd_rows)
        dn_inv = [False] * len(dense_rows) + [True] * len(nd_rows)
        Kd = _k_bucket(len(dn_rows)) if dn_rows else 1
        while len(dn_rows) < Kd:
            dn_rows.append(self.ones_row)
            dn_inv.append(False)
        limit_b = (min(_bucket_of(opts.limit, _LIMIT_BUCKETS), C)
                   if opts.limit > 0 else 0)

        if self.batcher is not None and (opts.limit > 0 or opts.count_only):
            lb = limit_b if limit_b > 0 else min(_LIMIT_BUCKETS[0], C)
            total, ids = self.batcher.submit_sparse(
                int(self.dev_offsets[driver]), dlen, sp_off, sp_len, sp_inv,
                dn_rows, dn_inv, C, Cmax, lb, opts.descending,
                extra=tuple(extra_words))
            if opts.count_only:
                return total, np.empty(0, dtype=np.int32)
            if not (total > lb and opts.limit > lb):
                ids = ids[ids >= 0][:opts.limit]
                return total, ids.astype(np.int32)
            # the requested page exceeds the batched bucket: exact path

        runtime.dispatches.bump()
        runtime.count_route("sparse_unbatched")
        count, ids, mask, cands = _sparse_query(
            self.postings, self.bitmaps, self.deleted,
            self._pack_extra(extra_words),
            self._tensor(int(self.dev_offsets[driver]), torch.int64),
            self._tensor(dlen, torch.int64),
            self._tensor(sp_off, torch.int64),
            self._tensor(sp_len, torch.int64),
            self._tensor(sp_inv, torch.bool),
            self._tensor(dn_rows, torch.int32),
            self._tensor(dn_inv, torch.bool),
            bool(extra_words), C=C, Cmax=Cmax, limit_b=limit_b,
            descending=opts.descending, n_words=self.n_words)
        total = int(count)
        if opts.count_only:
            return total, np.empty(0, dtype=np.int32)
        if opts.limit > 0:
            out = ids.cpu().numpy()
            return total, out[out >= 0][:opts.limit].astype(np.int32)
        return total, cands[mask].cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------------
    @staticmethod
    def _probe_words(words: np.ndarray, ids: np.ndarray) -> np.ndarray:
        w = ids >> 5
        b = ids & 31
        return ((words[w] >> b.astype(np.uint32)) & 1).astype(np.int32)

    def filter_by_ngrams(self, candidates: np.ndarray,
                         tids: Sequence[int]) -> np.ndarray:
        """Keep candidates containing ALL terms (host probe for small
        sets, reference index.cpp:355-376)."""
        if candidates.size == 0:
            return candidates
        dense_rs: List[int] = []
        sparse: List[int] = []
        for t in tids:
            r = int(self.dense_row[t])
            (dense_rs if r >= 0 else sparse).append(r if r >= 0 else t)
        keep = np.ones(candidates.size, dtype=bool)
        if dense_rs:
            rows = self.bitmaps[self._tensor(dense_rs, torch.int64)]
            for row in rows.cpu().numpy().view(np.uint32):
                keep &= self._probe_words(row, candidates).astype(bool)
        for t in sparse:
            p = self.postings_of(t)
            if p.size == 0:
                return np.empty(0, dtype=np.int32)
            pos = np.minimum(np.searchsorted(p, candidates), p.size - 1)
            keep &= p[pos] == candidates
        return candidates[keep]

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Run the dense and sparse programs once (first CUDA use, kernel
        library load) before serving."""
        opts_all = SearchOptions(limit=0)
        opts_top = SearchOptions(limit=100, descending=True)
        for opts in (opts_all, opts_top):
            self._dense_and_path([self.ones_row], [], [], [], opts)
        if self.postings.shape[0] > 0 and bool((self.lengths > 0).any()):
            tid = int(np.argmax(self.lengths > 0))
            if self.dense_row[tid] < 0:
                for opts in (opts_all, opts_top):
                    self._sparse_and_path([tid], [], [], [], [], opts)

    def memory_usage(self) -> int:
        return int(self.bitmaps.numel() * 4 + self.postings.numel() * 4
                   + self.deleted.numel() * 4)

    # ------------------------------------------------------------------
    # Device paths of the JAX package not ported yet
    # ------------------------------------------------------------------
    search_or = not_ported(__name__, "DeviceIndex.search_or", "11")
    ast_words = not_ported(__name__, "DeviceIndex.ast_words", "11")
    universe_words = not_ported(__name__, "DeviceIndex.universe_words",
                                "11")
    search_by_threshold = not_ported(
        __name__, "DeviceIndex.search_by_threshold", "10")
    search_and_verified = not_ported(
        __name__, "DeviceIndex.search_and_verified", "9")
    plan_positional = not_ported(__name__, "DeviceIndex.plan_positional",
                                 "14")
    search_verified_positional = not_ported(
        __name__, "DeviceIndex.search_verified_positional", "14")
