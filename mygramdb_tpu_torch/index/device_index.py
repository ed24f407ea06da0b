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
the rarest sparse term's slice the candidate vector and every other term
probes it, the whole program one launch of K3's probe entry
(``posting_ops.sparse_probe``). A boolean tree (``ast_words``) evaluates
as word-bitmap algebra in one launch of K2's boolean program (every
leaf's dense rows AND'ed, its sparse slices scattered into words, the
tree over them); ``search_or`` is K2's OR form; ``search_by_threshold``
is the fuzzy candidate count.

**Doc-sharded mesh** (``mesh_shards`` S > 1, ``parallel/mesh.py``): shard s
owns doc ids ``[s * Ds, (s + 1) * Ds)`` with ``Ds = n_docs_capacity / S``
and holds, on its own device, the bitmap block (V, W / S), tombstones and
filter words (W / S,) and a CSR of its postings as shard-local ids (sparse
terms only, as the single-device CSR; host ``offsets_sh`` / ``lengths_sh``
(S, V) int64). Shard s runs on card s mod the card count, so fewer cards
than shards still run S shards; an S that does not divide ``n_words`` is
a configuration error. Every route runs its single-device kernel once a
shard and merges the shards' counts and first ids (``parallel/mesh.py``);
the fuzzy candidate count runs on the host, as in the JAX package.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import bitmap_ops, runtime
from ..parallel import mesh as pmesh
from ..utils import trace
from ..ops.posting_ops import (gather_slices, pack_sparse_args,
                               sparse_probe, split_selection)
from ..ops.threshold_ops import threshold_count_bitmap, threshold_merge
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


def _sparse_query_batch(postings, bitmaps, deleted, d_off, d_len,
                        sp_off, sp_len, sp_inv, dn_rows, dn_inv, extra,
                        *, C: int, Cmax: int, limit_b: int, descending: bool,
                        n_words: int, has_extra: bool = False,
                        probe_free: bool = False):
    """Batched sparse candidate-probe query: B concurrent queries sharing a
    shape bucket in one program (one K3 probe launch on the card). extra
    (F, W) is shared by the batch.
    -> (counts (B,) int32, ids (B, limit_b) int32, -1 padded)."""
    args = torch.cat([d_off[:, None], d_len[:, None], sp_off, sp_len,
                      sp_inv.long(), dn_rows.long(), dn_inv.long()], dim=1)
    out = sparse_probe(
        postings, bitmaps, deleted, extra if has_extra else None, args,
        Ks=sp_off.shape[1], Kd=dn_rows.shape[1], C=C, Cmax=Cmax,
        n_words=n_words, form="topn", width=limit_b, descending=descending,
        sparse_probes=not probe_free, dense_probes=not probe_free)
    return out[:, 0], out[:, 1:]


def _sparse_query(postings, bitmaps, deleted, extra, args, *, Ks: int,
                  Kd: int, C: int, Cmax: int, limit_b: int, count_only: bool,
                  descending: bool, n_words: int):
    """One sparse candidate-probe query, ``args`` its (1, 2 + 3 Ks + 2 Kd)
    packed arguments on the device: one launch, one pull. -> (count, ids
    numpy int32): the first limit_b ids in the requested order when
    limit_b > 0, none when count_only, else every match ascending."""
    kw = dict(Ks=Ks, Kd=Kd, C=C, Cmax=Cmax, n_words=n_words)
    if count_only or limit_b > 0:
        out = sparse_probe(postings, bitmaps, deleted, extra, args,
                           form="topn", width=0 if count_only else limit_b,
                           descending=descending, **kw).cpu().numpy()
        return int(out[0, 0]), out[0, 1:]
    buf = sparse_probe(postings, bitmaps, deleted, extra, args,
                       form="compact", width=C, **kw).cpu().numpy()
    pre, sel = split_selection(buf, 1)
    return int(pre[0]), sel[0, :int(pre[0])]


@dataclass
class SearchOptions:
    limit: int = 0            # 0 = count/materialize all
    descending: bool = True   # doc-id (PK) order
    count_only: bool = False  # COUNT fast path: skip id materialization


def check_mesh_shards(n_words: int, shards: int, cuda: bool) -> None:
    """A mesh of ``shards`` doc shards must cut the index's words evenly
    (and, for the kernels' 16-byte vectors, into blocks of a multiple of
    4 words on the card): anything else is a configuration error."""
    if shards < 1 or n_words % shards:
        raise ValueError(
            f"device.mesh_shards={shards} does not divide the index's "
            f"{n_words} bitmap words (a power of two up to 1024 does)")
    if cuda and (n_words // shards) % 4:
        raise ValueError(
            f"device.mesh_shards={shards} leaves {n_words // shards} words "
            "a shard; the CUDA kernels need a multiple of 4")


def sharded_csr(built: BuiltIndex, dense_row: np.ndarray,
                n_docs_capacity: int, shards: int) -> dict:
    """The doc-range-sharded device CSR: shard s keeps the postings of
    sparse terms whose doc id lies in [s * Ds, (s + 1) * Ds), as
    shard-local ids, sorted per term. Dense terms' slices are dropped, as
    the single-device CSR drops them (every device path reads dense terms
    from bitmap rows), and their offsets point past each shard's end.
    -> postings_sh (S arrays, each its shard's size, no padding),
    offsets_sh and lengths_sh (S, V) int64."""
    V = built.n_terms
    Ds = n_docs_capacity // shards
    keep = dense_row < 0
    lens = np.where(keep, built.lengths, 0).astype(np.int64)
    post = np.asarray(built.postings, dtype=np.int32)
    if not keep.all():
        post = post[np.repeat(keep, built.lengths)]
    shard_of = post // Ds
    tid = np.repeat(np.arange(V, dtype=np.int64), lens)
    lengths_sh = np.ascontiguousarray(np.bincount(
        tid * shards + shard_of, minlength=V * shards
    ).reshape(V, shards).T).astype(np.int64)
    del tid
    offsets_sh = np.zeros((shards, V), dtype=np.int64)
    if V:
        np.cumsum(lengths_sh[:, :-1], axis=1, out=offsets_sh[:, 1:])
    parts = []
    for s in range(shards):
        # a term's postings stay in order: a per-shard mask is stable
        parts.append((post[shard_of == s] - s * Ds).astype(np.int32))
    offsets_sh[:, ~keep] = np.asarray([p.size for p in parts],
                                      dtype=np.int64)[:, None]
    return {"postings_sh": parts, "offsets_sh": offsets_sh,
            "lengths_sh": lengths_sh}


def host_state(built: BuiltIndex, dense_df_ratio: float = 0.01,
               max_dense_terms: int = 8192, mesh_shards: int = 1,
               cuda: bool = False) -> dict:
    """The index's arrays, built on the host: bitmaps (D+2, W) uint32,
    postings (P,) int32 without dense slices (with them when the built
    index has positions), offsets int64, lengths,
    dense_row, deleted (W,) uint32 and the scalar layout fields. With
    mesh_shards S > 1 the CSR is ``sharded_csr``'s in place of postings
    and offsets."""
    V = built.n_terms
    n_docs_capacity = DeviceIndex._capacity(built.max_doc_id)
    n_words = n_docs_capacity // 32
    if mesh_shards > 1:
        check_mesh_shards(n_words, mesh_shards, cuda)
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

    state = {"bitmaps": bm, "lengths": np.asarray(built.lengths),
             "dense_row": dense_row,
             "deleted": np.zeros(n_words, dtype=np.uint32),
             "ones_row": n_dense, "zeros_row": n_dense + 1,
             "n_words": n_words, "n_docs_capacity": n_docs_capacity}
    if mesh_shards > 1:
        state.update(sharded_csr(built, dense_row, n_docs_capacity,
                                 mesh_shards))
        return state
    postings = np.asarray(built.postings, dtype=np.int32)
    offsets = np.asarray(built.offsets, dtype=np.int64)
    # the positional index repeats every posting its occurrence count, so
    # with one the CSR keeps the dense terms' slices too (their offsets
    # are then real; K1 and K3 read sparse slices only)
    if n_dense and built.positional is None:
        keep = np.ones(V, dtype=bool)
        keep[dense] = False
        postings = postings[np.repeat(keep, built.lengths)]
        dev_len = np.where(keep, built.lengths, 0).astype(np.int64)
        offsets = np.zeros(V, dtype=np.int64)
        np.cumsum(dev_len[:-1], out=offsets[1:])
        offsets[dense] = postings.size  # past the end: gathers sentinels
    state.update({"postings": postings, "offsets": offsets})
    return state


class DeviceIndex:
    """Immutable compiled index segment resident on one torch device, or
    doc-sharded over a mesh of devices (``mesh_shards`` > 1 or ``mesh``)."""

    def __init__(self, built: BuiltIndex, dense_df_ratio: float = 0.01,
                 max_dense_terms: int = 8192,
                 candidate_buckets=(2048, 8192, 32768, 65536),
                 device=None, mesh_shards: int = 1, mesh=None):
        if mesh is None and mesh_shards > 1:
            mesh = pmesh.make_mesh(devices=pmesh.default_devices(
                mesh_shards, device))
        shards = 1 if mesh is None else mesh.shape["docs"]
        cuda = mesh is not None and mesh.home.type == "cuda"
        self._setup(built, host_state(built, dense_df_ratio,
                                      max_dense_terms, shards, cuda),
                    candidate_buckets, device, mesh)

    @classmethod
    def from_state(cls, state: dict, built: BuiltIndex, device=None,
                   candidate_buckets=(2048, 8192, 32768, 65536),
                   mesh=None) -> "DeviceIndex":
        """Build from a ``host_state``-shaped dict (for example one read
        from a JAX ``DeviceIndex`` by ``mygramdb_tpu_torch.convert``). A
        sharded state (``postings_sh``) builds on ``mesh``, or on one made
        for its shard count."""
        self = cls.__new__(cls)
        if mesh is None and "postings_sh" in state:
            mesh = pmesh.make_mesh(devices=pmesh.default_devices(
                len(state["postings_sh"]), device))
        self._setup(built, state, candidate_buckets, device, mesh)
        return self

    def _setup(self, built, state, candidate_buckets, device,
               mesh=None) -> None:
        self.built = built
        self.candidate_buckets = tuple(candidate_buckets)
        if mesh is not None:
            dev = mesh.home
        else:
            dev = (torch.device(device) if device is not None
                   else runtime.device())
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
        self.deleted_host = np.array(state["deleted"], dtype=np.uint32)
        self._del_lock = threading.Lock()
        self.batcher = None  # optional MicroBatcher (server attaches)
        # filter rows are full (W,) rows on the home device; the mesh
        # programs cut them per shard
        self._row_sharding = None
        self.positional = None
        self.upload_detail: dict = {}
        self.mesh = mesh
        if mesh is not None:
            self._setup_mesh(state, mesh)
            return
        self.postings_sh = None
        self.dev_offsets = np.asarray(state["offsets"], dtype=np.int64)
        self.bitmaps = runtime.to_device(state["bitmaps"], dev)
        self.postings = runtime.to_device(
            np.asarray(state["postings"], dtype=np.int32), dev)
        self.deleted = runtime.to_device(self.deleted_host, dev)
        self._ones_words = torch.full((self.n_words,), -1, dtype=torch.int32,
                                      device=dev)
        self._setup_positional(state, built)

    def _setup_positional(self, state: dict, built) -> None:
        """The positional occurrence index (``index/positional.py``), on
        one device: from the state's compact arrays, or built from the
        built index's positions over the full device CSR. A failed build
        fails construction."""
        import time
        from .positional import DevicePositional
        t0 = time.time()
        if state.get("positional") is not None:
            self.positional = DevicePositional.from_state(
                state["positional"], device=self._device)
        elif built.positional is not None:
            self.positional = DevicePositional(
                built.positional, self.n_docs_capacity, device=self._device,
                postings_dev=self.postings)
        else:
            return
        self.upload_detail["positional_s"] = round(time.time() - t0, 2)

    def set_positional_doc_lengths(self, doc_len) -> None:
        """Upload per-doc normalized-text lengths (BM25 norm for the
        positional score mode). doc_len: (n+1,) int32-like indexed by doc
        id (or None to keep zeros)."""
        if self.positional is None or doc_len is None:
            return
        self.positional.set_doc_lengths(doc_len)

    def _setup_mesh(self, state: dict, mesh) -> None:
        """Place each shard's bitmap block, tombstone and all-ones words
        and CSR on its device (contiguous tensors of their own)."""
        from ..utils.structured_log import StructuredLog
        devices = mesh.docs_devices
        S = len(devices)
        check_mesh_shards(self.n_words, S, mesh.home.type == "cuda")
        if len(state["postings_sh"]) != S:
            raise ValueError(f"a state of {len(state['postings_sh'])} "
                             f"shards for a mesh of {S}")
        self.words_local = self.n_words // S
        self.shard_docs = self.words_local * 32
        self.postings = None
        self.dev_offsets = None
        self.offsets_sh = np.asarray(state["offsets_sh"], dtype=np.int64)
        self.lengths_sh = np.asarray(state["lengths_sh"], dtype=np.int64)
        self.bitmaps = pmesh.split_words(
            np.asarray(state["bitmaps"], dtype=np.uint32), devices)
        self.postings_sh = pmesh.ShardedTensor(
            [runtime.to_device(np.asarray(p, dtype=np.int32), d)
             for p, d in zip(state["postings_sh"], devices)], axis=0)
        self.deleted = pmesh.split_words(self.deleted_host, devices)
        self._ones_words = pmesh.ShardedTensor(
            [torch.full((self.words_local,), -1, dtype=torch.int32,
                        device=d) for d in devices], axis=0)
        # the occurrence arrays are not doc-sharded: on a mesh the
        # positional index stays off, as in the JAX package
        StructuredLog().event("device_index_mesh").field(
            "shards", S).field("layout", mesh.layout()).field(
            "shard_docs", self.shard_docs).field(
            "positional", "off on a mesh" if self.built.positional
            is not None else "none").info()

    @property
    def text_doc_sharding(self):
        """The mesh a text store shards its padded rows over (with the
        index, so each shard verifies its own candidates); None on one
        device."""
        return self.mesh

    def state(self) -> dict:
        """The index's arrays read back to the host (``host_state`` keys)."""
        out = {"bitmaps": self.bitmaps.cpu().numpy().view(np.uint32),
               "lengths": self.lengths.copy(),
               "dense_row": self.dense_row.copy(),
               "deleted": self.deleted.cpu().numpy().view(np.uint32),
               "ones_row": self.ones_row, "zeros_row": self.zeros_row,
               "n_words": self.n_words,
               "n_docs_capacity": self.n_docs_capacity}
        if self.mesh is not None:
            out.update({"postings_sh": [p.cpu().numpy()
                                        for p in self.postings_sh.parts],
                        "offsets_sh": self.offsets_sh.copy(),
                        "lengths_sh": self.lengths_sh.copy()})
        else:
            out.update({"postings": self.postings.cpu().numpy(),
                        "offsets": self.dev_offsets.copy()})
        if self.positional is not None:
            out["positional"] = self.positional.state()
        return out

    def _words_on_device(self, words: np.ndarray):
        """(W,) host words -> the device: one tensor, or a ShardedTensor
        of per-shard blocks on a mesh."""
        if self.mesh is not None:
            return pmesh.split_words(words, self.mesh.docs_devices)
        return runtime.to_device(words, self._device)

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
            self.deleted = self._words_on_device(self.deleted_host)

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
    @trace.traced("index.search_and")
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
        rows = list(dense_rows)
        nrows = list(nd_rows)
        if ns_tids:
            # sparse NOT terms: a host-built bitmap row, AND'ed in inverted
            ids = np.concatenate([self.postings_of(t) for t in ns_tids])
            nb = bitmap_ops.make_bitmap_from_ids(ids, self.n_words)
            extra_words = list(extra_words) + [
                runtime.to_device(np.bitwise_not(nb), self._device)]
        if self.mesh is not None:
            return self._dense_and_path_sharded(rows, nrows, extra_words,
                                                opts)
        runtime.count_route("dense_unbatched")
        has_not = bool(nrows)
        if not nrows:
            nrows = [self.zeros_row]
        extra = self._pack_extra(extra_words)
        F = len(extra_words)
        rows_t = self._tensor([rows], torch.int32)
        nrows_t = self._tensor([nrows], torch.int32)
        if opts.count_only or opts.limit > 0:
            # one K1 launch: the count, and the first n ids (n = 0 counts)
            n = 0 if opts.count_only else min(
                _bucket_of(opts.limit, _LIMIT_BUCKETS), self.n_docs_capacity)
            count, ids = bitmap_ops.dense_search_topn_packed(
                self.bitmaps, rows_t, nrows_t, self.deleted, extra,
                has_not, F > 0, n, opts.descending)
            ids = ids[0]
            return int(count[0]), ids[ids >= 0][:opts.limit].astype(np.int32)
        count, res = bitmap_ops.dense_query_auto(
            self.bitmaps, rows_t, nrows_t, self.deleted, extra,
            has_not=has_not, has_extra=F > 0)
        return int(count[0]), self._bitmap_to_ids(res[0].cpu().numpy())

    def _dense_and_path_sharded(self, rows, nrows, extra_words, opts):
        """The unbatched dense AND on the mesh: K1 a shard, merged."""
        runtime.count_route("mesh_dense")
        runtime.dispatches.bump()
        devices = self.mesh.docs_devices
        extra = self._pack_extra(extra_words) if extra_words else None
        rows_np = np.asarray([rows], dtype=np.int32)
        nrows_np = np.asarray([nrows], dtype=np.int32) if nrows else None
        if opts.count_only or opts.limit > 0:
            n = 0 if opts.count_only else min(
                _bucket_of(opts.limit, _LIMIT_BUCKETS), self.n_docs_capacity)
            out = pmesh.dense_topn(devices, self.bitmaps, self.deleted,
                                   rows_np, nrows_np, extra, n,
                                   opts.descending, self.shard_docs)
            ids = out[0, 1:]
            return int(out[0, 0]), ids[ids >= 0][:opts.limit].astype(np.int32)
        count, words = pmesh.dense_words(devices, self.bitmaps, self.deleted,
                                         rows_np, nrows_np, extra)
        return int(count[0]), self._bitmap_to_ids(words[0])

    def _pack_extra(self, extra_words) -> torch.Tensor:
        """Stack extra AND-filter rows (an all-ones row when there are
        none, which is the AND identity). A row of another width was made
        for another segment: a swap raced the query, and
        ``FilterRowsRaced`` sends the pipeline to its exact host path."""
        if not extra_words:
            if self.mesh is not None:
                return None  # the mesh programs take no filter rows as None
            return self._ones_words[None, :]
        if any(w.shape != (self.n_words,) for w in extra_words):
            # the pipeline's import chain reaches this module
            from ..query.pipeline import FilterRowsRaced
            raise FilterRowsRaced(
                f"filter rows of widths {[tuple(w.shape) for w in extra_words]}"
                f" for an index of {self.n_words} words")
        if len(extra_words) == 1 and extra_words[0].is_contiguous():
            return extra_words[0][None, :]  # a view: no copy on the card
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
        if self.mesh is not None:
            return self._sparse_and_path_sharded(
                driver, sparse_tids[1:], dense_rows, ns_tids, nd_rows,
                extra_words, opts)
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
        args = runtime.to_device(pack_sparse_args(
            [int(self.dev_offsets[driver])], [dlen], [sp_off], [sp_len],
            [sp_inv], [dn_rows], [dn_inv]), self._device)
        total, ids = _sparse_query(
            self.postings, self.bitmaps, self.deleted,
            self._pack_extra(extra_words) if extra_words else None, args,
            Ks=Ks, Kd=Kd, C=C, Cmax=Cmax, limit_b=limit_b,
            count_only=opts.count_only, descending=opts.descending,
            n_words=self.n_words)
        if opts.count_only:
            return total, np.empty(0, dtype=np.int32)
        if opts.limit > 0:
            return total, ids[ids >= 0][:opts.limit].astype(np.int32)
        return total, ids.astype(np.int32)

    def _sparse_and_path_sharded(self, driver, probes, dense_rows, ns_tids,
                                 nd_rows, extra_words, opts):
        """The sparse program on the mesh: K3's probe entry a shard over
        its CSR slices (per-shard offsets and lengths), filter rows on the
        device, the covered-exact query probe-free as on one device (the
        JAX mesh probes it), then the merge. Not batched, as in the JAX
        package."""
        S = self.mesh.shape["docs"]
        C = self._cand_bucket(int(self.lengths[driver]))
        sp_tids = list(probes) + list(ns_tids)
        Ks = _k_bucket(len(sp_tids)) if sp_tids else 1
        Cmax = self._cand_bucket(
            max([1] + [int(self.lengths[t]) for t in sp_tids]))
        sp_off = np.zeros((1, Ks, S), dtype=np.int64)
        sp_len = np.zeros((1, Ks, S), dtype=np.int64)
        sp_inv = np.ones((1, Ks, S), dtype=bool)
        for i, t in enumerate(sp_tids):
            sp_off[0, i] = self.offsets_sh[:, t]
            sp_len[0, i] = self.lengths_sh[:, t]
            sp_inv[0, i] = i >= len(probes)
        dn_rows = list(dense_rows) + list(nd_rows)
        dn_inv = [False] * len(dense_rows) + [True] * len(nd_rows)
        probe_free = not sp_tids and not dn_rows
        Kd = _k_bucket(len(dn_rows)) if dn_rows else 1
        dn_rows += [self.ones_row] * (Kd - len(dn_rows))
        dn_inv += [False] * (Kd - len(dn_inv))
        # every match of an unlimited query fits C: it is at most dlen
        if opts.count_only:
            lb = 0
        elif opts.limit > 0:
            lb = min(_bucket_of(opts.limit, _LIMIT_BUCKETS), C)
        else:
            lb = C
        runtime.dispatches.bump()
        runtime.count_route("mesh_sparse")
        out = pmesh.sharded_sparse_query(
            self.mesh, self.postings_sh, self.bitmaps, self.deleted,
            self.offsets_sh[None, :, driver], self.lengths_sh[None, :, driver],
            sp_off, sp_len, sp_inv, [dn_rows], [dn_inv], C=C, Cmax=Cmax,
            limit_b=lb, descending=opts.descending and opts.limit > 0,
            shard_docs=self.shard_docs, words_local=self.words_local,
            extra=self._pack_extra(extra_words) if extra_words else None,
            probe_free=probe_free)
        total = int(out[0, 0])
        ids = out[0, 1:]
        return total, ids[ids >= 0][:opts.limit or None].astype(np.int32)

    # ------------------------------------------------------------------
    # Fused verified search (one program: match + verify + score + top-n)
    # ------------------------------------------------------------------
    _KV_BUCKET = 4096  # verify compaction width of the per-slot kernels
    # candidate widths of the fused path: finer at the short end than
    # candidate_buckets, since verify work grows with the width
    _VERIFY_CAND_BUCKETS = (512, 2048, 4096, 8192, 32768, 65536)
    # a dense driver's least df at 1.1M docs is often 100k-250k
    _VERIFY_DENSE_BUCKETS = _VERIFY_CAND_BUCKETS + (131072, 262144)

    def verify_cand_bucket(self, n: int) -> int:
        return _bucket_of(max(n, 1), self._VERIFY_CAND_BUCKETS)

    def verify_maxT(self, text_store, driver_tid: Optional[int]) -> int:
        """Window bucket of a verify: the longest stored text among the
        driver term's postings bounds every candidate's length, so the
        kernels read only that much of each document."""
        if driver_tid is None:
            return text_store.maxT
        p = self.postings_of(driver_tid)
        if p.size == 0:
            return text_store.maxT
        lens_host = text_store.lengths_host
        ok = p < lens_host.shape[0]
        bound = int(lens_host[p[ok]].max()) if ok.any() else 0
        return text_store.maxT_bucket(max(bound, 1))

    @trace.traced("index.search_and_verified")
    def search_and_verified(self, tids: Sequence[int], text_store,
                            needles: np.ndarray, needle_lens: np.ndarray,
                            limit_b: int, descending: bool,
                            score_mode: bool = False, idf=None,
                            k1: float = 1.2, b: float = 0.75,
                            avgdl: float = 1.0, nonoverlap: bool = False,
                            require_match: bool = True,
                            force_probes: bool = False,
                            extra_words=()):
        """One-program verified AND over a ``DeviceTextStore``: (total,
        ids, scores, pre) with total the VERIFIED match count and pre the
        gram-AND match count before the verify (the BM25 df of a
        single-term score query), or None when no fused shape applies or
        the match set exceeded the verify width (pre > Kv): the caller
        then re-runs the query on the exact path.

        needles (Nn, CAP) uint32 and needle_lens (Nn,) are padded to the
        Nn bucket. require_match=False keeps unverified candidates in
        score mode; force_probes=True keeps the gram probes so that pre is
        the exact AND count; extra_words are filter rows, which the verify
        never subsumes."""
        from ..ops import fused as fused_ops
        dense_rows, sparse_tids = self.classify(list(tids))
        idf_row = (np.zeros(needles.shape[0], dtype=np.float32)
                   if idf is None else np.asarray(idf, dtype=np.float32))
        empty = (0, np.empty(0, dtype=np.int32),
                 np.empty(0, dtype=np.float32), 0)
        extra = self._pack_extra(list(extra_words)) if extra_words else None
        if self.mesh is not None:
            # the sharded programs verify over the shards' own text rows;
            # the flat layout is not sharded, and the non-overlapping
            # count of a sparse driver has no sharded program (as in the
            # JAX package): both take the exact path, counted
            if not getattr(text_store, "doc_sharded", False) or (
                    sparse_tids and nonoverlap):
                runtime.count_route("mesh_to_exact")
                return None
            if sparse_tids:
                return self._search_and_verified_sharded(
                    sparse_tids, dense_rows, text_store, needles,
                    needle_lens, limit_b, descending, extra,
                    score_mode=score_mode, idf=idf_row, k1=k1, b=b,
                    avgdl=avgdl, require_match=require_match)
        if sparse_tids:
            sparse_tids = sorted(sparse_tids,
                                 key=lambda t: int(self.lengths[t]))
            driver = sparse_tids[0]
            dlen = int(self.lengths[driver])
            if dlen == 0:
                return empty
            C = self.verify_cand_bucket(dlen)
            if C > self.candidate_buckets[-1]:
                return None
            Kv = min(C, self._KV_BUCKET)
            # where the live-prefix kernel (K5) takes the batch, its cost
            # follows the live candidates: the full width cannot clip
            if fused_ops._global_pack_policy(text_store, 1, C, nonoverlap):
                Kv = C
            maxT = self.verify_maxT(text_store, driver)
            sp_off = [int(self.dev_offsets[t]) for t in sparse_tids[1:]]
            sp_len = [int(self.lengths[t]) for t in sparse_tids[1:]]
            sp_inv = [False] * len(sp_off)
            Ks = _k_bucket(len(sp_off)) if sp_off else 1
            Cmax = self._cand_bucket(max([1] + sp_len))
            while len(sp_off) < Ks:
                sp_off.append(0)
                sp_len.append(0)
                sp_inv.append(True)
            dn_rows = list(dense_rows)
            Kd = _k_bucket(len(dn_rows)) if dn_rows else 1
            dn_inv = [False] * len(dn_rows)
            while len(dn_rows) < Kd:
                dn_rows.append(self.ones_row)
                dn_inv.append(False)
            lb = min(limit_b, Kv)
            runtime.count_route("fused_sparse")
            # a window verify that filters subsumes the dense-gram probes
            # (the needles hold every query term), unless pre must be
            # exact; one that does not filter probes every gram
            if self.batcher is not None:
                out = self.batcher.submit_fused_sparse_verify(
                    int(self.dev_offsets[driver]), dlen, sp_off, sp_len,
                    sp_inv, dn_rows, dn_inv, needles, needle_lens,
                    text_store, C, Cmax, lb, descending, Kv=Kv, maxT=maxT,
                    score_mode=score_mode, idf=idf_row, k1=k1, b=b,
                    avgdl=avgdl, nonoverlap=nonoverlap,
                    require_match=require_match, force_probes=force_probes,
                    extra=tuple(extra_words))
                return self._fused_result(out)
            out = fused_ops.sparse_search_verify_topn_batch(
                self.postings, self.bitmaps, self.deleted,
                [int(self.dev_offsets[driver])], [dlen], [sp_off], [sp_len],
                [sp_inv], [dn_rows], [dn_inv], text_store, C, Cmax, lb,
                needles[None], needle_lens[None], self.n_words, descending,
                Kv=Kv, maxT=maxT, idf=idf_row[None], k1=k1, b=b,
                avgdl=avgdl, score_mode=score_mode, nonoverlap=nonoverlap,
                use_dense_probes=force_probes, require_match=require_match,
                extra=extra)
            return self._fused_result(self._unbatched(out, Kv, score_mode))
        # dense only: the least dense df bounds the match count
        if not dense_rows:
            return empty
        dfs = [int(self.lengths[t]) for t in tids]
        C = _bucket_of(max(min(dfs), 1), self._VERIFY_DENSE_BUCKETS)
        if C > self._VERIFY_DENSE_BUCKETS[-1]:
            return None
        # past the widest sparse bucket only the live-prefix kernel keeps
        # the verify work bounded by the matches
        if C > self.candidate_buckets[-1] and not \
                fused_ops._global_pack_policy(text_store, 1, C, nonoverlap):
            return None
        rows = list(dense_rows)
        while len(rows) < _k_bucket(len(rows)):
            rows.append(self.ones_row)
        from ..server.microbatch import MAX_K
        if len(rows) > MAX_K:
            return None
        lb = min(limit_b, C)
        vbound = max(min(dfs), 1)  # AND count <= least df
        runtime.count_route("fused_dense" if self.mesh is None
                            else "mesh_fused_dense")
        if self.batcher is not None:
            out = self.batcher.submit_fused_verify(
                rows, needles, needle_lens, text_store, C, lb, descending,
                score_mode=score_mode, idf=idf_row, k1=k1, b=b,
                avgdl=avgdl, nonoverlap=nonoverlap,
                require_match=require_match, extra=tuple(extra_words),
                vbound=vbound)
            return self._fused_result(out)
        if self.mesh is not None:
            pre, clipped, count, ids, scores = pmesh.split_fused(
                pmesh.sharded_dense_fused_verify(
                    self.mesh, self.bitmaps, self.deleted, text_store,
                    np.asarray([rows], dtype=np.int32), needles[None],
                    needle_lens[None], extra, C=C, n=lb,
                    maxT=text_store.maxT, descending=descending,
                    shard_docs=self.shard_docs, score_mode=score_mode,
                    require_match=require_match, idf=idf_row[None], k1=k1,
                    b=b, avgdl=avgdl, nonoverlap=nonoverlap), lb, score_mode)
            return self._fused_result(self._sharded_result(
                pre, clipped, count, ids, scores))
        out = fused_ops.search_verify_topn_batch(
            self.bitmaps, self._tensor([rows], torch.int32), self.deleted,
            extra, text_store, C, lb, needles[None], needle_lens[None],
            descending, idf=idf_row[None], k1=k1, b=b, avgdl=avgdl,
            score_mode=score_mode, nonoverlap=nonoverlap,
            require_match=require_match, vbound=vbound)
        return self._fused_result(self._unbatched(out, C, score_mode))

    def _search_and_verified_sharded(self, sparse_tids, dense_rows,
                                     text_store, needles, needle_lens,
                                     limit_b: int, descending: bool, extra,
                                     score_mode: bool = False, idf=None,
                                     k1: float = 1.2, b: float = 0.75,
                                     avgdl: float = 1.0,
                                     require_match: bool = True):
        """The fused verified search on the mesh, with the JAX mesh's
        shapes: C from the longest shard slice of the driver, Kv =
        min(C, 4096), probe-free where C <= Kv (the window verify
        subsumes every gram), the sparse probes otherwise and never the
        dense ones (``parallel.mesh.sharded_fused_verify``). Where the
        verify does not filter (``require_match`` off) every sparse and
        dense gram probes, since nothing else would apply them. None (the
        exact path) when a slice passes the buckets or a shard's
        survivors passed Kv."""
        S = self.mesh.shape["docs"]
        sparse_tids = sorted(sparse_tids, key=lambda t: int(self.lengths[t]))
        driver = sparse_tids[0]
        if int(self.lengths[driver]) == 0:
            return (0, np.empty(0, dtype=np.int32),
                    np.empty(0, dtype=np.float32), 0)
        C = self.verify_cand_bucket(int(self.lengths_sh[:, driver].max()))
        Kv = min(C, self._KV_BUCKET)
        probes = sparse_tids[1:] if C > Kv or not require_match else []
        dn_rows = [] if require_match else list(dense_rows)
        Kd = _k_bucket(len(dn_rows)) if dn_rows else 1
        dn_rows += [self.ones_row] * (Kd - len(dn_rows))
        Ks = _k_bucket(len(probes)) if probes else 1
        sp_off = np.zeros((1, Ks, S), dtype=np.int64)
        sp_len = np.zeros((1, Ks, S), dtype=np.int64)
        sp_inv = np.ones((1, Ks, S), dtype=bool)
        for j, t in enumerate(probes):
            sp_off[0, j] = self.offsets_sh[:, t]
            sp_len[0, j] = self.lengths_sh[:, t]
            sp_inv[0, j] = False
        Cmax = self._cand_bucket(max([1] + [
            int(self.lengths_sh[:, t].max()) for t in probes]))
        if C > self.candidate_buckets[-1] or \
                Cmax > self.candidate_buckets[-1]:
            runtime.count_route("mesh_to_exact")
            return None
        lb = min(limit_b, Kv)
        runtime.count_route("mesh_fused_sparse")
        out = pmesh.sharded_fused_verify(
            self.mesh, self.postings_sh, self.bitmaps, self.deleted,
            text_store, self.offsets_sh[None, :, driver],
            self.lengths_sh[None, :, driver], sp_off, sp_len, sp_inv,
            needles[None], needle_lens[None], extra, C=C, Cmax=Cmax, Kv=Kv,
            n=lb, maxT=self.verify_maxT(text_store, driver),
            descending=descending, shard_docs=self.shard_docs,
            words_local=self.words_local, score_mode=score_mode,
            require_match=require_match, idf=idf[None], k1=k1, b=b,
            avgdl=avgdl, dn_rows=np.asarray([dn_rows], dtype=np.int64))
        return self._fused_result(self._sharded_result(
            *pmesh.split_fused(out, lb, score_mode)))

    @staticmethod
    def _sharded_result(pre, clipped, count, ids, scores):
        """One query's row of a sharded fused program -> (total, ids,
        scores, pre), or None when a shard clipped."""
        if int(clipped[0]):
            return None
        sc = (scores[0] if scores is not None
              else np.zeros(ids.shape[1], dtype=np.float32))
        return int(count[0]), ids[0].astype(np.int32), sc, int(pre[0])

    @staticmethod
    def _unbatched(out, width: int, score_mode: bool):
        """One query's row of a fused program's numpy output -> (total,
        ids, scores, pre), or None when it clipped (pre > width)."""
        pre, count, ids = out[0], out[1], out[2]
        if int(pre[0]) > width:
            return None
        scores = (out[3][0] if score_mode
                  else np.zeros(ids.shape[1], dtype=np.float32))
        return int(count[0]), ids[0], scores, int(pre[0])

    @staticmethod
    def _fused_result(out):
        if out is None:  # the exact path re-runs the query
            runtime.count_route("fused_clipped")
        return out

    # ------------------------------------------------------------------
    def host_and_among(self, ids: np.ndarray, tids: Sequence[int]
                       ) -> np.ndarray:
        """The documents of ``ids`` (sorted) that hold every term of tids
        and are not deleted, from the host postings: the fused verified
        search's candidates among the text store's overflow documents,
        a few thousand ids at most, probed with no device call."""
        ids = np.asarray(ids, dtype=np.int64)
        V = self.lengths.shape[0]
        for t in sorted(set(tids), key=lambda t: int(self.lengths[t])
                        if t < V else 0):
            if ids.size == 0:
                break
            p = self.postings_of(t) if t < V else ids[:0]
            if p.size == 0:
                return ids[:0]
            pos = np.minimum(np.searchsorted(p, ids), p.size - 1)
            ids = ids[p[pos] == ids]
        dead = (self.deleted_host[ids >> 5] >> (ids & 31).astype(np.uint32)
                ) & 1
        return ids[dead == 0]

    @staticmethod
    def _probe_words(words: np.ndarray, ids: np.ndarray) -> np.ndarray:
        w = ids >> 5
        b = ids & 31
        return ((words[w] >> b.astype(np.uint32)) & 1).astype(np.int32)

    @trace.traced("index.filter_by_ngrams")
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
            for row in self._dense_rows_host(dense_rs):
                keep &= self._probe_words(row, candidates).astype(bool)
        for t in sparse:
            p = self.postings_of(t)
            if p.size == 0:
                return np.empty(0, dtype=np.int32)
            pos = np.minimum(np.searchsorted(p, candidates), p.size - 1)
            keep &= p[pos] == candidates
        return candidates[keep]

    def _dense_rows_host(self, rows: Sequence[int]) -> np.ndarray:
        """Bitmap rows pulled to the host -> (len(rows), W) uint32."""
        if self.mesh is None:
            return self.bitmaps[self._tensor(rows, torch.int64)
                                ].cpu().numpy().view(np.uint32)
        return np.concatenate(
            [p[torch.as_tensor(list(rows), device=p.device)
               ].cpu().numpy().view(np.uint32)
             for p in self.bitmaps.parts], axis=1)

    # ------------------------------------------------------------------
    # Boolean-AST device evaluation
    # ------------------------------------------------------------------
    @trace.traced("index.ast_words")
    def ast_words(self, sig: tuple, leaf_tids: Sequence[Sequence[int]],
                  universe) -> Optional[np.ndarray]:
        """Evaluate a boolean AST (shape ``sig`` over ``leaf_tids`` term
        gram lists) on the device; returns the result words on the host
        (W uint32), or None when a leaf's longest sparse slice passes the
        last candidate bucket (the caller then evaluates the tree with
        host set algebra; counted as route ``ast_host``). ``universe`` is
        the all-live-docs bitmap for NOT complements."""
        rows_l, sp_l = [], []
        max_len = 1
        for tids in leaf_tids:
            if tids is None:
                # unknown/empty gram: the term matches nothing
                dense_rows, sparse = [self.zeros_row], []
            else:
                dense_rows, sparse = self.classify(list(tids))
                if any(int(self.lengths[t]) == 0 for t in sparse):
                    dense_rows, sparse = [self.zeros_row], []
            rows_l.append(dense_rows or [self.ones_row])
            sp_l.append(list(sparse))
            # on the mesh a leaf's slice is its longest shard slice
            max_len = max([max_len] + [
                int(self.lengths[t]) if self.mesh is None
                else int(self.lengths_sh[:, t].max()) for t in sparse])
        if self._cand_bucket(max_len) > self.candidate_buckets[-1]:
            runtime.count_route("ast_host")
            return None
        T = len(leaf_tids)
        K = max(len(r) for r in rows_l)
        S = max(len(sp) for sp in sp_l)
        rows = np.full((T, K), self.ones_row, dtype=np.int32)
        for i in range(T):
            rows[i, :len(rows_l[i])] = rows_l[i]
        runtime.dispatches.bump()
        if self.mesh is not None:
            # per-shard slices; a real term's shard-empty slice gives zeros
            Ssh = self.mesh.shape["docs"]
            offs = np.zeros((T, S, Ssh), dtype=np.int64)
            lens = np.zeros((T, S, Ssh), dtype=np.int64)
            real = np.zeros((T, S), dtype=bool)
            for i, sparse in enumerate(sp_l):
                for j, t in enumerate(sparse):
                    offs[i, j] = self.offsets_sh[:, t]
                    lens[i, j] = self.lengths_sh[:, t]
                    real[i, j] = True
            runtime.count_route("mesh_ast")
            return pmesh.sharded_ast_words(
                self.mesh, self.postings_sh, self.bitmaps, self.deleted,
                universe, rows, offs, lens, real, sig=sig, bucket=max_len,
                words_local=self.words_local)
        offs = np.zeros((T, S), dtype=np.int64)
        lens = np.zeros((T, S), dtype=np.int64)
        for i in range(T):
            for j, t in enumerate(sp_l[i]):
                offs[i, j] = self.dev_offsets[t]
                lens[i, j] = self.lengths[t]
        runtime.count_route("ast_device")
        # one launch of K2's boolean program (reference in-process Roaring
        # set ops, index.cpp:378-446)
        words = bitmap_ops.ast_words(
            sig, self.bitmaps, self.postings, self.deleted, universe, rows,
            offs, lens, bucket=max_len, n_words=self.n_words)
        return words.cpu().numpy().view(np.uint32)

    def universe_words(self, doc_ids: np.ndarray) -> torch.Tensor:
        """Device bitmap of all live docs (NOT complement base), built on
        the host from the doc store's id set and uploaded once per segment
        generation (the caller caches it); per shard on a mesh."""
        return self._words_on_device(
            bitmap_ops.make_bitmap_from_ids(doc_ids, self.n_words))

    # ------------------------------------------------------------------
    @trace.traced("index.search_or")
    def search_or(self, tids: Sequence[int]) -> np.ndarray:
        """Union, ascending doc ids (host materialization; the boolean
        OR / NOT path). Tombstones applied."""
        if not tids:
            return np.empty(0, dtype=np.int32)
        runtime.count_route("or_rows" if self.mesh is None else "mesh_or")
        dense_rows, sparse_tids = self.classify(list(tids))
        parts = []
        if dense_rows:
            if self.mesh is not None:  # K2's OR a shard
                runtime.dispatches.bump()
                words = pmesh.sharded_or_rows(
                    self.mesh, self.bitmaps, np.asarray([dense_rows]))[0]
            else:
                words = bitmap_ops.or_rows(
                    self.bitmaps, self._tensor([dense_rows], torch.int32)
                )[0].cpu().numpy().view(np.uint32)
            parts.append(self._bitmap_to_ids(words & ~self.deleted_host))
        for t in sparse_tids:
            parts.append(self.postings_of(t))
        out = np.unique(np.concatenate(parts)).astype(np.int32)
        if sparse_tids and self.deleted_host.any():
            out = out[~self._deleted_mask(out)]
        return out

    def _deleted_mask(self, ids: np.ndarray) -> np.ndarray:
        in_range = (ids >= 0) & (ids < self.n_docs_capacity)
        safe = np.where(in_range, ids, 0)
        hit = ((self.deleted_host[safe >> 5]
                >> (safe & 31).astype(np.uint32)) & 1).astype(bool)
        return hit & in_range

    @trace.traced("index.search_by_threshold")
    def search_by_threshold(self, tids: Sequence[int], min_count: int,
                            max_out: int = 131072) -> np.ndarray:
        """Doc ids contained in >= min_count of the given term postings
        (fuzzy backbone; reference index.cpp:448-528). As in the JAX
        package the all-sparse form returns at most max_out ids and the
        form with dense terms every id."""
        if not tids or min_count <= 0:
            return np.empty(0, dtype=np.int32)
        dense_rows, sparse_tids = self.classify(list(tids))
        if self.mesh is not None:
            # no whole CSR on any device: a host count over the terms'
            # postings, as the JAX package's mesh does (its all-dense form,
            # a bitmap count over every id, is not cut at max_out)
            runtime.count_route("threshold_host")
            ids = np.concatenate([self.postings_of(t) for t in tids])
            out = np.flatnonzero(np.bincount(ids) >= min_count
                                 ).astype(np.int32)
            if sparse_tids:
                out = out[:max_out]
            if self.deleted_host.any():
                out = out[~self._deleted_mask(out)]
            return out
        offs = self._tensor([self.dev_offsets[t] for t in sparse_tids],
                            torch.int64)
        lens_host = [int(self.lengths[t]) for t in sparse_tids]
        lens = self._tensor(lens_host, torch.int64)
        width = max([1] + lens_host)
        if not dense_rows:
            # all sparse: gather, sort, rank-count
            runtime.dispatches.bump(2)
            runtime.count_route("threshold_merge")
            slices = gather_slices(self.postings, offs, lens, width)
            _, ids = threshold_merge(slices, min_count, max_out)
            out = ids.cpu().numpy()
            out = out[out >= 0]
            if self.deleted_host.any():
                out = out[~self._deleted_mask(out)]
            return out.astype(np.int32)
        # any dense term: one per-document count over the whole id space
        runtime.dispatches.bump()
        runtime.count_route("threshold_bitmap")
        words = threshold_count_bitmap(
            self.bitmaps, self._tensor(dense_rows, torch.int32),
            self.postings, offs, lens, min_count, self.deleted,
            g_sparse=len(sparse_tids), c_bucket=width)
        # tombstones already cleared on the device
        return self._bitmap_to_ids(words.cpu().numpy().view(np.uint32))

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Run the dense, sparse and boolean-tree programs once (first
        CUDA use, kernel library load) before serving."""
        with trace.stage("build.warmup"):
            self._warmup()

    def _warmup(self) -> None:
        opts_all = SearchOptions(limit=0)
        opts_top = SearchOptions(limit=100, descending=True)
        for opts in (opts_all, opts_top):
            self._dense_and_path([self.ones_row], [], [], [], opts)
        csr = self.postings if self.mesh is None else self.postings_sh
        if csr.numel() > 0 and bool((self.lengths > 0).any()):
            tid = int(np.argmax(self.lengths > 0))
            if self.dense_row[tid] < 0:
                for opts in (opts_all, opts_top):
                    self._sparse_and_path([tid], [], [], [], [], opts)
            self.ast_words(("&", ("t", 0), ("t", 1)), [[tid], [tid]],
                           self._ones_words)

    def memory_usage(self) -> int:
        """Device bytes of the index (every shard's on a mesh)."""
        csr = self.postings if self.mesh is None else self.postings_sh
        return int(self.bitmaps.numel() * 4 + csr.numel() * 4
                   + self.deleted.numel() * 4)

    def shard_memory(self) -> List[int]:
        """Device bytes of each shard of the index (one entry on one
        device)."""
        if self.mesh is None:
            return [self.memory_usage()]
        return [int(4 * (b.numel() + p.numel() + d.numel()))
                for b, p, d in zip(self.bitmaps.parts, self.postings_sh.parts,
                                   self.deleted.parts)]

    def per_device_sparse_bytes(self) -> int:
        """Sparse-CSR bytes one device holds: the whole CSR on one device,
        the largest shard's on a mesh (a card holding several shards
        holds their sum)."""
        if self.mesh is None:
            return int(self.postings.numel() * 4)
        return int(max(p.numel() for p in self.postings_sh.parts) * 4)

    # ------------------------------------------------------------------
    # Positional verified search (ops/positional_ops.py)
    # ------------------------------------------------------------------
    def plan_positional(self, tid_offsets) -> Optional[dict]:
        """Plan a single-term positional verified search.

        tid_offsets: [(tid, in-term offset)], one entry per gram placement
        (from textproc.query_gram_offsets, which also decides coverage;
        the caller plans covered terms only). Returns the per-query plan
        dict the batched program consumes, or None where the JAX package
        refuses the same inputs: no positional index, overflowing
        documents, an empty gram, or a shape past the last bucket. Plans
        carry int64 occurrence starts (``d_start``, ``p_start``) where the
        JAX package's carry aligned row indices."""
        pp = self.positional
        if pp is None or pp.overflow or not tid_offsets:
            return None
        from .positional import (C_BUCKETS, CO_BUCKETS, C2_BUCKETS,
                                 CO2_BUCKETS, G_BUCKETS, _bucket)
        dfs = [int(self.lengths[t]) for t, _ in tid_offsets]
        if any(d == 0 for d in dfs):
            return None  # empty AND; caller handles via estimated_size
        di = int(np.argmin(dfs))
        d_tid, d_term_off = tid_offsets[di]
        C = _bucket(dfs[di], C_BUCKETS)
        Co = _bucket(max(int(pp.occ_len[d_tid]), 1), CO_BUCKETS)
        probes = [(t, o - d_term_off)
                  for j, (t, o) in enumerate(tid_offsets) if j != di]
        G = _bucket(max(len(probes), 1), G_BUCKETS)
        C2 = _bucket(max([1] + [int(self.lengths[t])
                                for t, _ in probes]), C2_BUCKETS)
        Co2 = _bucket(max([1] + [max(int(pp.occ_len[t]), 1)
                                 for t, _ in probes]), CO2_BUCKETS)
        if None in (C, Co, G, C2, Co2):
            return None
        pad = G - len(probes)
        return {"d_off": int(self.dev_offsets[d_tid]), "d_len": dfs[di],
                "d_start": int(pp.occ_start[d_tid]),
                "d_olen": int(pp.occ_len[d_tid]),
                "p_off": [int(self.dev_offsets[t]) for t, _ in probes]
                + [0] * pad,
                "p_len": [int(self.lengths[t]) for t, _ in probes]
                + [0] * pad,
                "p_start": [int(pp.occ_start[t]) for t, _ in probes]
                + [0] * pad,
                "p_olen": [int(pp.occ_len[t]) for t, _ in probes]
                + [0] * pad,
                "p_delta": [int(d) for _, d in probes] + [0] * pad,
                "p_valid": [True] * len(probes) + [False] * pad,
                "C": C, "Co": Co, "C2": C2, "Co2": Co2, "G": G}

    @trace.traced("index.search_verified_positional")
    def search_verified_positional(self, plan: dict, limit_b: int,
                                   descending: bool,
                                   score_mode: bool = False,
                                   idf: float = 0.0, k1: float = 1.2,
                                   b: float = 0.75, avgdl: float = 1.0,
                                   require_match: bool = True,
                                   force_probes: bool = False,
                                   extra_words=()):
        """Single-query positional verified search (a batch of one; the
        micro-batcher groups concurrent plans by bucket tuple). Returns
        (total, ids, scores, pre) like search_and_verified."""
        from ..ops.positional_ops import positional_verify_batch
        pp = self.positional
        n = min(limit_b, plan["Co"])
        if self.batcher is not None:
            return self.batcher.submit_positional(
                plan, n, descending, score_mode=score_mode, idf=idf,
                k1=k1, b=b, avgdl=avgdl, require_match=require_match,
                use_doc_probes=force_probes, extra=tuple(extra_words))
        extra = (self._pack_extra(list(extra_words))
                 if extra_words else None)
        out = positional_verify_batch(
            self.postings, pp.occ_doc, pp.occ_pos, self.deleted,
            pp.doc_len, [plan], n, self.n_words, descending,
            score_mode=score_mode,
            idf=np.asarray([[idf]], dtype=np.float32), k1=k1, b=b,
            avgdl=avgdl, require_match=require_match,
            use_doc_probes=force_probes, extra=extra)
        if score_mode:
            pre, count, ids, scores = out
            return int(count[0]), ids[0], scores[0], int(pre[0])
        pre, count, ids = out
        return (int(count[0]), ids[0],
                np.zeros(ids.shape[1], dtype=np.float32), int(pre[0]))
