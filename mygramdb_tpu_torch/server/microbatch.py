"""Query micro-batching on torch: many connections, one device program.

The queueing, grouping and flush logic is the JAX package's
``MicroBatcher`` (its module imports no JAX at the top level); this
subclass replaces the two programs the SEARCH/COUNT path runs:

- **dense**: PK-sorted dense AND SEARCH -> ``dense_search_topn_packed``
  (the row-AND kernel K1 + top-n), grouped per (limit bucket, direction,
  filter rows).
- **sparse**: candidate-probe queries -> ``_sparse_query_batch`` (the
  slice-gather kernel K3 + probes + top-n), grouped per shape bucket and
  probe-free flag.

PyTorch runs eagerly, so a batch is not padded to a bucketed width: the
JAX package pads B and K only to bound its set of compiled programs.
"""

from __future__ import annotations

from typing import List

import numpy as np

from mygramdb_tpu.server.microbatch import MAX_K, MicroBatcher as _Batcher

from .._overlay import not_ported
from ..ops import bitmap_ops, runtime

__all__ = ["MAX_K", "MicroBatcher"]


class MicroBatcher(_Batcher):

    def _execute_dense(self, q: List, limit_b: int,
                       descending: bool) -> None:
        idx = self.idx
        K = max(len(r.rows) for r in q)
        rows = np.full((len(q), K), idx.ones_row, dtype=np.int32)
        for i, r in enumerate(q):
            rows[i, :len(r.rows)] = r.rows
        nrows = np.full((len(q), 1), idx.zeros_row, dtype=np.int32)
        # filter rows are identical across the batch (grouped by identity)
        extra_rows = list((q[0].sparse or {}).get("extra", ()))
        count_np, ids_np = bitmap_ops.dense_search_topn_packed(
            idx.bitmaps, runtime.to_device(rows, idx._device),
            runtime.to_device(nrows, idx._device), idx.deleted,
            idx._pack_extra(extra_rows), False, bool(extra_rows), limit_b,
            descending)
        self.batches_executed += 1
        self.queries_batched += len(q)
        runtime.count_route("dense_batched", len(q))
        for i, r in enumerate(q):
            r.total = int(count_np[i])
            r.ids = ids_np[i]
            r.event.set()

    def _execute_sparse(self, q: List, key: tuple) -> None:
        from ..index.device_index import _sparse_query_batch
        idx = self.idx
        _, C, Cmax, Ks, Kd, limit_b, descending, probe_free, _eids = key
        B = len(q)
        d_off = np.zeros(B, dtype=np.int64)
        d_len = np.zeros(B, dtype=np.int64)
        sp_off = np.zeros((B, Ks), dtype=np.int64)
        sp_len = np.zeros((B, Ks), dtype=np.int64)
        sp_inv = np.ones((B, Ks), dtype=bool)
        dn_rows = np.full((B, Kd), idx.ones_row, dtype=np.int32)
        dn_inv = np.zeros((B, Kd), dtype=bool)
        for i, r in enumerate(q):
            s = r.sparse
            d_off[i] = s["d_off"]
            d_len[i] = s["d_len"]
            sp_off[i] = s["sp_off"]
            sp_len[i] = s["sp_len"]
            sp_inv[i] = s["sp_inv"]
            dn_rows[i] = s["dn_rows"]
            dn_inv[i] = s["dn_inv"]
        runtime.dispatches.bump()
        extra_rows = list((q[0].sparse or {}).get("extra", ()))
        dev = idx._device
        count, ids = _sparse_query_batch(
            idx.postings, idx.bitmaps, idx.deleted,
            runtime.to_device(d_off, dev), runtime.to_device(d_len, dev),
            runtime.to_device(sp_off, dev), runtime.to_device(sp_len, dev),
            runtime.to_device(sp_inv, dev), runtime.to_device(dn_rows, dev),
            runtime.to_device(dn_inv, dev), idx._pack_extra(extra_rows),
            C=C, Cmax=Cmax, limit_b=limit_b, descending=descending,
            n_words=idx.n_words, has_extra=bool(extra_rows),
            probe_free=probe_free)
        count_np = count.cpu().numpy()
        ids_np = ids.cpu().numpy()
        self.batches_executed += 1
        self.sparse_batches += 1
        self.queries_batched += B
        runtime.count_route("sparse_batched", B)
        for i, r in enumerate(q):
            r.total = int(count_np[i])
            r.ids = ids_np[i]
            r.event.set()

    # fused verify and positional programs: not ported yet
    _execute_fused_verify = not_ported(
        __name__, "MicroBatcher._execute_fused_verify", "9")
    _execute_fused_sparse_verify = not_ported(
        __name__, "MicroBatcher._execute_fused_sparse_verify", "9")
    _execute_positional = not_ported(
        __name__, "MicroBatcher._execute_positional", "14")

