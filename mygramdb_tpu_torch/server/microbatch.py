"""Query micro-batching: one device program for many connections.

Concurrent queries are collected for up to ``window_us`` (or until
``max_batch``) and executed as one batched device program, on the worker
thread of whichever waiter flushes the queue. Program families:

- **dense**: PK-sorted dense AND SEARCH -> ``dense_search_topn_packed``
  (the row-AND kernel K1 + top-n), grouped per (limit bucket, direction,
  filter rows).
- **sparse**: candidate-probe queries -> ``posting_ops.sparse_probe``
  (K3's probe entry: driver gather, probes and top-n in one launch, the
  batch's arguments in one upload and its answer in one pull), grouped
  per shape bucket and probe-free flag.
- **fusedv** / **fusedsv**: the fused verified search with a dense or a
  sparse driver (``ops.fused``: K1 or K3's probe entry, then the
  window-TF kernels K4, K5 or K6), grouped per shape, needle bucket,
  scoring parameters and filter rows.
- **pos**: the positional verified search
  (``ops.positional_ops.positional_verify_batch``: torch ops around K3's
  slice gather), grouped per plan bucket tuple, page, order, scoring
  parameters and filter rows.

On a doc-sharded index (``idx.mesh``) the dense and the dense-driver
fused programs run once a shard and merge (``parallel.mesh``): the JAX
package gets them from XLA's partitioner. The sparse and fused-sparse
programs of a mesh run unbatched (``DeviceIndex``), as in the JAX package.

PyTorch runs eagerly, so a batch is not padded to a bucketed width (the
JAX package pads B and K only to bound its set of compiled programs, and
its pad lanes use the all-zeros row so that they match nothing); only a
query's own rows are padded, with the all-ones AND identity. The kernels
hold no per-batch text workspace, so a fused batch is not cut into
chunks either.

Counters (always on, summed under the batcher's lock as a batch ends;
``counters()``, which ``INFO`` and ``/metrics`` read): batches and the
queries in them, flushes by cause (``full``: an arrival filled
``max_batch``; ``window``: a waiter's timed wait ran out; ``late``: a
waiter's 5 s re-wait ran out), ``queue_wait_s`` (each query's wait from
its append to its batch's start) and ``wake_s`` (from a query's
``event.set()`` to its waiter running again; each waiter appends its
interval to a deque that the next batch's end or ``counters()`` folds in,
so a wake-up takes no lock). With ``utils.trace`` on, the same intervals
are the spans ``batcher.queue`` and ``batcher.wake``, and each batch is a
``batcher.execute`` span with the children ``batcher.pack`` (the host
arrays), ``ops.upload`` (them to the device), ``ops.launch`` (the kernel
wrapper and its launch) and ``ops.pull`` (the answer back); a family
whose program pulls inside its wrapper (all but the sparse one) records
its launches and pull as one ``ops.launch`` (attribute ``pull``:
``inside``), after an ``ops.upload`` where the batcher uploads itself
(the dense one).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import bitmap_ops, runtime
from ..parallel import mesh as pmesh
from ..utils import trace

MAX_K = 32  # dense row bucket ceiling for batched queries


@dataclass
class _Request:
    rows: List[int]
    event: threading.Event = field(default_factory=threading.Event)
    total: int = 0
    ids: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    # sparse payload (None for dense requests)
    sparse: Optional[dict] = None
    scores: Optional[np.ndarray] = None
    # fused-verify: the match set exceeded the verify compaction width, so
    # this request's result is invalid — caller re-runs on the exact path
    clipped: bool = False
    # fused-verify: pre-verify gram-AND match count (BM25 term df source)
    pre: int = 0
    # trace clock: appended to the queue; answered (its event set)
    t_in: float = 0.0
    set_at: Optional[float] = None
    # with tracing on: the request and the span that submitted it, and
    # the thread that ran its batch
    rid: Optional[int] = None
    parent: Optional[int] = None
    flusher: Optional[int] = None


class MicroBatcher:
    def __init__(self, device_index, max_batch: int = 64,
                 window_us: int = 200):
        self.idx = device_index
        self.max_batch = max(1, max_batch)
        self.window = window_us / 1e6
        self._lock = threading.Lock()
        self._queues: Dict[tuple, List[_Request]] = {}
        self.batches_executed = 0
        self.queries_batched = 0
        self.sparse_batches = 0
        self.flushes = {"full": 0, "window": 0, "late": 0}
        self.queue_wait_s = 0.0
        self.wake_s = 0.0
        self._woke: deque = deque()  # wake-ups not yet in wake_s

    # ------------------------------------------------------------------
    def _enqueue(self, key: tuple, req: _Request) -> None:
        """Requester-driven batching: the queue collects for up to the
        window; the first waiter whose window expires (or the arrival
        that fills max_batch) executes the whole batch on ITS OWN worker
        thread. _flush is idempotent, so concurrent waiters flushing is
        safe."""
        flush_now = False
        if trace.enabled:
            req.rid, req.parent = trace.context()
        req.t_in = trace.clock()
        with self._lock:
            q = self._queues.setdefault(key, [])
            q.append(req)
            if len(q) >= self.max_batch:
                flush_now = True
        if flush_now:
            self._flush(key, "full")
        # generous overall bound: a first kernel build runs inside the
        # flusher
        deadline = time.monotonic() + 600
        waited = max(self.window, 0.0005)
        cause = "window"
        while not req.event.wait(timeout=waited):
            if time.monotonic() >= deadline:
                break
            self._flush(key, cause)
            waited, cause = 5.0, "late"
        if req.set_at is not None:
            woke = trace.clock()
            self._woke.append(woke - req.set_at)
            if trace.enabled:
                mine = req.flusher == threading.get_ident()
                trace.record("batcher.wake", req.set_at, woke, req.rid,
                             req.parent, {"family": key[0], "flusher": mine})
        if req.error is not None:
            raise req.error
        if req.ids is None:
            raise TimeoutError("micro-batch execution timed out")

    def submit(self, dense_rows: List[int], limit_b: int,
               descending: bool, extra=()) -> Tuple[int, np.ndarray]:
        """Blocking submit; returns (total, top ids desc/asc, -1 padded).
        extra: tuple of device word rows AND'ed into the result — queries
        batch with peers sharing the SAME filter rows (grouped by array
        identity, e.g. every concurrent 'FILTER status = 1')."""
        if len(dense_rows) > MAX_K:
            # dropping rows would drop AND constraints (false positives);
            # callers must route >MAX_K queries to the unbatched path
            raise ValueError(
                f"micro-batch supports at most {MAX_K} dense rows, "
                f"got {len(dense_rows)}")
        req = _Request(rows=list(dense_rows), sparse={"extra": extra})
        self._enqueue(("dense", limit_b, descending,
                       tuple(id(x) for x in extra)), req)
        return req.total, req.ids

    def submit_fused_verify(self, dense_rows: List[int], needles,
                            needle_lens, text_store, C: int, limit_b: int,
                            descending: bool, score_mode: bool = False,
                            idf=None, k1: float = 1.2, b: float = 0.75,
                            avgdl: float = 1.0, nonoverlap: bool = False,
                            require_match: bool = True, extra=(),
                            vbound=None):
        """Blocking submit of a fused verified search (PK order or BM25
        score order). needles: (Nn, CAP) uint32 already padded to the Nn
        bucket. extra: shared EQ-filter word rows (grouped by identity —
        queries with the same filter value batch together). Returns
        (total, ids, scores, pre) or None when the match set exceeded the
        extraction width (caller re-runs exact)."""
        if len(dense_rows) > MAX_K:
            raise ValueError(
                f"micro-batch supports at most {MAX_K} dense rows")
        req = _Request(rows=list(dense_rows), sparse={
            "needles": needles, "nlens": needle_lens, "store": text_store,
            "idf": idf, "extra": extra,
            "vbound": C if vbound is None else int(vbound)})
        key = ("fusedv", id(text_store), C, needles.shape[0],
               limit_b, descending, score_mode, nonoverlap,
               round(k1, 6), round(b, 6), round(avgdl, 3), require_match,
               tuple(id(x) for x in extra))
        self._enqueue(key, req)
        if req.clipped:
            return None
        return req.total, req.ids, req.scores, req.pre

    def submit_fused_sparse_verify(self, d_off: int, d_len: int,
                                   sp_off, sp_len, sp_inv, dn_rows, dn_inv,
                                   needles, needle_lens, text_store,
                                   C: int, Cmax: int, limit_b: int,
                                   descending: bool, Kv: int = 0,
                                   maxT: int = 0, score_mode: bool = False,
                                   idf=None, k1: float = 1.2,
                                   b: float = 0.75, avgdl: float = 1.0,
                                   nonoverlap: bool = False,
                                   require_match: bool = True,
                                   force_probes: bool = False,
                                   extra=()):
        """Blocking submit of a sparse-driver fused verified search.
        extra: shared EQ-filter word rows (grouped by identity). Returns
        (total, ids, scores, pre) or None when the match set exceeded
        the verify compaction width Kv (caller re-runs exact)."""
        req = _Request(rows=[], sparse={
            "d_off": d_off, "d_len": d_len, "sp_off": sp_off,
            "sp_len": sp_len, "sp_inv": sp_inv, "dn_rows": dn_rows,
            "dn_inv": dn_inv, "needles": needles, "nlens": needle_lens,
            "store": text_store, "idf": idf, "extra": extra})
        Kv = Kv or min(C, 4096)
        maxT = maxT or text_store.maxT
        key = ("fusedsv", id(text_store), C, Cmax, len(sp_off),
               len(dn_rows), needles.shape[0], limit_b, descending,
               Kv, maxT, score_mode, nonoverlap,
               round(k1, 6), round(b, 6), round(avgdl, 3),
               require_match, force_probes,
               tuple(id(x) for x in extra))
        self._enqueue(key, req)
        if req.clipped:
            return None
        return req.total, req.ids, req.scores, req.pre

    def submit_positional(self, plan: dict, n: int, descending: bool,
                          score_mode: bool = False, idf: float = 0.0,
                          k1: float = 1.2, b: float = 0.75,
                          avgdl: float = 1.0, require_match: bool = True,
                          use_doc_probes: bool = False, extra=()):
        """Blocking submit of a positional verified search. Queries batch
        with peers sharing the plan's shape-bucket tuple and filter
        identity. Returns (total, ids, scores, pre) — never clips."""
        req = _Request(rows=[], sparse={"plan": plan, "idf": idf,
                                        "extra": extra})
        key = ("pos", plan["C"], plan["Co"], plan["C2"], plan["Co2"],
               plan["G"], n, descending, score_mode, require_match,
               use_doc_probes, round(k1, 6), round(b, 6),
               round(avgdl, 3), tuple(id(x) for x in extra))
        self._enqueue(key, req)
        return req.total, req.ids, req.scores, req.pre

    def submit_sparse(self, d_off: int, d_len: int,
                      sp_off: List[int], sp_len: List[int],
                      sp_inv: List[bool],
                      dn_rows: List[int], dn_inv: List[bool],
                      C: int, Cmax: int, limit_b: int,
                      descending: bool, extra=()) -> Tuple[int, np.ndarray]:
        """Blocking submit of a sparse candidate-probe query. Probe arrays
        must already be padded to their Ks/Kd buckets by the caller.
        extra: shared AND-filter rows (grouped by identity, see submit)."""
        req = _Request(rows=[], sparse={
            "d_off": d_off, "d_len": d_len, "sp_off": sp_off,
            "sp_len": sp_len, "sp_inv": sp_inv, "dn_rows": dn_rows,
            "dn_inv": dn_inv, "extra": extra})
        # covered-exact shape: nothing to probe — batch with peers on the
        # probe-free program (the no-op probe stages cost real gathers)
        probe_free = (all(not l for l in sp_len)
                      and all(r == self.idx.ones_row and not i
                              for r, i in zip(dn_rows, dn_inv)))
        key = ("sparse", C, Cmax, len(sp_off), len(dn_rows),
               limit_b, descending, probe_free,
               tuple(id(x) for x in extra))
        self._enqueue(key, req)
        return req.total, req.ids

    # ------------------------------------------------------------------
    def _flush(self, key: tuple, cause: str) -> None:
        """Run the batch queued under key, if any; cause: why now
        (``full``, ``window`` or ``late``)."""
        with self._lock:
            q = self._queues.pop(key, [])
        if not q:
            return
        t_pop = trace.clock()
        try:
            if trace.enabled:
                attrs = {"family": key[0], "b": len(q), "cause": cause}
                me = threading.get_ident()
                for r in q:
                    r.flusher = me
                    trace.record("batcher.queue", r.t_in, t_pop, r.rid,
                                 r.parent, attrs)
                with trace.span("batcher.execute",
                                rids=[r.rid for r in q], **attrs):
                    self._execute(q, key)
            else:
                self._execute(q, key)
        except BaseException as e:  # noqa: BLE001 — propagate to waiters
            for r in q:
                r.error = e
                r.set_at = trace.clock()
                r.event.set()
            return
        with self._lock:
            self.batches_executed += 1
            self.queries_batched += len(q)
            self.flushes[cause] += 1
            self.queue_wait_s += sum(t_pop - r.t_in for r in q)
            self._fold_wakes()

    def _fold_wakes(self) -> None:
        """Add the wake-ups appended since into wake_s (under _lock: the
        only place the deque is popped)."""
        woke = self._woke
        while woke:
            self.wake_s += woke.popleft()

    def _execute(self, q: List[_Request], key: tuple) -> None:
        if key[0] == "dense":
            self._execute_dense(q, key[1], key[2])
        elif key[0] == "fusedv":
            self._execute_fused_verify(q, key)
        elif key[0] == "fusedsv":
            self._execute_fused_sparse_verify(q, key)
        elif key[0] == "pos":
            self._execute_positional(q, key)
        else:
            self._execute_sparse(q, key)

    def _extra(self, q: List[_Request]):
        """The batch's filter rows (identical across it: grouped by
        identity in the queue key) stacked on the device, or None."""
        rows = list((q[0].sparse or {}).get("extra", ()))
        return self.idx._pack_extra(rows) if rows else None

    def _finish(self, q: List[_Request], pre, count, ids, scores,
                width: int, clipped=None) -> None:
        """Hand each waiter its row; a query clipped when its pre passed
        ``width`` (or, on a mesh, where ``clipped`` says a shard did)."""
        for i, r in enumerate(q):
            r.clipped = (int(pre[i]) > width if clipped is None
                         else bool(clipped[i]))
            r.pre = int(pre[i])
            r.total = int(count[i])
            r.ids = ids[i]
            r.scores = scores[i] if scores is not None else None
            r.set_at = trace.clock()
            r.event.set()

    def _execute_dense(self, q: List[_Request], limit_b: int,
                       descending: bool) -> None:
        idx = self.idx
        ph = trace.phases() if trace.enabled else None
        K = max(len(r.rows) for r in q)
        rows = np.full((len(q), K), idx.ones_row, dtype=np.int32)
        for i, r in enumerate(q):
            rows[i, :len(r.rows)] = r.rows
        if ph is not None:
            ph.end("batcher.pack")
        extra = self._extra(q)
        if idx.mesh is not None:
            runtime.dispatches.bump()
            out = pmesh.dense_topn(idx.mesh.docs_devices, idx.bitmaps,
                                   idx.deleted, rows, None, extra, limit_b,
                                   descending, idx.shard_docs)
            count_np, ids_np = out[:, 0], out[:, 1:]
            if ph is not None:
                ph.end("ops.launch", kernel="mesh_dense", pull="inside")
            runtime.count_route("mesh_dense", len(q))
        else:
            nrows = np.full((len(q), 1), idx.zeros_row, dtype=np.int32)
            rows_d = runtime.to_device(rows, idx._device)
            nrows_d = runtime.to_device(nrows, idx._device)
            if ph is not None:
                ph.end("ops.upload")
            count_np, ids_np = bitmap_ops.dense_search_topn_packed(
                idx.bitmaps, rows_d, nrows_d, idx.deleted,
                idx._pack_extra([]) if extra is None else extra, False,
                extra is not None, limit_b, descending)
            if ph is not None:
                ph.end("ops.launch", kernel="dense_and", pull="inside")
            runtime.count_route("dense_batched", len(q))
        for i, r in enumerate(q):
            r.total = int(count_np[i])
            r.ids = ids_np[i]
            r.set_at = trace.clock()
            r.event.set()

    def _execute_fused_verify(self, q: List[_Request], key: tuple) -> None:
        from ..ops import fused as fused_ops
        from ..ops.verify_ops import NEEDLE_CAP
        idx = self.idx
        (_, _sid, C, Nn, limit_b, descending, score_mode, nonoverlap,
         k1, b_, avgdl, require_match, _extra_ids) = key
        store = q[0].sparse["store"]
        B = len(q)
        ph = trace.phases() if trace.enabled else None
        K = 8 if max(len(r.rows) for r in q) <= 8 else MAX_K
        rows = np.full((B, K), idx.ones_row, dtype=np.int32)
        ndl = np.zeros((B, Nn, NEEDLE_CAP), dtype=np.uint32)
        nlens = np.zeros((B, Nn), dtype=np.int32)
        idf = np.zeros((B, Nn), dtype=np.float32)
        for i, r in enumerate(q):
            rows[i, :len(r.rows)] = r.rows
            ndl[i] = r.sparse["needles"]
            nlens[i] = r.sparse["nlens"]
            if r.sparse.get("idf") is not None:
                idf[i] = r.sparse["idf"]
        if ph is not None:
            ph.end("batcher.pack")
        if idx.mesh is not None:
            pre, clipped, count, ids, scores = pmesh.split_fused(
                pmesh.sharded_dense_fused_verify(
                    idx.mesh, idx.bitmaps, idx.deleted, store, rows, ndl,
                    nlens, self._extra(q), C=C, n=limit_b, maxT=store.maxT,
                    descending=descending, shard_docs=idx.shard_docs,
                    score_mode=score_mode, require_match=require_match,
                    idf=idf, k1=k1, b=b_, avgdl=avgdl,
                    nonoverlap=nonoverlap), limit_b, score_mode)
            if ph is not None:
                ph.end("ops.launch", kernel="mesh_fused_dense",
                       pull="inside")
            # a query clips when one of its shards passed C
            self._finish(q, pre, count, ids, scores, C, clipped=clipped)
            return
        out = fused_ops.search_verify_topn_batch(
            idx.bitmaps, runtime.to_device(rows, idx._device), idx.deleted,
            self._extra(q), store, C, limit_b, ndl, nlens,
            descending=descending, idf=idf, k1=k1, b=b_, avgdl=avgdl,
            score_mode=score_mode, nonoverlap=nonoverlap,
            require_match=require_match,
            vbound=sum(r.sparse.get("vbound", C) for r in q))
        if ph is not None:
            ph.end("ops.launch", kernel="fused_dense", pull="inside")
        self._finish(q, out[0], out[1], out[2],
                     out[3] if score_mode else None, C)

    def _execute_fused_sparse_verify(self, q: List[_Request],
                                     key: tuple) -> None:
        from ..ops import fused as fused_ops
        from ..ops.verify_ops import NEEDLE_CAP
        idx = self.idx
        (_, _sid, C, Cmax, Ks, Kd, Nn, limit_b, descending, Kv, maxT,
         score_mode, nonoverlap, k1, b_, avgdl, require_match,
         force_probes, _extra_ids) = key
        store = q[0].sparse["store"]
        B = len(q)
        ph = trace.phases() if trace.enabled else None
        d_off = np.zeros(B, dtype=np.int64)
        d_len = np.zeros(B, dtype=np.int64)
        sp_off = np.zeros((B, Ks), dtype=np.int64)
        sp_len = np.zeros((B, Ks), dtype=np.int64)
        sp_inv = np.ones((B, Ks), dtype=bool)
        dn_rows = np.full((B, Kd), idx.ones_row, dtype=np.int32)
        dn_inv = np.zeros((B, Kd), dtype=bool)
        ndl = np.zeros((B, Nn, NEEDLE_CAP), dtype=np.uint32)
        nlens = np.zeros((B, Nn), dtype=np.int32)
        idf = np.zeros((B, Nn), dtype=np.float32)
        for i, r in enumerate(q):
            s = r.sparse
            d_off[i] = s["d_off"]
            d_len[i] = s["d_len"]
            sp_off[i] = s["sp_off"]
            sp_len[i] = s["sp_len"]
            sp_inv[i] = s["sp_inv"]
            dn_rows[i] = s["dn_rows"]
            dn_inv[i] = s["dn_inv"]
            ndl[i] = s["needles"]
            nlens[i] = s["nlens"]
            if s.get("idf") is not None:
                idf[i] = s["idf"]
        if ph is not None:
            ph.end("batcher.pack")
        out = fused_ops.sparse_search_verify_topn_batch(
            idx.postings, idx.bitmaps, idx.deleted,
            d_off, d_len, sp_off, sp_len, sp_inv, dn_rows, dn_inv,
            store, C, Cmax, limit_b, ndl, nlens, idx.n_words,
            descending, Kv=Kv, maxT=maxT, idf=idf, k1=k1, b=b_,
            avgdl=avgdl, score_mode=score_mode, nonoverlap=nonoverlap,
            # needles cover every gram, so a verify that filters subsumes
            # the probes — unless the caller needs pre = exact AND count
            # (score df); one that does not filter probes every gram
            use_dense_probes=force_probes,
            require_match=require_match, extra=self._extra(q))
        if ph is not None:
            ph.end("ops.launch", kernel="fused_sparse", pull="inside")
        self.sparse_batches += 1
        self._finish(q, out[0], out[1], out[2],
                     out[3] if score_mode else None, Kv)

    def _execute_sparse(self, q: List[_Request], key: tuple) -> None:
        from ..ops.posting_ops import pack_sparse_args, sparse_probe
        idx = self.idx
        _, C, Cmax, Ks, Kd, limit_b, descending, probe_free, _eids = key
        B = len(q)
        ph = trace.phases() if trace.enabled else None
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
        packed = pack_sparse_args(d_off, d_len, sp_off, sp_len, sp_inv,
                                  dn_rows, dn_inv)
        if ph is not None:
            ph.end("batcher.pack")
        runtime.dispatches.bump()
        # one upload of the batch's arguments, one launch, one pull
        extra = self._extra(q)
        args = runtime.to_device(packed, idx._device)
        if ph is not None:
            ph.end("ops.upload")
        out = sparse_probe(
            idx.postings, idx.bitmaps, idx.deleted, extra, args, Ks=Ks,
            Kd=Kd, C=C, Cmax=Cmax, n_words=idx.n_words, form="topn",
            width=limit_b, descending=descending,
            sparse_probes=not probe_free, dense_probes=not probe_free)
        if ph is not None:
            ph.end("ops.launch", kernel="sparse_probe")
        out = out.cpu().numpy()
        if ph is not None:
            ph.end("ops.pull")
        self.sparse_batches += 1
        runtime.count_route("sparse_batched", B)
        for i, r in enumerate(q):
            r.total = int(out[i, 0])
            r.ids = out[i, 1:]
            r.set_at = trace.clock()
            r.event.set()

    def _execute_positional(self, q: List[_Request], key: tuple) -> None:
        from ..ops.positional_ops import positional_verify_batch
        idx = self.idx
        (_, _C, _Co, _C2, _Co2, _G, n, descending, score_mode,
         require_match, use_doc_probes, k1, b_, avgdl, _eids) = key
        pp = idx.positional
        ph = trace.phases() if trace.enabled else None
        idf = np.asarray([[r.sparse.get("idf") or 0.0] for r in q],
                         dtype=np.float32)
        if ph is not None:
            ph.end("batcher.pack")
        out = positional_verify_batch(
            idx.postings, pp.occ_doc, pp.occ_pos, idx.deleted, pp.doc_len,
            [r.sparse["plan"] for r in q], n, idx.n_words, descending,
            score_mode=score_mode, idf=idf, k1=k1, b=b_, avgdl=avgdl,
            require_match=require_match, use_doc_probes=use_doc_probes,
            extra=self._extra(q))
        if ph is not None:
            ph.end("ops.launch", kernel="positional", pull="inside")
        # the positional program never clips
        self._finish(q, out[0], out[1], out[2],
                     out[3] if score_mode else None, 0,
                     clipped=np.zeros(len(q), dtype=bool))

    # ------------------------------------------------------------------
    def counters(self) -> Dict[str, float]:
        """The batcher's counters, read together under its lock."""
        with self._lock:
            self._fold_wakes()
            out = {"batches_executed": self.batches_executed,
                   "queries_batched": self.queries_batched,
                   "sparse_batches": self.sparse_batches,
                   "queue_wait_s": self.queue_wait_s,
                   "wake_s": self.wake_s}
            out.update({f"flushes_{k}": v for k, v in self.flushes.items()})
        return out
