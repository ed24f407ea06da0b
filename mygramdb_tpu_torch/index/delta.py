"""Mutable index = immutable device segment + host delta overlay.

The reference mutates hash-map posting lists per binlog event
(index.cpp:38-166). HBM tensors want batch rebuilds instead, so mutation is
split (SURVEY.md §7.5):

- ``DeltaSegment`` (host): postings/doc-term sets for documents added or
  updated since the last compaction, plus tombstones.
- ``DeviceIndex`` (device): the compiled segment; deletes/updates of
  device-resident docs only flip its tombstone bitmap.
- ``MutableIndex``: facade with the reference Index API (AddDocument /
  UpdateDocument / RemoveDocument / SearchAnd / SearchOr / SearchNot /
  SearchByThreshold / FilterByNgrams / Optimize). Queries run on device and
  the (small) delta is merged host-side; ``optimize()`` compacts the delta
  into a fresh device segment.

The port's copy differs from the JAX package's in one way: where it holds
a list of grams it resolves them in one call to the term dictionary
(``lookup_many``, ``get_or_add_many``), which is the native term table.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..utils import trace
from .builder import BuiltIndex, IndexBuilder
from .device_index import DeviceIndex, SearchOptions
from .term_dict import TermDict


class DeltaSegment:
    """Host-side postings for post-compaction documents."""

    def __init__(self) -> None:
        self.doc_terms: Dict[int, Set[int]] = {}
        self.term_docs: Dict[int, Set[int]] = {}

    def __len__(self) -> int:
        return len(self.doc_terms)

    def add(self, doc_id: int, tids: Set[int]) -> None:
        self.doc_terms[doc_id] = tids
        for t in tids:
            self.term_docs.setdefault(t, set()).add(doc_id)

    def remove(self, doc_id: int) -> bool:
        tids = self.doc_terms.pop(doc_id, None)
        if tids is None:
            return False
        for t in tids:
            docs = self.term_docs.get(t)
            if docs is not None:
                docs.discard(doc_id)
                if not docs:
                    del self.term_docs[t]
        return True

    def docs_with_all(self, tids: Sequence[int]) -> Set[int]:
        """Docs containing every term (AND semantics)."""
        if not tids:
            return set()
        sets = []
        for t in tids:
            s = self.term_docs.get(t)
            if not s:
                return set()
            sets.append(s)
        sets.sort(key=len)
        out = set(sets[0])
        for s in sets[1:]:
            out &= s
            if not out:
                break
        return out

    def docs_with_any(self, tids: Sequence[int]) -> Set[int]:
        out: Set[int] = set()
        for t in tids:
            out |= self.term_docs.get(t, set())
        return out

    def count_terms_per_doc(self, tids: Sequence[int]) -> Dict[int, int]:
        counts: Dict[int, int] = {}
        for t in tids:
            for d in self.term_docs.get(t, ()):
                counts[d] = counts.get(d, 0) + 1
        return counts


class MutableIndex:
    """Reference-compatible Index facade over DeviceIndex + DeltaSegment."""

    def __init__(self, built: Optional[BuiltIndex] = None,
                 ngram_size: int = 2, kanji_ngram_size: int = 1,
                 cross_boundary_ngrams: bool = True,
                 kanji_extra_ngram: int = 0,
                 dense_df_ratio: float = 0.01, max_dense_terms: int = 8192,
                 candidate_buckets=(2048, 65536),
                 microbatch: Optional[Tuple[int, int]] = None,
                 mesh_shards: int = 1, collect_positions: bool = False,
                 text_provider=None):
        self.ngram_size = ngram_size
        self.kanji_ngram_size = kanji_ngram_size
        self.cross_boundary = cross_boundary_ngrams
        self.kanji_extra_ngram = kanji_extra_ngram
        # positional lifecycle: when the table runs with
        # device.positional_verify, optimize() re-derives the occurrence
        # index for the compacted segment — surviving device occurrences
        # are expanded from the old segment and delta docs re-shredded
        # with positions via text_provider (doc id -> normalized text, the
        # catalog's doc_store read-through). Without it the positional
        # index would silently vanish at the first compaction and the
        # verified fast path would fall back to text-window scans.
        self._collect_positions = collect_positions
        self._text_provider = text_provider
        self._dense_df_ratio = dense_df_ratio
        self._max_dense_terms = max_dense_terms
        self._candidate_buckets = candidate_buckets
        self._microbatch = microbatch
        self._mesh_shards = mesh_shards
        if built is None:
            built = IndexBuilder(ngram_size, kanji_ngram_size,
                                 cross_boundary_ngrams,
                                 kanji_extra_ngram=kanji_extra_ngram
                                 ).finalize()
        self._lock = threading.RLock()
        self._optimize_lock = threading.Lock()  # serializes optimize() calls
        self._install(built)
        self.delta = DeltaSegment()
        # delta being compacted by an in-flight optimize(): consulted
        # read-only by queries, never mutated (overrides/tombstones shadow it)
        self.frozen_delta: Optional[DeltaSegment] = None
        self.frozen_overrides: Set[int] = set()  # frozen docs re-added live
        self.tombstones: Set[int] = set()  # all deleted doc ids (authoritative)
        self._n_docs = built.n_docs
        self.version = 0  # bumped on every mutation (optimize concurrency)

    def _build_device(self, built: BuiltIndex) -> DeviceIndex:
        with trace.stage("build.device", what="index"):
            device = DeviceIndex(
                built, dense_df_ratio=self._dense_df_ratio,
                max_dense_terms=self._max_dense_terms,
                candidate_buckets=self._candidate_buckets,
                mesh_shards=self._mesh_shards)
        if self._microbatch is not None:
            from ..server.microbatch import MicroBatcher
            max_batch, window_us = self._microbatch
            device.batcher = MicroBatcher(device, max_batch, window_us)
        return device

    def _install(self, built: BuiltIndex,
                 device: Optional[DeviceIndex] = None) -> None:
        self.built = built
        self.term_dict = built.term_dict
        self.device = device if device is not None \
            else self._build_device(built)
        self._device_v = built.n_terms
        self._device_doc_max = built.max_doc_id
        # bumped on every device-segment swap (optimize/restore): consumers
        # holding derived device state (packed text store) must match this
        # or re-derive — a stale pack silently drops verify matches
        self.built_generation = getattr(self, "built_generation", -1) + 1

    # ------------------------------------------------------------------
    # Shredding
    # ------------------------------------------------------------------
    def shred(self, normalized_text: str) -> List[str]:
        from ..utils import textproc
        return textproc.generate_query_ngrams(
            normalized_text, self.ngram_size, self.kanji_ngram_size,
            self.cross_boundary, kanji_extra=self.kanji_extra_ngram)

    def query_tids(self, grams: Sequence[str]) -> Optional[List[int]]:
        """Term ids for query grams; None if any gram is unknown (=> empty)."""
        out = self.term_dict.lookup_many(grams)
        return None if None in out else out

    # ------------------------------------------------------------------
    # Mutation (binlog / SYNC path)
    # ------------------------------------------------------------------
    def add_document(self, doc_id: int, normalized_text: str) -> None:
        """Upsert: insert-or-replace (reference INSERT has insert-or-ignore
        at the DocumentStore level; the processor routes duplicates to
        update, so upsert here is safe for both)."""
        with self._lock:
            existed = self._remove_locked(doc_id)
            grams = set(self.shred(normalized_text))
            tids = set(self.term_dict.get_or_add_many(list(grams)))
            self.delta.add(doc_id, tids)
            if self.frozen_delta is not None and \
                    doc_id in self.frozen_delta.doc_terms:
                self.frozen_overrides.add(doc_id)
            self.tombstones.discard(doc_id)
            if not existed:
                self._n_docs += 1
            self.version += 1

    def update_document(self, doc_id: int, normalized_text: str) -> None:
        self.add_document(doc_id, normalized_text)

    def remove_document(self, doc_id: int) -> bool:
        with self._lock:
            existed = self._remove_locked(doc_id)
            if existed:
                self.tombstones.add(doc_id)
                self._n_docs -= 1
                self.version += 1
            return existed

    def _remove_locked(self, doc_id: int) -> bool:
        in_delta = self.delta.remove(doc_id)
        in_frozen = (self.frozen_delta is not None
                     and doc_id in self.frozen_delta.doc_terms
                     and doc_id not in self.frozen_overrides
                     and doc_id not in self.tombstones)
        on_device = (doc_id <= self._device_doc_max
                     and doc_id not in self.tombstones)
        if on_device:
            self.device.mark_deleted([doc_id])
        if in_delta and doc_id <= self._device_doc_max:
            return True
        return in_delta or on_device or in_frozen

    def clear(self) -> None:
        with self._lock:
            builder = IndexBuilder(self.ngram_size, self.kanji_ngram_size,
                                   self.cross_boundary,
                                   kanji_extra_ngram=self.kanji_extra_ngram)
            self._install(builder.finalize())
            self.delta = DeltaSegment()
            self.frozen_delta = None
            self.frozen_overrides = set()
            self.tombstones = set()
            self._n_docs = 0
            self.version += 1

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------
    def _split_tids(self, tids: Sequence[int]) -> Tuple[List[int], List[int]]:
        dev = [t for t in tids if t < self._device_v]
        return dev, list(tids)

    def search_and(self, grams: Sequence[str], not_grams: Sequence[str] = (),
                   extra_words=None, limit: int = 0, descending: bool = True,
                   delta_filter: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                   count_only: bool = False,
                   ) -> Tuple[int, np.ndarray]:
        """AND search. Returns (total, ids). ids = top-limit in doc-id order
        when limit>0, else all matches ascending."""
        tids = self.query_tids(grams)
        if tids is None or not tids:
            return 0, np.empty(0, dtype=np.int32)
        not_tids = [t for t in self.term_dict.lookup_many(not_grams)
                    if t is not None]

        # Snapshot under the lock (device segments are immutable; optimize
        # swaps the reference), then run the device query OUTSIDE the lock so
        # concurrent queries overlap on the device (the reference gets the
        # same effect from RCU posting snapshots, index.cpp:628-647).
        with self._lock:
            device = self.device
            device_v = self._device_v
            dev_ok = all(t < device_v for t in tids)
            delta_ids = self._delta_and(tids, not_tids)
        if dev_ok:
            dev_not = [t for t in not_tids if t < device_v]
            total_dev, ids_dev = device.search_and(
                tids, dev_not, extra_words,
                SearchOptions(limit=limit, descending=descending,
                              count_only=count_only))
        else:
            total_dev, ids_dev = 0, np.empty(0, dtype=np.int32)
        if delta_ids.size and delta_filter is not None:
            delta_ids = delta_filter(delta_ids)
        return self._merge(total_dev, ids_dev, delta_ids, limit, descending)

    def _delta_and(self, tids, not_tids) -> np.ndarray:
        """AND over the live delta plus (if an optimize is in flight) the
        frozen delta, with live overrides/tombstones shadowing frozen docs.
        Caller holds self._lock."""
        docs = self.delta.docs_with_all(tids)
        if self.frozen_delta is not None:
            fdocs = self.frozen_delta.docs_with_all(tids)
            if fdocs:
                fdocs = fdocs - self.frozen_overrides - self.tombstones
                docs = docs | fdocs
        if not docs:
            return np.empty(0, dtype=np.int32)
        if not_tids:
            bad = self.delta.docs_with_any(not_tids)
            if self.frozen_delta is not None:
                bad = bad | (self.frozen_delta.docs_with_any(not_tids)
                             - self.frozen_overrides)
            docs = docs - bad
            # delta docs' term sets are complete, so delta membership alone
            # decides NOT exclusion for delta-resident docs.
        return np.asarray(sorted(docs), dtype=np.int32)

    def _merge(self, total_dev: int, ids_dev: np.ndarray,
               delta_ids: np.ndarray, limit: int,
               descending: bool) -> Tuple[int, np.ndarray]:
        total = total_dev + int(delta_ids.size)
        if delta_ids.size == 0:
            return total, ids_dev
        if limit > 0:
            merged = np.union1d(ids_dev, delta_ids)
            merged = merged[::-1] if descending else merged
            return total, merged[:limit].astype(np.int32)
        return total, np.union1d(ids_dev, delta_ids).astype(np.int32)

    def search_or(self, grams: Sequence[str]) -> np.ndarray:
        tids = [t for t in self.term_dict.lookup_many(grams)
                if t is not None]
        if not tids:
            return np.empty(0, dtype=np.int32)
        with self._lock:
            device = self.device
            device_v = self._device_v
            delta_docs = self.delta.docs_with_any(tids)
            if self.frozen_delta is not None:
                delta_docs = delta_docs | (
                    self.frozen_delta.docs_with_any(tids)
                    - self.frozen_overrides - self.tombstones)
        dev = device.search_or([t for t in tids if t < device_v])
        if self.tombstones:
            dev = dev[~np.isin(dev, np.asarray(list(self.tombstones)))] \
                if dev.size else dev
        if delta_docs:
            return np.union1d(dev, np.asarray(sorted(delta_docs),
                                              dtype=np.int32)).astype(np.int32)
        return dev.astype(np.int32)

    def search_not(self, base_ids: np.ndarray,
                   not_grams: Sequence[str]) -> np.ndarray:
        """base minus docs containing any NOT gram (boolean-AST NOT)."""
        bad = self.search_or(not_grams)
        if bad.size == 0 or base_ids.size == 0:
            return base_ids
        return base_ids[~np.isin(base_ids, bad)]

    def search_by_threshold(self, grams: Sequence[str], min_count: int,
                            max_out: int = 131072) -> np.ndarray:
        tids = [t for t in self.term_dict.lookup_many(grams)
                if t is not None]
        if not tids:
            return np.empty(0, dtype=np.int32)
        with self._lock:
            device = self.device
            device_v = self._device_v
            counts = self.delta.count_terms_per_doc(tids)
            if self.frozen_delta is not None:
                live = self.delta.doc_terms
                for d, c in self.frozen_delta.count_terms_per_doc(
                        tids).items():
                    if d not in self.frozen_overrides and \
                            d not in self.tombstones and d not in live:
                        counts[d] = c
        dev_tids = [t for t in tids if t < device_v]
        dev = (device.search_by_threshold(dev_tids, min_count, max_out)
               if dev_tids else np.empty(0, dtype=np.int32))
        delta_ids = np.asarray(sorted(d for d, c in counts.items()
                                      if c >= min_count), dtype=np.int32)
        if self.tombstones and dev.size:
            dev = dev[~np.isin(dev, np.asarray(list(self.tombstones)))]
        return np.union1d(dev, delta_ids).astype(np.int32)

    def filter_by_ngrams(self, candidates: np.ndarray,
                         grams: Sequence[str]) -> np.ndarray:
        tids = self.query_tids(list(grams))
        if tids is None:
            return np.empty(0, dtype=np.int32)
        if candidates.size == 0:
            return candidates
        delta_mask = candidates > self._device_doc_max
        dev_part = candidates[~delta_mask]
        delta_part = candidates[delta_mask]
        # also: device-resident docs that were updated live in delta
        out_parts = []
        if dev_part.size:
            frozen = self.frozen_delta
            updated = np.asarray(
                [d for d in dev_part if d in self.delta.doc_terms
                 or (frozen is not None and d in frozen.doc_terms)],
                dtype=np.int32)
            pure_dev = dev_part[~np.isin(dev_part, updated)] \
                if updated.size else dev_part
            dev_tids = [t for t in tids if t < self._device_v]
            if len(dev_tids) == len(tids):
                out_parts.append(self.device.filter_by_ngrams(pure_dev, tids))
            if updated.size:
                out_parts.append(self._delta_probe(updated, tids))
        if delta_part.size:
            out_parts.append(self._delta_probe(delta_part, tids))
        if not out_parts:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(out_parts).astype(np.int32)

    def _delta_probe(self, ids: np.ndarray, tids) -> np.ndarray:
        tid_set = set(tids)
        frozen = self.frozen_delta
        keep = []
        for d in ids.tolist():
            d = int(d)
            ts = self.delta.doc_terms.get(d)
            if ts is None and frozen is not None and \
                    d not in self.frozen_overrides and \
                    d not in self.tombstones:
                ts = frozen.doc_terms.get(d)
            if ts is not None and tid_set <= ts:
                keep.append(d)
        return np.asarray(keep, dtype=np.int32)

    # ------------------------------------------------------------------
    # Maintenance
    # ------------------------------------------------------------------
    def optimize(self) -> None:
        """Compact delta + tombstones into a fresh device segment WITHOUT
        stalling queries (reference Index::OptimizeInBatches clone/convert/
        validate pattern, index_optimization.cpp:36-80).

        The expensive work — full lexsort merge, host bitmap build, HBM
        upload — runs OUTSIDE the index lock against a frozen snapshot of
        the delta. Queries keep flowing throughout: they consult the
        frozen delta read-only (overrides/tombstones shadow it), while new
        writes land in a fresh live delta. The swap at the end re-acquires
        the lock briefly and re-marks device tombstones for docs mutated
        during the build (the standing immutable-segment invariant)."""
        with self._optimize_lock:
            # --- snapshot (brief lock) ---
            with self._lock:
                built = self.built
                V = len(self.term_dict)
                frozen = self.delta
                self.frozen_delta = frozen
                self.frozen_overrides = set()
                self.delta = DeltaSegment()
                tombs_at_snap = set(self.tombstones)
                n_docs_snap = self._n_docs
                device_doc_max = self._device_doc_max

            # --- build (NO lock held; queries keep flowing) ---
            try:
                self._optimize_build_and_swap(
                    built, V, frozen, tombs_at_snap, n_docs_snap,
                    device_doc_max)
            except BaseException:
                # device build/upload failed: merge the frozen delta back
                # into the live one so its docs aren't lost when a later
                # optimize() re-snapshots (reference one-shot failure
                # semantics, posting_list.h:205-219 — a failed op must
                # leave the index serving and complete). Newer writes and
                # deletes since the snapshot win.
                with self._lock:
                    live = self.delta
                    for d, ts in frozen.doc_terms.items():
                        if d in live.doc_terms or \
                                d in self.frozen_overrides or \
                                d in self.tombstones:
                            continue
                        live.add(d, ts)
                    self.frozen_delta = None
                    self.frozen_overrides = set()
                raise

    def _optimize_build_and_swap(self, built, V, frozen, tombs_at_snap,
                                 n_docs_snap, device_doc_max) -> None:
            dead = set(tombs_at_snap)
            dead.update(d for d in frozen.doc_terms if d <= device_doc_max)
            new_built = None
            if self._collect_positions and self._text_provider is not None \
                    and (built.positional is not None
                         or built.postings.size == 0):
                new_built = self._compact_with_positions(
                    built, frozen, tombs_at_snap, dead, n_docs_snap)
            if new_built is None:
                tids_rep = np.repeat(
                    np.arange(built.lengths.shape[0], dtype=np.int64),
                    built.lengths)
                docs = built.postings.astype(np.int64)
                if dead:
                    dead_arr = np.asarray(sorted(dead), dtype=np.int64)
                    keep = ~np.isin(docs, dead_arr)
                    tids_rep = tids_rep[keep]
                    docs = docs[keep]
                extra_t: List[int] = []
                extra_d: List[int] = []
                for d, ts in frozen.doc_terms.items():
                    if d in tombs_at_snap:
                        continue
                    extra_t.extend(ts)
                    extra_d.extend([d] * len(ts))
                if extra_t:
                    tids_rep = np.concatenate(
                        [tids_rep, np.asarray(extra_t, dtype=np.int64)])
                    docs = np.concatenate(
                        [docs, np.asarray(extra_d, dtype=np.int64)])
                order = np.lexsort((docs, tids_rep))
                tids_rep = tids_rep[order]
                docs = docs[order]
                lengths = np.bincount(tids_rep, minlength=V).astype(np.int32)
                offsets = np.zeros(V, dtype=np.int64)
                np.cumsum(lengths[:-1], out=offsets[1:])
                max_doc = int(docs.max()) if docs.size else 0
                new_built = BuiltIndex(self.term_dict, offsets, lengths,
                                       docs.astype(np.int32), max_doc,
                                       n_docs_snap)
            new_device = self._build_device(new_built)

            # --- swap (brief lock) + fixup for concurrent mutations ---
            with self._lock:
                self._install(new_built, new_device)
                self.frozen_delta = None
                self.frozen_overrides = set()
                # pre-snapshot tombstones were baked out of the segment
                self.tombstones -= tombs_at_snap
                # docs mutated DURING the build: deletes since the snapshot
                # plus re-added docs now living in the live delta must be
                # tombstoned on the new device segment
                fix = {d for d in self.tombstones if d <= max_doc}
                fix |= {d for d in self.delta.doc_terms if d <= max_doc}
                if fix:
                    self.device.mark_deleted(sorted(fix))
                # self._n_docs stays live-maintained by add/remove
                self.version += 1

    def _compact_with_positions(self, built, frozen, tombs_at_snap,
                                dead, n_docs_snap):
        """Occurrence-stream compaction: the positional analog of the
        (term, doc) pair merge. Surviving device occurrences are expanded
        from the old segment's aligned regions (vectorized, same
        addressing as DevicePositional), delta docs are re-shredded WITH
        positions from their stored normalized text, and one positional
        finalize emits both the deduped CSR and the new occurrence index.
        Returns None (-> plain pair merge, positional dropped) when any
        delta doc's text is unavailable. Transient cost is O(occurrences)
        host memory — the same class as the initial positional build."""
        from .positional import POS_CAP, finalize_with_positions_np
        from ..utils import textproc
        pp = built.positional
        # --- delta docs: re-shred with positions ---
        dt: List[int] = []
        dd: List[int] = []
        dp: List[int] = []
        over_new: set = set()
        get_or_add_many = self.term_dict.get_or_add_many
        for d, _ts in frozen.doc_terms.items():
            if d in tombs_at_snap:
                continue
            text = self._text_provider(d)
            if text is None:
                return None  # no text -> positions unrecoverable
            pairs, _cov = textproc.query_gram_offsets(
                text, self.ngram_size, self.kanji_ngram_size,
                self.cross_boundary, kanji_extra=self.kanji_extra_ngram)
            if pairs and pairs[-1][1] > POS_CAP:
                over_new.add(d)
            dt.extend(get_or_add_many([g for g, _ in pairs]))
            dd.extend([d] * len(pairs))
            dp.extend(min(o, POS_CAP) for _, o in pairs)
        # --- surviving device occurrences: expand aligned regions ---
        if pp is not None and built.postings.size:
            lengths64 = built.lengths.astype(np.int64)
            t_post = np.repeat(
                np.arange(built.lengths.shape[0], dtype=np.int64),
                lengths64)
            cnt64 = pp.occ_cnt.astype(np.int64)  # parallel to postings
            occ_prefix = np.cumsum(pp.occ_len) - pp.occ_len
            run = np.cumsum(cnt64) - cnt64       # global unaligned prefix
            start = pp.occ_base[t_post] + (run - occ_prefix[t_post])
            E = int(cnt64.sum())
            idx = np.repeat(start, cnt64) + (
                np.arange(E, dtype=np.int64) - np.repeat(run, cnt64))
            del start, run
            tids_occ = np.repeat(t_post, cnt64).astype(np.int32)
            del t_post
            docs_occ = np.repeat(built.postings, cnt64)
            pos_occ = pp.occ_pos[idx]
            del idx
            if dead:
                dead_arr = np.asarray(sorted(dead), dtype=np.int64)
                keep = ~np.isin(docs_occ, dead_arr)
                tids_occ = tids_occ[keep]
                docs_occ = docs_occ[keep]
                pos_occ = pos_occ[keep]
                del keep
        else:
            tids_occ = np.zeros(0, dtype=np.int32)
            docs_occ = np.zeros(0, dtype=np.int32)
            pos_occ = np.zeros(0, dtype=np.uint16)
        if dt:
            tids_occ = np.concatenate(
                [tids_occ, np.asarray(dt, dtype=np.int32)])
            docs_occ = np.concatenate(
                [docs_occ, np.asarray(dd, dtype=np.int32)])
            pos_occ = np.concatenate(
                [pos_occ, np.asarray(dp, dtype=np.uint16)])
        V2 = len(self.term_dict)  # >= snapshot V if the shred added grams
        postings, lengths, positional = finalize_with_positions_np(
            tids_occ, docs_occ, pos_occ, V2)
        positional.overflow_docs = \
            (set(pp.overflow_docs) - dead if pp is not None else set()) \
            | over_new
        offsets = np.zeros(V2, dtype=np.int64)
        np.cumsum(lengths[:-1], out=offsets[1:])
        max_doc = int(docs_occ.max()) if docs_occ.size else 0
        return BuiltIndex(self.term_dict, offsets, lengths, postings,
                          max_doc, n_docs_snap, positional)

    # ------------------------------------------------------------------
    def dirty_doc_ids(self):
        """Doc ids whose text may differ from the compacted device copies
        (live delta plus any delta frozen by an in-flight optimize) — the
        device text-verify/BM25 kernels must re-check these host-side."""
        if self.frozen_delta is None:
            return self.delta.doc_terms.keys()
        return self.delta.doc_terms.keys() | self.frozen_delta.doc_terms.keys()

    @property
    def n_docs(self) -> int:
        return self._n_docs

    @property
    def n_terms(self) -> int:
        return len(self.term_dict)

    def term_df(self, gram: str) -> int:
        """Document frequency incl. delta (approximate during delta phase)."""
        t = self.term_dict.get(gram)
        if t is None:
            return 0
        base = int(self.built.lengths[t]) if t < self._device_v else 0
        n = base + len(self.delta.term_docs.get(t, ()))
        if self.frozen_delta is not None:
            n += len(self.frozen_delta.term_docs.get(t, ()))
        return n

    def memory_usage(self) -> int:
        dev = self.device.memory_usage()
        host = self.built.postings.nbytes + self.built.offsets.nbytes
        return int(dev + host)
