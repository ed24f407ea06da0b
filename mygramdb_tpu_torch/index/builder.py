"""Sorted-segment index builder.

The TPU-native replacement for the reference's per-document hash-map inserts
(Index::AddDocumentBatch, index.cpp:79-115): accumulate (term_id, doc_id)
pairs in flat numpy chunks, then one lexsort + dedupe produces the packed CSR
posting array the device consumes. Bulk builds become O(E log E) vectorized
work instead of hash-map churn, and the output layout is already the device
layout (no conversion step).

The port's copy differs from the JAX package's in how grams get their term
ids: where the term dictionary is the native term table, one call a batch
resolves every gram and numbers the new ones (``TermDict.resolve``), in
the order the JAX package's builder gives them, so the built index is the
same; there is no separate hash -> tid map. The build's counts of the
table's work are in ``term_stats``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import textproc
from .term_dict import TermDict

_CHUNK = 1 << 20


@dataclass
class BuiltIndex:
    """Immutable CSR snapshot handed to DeviceIndex."""
    term_dict: TermDict
    offsets: np.ndarray    # (V,) int64 into postings
    lengths: np.ndarray    # (V,) int32
    postings: np.ndarray   # (P,) int32 doc ids, sorted per term
    max_doc_id: int        # largest doc id present (0 if empty)
    n_docs: int            # live document count
    positional: Optional["PositionalPostings"] = None  # occurrence index
    # (index/positional.py) — present when the builder collected gram
    # positions; powers the gather-free verified search
    term_stats: Optional[Dict[str, object]] = None  # the IndexBuilder's
    # counts of the term dictionary's work (IndexBuilder.term_stats)

    @property
    def n_terms(self) -> int:
        return len(self.term_dict)

    def df(self) -> np.ndarray:
        return self.lengths

    def postings_of(self, tid: int) -> np.ndarray:
        o = int(self.offsets[tid])
        return self.postings[o:o + int(self.lengths[tid])]


class IndexBuilder:
    """Accumulates shredded documents; finalize() emits a BuiltIndex."""

    def __init__(self, ngram_size: int = 2, kanji_ngram_size: int = 1,
                 cross_boundary_ngrams: bool = True,
                 term_dict: Optional[TermDict] = None,
                 collect_positions: bool = False,
                 kanji_extra_ngram: int = 0):
        self.ngram_size = ngram_size
        self.kanji_ngram_size = kanji_ngram_size
        self.cross_boundary = cross_boundary_ngrams
        # kanji_extra_ngram > 1: CJK positions also emit that size
        # (textproc.generate_hybrid_ngrams kanji_extra) — query-side
        # candidate sets shrink by ~10x on multi-kanji terms and 2-char
        # CJK terms become coverage-exact (no text verify)
        self.kanji_extra_ngram = kanji_extra_ngram
        self.term_dict = term_dict or TermDict()
        # collect_positions: keep one entry PER GRAM OCCURRENCE (with its
        # in-doc position) instead of per-doc-deduped pairs; finalize()
        # then also emits the positional occurrence index
        # (index/positional.py) powering the gather-free verified search
        self.collect_positions = collect_positions
        self._pos_chunks: List[np.ndarray] = []   # uint16, parallel tids
        self._cur_pos: List[int] = []
        self._pos_overflow: set = set()
        self._tid_chunks: List[np.ndarray] = []
        # doc ids repeat once per gram of the doc (~100x at CJK scale), so
        # chunks keep them run-length encoded: (run_ids int32, run_counts
        # int64) parallel to the tid chunk, sum(run_counts) == tids.size.
        # Peak host RSS at 1M+ docs is the builder's pair stream — RLE
        # halves it and the chunked finalize avoids the concat copy.
        self._doc_chunks: List[Tuple[np.ndarray, np.ndarray]] = []
        self._cur_tids: List[int] = []
        self._cur_docs: List[int] = []
        self._max_doc_id = 0
        self._n_docs = 0
        # without the native term table: gram hash -> tid (strings
        # materialized only on first sight of a hash; 64-bit collision
        # odds are ~V^2/2^65)
        self._hash_to_tid: Dict[int, int] = {}
        self._use_native = None  # resolved lazily
        # term_path: who numbered the grams, "native" (the term table) or
        # "python"; terms_new: terms the build added; terms_found: grams
        # (after the per-doc dedup; occurrences where positions are
        # collected) whose term was there before their batch or document;
        # term_collisions: new terms whose hash another term held
        self.term_stats = {
            "term_path": "native" if self.term_dict.native else "python",
            "terms_new": 0, "terms_found": 0, "term_collisions": 0}

    def shred(self, normalized_text: str) -> List[str]:
        return textproc.generate_query_ngrams(
            normalized_text, self.ngram_size, self.kanji_ngram_size,
            self.cross_boundary, kanji_extra=self.kanji_extra_ngram)

    def _native_usable(self) -> bool:
        if self._use_native is None:
            from .. import native
            # the native shredder implements the hybrid dispatch semantics
            # (kanji size in effect); plain fixed-n uses the Python path
            # kanji_extra needs the _x entry points; the per-call
            # wrappers return None on a stale .so and we fall back
            self._use_native = (native.available()
                                and self.kanji_ngram_size > 0)
        return self._use_native

    # ctypes-call overhead beats Python only on longer documents
    _NATIVE_MIN_CPS = 200

    def add_document(self, doc_id: int, normalized_text: str) -> None:
        if len(normalized_text) >= self._NATIVE_MIN_CPS and \
                self._native_usable():
            self._add_document_native(doc_id, normalized_text)
            return
        if self.collect_positions:
            from .positional import POS_CAP
            pairs, _cov = textproc.query_gram_offsets(
                normalized_text, self.ngram_size, self.kanji_ngram_size,
                self.cross_boundary, kanji_extra=self.kanji_extra_ngram)
            if pairs and pairs[-1][1] > POS_CAP:
                self._pos_overflow.add(doc_id)
            v0 = len(self.term_dict)
            tids = [self.term_dict.get_or_add(g) for g, _ in pairs]
            self._count_terms(v0, tids)
            self._record(doc_id, tids,
                         [min(o, POS_CAP) for _, o in pairs])
            return
        grams = set(self.shred(normalized_text))
        v0 = len(self.term_dict)
        tids = [self.term_dict.get_or_add(g) for g in grams]
        self._count_terms(v0, tids)
        self._record(doc_id, tids)

    def _add_document_native(self, doc_id: int, text: str) -> None:
        from .. import native
        ascii_n = self.ngram_size if self.ngram_size > 0 else 2
        out = native.hybrid_ngrams(text, ascii_n, self.kanji_ngram_size,
                                   self.cross_boundary,
                                   kanji_extra=self.kanji_extra_ngram)
        if out is None:
            self._use_native = False
            self.add_document(doc_id, text)
            return
        starts, lens, hashes = out
        if self.collect_positions:
            from .positional import POS_CAP
            tids = self._resolve_tids(native.to_cp(text), starts, lens,
                                      hashes)
            if starts.size and int(starts[-1]) > POS_CAP:
                self._pos_overflow.add(doc_id)
            self._record(doc_id, tids.tolist(),
                         np.minimum(starts, POS_CAP).tolist())
            return
        # hybrid_ngrams emits every position: dedupe per doc first
        uniq, first_idx = np.unique(hashes, return_index=True)
        tids = self._resolve_tids(native.to_cp(text), starts[first_idx],
                                  lens[first_idx], uniq)
        self._record(doc_id, tids.tolist())

    def _resolve_tids(self, flat, starts, lens, hashes) -> np.ndarray:
        """(start, len, hash) grams of ``flat`` -> tid array. With the
        native term table: one call, which also numbers the new grams
        (ascending hash order, as below). Without it, a Python dict keyed
        by hash; only never-seen hashes materialize gram strings and
        consult the TermDict (so a pre-populated term_dict — compaction —
        stays the source of truth)."""
        v0 = len(self.term_dict)
        out = self.term_dict.resolve(flat, starts, lens, hashes)
        if out is not None:
            tids, collisions = out
            self._count_terms(v0, tids, collisions)
            return tids
        uniq, first_idx, inverse = np.unique(
            hashes, return_index=True, return_inverse=True)
        h2t = self._hash_to_tid
        get_or_add = self.term_dict.get_or_add
        tid_of_uniq = np.empty(uniq.size, dtype=np.int64)
        for j in range(uniq.size):
            h = int(uniq[j])
            tid = h2t.get(h)
            if tid is None:
                s = int(starts[first_idx[j]])
                ln = int(lens[first_idx[j]])
                tid = get_or_add("".join(map(chr, flat[s:s + ln])))
                h2t[h] = tid
            tid_of_uniq[j] = tid
        tids = tid_of_uniq[inverse]
        self._count_terms(v0, tids)
        return tids

    def _count_terms(self, v0: int, tids, collisions: int = 0) -> None:
        st = self.term_stats
        st["terms_new"] += len(self.term_dict) - v0
        st["terms_found"] += int(np.count_nonzero(np.asarray(tids) < v0))
        st["term_collisions"] += collisions

    def _record(self, doc_id: int, tids: List[int],
                pos: Optional[List[int]] = None) -> None:
        self._cur_tids.extend(tids)
        self._cur_docs.extend([doc_id] * len(tids))
        if pos is not None:
            self._cur_pos.extend(pos)
        self._n_docs += 1
        self._max_doc_id = max(self._max_doc_id, doc_id)
        if len(self._cur_tids) >= _CHUNK:
            self._flush()

    def pair_count(self) -> int:
        return (sum(c.size for c in self._tid_chunks)
                + len(self._cur_tids))

    def add_batch(self, items: Iterable[Tuple[int, str]]) -> None:
        """Bulk insert: ONE native shred call for the whole batch with
        per-doc dedup in C++, then a vectorized hash->tid mapping — the
        loader hot path (per-doc ctypes calls + Python dict churn measured
        ~5x slower)."""
        items = list(items)
        if not items:
            return
        if self._native_usable():
            out = None
            from .. import native
            shred = (native.shred_batch_all if self.collect_positions
                     else native.shred_batch)
            out = shred(
                [t for _, t in items],
                self.ngram_size if self.ngram_size > 0 else 2,
                self.kanji_ngram_size, self.cross_boundary,
                kanji_extra=self.kanji_extra_ngram)
            if out is not None:
                self._add_batch_native(items, out)
                return
        for doc_id, text in items:
            self.add_document(doc_id, text)

    def _add_batch_native(self, items, out) -> None:
        flat, starts, lens, hashes, counts = out
        tids = self._resolve_tids(flat, starts, lens, hashes)
        self._flush()
        self._tid_chunks.append(tids.astype(np.int32, copy=False))
        self._doc_chunks.append(
            (np.asarray([d for d, _ in items], dtype=np.int32),
             counts.astype(np.int64)))
        if self.collect_positions:
            from .positional import POS_CAP
            # starts index the batch-flat buffer; doc-relative position =
            # start - its doc's flat offset
            doc_len = np.asarray([len(t) for _, t in items],
                                 dtype=np.int64)
            doc_off = np.zeros(len(items), dtype=np.int64)
            np.cumsum(doc_len[:-1], out=doc_off[1:])
            rel = starts.astype(np.int64) - np.repeat(
                doc_off, counts.astype(np.int64))
            over = rel > POS_CAP
            if over.any():
                docs_arr = np.repeat(
                    np.asarray([d for d, _ in items], dtype=np.int64),
                    counts.astype(np.int64))
                self._pos_overflow.update(
                    int(d) for d in np.unique(docs_arr[over]).tolist())
                np.minimum(rel, POS_CAP, out=rel)
            self._pos_chunks.append(rel.astype(np.uint16))
        self._n_docs += len(items)
        if items:
            self._max_doc_id = max(self._max_doc_id,
                                   max(d for d, _ in items))

    def _flush(self) -> None:
        if self._cur_tids:
            self._tid_chunks.append(np.asarray(self._cur_tids, dtype=np.int32))
            docs = np.asarray(self._cur_docs, dtype=np.int32)
            # adjacent-run RLE (stream order preserved; per-doc appends are
            # contiguous so runs == docs except merged equal neighbors)
            starts = np.concatenate(
                [[0], np.flatnonzero(np.diff(docs)) + 1])
            run_ids = docs[starts]
            run_counts = np.diff(
                np.concatenate([starts, [docs.size]])).astype(np.int64)
            self._doc_chunks.append((run_ids, run_counts))
            if self.collect_positions:
                self._pos_chunks.append(
                    np.asarray(self._cur_pos, dtype=np.uint16))
                self._cur_pos = []
            self._cur_tids = []
            self._cur_docs = []

    def _chunks_doc_sorted(self) -> bool:
        """True when the RLE doc-id stream is globally non-decreasing
        (loaders feed ascending PK order) — checked without expansion."""
        last = -1
        for run_ids, _ in self._doc_chunks:
            if run_ids.size == 0:
                continue
            if int(run_ids[0]) < last or np.any(np.diff(run_ids) < 0):
                return False
            last = int(run_ids[-1])
        return True

    def finalize(self) -> BuiltIndex:
        built = self._finalize()
        built.term_stats = dict(self.term_stats)
        return built

    def _finalize(self) -> BuiltIndex:
        self._flush()
        V = len(self.term_dict)
        if not self._tid_chunks:
            return BuiltIndex(self.term_dict,
                              np.zeros(V, dtype=np.int64),
                              np.zeros(V, dtype=np.int32),
                              np.zeros(0, dtype=np.int32),
                              self._max_doc_id, self._n_docs)
        if self.collect_positions:
            return self._finalize_positions(V)
        # One sorted segment: order by (term, doc). Loaders feed doc ids
        # in ascending order, so the common case is a single STABLE
        # counting-sort grouping pass by term (docs stay sorted inside
        # each term) — O(E), no comparison sort. The chunked native path
        # (mg_tid_hist + mg_scatter_rle) streams the accumulation chunks
        # straight into the postings array: no concatenated pair copy, no
        # expanded doc array — peak host RSS drops from ~2x to ~1x the
        # tid stream (the builder's dominant spike at 1M+ docs).
        if self._chunks_doc_sorted():
            from .. import native
            out = native.radix_finalize_chunked(
                [(t, ids, cnts) for t, (ids, cnts)
                 in zip(self._tid_chunks, self._doc_chunks)], V)
            if out is not None:
                postings, lengths = out
                self._tid_chunks = []
                self._doc_chunks = []
                return self._dedup_build(postings, lengths, V)
        tids = np.concatenate(self._tid_chunks)
        docs = np.concatenate([np.repeat(ids, cnts)
                               for ids, cnts in self._doc_chunks])
        self._tid_chunks = []
        self._doc_chunks = []
        if bool(np.all(docs[1:] >= docs[:-1])):
            from .. import native
            out = native.radix_finalize(tids, docs, V)
            if out is not None:
                postings, lengths = out
                del tids, docs
                return self._dedup_build(postings, lengths, V)
            order = np.argsort(tids, kind="stable")
        else:
            order = np.lexsort((docs, tids))
        tids = tids[order]
        docs = docs[order]
        del order
        # dedupe (term, doc) pairs (documents are shredded deduped, but
        # incremental merges may re-add)
        if tids.size:
            keep = np.empty(tids.size, dtype=bool)
            keep[0] = True
            np.logical_or(tids[1:] != tids[:-1], docs[1:] != docs[:-1],
                          out=keep[1:])
            tids = tids[keep]
            docs = docs[keep]
        lengths = np.bincount(tids, minlength=V).astype(np.int32)
        offsets = np.zeros(V, dtype=np.int64)
        np.cumsum(lengths[:-1], out=offsets[1:])
        return BuiltIndex(self.term_dict, offsets, lengths,
                          docs.astype(np.int32), self._max_doc_id,
                          self._n_docs)

    def _finalize_positions(self, V: int) -> BuiltIndex:
        """Occurrence-stream finalize: deduped doc CSR + positional
        occurrence index in one pass (native two-pass scatter when
        available and the doc stream is ascending; numpy lexsort
        fallback otherwise)."""
        from .. import native
        from .positional import finalize_with_positions_np
        if self._chunks_doc_sorted():
            chunks = [(t, ids, cnts, p) for t, (ids, cnts), p
                      in zip(self._tid_chunks, self._doc_chunks,
                             self._pos_chunks)]
            out = native.pos_finalize_chunked(chunks, V)
            if out is not None:
                postings, lengths, occ_cnt, occ_pos, occ_base, occ_len = out
                from .positional import PositionalPostings
                self._tid_chunks = []
                self._doc_chunks = []
                self._pos_chunks = []
                offsets = np.zeros(V, dtype=np.int64)
                np.cumsum(lengths[:-1], out=offsets[1:])
                positional = PositionalPostings(
                    occ_cnt, occ_pos, occ_base, occ_len,
                    set(self._pos_overflow))
                return BuiltIndex(self.term_dict, offsets, lengths,
                                  postings, self._max_doc_id,
                                  self._n_docs, positional)
        tids = np.concatenate(self._tid_chunks)
        docs = np.concatenate([np.repeat(ids, cnts)
                               for ids, cnts in self._doc_chunks])
        pos = (np.concatenate(self._pos_chunks) if self._pos_chunks
               else np.zeros(0, dtype=np.uint16))
        self._tid_chunks = []
        self._doc_chunks = []
        self._pos_chunks = []
        postings, lengths, positional = finalize_with_positions_np(
            tids, docs, pos, V)
        positional.overflow_docs = set(self._pos_overflow)
        offsets = np.zeros(V, dtype=np.int64)
        np.cumsum(lengths[:-1], out=offsets[1:])
        return BuiltIndex(self.term_dict, offsets, lengths, postings,
                          self._max_doc_id, self._n_docs, positional)

    def _dedup_build(self, postings: np.ndarray, lengths: np.ndarray,
                     V: int) -> BuiltIndex:
        """Adjacent-duplicate cleanup within term segments (rare: only
        incremental re-adds produce dups) + BuiltIndex assembly."""
        E = postings.size
        offsets = np.zeros(V, dtype=np.int64)
        np.cumsum(lengths[:-1], out=offsets[1:])
        if E:
            dup = np.zeros(E, dtype=bool)
            np.equal(postings[1:], postings[:-1], out=dup[1:])
            dup[offsets[lengths > 0]] = False  # segment starts never dup
            if dup.any():
                term_of = np.repeat(np.arange(V, dtype=np.int64),
                                    lengths)
                lengths = (lengths - np.bincount(
                    term_of[dup], minlength=V)).astype(np.int32)
                postings = postings[~dup]
                offsets = np.zeros(V, dtype=np.int64)
                np.cumsum(lengths[:-1], out=offsets[1:])
        return BuiltIndex(self.term_dict, offsets, lengths, postings,
                          self._max_doc_id, self._n_docs)


def build_from_csr_like(term_dict: TermDict,
                        posting_map: Dict[int, np.ndarray],
                        max_doc_id: int, n_docs: int) -> BuiltIndex:
    """Rebuild a BuiltIndex from per-term doc-id arrays (compaction path)."""
    V = len(term_dict)
    lengths = np.zeros(V, dtype=np.int32)
    for tid, arr in posting_map.items():
        lengths[tid] = arr.size
    offsets = np.zeros(V, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    total = int(lengths.sum())
    postings = np.zeros(total, dtype=np.int32)
    for tid, arr in posting_map.items():
        o = offsets[tid]
        postings[o:o + arr.size] = arr
    return BuiltIndex(term_dict, offsets, lengths, postings, max_doc_id, n_docs)
