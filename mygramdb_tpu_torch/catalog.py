"""Table catalog: per-table state composition and name resolution.

Reference ``TableContext`` (server/server_types.h:199-207) = name + config +
Index + DocumentStore + BM25Stats + SynonymDictionary; ``TableCatalog``
(server/table_catalog.h:65) resolves names with exact-match priority incl.
``database.table`` qualification (CHANGELOG v1.7.0).

``TableContext.add_row/update_row/remove_row`` is the single write path used
by the initial loader, the binlog processor, and SYNC — it fans one row out
to DocumentStore + MutableIndex + FilterIndex + BM25Stats exactly like the
reference's BinlogEventProcessor (mysql/binlog_event_processor.cpp).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from .config.schema import Config, TableConfig
from .index.delta import MutableIndex
from .query.bm25 import BM25Stats
from .query.synonyms import SynonymDictionary
from .storage.document_store import DocumentStore, _pk_sort_key
from .storage.filter_index import FilterIndex
from .utils import textproc, trace
from .utils.structured_log import StructuredLog


class TableContext:
    def __init__(self, table_cfg: TableConfig, config: Config):
        self.table_cfg = table_cfg
        self.config = config
        self.name = table_cfg.qualified_name()
        norm = config.memory.normalize
        self._norm_args = (norm.nfkc, norm.width, norm.lower)
        store_texts = config.memory.verify_text != "off"
        self.doc_store = DocumentStore(store_texts=store_texts)
        self.index = self._make_index()
        self.filter_index = self._make_filter_index()
        self.bm25 = BM25Stats()
        self.device_text = None  # DeviceTextStore after compaction
        self.synonyms: Optional[SynonymDictionary] = None
        if table_cfg.synonyms.enable and table_cfg.synonyms.file:
            self.synonyms = SynonymDictionary(normalize=self.normalize)
            try:
                n = self.synonyms.load_from_file(table_cfg.synonyms.file)
                StructuredLog().event("synonyms_loaded").field(
                    "table", self.name).field("groups", n).info()
            except OSError as e:
                StructuredLog().event("synonyms_load_failed").field(
                    "table", self.name).field("error", str(e)).warn()
                self.synonyms = None
        self._write_lock = threading.RLock()
        # seqlock for component swaps (SYNC / DUMP LOAD): odd while a swap
        # is in flight; query snapshots retry (pipeline._CtxSnapshot)
        self._swap_seq = 0

    @property
    def kanji_extra_effective(self) -> int:
        """The kanji_extra_ngram actually in force: the config value,
        unless a restored dump was built with a different emission (the
        override keeps query grams aligned with the restored term dict;
        the next SYNC/bulk rebuild returns to the config value)."""
        ov = getattr(self, "_kanji_extra_override", None)
        v = ov if ov is not None else self.table_cfg.kanji_extra_ngram
        return 0 if v <= 1 else v

    # ------------------------------------------------------------------
    def _make_index(self, built=None) -> MutableIndex:
        t = self.table_cfg
        cfg = self.config
        microbatch = None
        if cfg.device.enable and cfg.device.microbatch_size > 1:
            microbatch = (cfg.device.microbatch_size,
                          cfg.device.microbatch_window_us)
        return MutableIndex(
            built,
            ngram_size=t.ngram_size,
            kanji_ngram_size=t.kanji_ngram_size,
            cross_boundary_ngrams=t.cross_boundary_ngrams,
            kanji_extra_ngram=self.kanji_extra_effective,
            dense_df_ratio=cfg.device.dense_df_ratio,
            max_dense_terms=cfg.device.max_dense_terms,
            candidate_buckets=tuple(cfg.device.candidate_buckets),
            microbatch=microbatch,
            mesh_shards=cfg.device.mesh_shards,
            collect_positions=cfg.device.positional_verify,
            text_provider=self._doc_text)

    def _doc_text(self, doc_id: int):
        """Normalized text read-through for the index's positional
        compaction (resolves the live doc_store at call time — restore
        swaps replace the store object)."""
        return self.doc_store.text(doc_id)

    def _make_filter_index(self) -> FilterIndex:
        fi = FilterIndex()
        for f in self.table_cfg.filters:
            fi.add_column(f.name, f.type, f.bitmap_index,
                          f.bucket, f.dict_compress)
        for rf in self.table_cfg.required_filters:
            if rf.bitmap_index and not fi.has_column(rf.name):
                fi.add_column(rf.name, rf.type, True)
        return fi

    # ------------------------------------------------------------------
    def normalize(self, text: str) -> str:
        return textproc.normalize_text(text, *self._norm_args)

    # ------------------------------------------------------------------
    # Bulk initial load (loaders only — not for live tables)
    # ------------------------------------------------------------------
    def begin_bulk_load(self) -> "BulkLoad":
        """Loader fast path: rows accumulate in a sorted-segment
        IndexBuilder (ONE native shred call per batch) instead of the
        per-row delta path, and finish() installs the compiled segment.
        Only valid on an empty table; live mutation goes through
        add_row/update_row/remove_row."""
        # a full rebuild re-shreds with the CONFIG's gram emission —
        # drop any dump-adopted override
        self._kanji_extra_override = None
        if self.doc_count:
            raise RuntimeError("bulk load requires an empty table")
        return BulkLoad(self)

    def begin_staging_rebuild(self) -> "StagingRebuild":
        """SYNC fast path for LIVE tables: build a complete replacement
        state aside (sorted-segment builder, fresh stores) while queries
        keep serving the old state, then swap atomically on finish()
        (reference SyncOperationManager + LoadFromExistingSnapshot,
        sync_operation_manager.h:85). Dropping the staging object without
        finish() discards it and leaves the table untouched."""
        return StagingRebuild(self)

    # ------------------------------------------------------------------
    # Row write path (loader / binlog / SYNC)
    # ------------------------------------------------------------------
    def add_row(self, pk: str, raw_text: str,
                filters: Optional[Dict[str, Any]] = None) -> Optional[int]:
        """Insert-or-ignore one row; returns doc id (None if ignored)."""
        normalized = self.normalize(raw_text)
        with self._write_lock:
            doc_id, inserted = self.doc_store.add_document(
                pk, filters, normalized if self.doc_store.stores_texts
                else None)
            if not inserted:
                return None
            self.index.add_document(doc_id, normalized)
            if filters:
                self.filter_index.add_document(doc_id, filters)
            self.bm25.add_document(doc_id, len(normalized))
            return doc_id

    def update_row(self, pk: str, raw_text: Optional[str] = None,
                   filters: Optional[Dict[str, Any]] = None) -> Optional[int]:
        with self._write_lock:
            doc_id = self.doc_store.doc_id(pk)
            if doc_id is None:
                # row entering the replica (e.g. required_filters transition)
                return self.add_row(pk, raw_text or "", filters)
            if raw_text is not None:
                normalized = self.normalize(raw_text)
                self.doc_store.update_document(
                    doc_id, filters,
                    normalized if self.doc_store.stores_texts else None)
                self.index.update_document(doc_id, normalized)
                self.bm25.add_document(doc_id, len(normalized))
            elif filters is not None:
                self.doc_store.update_document(doc_id, filters)
            if filters is not None:
                self.filter_index.update_document(doc_id, filters)
            return doc_id

    def remove_row(self, pk: str) -> Optional[int]:
        with self._write_lock:
            doc_id = self.doc_store.remove_by_pk(pk)
            if doc_id is None:
                return None
            self.index.remove_document(doc_id)
            self.filter_index.remove_document(doc_id)
            self.bm25.remove_document(doc_id)
            return doc_id

    def truncate(self) -> None:
        with self._write_lock:
            self.doc_store.clear()
            self.index.clear()
            self.filter_index.clear()
            self.bm25.clear()

    def optimize(self) -> None:
        self.index.optimize()
        dev = self.index.device
        if dev is not None and dev.positional is not None:
            # compaction built a fresh DevicePositional with zero doc
            # lengths; re-attach the BM25 norm row
            dev.set_positional_doc_lengths(self.bm25.doc_length_array())
        self._rebuild_device_text()

    def _rebuild_device_text(self) -> None:
        """Pack normalized texts into device memory for the verify
        kernels. A failed build raises: serving on with a host verify
        would hide the card's failure."""
        from .ops import runtime
        self.device_text = None
        self._device_text_gen = -1
        runtime.text_store_bytes[self.name] = 0
        if not (self.config.device.enable and
                self.doc_store.stores_texts):
            return
        from .storage.device_text import DeviceTextStore
        dev = self.index.device
        with trace.stage("build.device", what="text") as st:
            store = DeviceTextStore.from_doc_store(
                self.doc_store, dev.n_docs_capacity,
                doc_sharding=dev.text_doc_sharding)
            nbytes = store.memory_usage()
            st.set(layout=store.layout, maxT=store.maxT,
                   overflow=len(store._overflow), bytes=nbytes)
        self.device_text = store
        runtime.text_store_bytes[self.name] = nbytes
        self._device_text_gen = self.index.built_generation

    def fresh_device_text(self):
        """The packed text store, or None when it predates the current
        device segment (a stale pack would serve empty/old text to the
        device verify and BM25 kernels for docs compacted after the pack —
        silent result corruption; callers must fall back to host verify)."""
        dt = self.device_text
        if dt is None or \
                getattr(self, "_device_text_gen", -1) != \
                self.index.built_generation:
            return None
        return dt

    # ------------------------------------------------------------------
    # checkpoint state (DUMP SAVE/LOAD)
    # ------------------------------------------------------------------
    def table_state(self):
        """Compact the delta, then snapshot CSR + stores for the dump."""
        from .storage.dump import TableState
        with self._write_lock:
            if len(self.index.delta) or self.index.tombstones:
                # ctx-level optimize: compaction moves delta docs onto the
                # device, so the packed DeviceTextStore MUST be rebuilt too
                # or the device verify/BM25 kernels read empty text for
                # them and silently drop matches
                self.optimize()
            built = self.index.built
            return TableState(
                name=self.name,
                terms=self.index.term_dict.state(),
                offsets=built.offsets, lengths=built.lengths,
                postings=built.postings, max_doc_id=built.max_doc_id,
                n_docs=built.n_docs,
                doc_store_state=self.doc_store.state(),
                filter_state=self.filter_index.state(),
                bm25_state=self.bm25.state(),
                positional_state=(built.positional.state()
                                  if built.positional is not None
                                  else None),
                kanji_extra_ngram=self.kanji_extra_effective)

    def restore_from_state(self, ts) -> None:
        """Validate-then-apply swap (reference ReplaceWithLoaded,
        index.h:243-249)."""
        from .index.builder import BuiltIndex
        from .index.term_dict import TermDict
        from .storage.document_store import DocumentStore
        from .storage.filter_index import FilterIndex
        td = TermDict.from_state(ts.terms)
        dump_extra = getattr(ts, "kanji_extra_ngram", -1)
        if dump_extra < 0:
            dump_extra = 0  # legacy dump: no extra grams indexed
        if dump_extra != self.kanji_extra_effective:
            self._kanji_extra_override = dump_extra
        positional = None
        if ts.positional_state is not None:
            from .index.positional import PositionalPostings
            positional = PositionalPostings.from_state(ts.positional_state)
        built = BuiltIndex(td, ts.offsets.astype(np.int64),
                           ts.lengths.astype(np.int32),
                           ts.postings.astype(np.int32),
                           int(ts.max_doc_id), int(ts.n_docs),
                           positional=positional)
        new_index = self._make_index(built)
        new_store = DocumentStore.from_state(ts.doc_store_state)
        new_filters = FilterIndex.from_state(ts.filter_state)
        from .query.bm25 import BM25Stats as _BM25
        new_bm25 = _BM25.from_state(ts.bm25_state)
        dev = getattr(new_index, "device", None)
        if dev is not None and dev.positional is not None:
            # BM25 norm lengths for the positional score path (the dump's
            # flat doc-length array is doc-id-indexed, same as the device
            # doc_len row)
            dev.set_positional_doc_lengths(new_bm25.doc_length_array())
        with self._write_lock:
            self._swap_seq += 1  # odd: swap in flight
            self.index = new_index
            self.doc_store = new_store
            self.filter_index = new_filters
            self.bm25 = new_bm25
            # the packed device text belongs to the PREVIOUS corpus; leaving
            # it in place would serve old texts for new doc ids in the
            # verify_text / BM25 device kernels after a runtime DUMP LOAD
            self.device_text = None
            self._swap_seq += 1  # even: consistent again
        self._rebuild_device_text()

    # ------------------------------------------------------------------
    def memory_usage(self) -> int:
        return (self.index.memory_usage() + self.doc_store.memory_usage() +
                self.filter_index.memory_usage())

    @property
    def doc_count(self) -> int:
        return self.doc_store.count


class _ColumnarLoad:
    """Shared bulk-load core: rows accumulate into a sorted-segment
    IndexBuilder + a columnar FrozenDocBuilder (no per-doc dict entries —
    the host-memory story at 1M+ docs, see storage/frozen_docs.py), plus
    a private FilterIndex and BM25Stats. ``build_doc_store()`` freezes
    the columns into a hybrid DocumentStore.

    Duplicate-PK handling (insert-or-ignore, reference InitialLoader):
    a PK-sorted stream — the ordered SELECT common case — only needs an
    adjacency check inside equal-sort-key runs; an out-of-order stream
    falls back to a full seen-set built on first disorder."""

    def __init__(self, ctx: TableContext):
        from .index.builder import IndexBuilder
        from .storage.frozen_docs import FrozenDocBuilder
        self.ctx = ctx
        t = ctx.table_cfg
        self.builder = IndexBuilder(
            t.ngram_size, t.kanji_ngram_size, t.cross_boundary_ngrams,
            collect_positions=ctx.config.device.positional_verify,
            kanji_extra_ngram=ctx.kanji_extra_effective)
        store_texts = ctx.doc_store.stores_texts
        self.fbuilder = FrozenDocBuilder(store_texts)
        self.filter_index = ctx._make_filter_index()
        self.bm25 = BM25Stats()
        self.pk_order_valid = True
        self.last_pk: Optional[str] = None
        self._last_key = None
        self._run_pks: set = set()   # PKs sharing the current sort key
        self._seen: Optional[set] = None  # full dup set (disorder fallback)
        self._next_doc = 1

    def _backfill_seen(self) -> None:
        self._seen = set()
        for chunk in self.fbuilder._pk_chunks:
            self._seen.update(chunk.decode("utf-8").split("\x00"))
        self._seen.update(self._inflight)  # current batch's accepted rows

    def _is_dup(self, pk: str) -> bool:
        if self._seen is not None:
            return pk in self._seen
        key = _pk_sort_key(pk)
        if self._last_key is None or key > self._last_key:
            self._last_key = key
            self._run_pks = {pk}
            return False
        if key == self._last_key:
            if pk in self._run_pks:
                return True
            self._run_pks.add(pk)
            return False
        # out of order: PK order invalid AND duplicates can be anywhere
        self.pk_order_valid = False
        self._backfill_seen()
        return pk in self._seen

    def add_batch(self, rows) -> int:
        """rows: iterable of (pk, raw_text, filters|None). Returns number
        of rows inserted (insert-or-ignore on duplicate PKs)."""
        ctx = self.ctx
        pairs = []
        pks: List[str] = []
        texts: List[str] = []
        self._inflight = pks
        for pk, raw_text, filters in rows:
            pk = str(pk)
            if self._is_dup(pk):
                continue
            if self._seen is not None:
                self._seen.add(pk)
            normalized = ctx.normalize(raw_text)
            doc_id = self._next_doc
            self._next_doc += 1
            pairs.append((doc_id, normalized))
            pks.append(pk)
            texts.append(normalized)
            self.last_pk = pk
            if filters:
                self.filter_index.add_document(doc_id, filters)
            self.bm25.add_document(doc_id, len(normalized))
        self.fbuilder.append(pks, texts)
        self.builder.add_batch(pairs)
        return len(pairs)

    def build_doc_store(self) -> DocumentStore:
        ds = DocumentStore.from_frozen(
            self.fbuilder, self.ctx.doc_store.stores_texts,
            self.pk_order_valid, self.last_pk)
        fi = self.filter_index
        ds.filters_source = fi.values_of
        return ds

    @staticmethod
    def _attach_positional_lengths(new_index, new_store) -> None:
        """Doc lengths power the BM25 norm on the positional score path;
        sourced from the frozen columnar store's codepoint lengths."""
        dev = getattr(new_index, "device", None)
        if dev is None or dev.positional is None:
            return
        fr = new_store.frozen
        if fr is None or fr.cp_lens is None:
            return
        dl = np.zeros(dev.n_docs_capacity, dtype=np.int32)
        m = min(int(fr.n), dev.n_docs_capacity - 1)
        dl[1:m + 1] = fr.cp_lens[:m]
        dev.set_positional_doc_lengths(dl)


class BulkLoad(_ColumnarLoad):
    """Accumulates an initial snapshot into a sorted-segment builder
    (reference InitialLoader's AddDocumentBatch bulk path,
    initial_loader.h:117-134) — ~4-5x the per-row delta path and no
    per-doc host dict/set churn. finish() compiles + installs the whole
    state (empty table precondition => nothing is lost by swapping)."""

    def __init__(self, ctx: TableContext):
        super().__init__(ctx)
        self._finished = False

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        built = self.builder.finalize()
        new_index = self.ctx._make_index(built)
        new_store = self.build_doc_store()
        self._attach_positional_lengths(new_index, new_store)
        with self.ctx._write_lock:
            self.ctx._swap_seq += 1
            self.ctx.index = new_index
            self.ctx.doc_store = new_store
            self.ctx.filter_index = self.filter_index
            self.ctx.bm25 = self.bm25
            self.ctx._swap_seq += 1
        self.ctx._rebuild_device_text()


class StagingRebuild(_ColumnarLoad):
    """Builds a full replacement table state off to the side (own
    columnar doc store / IndexBuilder / FilterIndex / BM25Stats) so a
    SYNC of a live table never truncates what queries are reading;
    finish() swaps everything under the write lock. Doc ids restart at 1
    in PK-insertion order, re-enabling the device top-N shortcut."""

    def __init__(self, ctx: TableContext):
        super().__init__(ctx)
        self._finished = False

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        built = self.builder.finalize()
        new_index = self.ctx._make_index(built)
        new_store = self.build_doc_store()
        self._attach_positional_lengths(new_index, new_store)
        with self.ctx._write_lock:
            self.ctx._swap_seq += 1  # odd: swap in flight
            self.ctx.index = new_index
            self.ctx.doc_store = new_store
            self.ctx.filter_index = self.filter_index
            self.ctx.bm25 = self.bm25
            self.ctx.device_text = None  # old packed corpus: invalid now
            self.ctx._swap_seq += 1  # even: consistent again
        self.ctx._rebuild_device_text()


class TableCatalog:
    def __init__(self, config: Config):
        self.config = config
        self._tables: Dict[str, TableContext] = {}
        for t in config.tables:
            self._tables[t.qualified_name()] = TableContext(t, config)

    def resolve(self, name: str) -> Optional[TableContext]:
        """Exact (qualified) match first, then bare-name match
        (reference TableCatalog::Resolve, CHANGELOG:26)."""
        ctx = self._tables.get(name)
        if ctx is not None:
            return ctx
        matches = [c for c in self._tables.values()
                   if c.table_cfg.name == name]
        if len(matches) == 1:
            return matches[0]
        return None

    def names(self) -> List[str]:
        return list(self._tables)

    def contexts(self) -> List[TableContext]:
        return list(self._tables.values())

    def replace(self, name: str, ctx: TableContext) -> None:
        """Swap a table's state (SYNC / DUMP LOAD)."""
        self._tables[name] = ctx
