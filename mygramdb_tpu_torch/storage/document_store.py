"""Document store: DocId <-> primary key, filter values, normalized text.

Reference storage/document_store.h:108 keeps four hash maps under one
shared_mutex. Python dicts cost ~5 GB per million docs at bulk scale, so
this store is HYBRID (mirroring the index's segment + delta design):

- ``FrozenDocs`` (storage/frozen_docs.py): immutable columnar base built
  by bulk loads — int64 PK column (or utf-8 blob) + utf-8 text blob.
- dict overlays for everything mutated after the freeze (binlog rates):
  ``_doc_to_pk``/``_pk_to_doc``/``_texts``/``_filters`` hold ONLY
  post-freeze rows and overridden frozen rows; ``_frozen_dead`` doc ids /
  ``_frozen_pk_dead`` PKs shadow removed or remapped frozen rows.
- filter values for frozen docs read through ``filters_source`` (the
  table's FilterIndex — already columnar) instead of a duplicate dict.

DocIds are monotonically allocated from 1 (document_store.h:436) in insert
order, so a PK-ordered initial load yields doc-id order == PK order — the
precondition for the device top-k shortcut (IsPrimaryKeyDocIdOrderValid,
document_store.h:319-325).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple, Union

import numpy as np

from .frozen_docs import FrozenDocBuilder, FrozenDocs
from ..utils.errors import ErrorCode, MygramError

# FilterValue: python analog of the reference's 13-alternative variant
# (document_store.h:72-85). Times are epoch ints (TimeValue).
TimeValue = int
FilterValue = Union[None, bool, int, float, str, TimeValue]


@dataclass
class Document:
    primary_key: str
    filters: Dict[str, FilterValue] = field(default_factory=dict)
    text: Optional[str] = None


def _pk_sort_key(pk: str):
    """Numeric-aware PK ordering (reference ResultSorter numeric-aware sort)."""
    try:
        return (0, int(pk), "")
    except ValueError:
        return (1, 0, pk)


class DocumentStore:
    def __init__(self, store_texts: bool = True):
        self._lock = threading.RLock()
        self._pk_to_doc: Dict[str, int] = {}
        self._doc_to_pk: Dict[int, str] = {}
        self._filters: Dict[int, Dict[str, FilterValue]] = {}
        self._texts: Dict[int, str] = {}
        self._next_doc_id = 1
        self._store_texts = store_texts
        self._pk_order_valid = True
        self._last_pk_key = None
        # frozen columnar base (bulk loads); overlays shadow it
        self._frozen: Optional[FrozenDocs] = None
        self._frozen_dead: set = set()
        self._frozen_pk_dead: set = set()
        self._frozen_live = 0
        # read-through for frozen docs' filter values (the FilterIndex is
        # already columnar — no duplicate per-doc dict); set by the catalog
        self.filters_source: Optional[Callable[[int],
                                               Dict[str, FilterValue]]] = None

    # ------------------------------------------------------------------
    @classmethod
    def from_frozen(cls, builder: FrozenDocBuilder, store_texts: bool,
                    pk_order_valid: bool,
                    last_pk: Optional[str]) -> "DocumentStore":
        ds = cls(store_texts=store_texts)
        ds._frozen = builder.build()
        ds._frozen_live = ds._frozen.n
        ds._next_doc_id = ds._frozen.n + 1
        ds._pk_order_valid = pk_order_valid
        ds._last_pk_key = _pk_sort_key(last_pk) if last_pk is not None \
            else None
        return ds

    # ------------------------------------------------------------------
    def set_store_texts(self, enabled: bool) -> None:
        """verify_text off drops text storage (document_store.h:303-316)."""
        with self._lock:
            self._store_texts = enabled
            if not enabled:
                self._texts.clear()
                if self._frozen is not None:
                    self._frozen.txt_blob = None
                    self._frozen.txt_off = None
                    self._frozen.cp_lens = None

    @property
    def stores_texts(self) -> bool:
        return self._store_texts

    # ------------------------------------------------------------------
    def _frozen_doc_of(self, pk: str) -> Optional[int]:
        if self._frozen is None or pk in self._frozen_pk_dead:
            return None
        d = self._frozen.doc_of(pk)
        if d is None or d in self._frozen_dead:
            return None
        return d

    def _frozen_alive(self, doc_id: int) -> bool:
        return (self._frozen is not None
                and 1 <= doc_id <= self._frozen.n
                and doc_id not in self._frozen_dead)

    # ------------------------------------------------------------------
    def add_document(self, primary_key: str,
                     filters: Optional[Dict[str, FilterValue]] = None,
                     text: Optional[str] = None) -> Tuple[int, bool]:
        """Insert-or-ignore. Returns (doc_id, inserted)."""
        pk = str(primary_key)
        with self._lock:
            existing = self._pk_to_doc.get(pk)
            if existing is None:
                existing = self._frozen_doc_of(pk)
            if existing is not None:
                return existing, False
            doc_id = self._next_doc_id
            if doc_id > 0xFFFFFFFF:
                # doc ids are uint32 on device (bitmap words, CSR
                # postings, packed transports): exhaustion must be a hard
                # error, never a silent wrap that would alias doc 0/1
                # (reference document_store_docid_overflow_test.cpp)
                raise MygramError(ErrorCode.OUT_OF_RANGE,
                                  "doc id space exhausted (uint32)")
            self._next_doc_id += 1
            self._pk_to_doc[pk] = doc_id
            self._doc_to_pk[doc_id] = pk
            if filters:
                self._filters[doc_id] = dict(filters)
            if text is not None and self._store_texts:
                self._texts[doc_id] = text
            key = _pk_sort_key(pk)
            if self._last_pk_key is not None and key < self._last_pk_key:
                self._pk_order_valid = False
            self._last_pk_key = key
            return doc_id, True

    def add_batch(self, rows: Iterable[Tuple[str, Dict[str, FilterValue],
                                             Optional[str]]]) -> List[int]:
        out = []
        for pk, filters, text in rows:
            doc_id, _ = self.add_document(pk, filters, text)
            out.append(doc_id)
        return out

    def update_document(self, doc_id: int,
                        filters: Optional[Dict[str, FilterValue]] = None,
                        text: Optional[str] = None) -> bool:
        with self._lock:
            known = doc_id in self._doc_to_pk or self._frozen_alive(doc_id)
            if not known:
                return False
            if filters is not None:
                self._filters[doc_id] = dict(filters)
            if text is not None and self._store_texts:
                self._texts[doc_id] = text
            return True

    def remove_document(self, doc_id: int) -> bool:
        with self._lock:
            pk = self._doc_to_pk.pop(doc_id, None)
            if pk is not None:
                self._pk_to_doc.pop(pk, None)
                self._filters.pop(doc_id, None)
                self._texts.pop(doc_id, None)
                return True
            if self._frozen_alive(doc_id):
                self._frozen_dead.add(doc_id)
                self._frozen_pk_dead.add(self._frozen.pk(doc_id))
                self._frozen_live -= 1
                self._filters.pop(doc_id, None)
                self._texts.pop(doc_id, None)
                return True
            return False

    def remove_by_pk(self, primary_key: str) -> Optional[int]:
        with self._lock:
            pk = str(primary_key)
            doc_id = self._pk_to_doc.get(pk)
            if doc_id is None:
                doc_id = self._frozen_doc_of(pk)
            if doc_id is None:
                return None
            self.remove_document(doc_id)
            return doc_id

    def change_primary_key(self, old_pk: str, new_pk: str) -> Optional[int]:
        """PK-change support (reference splits into DELETE+INSERT; exposed
        for processor symmetry)."""
        with self._lock:
            doc_id = self._pk_to_doc.pop(str(old_pk), None)
            if doc_id is None:
                doc_id = self._frozen_doc_of(str(old_pk))
                if doc_id is None:
                    return None
                # frozen row remaps: shadow the old frozen PK, overlay the
                # new mapping (text/filters stay readable through the row)
                self._frozen_pk_dead.add(str(old_pk))
            self._pk_to_doc[str(new_pk)] = doc_id
            self._doc_to_pk[doc_id] = str(new_pk)
            self._pk_order_valid = False
            return doc_id

    def clear(self) -> None:
        with self._lock:
            self._pk_to_doc.clear()
            self._doc_to_pk.clear()
            self._filters.clear()
            self._texts.clear()
            self._next_doc_id = 1
            self._pk_order_valid = True
            self._last_pk_key = None
            self._frozen = None
            self._frozen_dead = set()
            self._frozen_pk_dead = set()
            self._frozen_live = 0

    # ------------------------------------------------------------------
    def doc_id(self, primary_key: str) -> Optional[int]:
        pk = str(primary_key)
        d = self._pk_to_doc.get(pk)
        if d is not None:
            return d
        return self._frozen_doc_of(pk)

    def primary_key(self, doc_id: int) -> Optional[str]:
        pk = self._doc_to_pk.get(doc_id)
        if pk is not None:
            return pk
        if self._frozen_alive(doc_id):
            return self._frozen.pk(doc_id)
        return None

    def primary_keys_batch(self, doc_ids: Sequence[int]) -> List[Optional[str]]:
        with self._lock:
            return [self.primary_key(d) for d in doc_ids]

    def get_document(self, primary_key: str) -> Optional[Document]:
        with self._lock:
            doc_id = self.doc_id(str(primary_key))
            if doc_id is None:
                return None
            return Document(primary_key=str(primary_key),
                            filters=self.filters_of(doc_id),
                            text=self.text(doc_id))

    def text(self, doc_id: int) -> Optional[str]:
        t = self._texts.get(doc_id)
        if t is not None:
            return t
        if self._frozen_alive(doc_id):
            return self._frozen.text(doc_id)
        return None

    def texts_batch(self, doc_ids: Sequence[int]) -> List[Optional[str]]:
        with self._lock:
            return [self.text(d) for d in doc_ids]

    def filter_value(self, doc_id: int, column: str) -> FilterValue:
        f = self.filters_of(doc_id)
        return f.get(column) if f else None

    def filter_values_batch(self, doc_ids: Sequence[int],
                            column: str) -> List[FilterValue]:
        with self._lock:
            return [self.filter_value(d, column) for d in doc_ids]

    def filters_of(self, doc_id: int) -> Dict[str, FilterValue]:
        f = self._filters.get(doc_id)
        if f is not None:
            return dict(f)
        if self._frozen_alive(doc_id) and self.filters_source is not None:
            return self.filters_source(doc_id)
        return {}

    # ------------------------------------------------------------------
    @property
    def count(self) -> int:
        return len(self._doc_to_pk) + self._frozen_live

    @property
    def next_doc_id(self) -> int:
        return self._next_doc_id

    @property
    def pk_doc_id_order_valid(self) -> bool:
        """True when ascending doc id == ascending numeric-aware PK order,
        enabling the device top-N shortcut."""
        return self._pk_order_valid

    @property
    def frozen(self) -> Optional[FrozenDocs]:
        return self._frozen

    def text_overlay(self) -> Dict[int, str]:
        """Post-freeze text mutations (device text pack overlays these on
        the frozen blob)."""
        with self._lock:
            return dict(self._texts)

    def texts_snapshot(self) -> Dict[int, str]:
        """Copy of doc_id -> normalized text. NOTE: materializes per-doc
        strings — at bulk scale prefer ``frozen`` + ``text_overlay`` (the
        DeviceTextStore pack path does)."""
        with self._lock:
            out = {}
            if self._frozen is not None and self._frozen.txt_blob is not None:
                for d in range(1, self._frozen.n + 1):
                    if d not in self._frozen_dead:
                        out[d] = self._frozen.text(d)
            out.update(self._texts)
            return out

    def all_doc_ids(self) -> np.ndarray:
        with self._lock:
            overlay = np.fromiter(self._doc_to_pk.keys(), dtype=np.int64,
                                  count=len(self._doc_to_pk))
            if self._frozen is None:
                return overlay
            base = np.arange(1, self._frozen.n + 1, dtype=np.int64)
            if self._frozen_dead:
                dead = np.fromiter(self._frozen_dead, dtype=np.int64,
                                   count=len(self._frozen_dead))
                base = base[~np.isin(base, dead)]
            return np.concatenate([base, overlay])

    def memory_usage(self) -> int:
        # rough estimate (reference reports approximate sizes too)
        n = len(self._doc_to_pk)
        pk_bytes = sum(len(p) for p in list(self._pk_to_doc)[:1000])
        avg_pk = (pk_bytes / min(n, 1000)) if n else 0
        text_bytes = sum(len(t) for t in list(self._texts.values())[:1000])
        avg_text = (text_bytes / min(len(self._texts), 1000)) if self._texts else 0
        total = int(n * (avg_pk * 2 + 64) + len(self._texts) * (avg_text + 48)
                    + len(self._filters) * 96)
        if self._frozen is not None:
            total += self._frozen.memory_usage()
        return total

    # ------------------------------------------------------------------
    # dump/load state
    # ------------------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        with self._lock:
            doc_to_pk = {}
            filters = {}
            texts = {}
            if self._frozen is not None:
                for d in range(1, self._frozen.n + 1):
                    if d in self._frozen_dead:
                        continue
                    doc_to_pk[d] = self.primary_key(d)
                    f = self.filters_of(d)
                    if f:
                        filters[d] = f
                    t = self.text(d)
                    if t is not None:
                        texts[d] = t
            doc_to_pk.update(self._doc_to_pk)
            for d, f in self._filters.items():
                if d in doc_to_pk:
                    filters[d] = dict(f)
            for d, t in self._texts.items():
                if d in doc_to_pk:
                    texts[d] = t
            return {
                "doc_to_pk": doc_to_pk,
                "filters": filters,
                "texts": texts,
                "next_doc_id": self._next_doc_id,
                "store_texts": self._store_texts,
                "pk_order_valid": self._pk_order_valid,
            }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "DocumentStore":
        ds = cls(store_texts=state.get("store_texts", True))
        ds._doc_to_pk = {int(k): v for k, v in state["doc_to_pk"].items()}
        ds._pk_to_doc = {v: k for k, v in ds._doc_to_pk.items()}
        ds._filters = {int(k): dict(v) for k, v in state["filters"].items()}
        ds._texts = {int(k): v for k, v in state.get("texts", {}).items()}
        ds._next_doc_id = int(state["next_doc_id"])
        ds._pk_order_valid = bool(state.get("pk_order_valid", True))
        return ds
