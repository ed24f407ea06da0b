"""Filter index: per-(column, value) doc bitmaps + typed column vectors.

Reference storage/filter_index.h:38 keeps column -> (serialized value ->
Roaring bitmap). The TPU design keeps two complementary structures:

- ``bitmap_index`` columns: host uint32 word bitmaps per distinct value with
  a lazily-uploaded device mirror (an int32 torch tensor of the same
  bits) — EQ/NE filters fold into the device query as extra AND/AND-NOT
  word rows (DeviceIndex extra_words).
- every filter column additionally keeps doc-indexed typed numpy arrays so
  range ops (>, >=, <, <=) vectorize host-side over candidate ids (the
  reference's per-doc fallback, search_pipeline.cpp:785-793, but batched).

FACET = value counts over a result set (filter_index.h:76-83): bitmap
columns count by AND+popcount on device; others by np.unique over gathered
candidate values.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops import runtime

_GROW = 4096


def _sort_key(v):
    return (0, float(v), "") if isinstance(v, (int, float, bool)) \
        else (1, 0.0, str(v))


class _Column:
    """Typed doc-indexed value array + optional per-value bitmaps."""

    def __init__(self, name: str, ftype: str, bitmap_index: bool,
                 bucket: str = "", dict_compress: bool = False):
        self.name = name
        self.ftype = ftype
        self.bitmap_index = bitmap_index
        self.bucket = bucket
        self.numeric = ftype in ("int", "uint", "bigint", "float", "double",
                                 "bool", "datetime", "date", "time",
                                 "timestamp", "tinyint", "smallint")
        # dict_compress (reference config.h:134 accepts + persists the
        # flag): string values intern to int32 codes — ~16x less host
        # memory per doc at low cardinality, and EQ/NE/FACET vectorize
        # over codes instead of Python string loops.
        self.dict_compress = bool(dict_compress) and not self.numeric
        if self.numeric:
            self.values = np.full(_GROW, np.nan, dtype=np.float64)
        elif self.dict_compress:
            self.values = np.full(_GROW, -1, dtype=np.int32)
            self._dict: Dict[str, int] = {}
            self._rev: List[str] = []
        else:
            self.values: Any = [None] * _GROW
        self.present = np.zeros(_GROW, dtype=bool)
        self.value_bitmaps: Dict[Any, np.ndarray] = {}
        self._dev_bitmaps: Dict[Any, Any] = {}
        # device mirrors of computed (op, value) word rows (range/NE/NULL
        # filters); ANY mutation of the column evicts them all — unlike EQ
        # rows there is no per-value invalidation cheap enough to be worth
        # tracking
        self._dev_range: Dict[Any, Any] = {}
        self.n_words = 0

    def _grow(self, doc_id: int) -> None:
        need = doc_id + 1
        cur = len(self.values) if isinstance(self.values, list) \
            else self.values.shape[0]
        if need <= cur:
            return
        new = max(need, cur * 2)
        if self.numeric:
            nv = np.full(new, np.nan, dtype=np.float64)
            nv[:cur] = self.values
            self.values = nv
        elif self.dict_compress:
            nv = np.full(new, -1, dtype=np.int32)
            nv[:cur] = self.values
            self.values = nv
        else:
            self.values.extend([None] * (new - cur))
        np_new = np.zeros(new, dtype=bool)
        np_new[:cur] = self.present
        self.present = np_new

    _BUCKET_SECONDS = {"minute": 60, "hour": 3600, "day": 86400}

    def _apply_bucket(self, value: Any) -> Any:
        """Datetime bucketing (reference filters[].bucket minute/hour/day):
        truncate epoch values to the bucket boundary to cut cardinality."""
        if not self.bucket or value is None:
            return value
        step = self._BUCKET_SECONDS.get(self.bucket)
        if step is None:
            return value
        try:
            return (int(float(value)) // step) * step
        except (TypeError, ValueError):
            return value

    def set(self, doc_id: int, value: Any) -> None:
        value = self._apply_bucket(value)
        self._grow(doc_id)
        if self._dev_range:
            self._dev_range.clear()
        old = self.get(doc_id)
        if self.bitmap_index and self.present[doc_id] and old != value:
            bm = self.value_bitmaps.get(self._bm_key(old))
            if bm is not None:
                self._clear_bit(bm, doc_id)
                self._dev_bitmaps.pop(self._bm_key(old), None)
        if value is None:
            self.present[doc_id] = False
            if self.numeric:
                self.values[doc_id] = np.nan
            elif self.dict_compress:
                self.values[doc_id] = -1
            else:
                self.values[doc_id] = None
            return
        if self.numeric:
            self.values[doc_id] = self._to_num(value)
        elif self.dict_compress:
            self.values[doc_id] = self._intern(str(value))
        else:
            self.values[doc_id] = str(value)
        self.present[doc_id] = True
        if self.bitmap_index:
            key = self._bm_key(value)
            bm = self.value_bitmaps.get(key)
            need_words = (doc_id >> 5) + 1
            if bm is None or bm.shape[0] < need_words:
                nb = np.zeros(max(need_words, self.n_words, 128),
                              dtype=np.uint32)
                if bm is not None:
                    nb[:bm.shape[0]] = bm
                self.value_bitmaps[key] = nb
                bm = nb
            bm[doc_id >> 5] |= np.uint32(1) << np.uint32(doc_id & 31)
            self._dev_bitmaps.pop(key, None)
            self.n_words = max(self.n_words, bm.shape[0])

    def unset(self, doc_id: int) -> None:
        if doc_id >= self.present.shape[0] or not self.present[doc_id]:
            return
        if self._dev_range:
            self._dev_range.clear()
        if self.bitmap_index:
            old = self.get(doc_id)
            bm = self.value_bitmaps.get(self._bm_key(old))
            if bm is not None:
                self._clear_bit(bm, doc_id)
                self._dev_bitmaps.pop(self._bm_key(old), None)
        self.present[doc_id] = False
        if self.numeric:
            self.values[doc_id] = np.nan
        elif self.dict_compress:
            self.values[doc_id] = -1
        else:
            self.values[doc_id] = None

    @staticmethod
    def _clear_bit(bm: np.ndarray, doc_id: int) -> None:
        if (doc_id >> 5) < bm.shape[0]:
            bm[doc_id >> 5] &= ~(np.uint32(1) << np.uint32(doc_id & 31))

    def _intern(self, s: str) -> int:
        code = self._dict.get(s)
        if code is None:
            code = len(self._rev)
            self._dict[s] = code
            self._rev.append(s)
        return code

    def _to_num(self, value: Any) -> float:
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        return float(value)

    def _bm_key(self, value: Any) -> Any:
        return self._to_num(value) if self.numeric else str(value)

    def get(self, doc_id: int):
        if doc_id >= self.present.shape[0] or not self.present[doc_id]:
            return None
        v = self.values[doc_id]
        if self.numeric:
            return float(v)
        if self.dict_compress:
            c = int(v)
            return self._rev[c] if 0 <= c < len(self._rev) else None
        return v

    # ------------------------------------------------------------------
    def eq_bitmap(self, value: Any) -> Optional[np.ndarray]:
        return self.value_bitmaps.get(self._bm_key(self._apply_bucket(value)))

    def match_mask(self, doc_ids: np.ndarray, op: str,
                   value: Any) -> np.ndarray:
        """Vectorized filter evaluation over candidate doc ids."""
        size = self.present.shape[0]
        in_range = doc_ids < size
        safe = np.where(in_range, doc_ids, 0)
        present = self.present[safe] & in_range
        if op == "IS NULL":
            return ~present
        if op == "IS NOT NULL":
            return present
        if self.numeric:
            vals = self.values[safe]
            try:
                cmp = self._to_num(value) if not isinstance(value, str) \
                    else float(value)
            except (TypeError, ValueError):
                return np.zeros(doc_ids.shape[0], dtype=bool)
            with np.errstate(invalid="ignore"):
                if op == "=":
                    m = vals == cmp
                elif op == "!=":
                    m = vals != cmp
                elif op == ">":
                    m = vals > cmp
                elif op == ">=":
                    m = vals >= cmp
                elif op == "<":
                    m = vals < cmp
                elif op == "<=":
                    m = vals <= cmp
                else:
                    m = np.zeros_like(present)
            if op == "!=":
                return m & present
            return m & present
        # string column
        sval = str(value)
        if self.dict_compress:
            codes = self.values[safe]
            if op in ("=", "!="):
                target = self._dict.get(sval, -2)
                m = codes == target if op == "=" else codes != target
                return m & present
            # range ops: compare over the (small) dictionary, then isin
            ok = np.asarray(
                [i for i, s in enumerate(self._rev)
                 if (op == ">" and s > sval) or (op == ">=" and s >= sval)
                 or (op == "<" and s < sval) or (op == "<=" and s <= sval)],
                dtype=np.int32)
            return np.isin(codes, ok) & present
        out = np.zeros(doc_ids.shape[0], dtype=bool)
        vals_list = self.values
        for i, (d, ok) in enumerate(zip(safe.tolist(), present.tolist())):
            if not ok:
                continue
            v = vals_list[d]
            if op == "=":
                out[i] = v == sval
            elif op == "!=":
                out[i] = v != sval
            elif op == ">":
                out[i] = v > sval
            elif op == ">=":
                out[i] = v >= sval
            elif op == "<":
                out[i] = v < sval
            elif op == "<=":
                out[i] = v <= sval
        return out

    def value_counts(self, doc_ids: Optional[np.ndarray]) -> List[Tuple[str, int]]:
        """FACET aggregation over the given doc ids (None = all present)."""
        size = self.present.shape[0]
        if doc_ids is None:
            sel = np.flatnonzero(self.present)
        else:
            in_range = doc_ids < size
            ids = doc_ids[in_range]
            sel = ids[self.present[ids]]
        if sel.size == 0:
            return []
        if self.numeric:
            vals = self.values[sel]
            uniq, counts = np.unique(vals, return_counts=True)
            out = []
            for v, c in zip(uniq.tolist(), counts.tolist()):
                if v == int(v):
                    out.append((str(int(v)), c))
                else:
                    out.append((repr(v), c))
            return out
        if self.dict_compress:
            codes, counts = np.unique(self.values[sel], return_counts=True)
            out = [(self._rev[int(c)], int(n))
                   for c, n in zip(codes.tolist(), counts.tolist())
                   if 0 <= c < len(self._rev)]
            return sorted(out, key=lambda kv: kv[0])
        from collections import Counter
        c = Counter(self.values[d] for d in sel.tolist())
        return sorted(((str(k), v) for k, v in c.items()),
                      key=lambda kv: kv[0])


class FilterIndex:
    def __init__(self):
        self._lock = threading.RLock()
        self._columns: Dict[str, _Column] = {}

    def add_column(self, name: str, ftype: str, bitmap_index: bool = False,
                   bucket: str = "", dict_compress: bool = False) -> None:
        with self._lock:
            if name not in self._columns:
                self._columns[name] = _Column(name, ftype, bitmap_index,
                                              bucket, dict_compress)

    def has_column(self, name: str) -> bool:
        return name in self._columns

    def columns(self) -> List[str]:
        return list(self._columns)

    def column_type(self, name: str) -> Optional[str]:
        col = self._columns.get(name)
        return col.ftype if col else None

    def is_bitmap(self, name: str) -> bool:
        col = self._columns.get(name)
        return bool(col and col.bitmap_index)

    # ------------------------------------------------------------------
    def add_document(self, doc_id: int, values: Dict[str, Any]) -> None:
        with self._lock:
            for name, col in self._columns.items():
                if name in values:
                    col.set(doc_id, values[name])
                else:
                    col.unset(doc_id)

    def update_document(self, doc_id: int, values: Dict[str, Any]) -> None:
        self.add_document(doc_id, values)

    def remove_document(self, doc_id: int) -> None:
        with self._lock:
            for col in self._columns.values():
                col.unset(doc_id)

    def clear(self) -> None:
        with self._lock:
            for name, col in list(self._columns.items()):
                self._columns[name] = _Column(name, col.ftype,
                                              col.bitmap_index, col.bucket,
                                              col.dict_compress)

    # ------------------------------------------------------------------
    def eq_bitmap(self, column: str, value: Any,
                  n_words: int) -> Optional[np.ndarray]:
        """Padded/truncated copy of the (column == value) bitmap
        (reference GetEqBitmap returns an independent copy)."""
        col = self._columns.get(column)
        if col is None or not col.bitmap_index:
            return None
        bm = col.eq_bitmap(value)
        out = np.zeros(n_words, dtype=np.uint32)
        if bm is not None:
            n = min(n_words, bm.shape[0])
            out[:n] = bm[:n]
        return out

    def eq_bitmap_device(self, column: str, value: Any, n_words: int,
                         device=None):
        """Device mirror of the (column == value) bitmap, lazily uploaded
        and cached per (value, width); mutations to the host bitmap evict
        the mirror (col.set/unset pop ``_dev_bitmaps``), so a fetched
        mirror is fresh-at-fetch. This is the FILTER col = v fast path:
        the row rides the device query as an extra AND operand instead of
        a host-side post-mask over materialized ids (reference
        ApplyFiltersWithBitmap, search_pipeline.cpp:785-793).

        Returns None when the column isn't bitmap-indexed. A value with no
        bitmap yet (no matching docs) returns an all-zeros row — correct
        AND semantics (empty result)."""
        col = self._columns.get(column)
        if col is None or not col.bitmap_index:
            return None
        key = col._bm_key(col._apply_bucket(value))
        with self._lock:
            # nested by width so col.set/unset's pop(key) evicts every
            # mirror of the mutated value at once
            widths = col._dev_bitmaps.get(key)
            if widths is not None and n_words in widths:
                return widths[n_words]
            host = self.eq_bitmap(column, value, n_words)
            dev = runtime.to_device(host, device)
            col._dev_bitmaps.setdefault(key, {})[n_words] = dev
            return dev

    _CMP_OPS = (">", ">=", "<", "<=", "!=", "=", "IS NULL", "IS NOT NULL")

    def cmp_bitmap_device(self, column: str, op: str, value: Any,
                          n_words: int, device=None):
        """Device word row for (column OP value) over doc ids
        [0, 32*n_words) — the range/NE/NULL analog of eq_bitmap_device,
        so ``FILTER col > v`` rides the device fast paths as an extra AND
        row instead of forcing full id materialization + a host mask
        (reference treats non-EQ as per-doc fallback,
        search_pipeline.cpp:785-793, but pays no network hop per id; we
        must not either). Computed host-side from the typed column
        (vectorized compare, packed little-endian to match the doc-id bit
        layout), uploaded once and cached per (op, value, width); any
        column mutation evicts the cache (set/unset clear _dev_range).
        None => unsupported (plain string columns compare per-doc in
        Python — the host path keeps those) or unparseable value."""
        col = self._columns.get(column)
        if col is None or op not in self._CMP_OPS:
            return None
        if op == "=" and col.bitmap_index:
            return self.eq_bitmap_device(column, value, n_words, device)
        if not (col.numeric or col.dict_compress) and \
                op not in ("IS NULL", "IS NOT NULL"):
            return None
        try:
            key = (op, None if value is None else col._bm_key(value),
                   n_words)
        except (TypeError, ValueError):
            return None
        with self._lock:
            cached = col._dev_range.get(key)
            if cached is not None:
                return cached
            row = self._host_cmp_row(col, op, value, n_words)
            if row is None:
                return None
            dev = runtime.to_device(row, device)
            col._dev_range[key] = dev
            return dev

    @staticmethod
    def _host_cmp_row(col: FilterColumn, op: str, value: Any,
                      n_words: int) -> Optional[np.ndarray]:
        """(n_words,) uint32 with bit (d & 31) of word (d >> 5) set when
        doc d matches — same semantics as col.match_mask (presence
        guard; NE true only for present docs; NULL true beyond the
        column's grown size)."""
        n_bits = n_words * 32
        size = min(col.present.shape[0], n_bits)
        mask = np.zeros(n_bits, dtype=bool)
        if op == "IS NULL":
            mask[:size] = ~col.present[:size]
            mask[size:] = True
        elif op == "IS NOT NULL":
            mask[:size] = col.present[:size]
        elif col.numeric:
            try:
                cmp = float(value) if isinstance(value, str) \
                    else col._to_num(value)
            except (TypeError, ValueError):
                return None
            vals = col.values[:size]
            with np.errstate(invalid="ignore"):
                if op == "=":
                    m = vals == cmp
                elif op == "!=":
                    m = vals != cmp
                elif op == ">":
                    m = vals > cmp
                elif op == ">=":
                    m = vals >= cmp
                elif op == "<":
                    m = vals < cmp
                else:
                    m = vals <= cmp
            mask[:size] = m & col.present[:size]
        else:  # dict-compressed strings: compare the (small) dictionary
            sval = str(value)
            codes = col.values[:size]
            if op == "=":
                m = codes == col._dict.get(sval, -2)
            elif op == "!=":
                m = codes != col._dict.get(sval, -2)
            else:
                ok = np.asarray(
                    [i for i, s in enumerate(col._rev)
                     if (op == ">" and s > sval)
                     or (op == ">=" and s >= sval)
                     or (op == "<" and s < sval)
                     or (op == "<=" and s <= sval)], dtype=np.int32)
                m = np.isin(codes, ok)
            mask[:size] = m & col.present[:size]
        return np.packbits(mask, bitorder="little").view(np.uint32)

    _INT_TYPES = ("int", "uint", "bigint", "bool", "datetime", "date",
                  "time", "timestamp", "tinyint", "smallint")

    def values_of(self, doc_id: int) -> Dict[str, Any]:
        """All present filter values for one doc, typed back from the
        columnar storage (int-typed columns return ints, not the float64
        the column array holds). This is the frozen DocumentStore's
        filters read-through — bulk loads keep NO per-doc filter dicts."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name, col in self._columns.items():
                v = col.get(doc_id)
                if v is None:
                    continue
                if col.numeric and col.ftype in self._INT_TYPES:
                    if col.ftype == "bool":
                        v = bool(v)
                    elif float(v) == int(v):
                        v = int(v)
                out[name] = v
        return out

    def match_mask(self, column: str, doc_ids: np.ndarray, op: str,
                   value: Any = None) -> np.ndarray:
        col = self._columns.get(column)
        if col is None:
            return np.zeros(doc_ids.shape[0], dtype=bool)
        return col.match_mask(doc_ids, op, value)

    def value_counts(self, column: str,
                     doc_ids: Optional[np.ndarray] = None
                     ) -> List[Tuple[str, int]]:
        col = self._columns.get(column)
        if col is None:
            return []
        with self._lock:
            return col.value_counts(doc_ids)

    def memory_usage(self) -> int:
        total = 0
        for col in self._columns.values():
            if col.numeric:
                total += col.values.nbytes
            elif col.dict_compress:
                total += col.values.nbytes + sum(
                    len(s) + 49 for s in col._rev)
            else:
                total += len(col.values) * 16
            total += col.present.nbytes
            for bm in col.value_bitmaps.values():
                total += bm.nbytes
        return total

    # ------------------------------------------------------------------
    # dump/load state
    # ------------------------------------------------------------------
    def state(self) -> Dict[str, Any]:
        with self._lock:
            cols = {}
            for name, col in self._columns.items():
                present_idx = np.flatnonzero(col.present)
                if col.numeric:
                    vals = col.values[present_idx].tolist()
                elif col.dict_compress:
                    vals = [col._rev[int(col.values[i])]
                            for i in present_idx.tolist()]
                else:
                    vals = [col.values[i] for i in present_idx.tolist()]
                cols[name] = {
                    "type": col.ftype,
                    "bitmap_index": col.bitmap_index,
                    "bucket": col.bucket,
                    "dict_compress": col.dict_compress,
                    "doc_ids": present_idx.tolist(),
                    "values": vals,
                }
            return {"columns": cols}

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "FilterIndex":
        fi = cls()
        for name, cs in state.get("columns", {}).items():
            fi.add_column(name, cs["type"], cs.get("bitmap_index", False),
                          cs.get("bucket", ""),
                          cs.get("dict_compress", False))
            col = fi._columns[name]
            for d, v in zip(cs["doc_ids"], cs["values"]):
                col.set(int(d), v)
        return fi
