"""``mygramdb_tpu.storage.filter_index`` with torch device rows.

The host FilterIndex is the JAX package's own source, loaded privately so
its ``..ops`` import resolves to this package. The two methods that upload
a filter's word row to the device are overridden: ``FILTER col = v`` and
range filters then ride the dense kernel (K1) and the sparse path as
``extra`` rows, int32 tensors on the index's torch device.
"""

from __future__ import annotations

from typing import Any

from .._overlay import load_host_module
from ..ops import runtime

_host = load_host_module(__package__ + "._filter_index_host",
                         "storage/filter_index.py")


class FilterIndex(_host.FilterIndex):
    def eq_bitmap_device(self, column: str, value: Any, n_words: int,
                         device=None):
        """Device mirror of the (column == value) row, cached per (value,
        width) until the column's host bitmap changes. None when the
        column is not bitmap-indexed."""
        col = self._columns.get(column)
        if col is None or not col.bitmap_index:
            return None
        key = col._bm_key(col._apply_bucket(value))
        with self._lock:
            widths = col._dev_bitmaps.get(key)
            if widths is not None and n_words in widths:
                return widths[n_words]
            host = self.eq_bitmap(column, value, n_words)
            dev = runtime.to_device(host, device)
            col._dev_bitmaps.setdefault(key, {})[n_words] = dev
            return dev

    def cmp_bitmap_device(self, column: str, op: str, value: Any,
                          n_words: int, device=None):
        """Device row for (column OP value), cached per (op, value, width)
        until the column changes. None when the filter has no device form."""
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
