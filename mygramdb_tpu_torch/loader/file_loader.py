"""Bulk index build from seed files (TSV / JSONL).

The file-based counterpart of the MySQL InitialLoader (reference
loader/initial_loader.h:42): stream rows in batches, normalize text,
feed DocumentStore + Index + FilterIndex + BM25 through the TableContext
write path, with progress callbacks and cancellation. Used by tests, the
benchmark harness, and `mygramdb-tpu load` tooling; the MySQL snapshot
loader (replication/initial_loader.py) shares the same batching shape.

Formats:
- JSONL: one object per line; primary key from ``table_cfg.primary_key``
  field (or "id"), text from the configured text_source column(s), all
  other fields become filter values.
- TSV: first line is the header with column names.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..catalog import TableContext
from ..utils.structured_log import StructuredLog


class FileLoader:
    def __init__(self, ctx: TableContext, batch_size: int = 5000):
        self.ctx = ctx
        self.batch_size = batch_size
        self.rows_loaded = 0

    # ------------------------------------------------------------------
    def _row_fields(self) -> Tuple[str, List[str], str]:
        t = self.ctx.table_cfg
        return (t.primary_key or "id", t.text_source.columns(),
                t.text_source.delimiter or " ")

    def load_rows(self, rows: Iterable[Dict[str, object]],
                  cancel: Optional[threading.Event] = None,
                  progress: Optional[Callable[[int], None]] = None,
                  rebuild: bool = False) -> int:
        """rebuild=True (SYNC): build a staging state aside and swap on
        completion — queries keep serving the old state, and a cancelled
        rebuild is discarded."""
        pk_col, text_cols, delim = self._row_fields()
        n = 0
        t0 = time.time()
        # empty table -> sorted-segment bulk path (one native shred per
        # batch); otherwise the per-row live write path
        bulk = None
        if self.ctx.doc_count == 0:
            bulk = self.ctx.begin_bulk_load()
        elif rebuild:
            bulk = self.ctx.begin_staging_rebuild()
        pending = []

        def flush_pending():
            if bulk is not None and pending:
                bulk.add_batch(pending)
                pending.clear()

        for row in rows:
            if cancel is not None and cancel.is_set():
                break
            pk = row.get(pk_col)
            if pk is None:
                continue
            text = delim.join(str(row.get(c, "") or "") for c in text_cols)
            filters = {k: v for k, v in row.items()
                       if k != pk_col and k not in text_cols}
            if self._passes_required(filters, row):
                if bulk is not None:
                    pending.append((str(pk), text, filters))
                    if len(pending) >= self.batch_size:
                        flush_pending()
                else:
                    self.ctx.add_row(str(pk), text, filters)
            n += 1
            if progress is not None and n % self.batch_size == 0:
                progress(n)
        if cancel is not None and cancel.is_set():
            return n  # staging (if any) is discarded; old state survives
        flush_pending()
        if bulk is not None:
            bulk.finish()
        self.rows_loaded = n
        dt = max(time.time() - t0, 1e-9)
        StructuredLog().event("initial_load_done").field(
            "table", self.ctx.name).field("rows", n).field(
            "rows_per_sec", round(n / dt, 1)).info()
        if progress is not None:
            progress(n)
        return n

    def _passes_required(self, filters: Dict, row: Dict) -> bool:
        """required_filters membership (reference BinlogFilterEvaluator)."""
        for rf in self.ctx.table_cfg.required_filters:
            v = row.get(rf.name)
            if not _eval_required(rf.op, v, rf.value):
                return False
        return True

    # ------------------------------------------------------------------
    def load_file(self, path: str,
                  cancel: Optional[threading.Event] = None,
                  progress: Optional[Callable[[int], None]] = None,
                  rebuild: bool = False) -> int:
        if path.endswith(".jsonl") or path.endswith(".json"):
            return self.load_rows(self._iter_jsonl(path), cancel, progress,
                                  rebuild)
        return self.load_rows(self._iter_tsv(path), cancel, progress,
                              rebuild)

    @staticmethod
    def _iter_jsonl(path: str):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)

    @staticmethod
    def _iter_tsv(path: str):
        with open(path, "r", encoding="utf-8") as f:
            header: Optional[List[str]] = None
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                if header is None:
                    header = line.split("\t")
                    continue
                yield dict(zip(header, line.split("\t")))


def _eval_required(op: str, value, expected) -> bool:
    if op == "IS NULL":
        return value is None
    if op == "IS NOT NULL":
        return value is not None
    if value is None:
        return False
    try:
        if isinstance(expected, (int, float)) or (
                isinstance(expected, str) and
                expected.replace(".", "", 1).lstrip("-").isdigit()):
            value_num = float(value)
            expected_num = float(expected)
            value, expected = value_num, expected_num
    except (TypeError, ValueError):
        value, expected = str(value), str(expected)
    if op == "=":
        return value == expected
    if op == "!=":
        return value != expected
    if op == "<":
        return value < expected
    if op == ">":
        return value > expected
    if op == "<=":
        return value <= expected
    if op == ">=":
        return value >= expected
    return False


def load_seed_file(ctx: TableContext, path: str, batch_size: int = 5000) -> int:
    return FileLoader(ctx, batch_size).load_file(path)


def make_sync_loader(seed_path: str):
    """loader_factory for SyncOperationManager backed by a seed file:
    builds a staging state aside and swaps on completion, so queries keep
    serving the old state during the rebuild (online rebuild semantics)."""
    def factory(ctx: TableContext, cancel: threading.Event,
                progress: Callable[[int], None]) -> int:
        return FileLoader(ctx).load_file(seed_path, cancel, progress,
                                         rebuild=True)
    return factory
