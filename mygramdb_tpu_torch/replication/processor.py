"""Apply binlog events to table state.

Reference mysql/binlog_event_processor.{h,cpp} + binlog_filter_evaluator:
INSERT -> add (store + index + filters + BM25), UPDATE -> diff-based
update with PK-change split into DELETE+INSERT, DELETE -> remove,
TRUNCATE -> clear; required_filters membership decides whether a row
belongs in the replica at all (rows leaving the predicate are deleted,
rows entering are inserted); every write invalidates the query cache by
n-gram overlap.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..catalog import TableCatalog, TableContext
from ..config.schema import RequiredFilterConfig, TableConfig
from ..utils.structured_log import StructuredLog
from .binlog_events import BinlogEvent, RowsData, TableMap, ddl_target_table


def _eval_required(rf: RequiredFilterConfig, value: Any) -> bool:
    op = rf.op
    if op == "IS NULL":
        return value is None
    if op == "IS NOT NULL":
        return value is not None
    if value is None:
        return False
    expected = rf.value
    try:
        if isinstance(expected, (int, float)):
            value = float(value)
            expected = float(expected)
        else:
            value = str(value)
            expected = str(expected)
    except (TypeError, ValueError):
        return False
    return {
        "=": value == expected,
        "!=": value != expected,
        "<": value < expected,
        ">": value > expected,
        "<=": value <= expected,
        ">=": value >= expected,
    }.get(op, False)


class BinlogEventProcessor:
    def __init__(self, catalog: TableCatalog, cache_manager=None,
                 database: str = ""):
        self.catalog = catalog
        self.cache = cache_manager
        self.database = database
        self.events_applied = 0
        self.events_skipped = 0
        self.errors = 0

    # ------------------------------------------------------------------
    def _resolve(self, schema: str, table: str) -> Optional[TableContext]:
        ctx = self.catalog.resolve(f"{schema}.{table}")
        if ctx is not None:
            return ctx
        if not self.database or schema == self.database:
            return self.catalog.resolve(table)
        return None

    @staticmethod
    def _row_dict(tm: TableMap, values: List[Any]) -> Dict[str, Any]:
        names = tm.col_names
        if not names or len(names) != len(values):
            names = [f"col{i}" for i in range(len(values))]
        return dict(zip(names, values))

    @staticmethod
    def _pk_of(ctx: TableContext, row: Dict[str, Any]) -> Optional[str]:
        pk_col = ctx.table_cfg.primary_key or "id"
        v = row.get(pk_col)
        if v is None:
            return None
        if isinstance(v, float) and v == int(v):
            v = int(v)
        return str(v)

    @staticmethod
    def _text_of(ctx: TableContext, row: Dict[str, Any]) -> str:
        ts = ctx.table_cfg.text_source
        cols = ts.columns()
        return (ts.delimiter or " ").join(
            str(row.get(c, "") if row.get(c) is not None else "")
            for c in cols)

    @staticmethod
    def _filters_of(ctx: TableContext, row: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for f in ctx.table_cfg.filters:
            if f.name in row:
                out[f.name] = row[f.name]
        for rf in ctx.table_cfg.required_filters:
            if rf.bitmap_index and rf.name in row:
                out[rf.name] = row[rf.name]
        return out

    @staticmethod
    def _passes_required(ctx: TableContext, row: Dict[str, Any]) -> bool:
        return all(_eval_required(rf, row.get(rf.name))
                   for rf in ctx.table_cfg.required_filters)

    def _invalidate(self, ctx: TableContext, *texts: str) -> None:
        if self.cache is None:
            return
        grams = set()
        for t in texts:
            if t:
                grams.update(ctx.index.shred(ctx.normalize(t)))
        self.cache.invalidate_by_ngrams(ctx.name, grams)

    # ------------------------------------------------------------------
    def apply_rows(self, rows: RowsData) -> int:
        tm = rows.table_map
        ctx = self._resolve(tm.schema, tm.table)
        if ctx is None:
            self.events_skipped += 1
            return 0
        applied = 0
        for row in rows.rows:
            try:
                if rows.kind == "insert":
                    applied += self._apply_insert(ctx, tm, row)
                elif rows.kind == "delete":
                    applied += self._apply_delete(ctx, tm, row)
                else:
                    applied += self._apply_update(ctx, tm, row[0], row[1])
            except Exception as e:  # noqa: BLE001 — per-row resilience
                self.errors += 1
                StructuredLog().event("binlog_apply_error").field(
                    "table", ctx.name).field("kind", rows.kind).field(
                    "error", repr(e)).error()
        self.events_applied += applied
        return applied

    def _apply_insert(self, ctx: TableContext, tm: TableMap,
                      values: List[Any]) -> int:
        row = self._row_dict(tm, values)
        if not self._passes_required(ctx, row):
            return 0
        pk = self._pk_of(ctx, row)
        if pk is None:
            return 0
        text = self._text_of(ctx, row)
        ctx.add_row(pk, text, self._filters_of(ctx, row))
        self._invalidate(ctx, text)
        return 1

    def _apply_delete(self, ctx: TableContext, tm: TableMap,
                      values: List[Any]) -> int:
        row = self._row_dict(tm, values)
        pk = self._pk_of(ctx, row)
        if pk is None:
            return 0
        doc_id = ctx.doc_store.doc_id(pk)
        old_text = ctx.doc_store.text(doc_id) if doc_id else None
        if ctx.remove_row(pk) is None:
            return 0
        self._invalidate(ctx, old_text or self._text_of(ctx, row))
        return 1

    def _apply_update(self, ctx: TableContext, tm: TableMap,
                      before: List[Any], after: List[Any]) -> int:
        brow = self._row_dict(tm, before)
        arow = self._row_dict(tm, after)
        bpk = self._pk_of(ctx, brow)
        apk = self._pk_of(ctx, arow)
        b_in = self._passes_required(ctx, brow)
        a_in = self._passes_required(ctx, arow)
        btext = self._text_of(ctx, brow)
        atext = self._text_of(ctx, arow)
        n = 0
        if bpk is not None and apk is not None and bpk != apk:
            # PK change: DELETE old + INSERT new (reference CHANGELOG:24)
            if b_in:
                ctx.remove_row(bpk)
                n += 1
            if a_in:
                ctx.add_row(apk, atext, self._filters_of(ctx, arow))
                n += 1
            self._invalidate(ctx, btext, atext)
            return n
        pk = apk or bpk
        if pk is None:
            return 0
        if b_in and not a_in:
            # row left the predicate: remove
            if ctx.remove_row(pk) is not None:
                self._invalidate(ctx, btext)
                return 1
            return 0
        if not a_in:
            return 0
        # insert-or-update; filter-only updates (text unchanged) must not
        # touch the full-text index at all (reference 1.8.0 critical-fix
        # class: deciding index mutation on the wrong predicate dropped
        # still-qualifying documents)
        if btext == atext and ctx.doc_store.doc_id(pk) is not None:
            ctx.update_row(pk, None, self._filters_of(ctx, arow))
            self._invalidate(ctx, atext)  # cached filtered results stale
        else:
            ctx.update_row(pk, atext, self._filters_of(ctx, arow))
            self._invalidate(ctx, btext, atext)
        return 1

    # ------------------------------------------------------------------
    def apply_ddl(self, event: BinlogEvent) -> None:
        schema, table = ddl_target_table(event.query)
        schema = schema or event.schema
        ctx = self._resolve(schema, table) if table else None
        if event.ddl_type == "truncate" and ctx is not None:
            ctx.truncate()
            if self.cache is not None:
                self.cache.clear_table(ctx.name)
            StructuredLog().event("binlog_truncate").field(
                "table", ctx.name).info()
        elif event.ddl_type == "alter" and ctx is not None:
            # Schema may no longer match the configured columns; cached
            # results keyed on old column values are suspect. Reference
            # warns + clears the table's query cache and keeps serving
            # (binlog_event_processor.cpp:374-393).
            if self.cache is not None:
                self.cache.clear_table(ctx.name)
            StructuredLog().event("binlog_ddl").field(
                "table", ctx.name).field("type", "alter").field(
                "query", event.query[:200]).field(
                "message", "schema change may cause data inconsistency; "
                "consider rebuilding from snapshot").warn()
        elif event.ddl_type == "drop" and ctx is not None:
            # Table is gone upstream: serving stale rows would be wrong.
            # Reference clears index + doc store + cache and logs an error
            # (binlog_event_processor.cpp:394-413).
            ctx.truncate()
            if self.cache is not None:
                self.cache.clear_table(ctx.name)
            StructuredLog().event("binlog_ddl").field(
                "table", ctx.name).field("type", "drop").field(
                "message", "index and document store cleared; reconfigure "
                "or stop the server").error()
        elif event.ddl_type == "rename" and ctx is not None:
            StructuredLog().event("binlog_ddl").field(
                "table", ctx.name).field("type", "rename").field(
                "query", event.query[:200]).warn()
        else:
            pass  # unrelated DDL
