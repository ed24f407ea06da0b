"""MySQL initial snapshot loader.

Reference loader/initial_loader.{h,cpp}: ``START TRANSACTION WITH
CONSISTENT SNAPSHOT``, capture the executed GTID *inside* the transaction,
stream ``SELECT pk, text_cols, filter_cols`` in batches, and feed the
TableContext write path; progress callbacks and cancellation supported.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..catalog import TableContext
from ..utils.structured_log import StructuredLog
from .connection import MysqlConnection


class InitialLoader:
    def __init__(self, ctx: TableContext, conn: MysqlConnection,
                 batch_size: int = 5000):
        self.ctx = ctx
        self.conn = conn
        self.batch_size = batch_size
        self.snapshot_gtid = ""

    def _columns(self) -> List[str]:
        t = self.ctx.table_cfg
        cols = [t.primary_key or "id"]
        cols.extend(t.text_source.columns())
        for f in t.filters:
            if f.name not in cols:
                cols.append(f.name)
        for rf in t.required_filters:
            if rf.name not in cols:
                cols.append(rf.name)
        return cols

    def load(self, cancel: Optional[threading.Event] = None,
             progress: Optional[Callable[[int], None]] = None,
             truncate_first: bool = False) -> int:
        t = self.ctx.table_cfg
        schema = t.database or self.conn.database
        table_ref = f"`{schema}`.`{t.name}`" if schema else f"`{t.name}`"
        cols = self._columns()
        col_list = ", ".join(f"`{c}`" for c in cols)

        self.conn.execute("SET SESSION TRANSACTION ISOLATION LEVEL "
                          "REPEATABLE READ")
        self.conn.execute("START TRANSACTION WITH CONSISTENT SNAPSHOT")
        try:
            self.snapshot_gtid = self.conn.fetch_executed_gtid()
            pk_col = t.primary_key or "id"
            last_pk: Optional[str] = None
            total = 0
            t0 = time.time()
            # empty table -> sorted-segment bulk path (reference
            # AddDocumentBatch analog); SYNC of a live table builds a
            # staging state aside and swaps (queries keep serving the old
            # snapshot — reference LoadFromExistingSnapshot semantics);
            # otherwise per-row live writes
            if self.ctx.doc_count == 0:
                bulk = self.ctx.begin_bulk_load()
            elif truncate_first:
                bulk = self.ctx.begin_staging_rebuild()
            else:
                bulk = None
            while True:
                if cancel is not None and cancel.is_set():
                    break
                where = f" WHERE `{pk_col}` > {_sql_quote(last_pk)}" \
                    if last_pk is not None else ""
                rs = self.conn.query(
                    f"SELECT {col_list} FROM {table_ref}{where} "
                    f"ORDER BY `{pk_col}` LIMIT {self.batch_size}")
                if not rs.rows:
                    break
                pending = []
                for row in rs.rows:
                    d = dict(zip(cols, row))
                    if not self._passes_required(d):
                        continue
                    pk = d.get(pk_col)
                    if pk is None:
                        continue
                    text = (t.text_source.delimiter or " ").join(
                        str(d.get(c) or "") for c in t.text_source.columns())
                    filters = {k: _coerce_filter(v) for k, v in d.items()
                               if k != pk_col and
                               k not in t.text_source.columns()}
                    if bulk is not None:
                        pending.append((str(pk), text, filters))
                    else:
                        self.ctx.add_row(str(pk), text, filters)
                if bulk is not None and pending:
                    bulk.add_batch(pending)
                last_pk = rs.rows[-1][0]
                total += len(rs.rows)
                if progress is not None:
                    progress(total)
                if len(rs.rows) < self.batch_size:
                    break
            if cancel is not None and cancel.is_set():
                # discard staging state; keep the old snapshot + GTID so a
                # cancelled SYNC changes nothing (partial swap would
                # desync the binlog resume point)
                self.snapshot_gtid = ""
                return total
            if bulk is not None:
                bulk.finish()
            dt = max(time.time() - t0, 1e-9)
            StructuredLog().event("initial_load_done").field(
                "table", self.ctx.name).field("rows", total).field(
                "rows_per_sec", round(total / dt, 1)).field(
                "gtid", self.snapshot_gtid[:80]).info()
            return total
        finally:
            try:
                self.conn.execute("COMMIT")
            except Exception:
                pass

    def _passes_required(self, row: Dict) -> bool:
        from .processor import _eval_required
        return all(_eval_required(rf, row.get(rf.name))
                   for rf in self.ctx.table_cfg.required_filters)


def _sql_quote(v: str) -> str:
    try:
        float(v)
        return v
    except (TypeError, ValueError):
        escaped = str(v).replace("\\", "\\\\").replace("'", "\\'")
        return f"'{escaped}'"


def _coerce_filter(v):
    if v is None:
        return None
    try:
        f = float(v)
        return int(f) if f == int(f) else f
    except (TypeError, ValueError):
        return v
