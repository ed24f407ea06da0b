"""Binlog reader: two-thread pipeline with bounded queue.

Reference mysql/binlog_reader.{h,cpp,_threads.cpp}: a **reader thread**
pulls raw events off the dump stream, parses, and pushes typed events onto
a bounded blocking queue (10k default); a **worker thread** pops and
applies them through BinlogEventProcessor. GTID tracking commits
``pending_commit_gtid`` only at COMMIT/XID; failover is detected by
server-UUID change and resumes from the executed GTID set; dead
connections reconnect with exponential backoff; CRC mismatches fail fast
into a reconnect (CHANGELOG.md:27).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..utils.errors import ProtocolError
from ..utils.structured_log import StructuredLog
from .binlog_events import BinlogEvent, BinlogParser
from .connection import MysqlConnection
from .gtid import Gtid, GtidSet, MariadbGtid
from .processor import BinlogEventProcessor


@dataclass
class ReaderStats:
    events_received: int = 0
    events_applied: int = 0
    reconnects: int = 0
    crc_errors: int = 0
    failovers: int = 0
    last_error: str = ""
    last_event_ts: float = 0.0


class BinlogReader:
    def __init__(self, mysql_cfg, repl_cfg, processor: BinlogEventProcessor,
                 connection_factory: Optional[Callable[[], MysqlConnection]] = None,
                 tz_offset_sec: int = 0):
        self.mysql_cfg = mysql_cfg
        self.repl_cfg = repl_cfg
        self.processor = processor
        self.tz_offset_sec = tz_offset_sec
        self._factory = connection_factory or self._default_factory
        self.queue: "queue.Queue" = queue.Queue(maxsize=repl_cfg.queue_size)
        self.stats = ReaderStats()
        self.executed = GtidSet()
        self.current_gtid: Optional[Gtid] = None
        self.mariadb_pos: Optional[MariadbGtid] = None
        self._pending: Optional[Gtid] = None
        self._pending_maria: Optional[MariadbGtid] = None
        self._server_uuid = ""
        self._running = threading.Event()
        self._paused = threading.Event()
        self._reader_t: Optional[threading.Thread] = None
        self._worker_t: Optional[threading.Thread] = None
        self._conn: Optional[MysqlConnection] = None
        self.is_mariadb = False
        self._schema_cols: Dict = {}
        self._schema_unsigned: Dict = {}

    # ------------------------------------------------------------------
    def _default_factory(self) -> MysqlConnection:
        m = self.mysql_cfg
        return MysqlConnection(
            m.host, m.port, m.user, m.password, m.database,
            connect_timeout=m.connect_timeout_ms / 1000.0,
            ssl_enable=m.ssl_enable, ssl_ca=m.ssl_ca,
            ssl_verify=m.ssl_verify_server_cert)

    # ------------------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._running.is_set()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    def set_start_gtid(self, gtid_text: str) -> None:
        """Resume point (from dump restore or start_from=gtid=...)."""
        if not gtid_text:
            return
        try:
            if "-" in gtid_text and ":" not in gtid_text:
                self.mariadb_pos = MariadbGtid.parse(gtid_text)
            else:
                self.executed = GtidSet.parse(gtid_text)
        except Exception as e:
            StructuredLog().event("invalid_start_gtid").field(
                "gtid", gtid_text).field("error", str(e)).warn()

    def gtid_position(self) -> str:
        if self.is_mariadb:
            return str(self.mariadb_pos) if self.mariadb_pos else ""
        return str(self.executed)

    # ------------------------------------------------------------------
    def start(self) -> bool:
        if self._running.is_set():
            return True
        self._running.set()
        self._paused.clear()
        self._reader_t = threading.Thread(target=self._reader_loop,
                                          name="binlog-reader", daemon=True)
        self._worker_t = threading.Thread(target=self._worker_loop,
                                          name="binlog-worker", daemon=True)
        self._reader_t.start()
        self._worker_t.start()
        return True

    def stop(self) -> bool:
        if not self._running.is_set():
            return False
        self._running.clear()
        conn = self._conn
        if conn is not None:
            conn.close()
        for t in (self._reader_t, self._worker_t):
            if t is not None:
                t.join(timeout=10)
        self._reader_t = self._worker_t = None
        return True

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    # ------------------------------------------------------------------
    def _reader_loop(self) -> None:
        backoff = self.repl_cfg.reconnect_backoff_min_ms / 1000.0
        while self._running.is_set():
            try:
                self._stream_once()
                backoff = self.repl_cfg.reconnect_backoff_min_ms / 1000.0
            except Exception as e:  # noqa: BLE001 — reconnect boundary
                if not self._running.is_set():
                    break
                self.stats.last_error = str(e)
                self.stats.reconnects += 1
                if "CRC32" in str(e):
                    self.stats.crc_errors += 1
                StructuredLog().event("binlog_reconnect").field(
                    "error", str(e)).field("backoff_sec", backoff).warn()
                # interruptible backoff: stop() during a long backoff
                # must not stall the join (stop contract)
                deadline = time.time() + backoff
                while self._running.is_set() and time.time() < deadline:
                    time.sleep(0.05)
                backoff = min(backoff * 2,
                              self.repl_cfg.reconnect_backoff_max_ms / 1000.0)

    def _stream_once(self) -> None:
        conn = self._factory()
        try:
            self._stream_with(conn)
        finally:
            # explicit close on EVERY exit (EOF, prereq failure, parse
            # error): relying on refcount GC leaks the socket until the
            # next reconnect iteration rebinds it, and under a tight
            # error loop that accumulates fds (reference
            # binlog_reader_resource_test analog)
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — already tearing down
                pass
            if self._conn is conn:
                self._conn = None

    def _stream_with(self, conn: MysqlConnection) -> None:
        conn.connect()
        self._conn = conn
        self.is_mariadb = conn.is_mariadb
        uuid = conn.fetch_server_uuid()
        if self._server_uuid and uuid != self._server_uuid:
            self.stats.failovers += 1
            StructuredLog().event("mysql_failover_detected").field(
                "old_uuid", self._server_uuid).field("new_uuid", uuid).warn()
        self._server_uuid = uuid
        problems = conn.validate_replication_prereqs()
        if problems:
            raise ProtocolError("replication prerequisites not met: "
                                + "; ".join(problems))
        self._load_schema_metadata(conn)
        parser = BinlogParser(tz_offset_sec=self.tz_offset_sec)
        for (schema, table), names in self._schema_cols.items():
            parser.set_schema_columns(schema, table, names,
                                      self._schema_unsigned.get(
                                          (schema, table)))
        if self.is_mariadb:
            pos = str(self.mariadb_pos) if self.mariadb_pos else \
                conn.fetch_executed_gtid()
            conn.start_binlog_dump_mariadb(self.repl_cfg.server_id, pos)
        else:
            if not self.executed:
                self.executed = GtidSet.parse(conn.fetch_executed_gtid())
            conn.start_binlog_dump_gtid(self.repl_cfg.server_id,
                                        self.executed)
        StructuredLog().event("binlog_stream_started").field(
            "mariadb", self.is_mariadb).field(
            "gtid", self.gtid_position()[:120]).info()
        while self._running.is_set():
            raw = conn.read_binlog_event()
            if raw is None:
                raise ProtocolError("binlog stream EOF")
            event = parser.parse_event(raw)
            if event is None:
                continue
            self.stats.events_received += 1
            self.stats.last_event_ts = time.time()
            # block while paused (dump/sync) without losing events
            while self._paused.is_set() and self._running.is_set():
                time.sleep(0.05)
            # bounded put: backpressure at capacity, but a stop() while
            # the worker has already exited must not block forever
            while self._running.is_set():
                try:
                    self.queue.put(event, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def _load_schema_metadata(self, conn: MysqlConnection) -> None:
        """Column names/signedness from INFORMATION_SCHEMA
        (reference TableMetadataCache enrichment)."""
        self._schema_cols = {}
        self._schema_unsigned = {}
        catalog = self.processor.catalog
        for ctx in catalog.contexts():
            schema = ctx.table_cfg.database or self.mysql_cfg.database
            table = ctx.table_cfg.name
            try:
                cols = conn.fetch_table_columns(schema, table)
            except ProtocolError:
                continue
            if cols:
                self._schema_cols[(schema, table)] = [c["name"] for c in cols]
                self._schema_unsigned[(schema, table)] = [
                    "unsigned" in c["column_type"].lower() for c in cols]

    # ------------------------------------------------------------------
    def _worker_loop(self) -> None:
        while self._running.is_set():
            try:
                event: BinlogEvent = self.queue.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._apply(event)
            except Exception as e:  # noqa: BLE001 — keep applying
                self.stats.last_error = str(e)
                StructuredLog().event("binlog_worker_error").field(
                    "error", repr(e)).error()

    def _apply(self, event: BinlogEvent) -> None:
        kind = event.kind
        if kind == "gtid":
            if event.gtid is not None:
                self._pending = event.gtid
            if event.mariadb_gtid is not None:
                self._pending_maria = event.mariadb_gtid
        elif kind == "rows":
            self.processor.apply_rows(event.rows)
            self.stats.events_applied += 1
        elif kind == "xid":
            # commit: promote pending GTID (binlog_reader.h:429-432)
            if self._pending is not None:
                self.executed.add(self._pending)
                self.current_gtid = self._pending
                self._pending = None
            if self._pending_maria is not None:
                self.mariadb_pos = self._pending_maria
                self._pending_maria = None
        elif kind == "query":
            if event.ddl_type != "other":
                self.processor.apply_ddl(event)
            # DDL in MySQL is auto-committing
            if self._pending is not None:
                self.executed.add(self._pending)
                self.current_gtid = self._pending
                self._pending = None
            if self._pending_maria is not None:
                self.mariadb_pos = self._pending_maria
                self._pending_maria = None

    # ------------------------------------------------------------------
    def status(self) -> Dict[str, object]:
        return {
            "enabled": 1,
            "running": 1 if self.running else 0,
            "state": ("paused" if self.paused else
                      "running" if self.running else "stopped"),
            "flavor": "mariadb" if self.is_mariadb else "mysql",
            "gtid_position": self.gtid_position()[:200],
            "events_received": self.stats.events_received,
            "events_applied": self.stats.events_applied,
            "queue_depth": self.queue.qsize(),
            "reconnects": self.stats.reconnects,
            "crc_errors": self.stats.crc_errors,
            "failovers": self.stats.failovers,
            "last_error": self.stats.last_error[:200],
        }
