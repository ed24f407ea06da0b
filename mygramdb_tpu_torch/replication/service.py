"""Replication service facade wired into the application.

Bundles BinlogReader + BinlogEventProcessor + MySQL connections behind the
interface ServerCore expects (status/stop/start/pause/resume/current_gtid/
set_start_gtid) and provides the SYNC loader factory (online re-snapshot
via InitialLoader — reference SyncOperationManager uses
InitialLoader::LoadFromExistingSnapshot the same way).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ..catalog import TableCatalog, TableContext
from ..config.schema import Config
from ..utils.structured_log import StructuredLog
from .connection import MysqlConnection
from .initial_loader import InitialLoader
from .processor import BinlogEventProcessor
from .reader import BinlogReader


def _tz_offset_seconds(tz: str) -> int:
    """Parse '[+-]HH:MM' (reference mysql.datetime_timezone)."""
    try:
        sign = -1 if tz.startswith("-") else 1
        hh, mm = tz.lstrip("+-").split(":")
        return sign * (int(hh) * 3600 + int(mm) * 60)
    except Exception:
        return 0


class ReplicationService:
    enabled = True

    def __init__(self, config: Config, catalog: TableCatalog):
        self.config = config
        self.catalog = catalog
        self.processor = BinlogEventProcessor(
            catalog, cache_manager=None,
            database=config.mysql.database)
        self.reader = BinlogReader(
            config.mysql, config.replication, self.processor,
            tz_offset_sec=_tz_offset_seconds(
                config.mysql.datetime_timezone))
        start_from = config.replication.start_from
        if start_from.startswith("gtid="):
            self.reader.set_start_gtid(start_from[5:])

    # ------------------------------------------------------------------
    def attach_cache(self, cache_manager) -> None:
        self.processor.cache = cache_manager

    def _query_connection(self) -> MysqlConnection:
        m = self.config.mysql
        conn = MysqlConnection(
            m.host, m.port, m.user, m.password, m.database,
            connect_timeout=m.connect_timeout_ms / 1000.0,
            ssl_enable=m.ssl_enable, ssl_ca=m.ssl_ca,
            ssl_verify=m.ssl_verify_server_cert)
        conn.connect()
        return conn

    # ------------------------------------------------------------------
    # ServerCore interface
    # ------------------------------------------------------------------
    def status(self) -> Dict[str, object]:
        return self.reader.status()

    def start(self) -> bool:
        return self.reader.start()

    def stop(self) -> bool:
        return self.reader.stop()

    def pause(self) -> None:
        self.reader.pause()

    def resume(self) -> None:
        self.reader.resume()

    @property
    def current_gtid(self) -> str:
        return self.reader.gtid_position()

    def set_start_gtid(self, gtid: str) -> None:
        self.reader.set_start_gtid(gtid)

    # ------------------------------------------------------------------
    async def start_async(self) -> None:
        """Application startup: optional initial snapshot then stream."""
        if self.config.replication.auto_initial_snapshot:
            import asyncio
            await asyncio.get_running_loop().run_in_executor(
                None, self.initial_snapshot_all)
        if self.config.replication.start_from == "latest":
            try:
                conn = self._query_connection()
                self.reader.set_start_gtid(conn.fetch_executed_gtid())
                conn.close()
            except Exception as e:  # noqa: BLE001
                StructuredLog().event("latest_gtid_fetch_failed").field(
                    "error", str(e)).warn()
        self.reader.start()

    async def stop_async(self) -> None:
        self.reader.stop()

    def initial_snapshot_all(self) -> None:
        conn = self._query_connection()
        try:
            for ctx in self.catalog.contexts():
                loader = InitialLoader(ctx, conn,
                                       self.config.build.batch_size)
                loader.load(truncate_first=False)
                if loader.snapshot_gtid:
                    self.reader.set_start_gtid(loader.snapshot_gtid)
        finally:
            conn.close()

    # ------------------------------------------------------------------
    def sync_loader_factory(self) -> Callable:
        """SYNC <table> loader: fresh consistent snapshot per call."""
        def factory(ctx: TableContext, cancel: threading.Event,
                    progress: Callable[[int], None]) -> int:
            conn = self._query_connection()
            try:
                loader = InitialLoader(ctx, conn,
                                       self.config.build.batch_size)
                rows = loader.load(cancel=cancel, progress=progress,
                                   truncate_first=True)
                if loader.snapshot_gtid:
                    self.reader.set_start_gtid(loader.snapshot_gtid)
                return rows
            finally:
                conn.close()
        return factory
