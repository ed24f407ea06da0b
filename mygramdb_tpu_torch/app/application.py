"""Application lifecycle (reference app/application.h:49 +
app/server_orchestrator.cpp).

Startup order mirrors the reference (§3.1): load + validate config ->
logging -> tables (catalog) -> optional dump restore / seed load ->
replication (MySQL binlog) -> TCP + HTTP servers -> signal loop. Shutdown
runs in reverse.

``initialize()`` is timed as build stages (``utils.trace.build_stages()``):
``build.initialize`` around it all, ``build.load`` for the seed file's
load (parse, shred, host postings; the device build inside it is its own
stage), ``build.device`` for each device index and text store,
``build.kernels`` for the kernel library and ``build.warmup``. The
``build.load`` stage carries the index builder's ``term_stats``.
"""

from __future__ import annotations

import asyncio
import os
import signal
import threading
from typing import Optional

from ..catalog import TableCatalog
from ..config import Config, load_config
from ..server.core import ServerCore
from ..server.snapshot_scheduler import SnapshotScheduler
from ..server.tcp_server import TcpServer
from ..utils import trace
from ..utils.structured_log import StructuredLog, configure_logging


class Application:
    def __init__(self, config: Config, seed_path: Optional[str] = None,
                 restore_dump: Optional[str] = None):
        self.config = config
        self.seed_path = seed_path
        self.restore_dump = restore_dump
        self.catalog: Optional[TableCatalog] = None
        self.core: Optional[ServerCore] = None
        self.tcp: Optional[TcpServer] = None
        self.http = None
        self.binlog = None
        self.scheduler: Optional[SnapshotScheduler] = None
        self._stop_event: Optional[asyncio.Event] = None

    # ------------------------------------------------------------------
    def _verify_dump_directory(self) -> None:
        """Startup dump-directory check (reference application.cpp
        VerifyDumpDirectory): reject '..' components BEFORE creating
        anything (canonical checks after creation are too late), create
        the directory, and require it writable — DUMP SAVE failing at
        3am is the wrong time to learn about a typo'd path."""
        import os
        from ..utils.errors import ConfigError
        dump_dir = self.config.dump.dir
        if ".." in dump_dir.split(os.sep):
            raise ConfigError(
                f"dump.dir contains a '..' component: {dump_dir!r}")
        try:
            os.makedirs(dump_dir, exist_ok=True)
        except OSError as e:
            raise ConfigError(
                f"cannot create dump.dir {dump_dir!r}: {e}") from None
        if not os.access(dump_dir, os.W_OK):
            raise ConfigError(f"dump.dir is not writable: {dump_dir!r}")

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, config_path: str, seed_path: Optional[str] = None,
               restore_dump: Optional[str] = None) -> "Application":
        config = load_config(config_path)
        return cls(config, seed_path=seed_path, restore_dump=restore_dump)

    # ------------------------------------------------------------------
    def initialize(self) -> None:
        with trace.stage("build.initialize"):
            self._initialize()

    def _initialize(self) -> None:
        log = self.config.logging
        configure_logging(log.level, log.format, log.file)
        self._verify_dump_directory()
        self.catalog = TableCatalog(self.config)

        # replication backend (MySQL binlog reader) if configured
        binlog = None
        sync_loader = None
        if self.config.replication.enable and self.config.mysql.user:
            try:
                from ..replication.service import ReplicationService
                binlog = ReplicationService(self.config, self.catalog)
                sync_loader = binlog.sync_loader_factory()
            except Exception as e:  # noqa: BLE001 — startup resilience
                StructuredLog().event("replication_init_failed").field(
                    "error", str(e)).error()
        elif self.seed_path:
            from ..loader.file_loader import make_sync_loader
            sync_loader = make_sync_loader(self.seed_path)

        self.core = ServerCore(self.config, self.catalog,
                               binlog_reader=binlog,
                               sync_loader_factory=sync_loader)
        self.binlog = self.core.binlog
        if binlog is not None:
            binlog.attach_cache(self.core.cache)

        # restore from dump, then seed if empty
        if self.restore_dump:
            self.core.dump_manager.start_load(self.restore_dump,
                                              trusted=True)
            self.core.dump_manager.wait(timeout=3600)
        if self.seed_path and all(c.doc_count == 0
                                  for c in self.catalog.contexts()):
            from ..loader.file_loader import FileLoader
            for ctx in self.catalog.contexts():
                with trace.stage("build.load", table=ctx.name) as st:
                    FileLoader(ctx, self.config.build.batch_size).load_file(
                        self.seed_path)
                    # the term dictionary's work: term_path, terms_new,
                    # terms_found, term_collisions
                    st.set(**(ctx.index.built.term_stats or {}))

        # compact seeds onto the device (a failed device build fails
        # startup) and run the hot query programs once
        for ctx in self.catalog.contexts():
            if len(ctx.index.delta):
                ctx.optimize()
            try:
                ctx.index.device.warmup()
            except Exception as e:  # noqa: BLE001 — warmup is best-effort
                StructuredLog().event("warmup_failed").field(
                    "table", ctx.name).field("error", str(e)).warn()

        self.scheduler = SnapshotScheduler(
            self.core.dump_manager, self.config.dump,
            busy=lambda: self.core.sync_manager.any_running)
        self.core.vars.add_listener(
            lambda name, _v: self.scheduler.apply_interval()
            if name == "dump.interval_sec" else None)

    # ------------------------------------------------------------------
    async def run_async(self) -> None:
        if self.core is None:
            self.initialize()
        self._stop_event = asyncio.Event()
        self.tcp = TcpServer(self.core, self.config)
        await self.tcp.start()
        if self.config.api.http.enable:
            from ..server.http_server import HttpServer
            self.http = HttpServer(self.core, self.config)
            await self.http.start()
        if hasattr(self.binlog, "start_async"):
            await self.binlog.start_async()
        elif self.config.replication.auto_initial_snapshot and \
                hasattr(self.binlog, "start"):
            self.binlog.start()
        self.scheduler.start()
        # periodic rate-limiter sweep: drop idle client buckets so the
        # tracked-client table reflects live peers, not history
        # (reference rate_limiter_cleanup_test.cpp / io_reactor
        # maintenance loop)
        from ..utils.periodic import PeriodicWorker
        self._rl_sweeper = PeriodicWorker(
            60.0, self.core.rate_limiter.sweep_idle,
            name="rate-limiter-sweep")
        self._rl_sweeper.start()
        StructuredLog().event("server_ready").field(
            "tcp_port", self.tcp.port).info()
        try:
            await self._stop_event.wait()
        finally:
            await self.shutdown()

    async def shutdown(self) -> None:
        StructuredLog().event("server_stopping").info()
        if getattr(self, "_rl_sweeper", None) is not None:
            self._rl_sweeper.stop()
        if self.scheduler:
            self.scheduler.stop()
        if hasattr(self.binlog, "stop_async"):
            await self.binlog.stop_async()
        elif hasattr(self.binlog, "stop"):
            try:
                self.binlog.stop()
            except Exception:
                pass
        if self.http is not None:
            await self.http.stop()
        if self.tcp is not None:
            await self.tcp.stop()

    def request_stop(self) -> None:
        if self._stop_event is not None:
            self._stop_event.set()

    # ------------------------------------------------------------------
    @staticmethod
    def register_stack_dump_signal() -> None:
        """SIGUSR2 -> all-thread stack dump to stderr: first-line diagnosis
        for requests stuck in device dispatches (tunnel stalls) or lock
        waits, without restarting the server. Must be registered BEFORE
        initialize() — startup warmup compiles can run for minutes and an
        unregistered SIGUSR2 terminates the process."""
        import faulthandler
        try:
            faulthandler.register(signal.SIGUSR2, all_threads=True,
                                  chain=False)
        except (AttributeError, ValueError):  # non-Unix / no SIGUSR2
            pass

    def run(self) -> int:
        self.register_stack_dump_signal()

        async def _main():
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    loop.add_signal_handler(sig, self.request_stop)
                except NotImplementedError:
                    pass
            await self.run_async()

        asyncio.run(_main())
        return 0
