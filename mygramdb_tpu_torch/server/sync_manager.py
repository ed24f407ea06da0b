"""Online table re-snapshot (SYNC) manager.

Reference server/sync_operation_manager.h:85: SYNC <table> rebuilds one
table from the source in the background with a progress state machine and
per-table guards; SYNC STATUS/STOP inspect/cancel. The actual row source is
injected (``loader_factory``) — the MySQL initial loader in production, a
file/seed loader in tests — mirroring how the reference wires
InitialLoader::LoadFromExistingSnapshot.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from ..utils.structured_log import StructuredLog


@dataclass
class SyncState:
    table: str = ""
    state: str = "idle"   # idle|running|done|failed|cancelled
    started_at: float = 0.0
    finished_at: float = 0.0
    rows_loaded: int = 0
    error: str = ""

    def snapshot(self) -> Dict[str, object]:
        d = {"table": self.table, "state": self.state,
             "rows_loaded": self.rows_loaded}
        if self.started_at:
            d["elapsed_sec"] = round(
                (self.finished_at or time.time()) - self.started_at, 3)
        if self.error:
            d["error"] = self.error
        return d


class SyncOperationManager:
    """loader_factory(ctx, cancel_event, progress_cb) -> row count."""

    def __init__(self, catalog, loader_factory: Optional[Callable] = None,
                 pause_replication: Callable[[], None] = lambda: None,
                 resume_replication: Callable[[], None] = lambda: None,
                 dump_busy: Callable[[], bool] = lambda: False,
                 on_table_synced: Callable[[str], None] = lambda name: None):
        self.catalog = catalog
        self.loader_factory = loader_factory
        self.pause_replication = pause_replication
        self.resume_replication = resume_replication
        self.dump_busy = dump_busy
        self.on_table_synced = on_table_synced
        self._states: Dict[str, SyncState] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._cancels: Dict[str, threading.Event] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def start_sync(self, table: str = "") -> Dict[str, str]:
        """Start SYNC for one table (or all when empty). Returns
        {table: "started"|error}."""
        if self.loader_factory is None:
            raise RuntimeError(
                "SYNC requires a configured data source (replication "
                "disabled and no loader available)")
        if self.dump_busy():
            raise RuntimeError("dump operation in progress")
        tables = [table] if table else self.catalog.names()
        out = {}
        for name in tables:
            ctx = self.catalog.resolve(name)
            if ctx is None:
                out[name] = "unknown table"
                continue
            with self._lock:
                st = self._states.get(ctx.name)
                if st is not None and st.state == "running":
                    out[name] = "already running"
                    continue
                state = SyncState(table=ctx.name, state="running",
                                  started_at=time.time())
                self._states[ctx.name] = state
                cancel = threading.Event()
                self._cancels[ctx.name] = cancel
                t = threading.Thread(target=self._worker,
                                     args=(ctx, state, cancel),
                                     daemon=True, name=f"sync-{ctx.name}")
                self._threads[ctx.name] = t
            t.start()
            out[name] = "started"
        return out

    def _worker(self, ctx, state: SyncState, cancel: threading.Event) -> None:
        try:
            self.pause_replication()
            try:
                def progress(rows: int) -> None:
                    state.rows_loaded = rows

                rows = self.loader_factory(ctx, cancel, progress)
                if cancel.is_set():
                    state.state = "cancelled"
                else:
                    state.rows_loaded = rows
                    state.state = "done"
                    self.on_table_synced(ctx.name)
                    StructuredLog().event("sync_done").field(
                        "table", ctx.name).field("rows", rows).info()
            finally:
                self.resume_replication()
        except Exception as e:  # noqa: BLE001 — worker boundary
            state.state = "failed"
            state.error = str(e)
            StructuredLog().event("sync_failed").field(
                "table", ctx.name).field("error", str(e)).error()
        finally:
            state.finished_at = time.time()

    # ------------------------------------------------------------------
    def stop_sync(self, table: str = "") -> Dict[str, str]:
        out = {}
        with self._lock:
            targets = [table] if table else list(self._cancels)
            for name in targets:
                cancel = self._cancels.get(name)
                st = self._states.get(name)
                if cancel is None or st is None or st.state != "running":
                    out[name or "(all)"] = "not running"
                    continue
                cancel.set()
                out[name] = "stopping"
        return out

    def status(self) -> Dict[str, Dict]:
        with self._lock:
            return {name: st.snapshot() for name, st in self._states.items()}

    @property
    def any_running(self) -> bool:
        return any(st.state == "running" for st in self._states.values())

    def wait_all(self, timeout: float = 120.0) -> None:
        deadline = time.time() + timeout
        for t in list(self._threads.values()):
            t.join(max(0.0, deadline - time.time()))
