"""Async dump save/load with progress tracking.

Reference handlers/dump_handler.cpp + server_types.h:363 DumpProgress:
DUMP SAVE/LOAD run on a background worker thread; replication is paused for
the duration (replication_pause::Scope analog via callbacks); DUMP STATUS
polls progress; mutual exclusion against SYNC/OPTIMIZE via shared flags.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..storage import dump as dump_format
from ..utils.errors import DumpError, MygramError
from ..utils.safe_path import resolve_safe_path
from ..utils.structured_log import StructuredLog


@dataclass
class DumpProgress:
    operation: str = ""     # save | load
    state: str = "idle"      # idle | running | done | failed
    filepath: str = ""
    started_at: float = 0.0
    finished_at: float = 0.0
    error: str = ""
    bytes_written: int = 0
    tables_done: int = 0
    tables_total: int = 0

    def snapshot(self) -> Dict[str, object]:
        d = {
            "operation": self.operation or "none",
            "state": self.state,
            "filepath": self.filepath,
            "tables_done": self.tables_done,
            "tables_total": self.tables_total,
        }
        if self.state in ("done", "failed") and self.started_at:
            d["elapsed_sec"] = round(
                (self.finished_at or time.time()) - self.started_at, 3)
        if self.error:
            d["error"] = self.error
        if self.bytes_written:
            d["bytes"] = self.bytes_written
        return d


class DumpManager:
    def __init__(self, catalog, config, config_dict: Dict,
                 pause_replication: Callable[[], None] = lambda: None,
                 resume_replication: Callable[[], None] = lambda: None,
                 current_gtid: Callable[[], str] = lambda: "",
                 on_loaded_gtid: Callable[[str], None] = lambda g: None,
                 on_tables_replaced: Callable[[List[str]], None] = lambda names: None):
        self.catalog = catalog
        self.config = config
        self.config_dict = config_dict
        self.pause_replication = pause_replication
        self.resume_replication = resume_replication
        self.current_gtid = current_gtid
        self.on_loaded_gtid = on_loaded_gtid
        self.on_tables_replaced = on_tables_replaced
        self.progress = DumpProgress()
        self._lock = threading.Lock()
        self._busy = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    @property
    def busy(self) -> bool:
        return self._busy.is_set()

    def default_path(self) -> str:
        return os.path.join(self.config.dump.dir,
                            self.config.dump.default_filename)

    def _resolve(self, filepath: str) -> str:
        """Resolve a DUMP SAVE/LOAD/VERIFY path, confined to the dump
        directory (traversal/symlink escapes rejected — DUMP commands
        arrive over the network; reference dump_handler.cpp
        ResolveDumpFilepath + safe_path.h)."""
        if not filepath:
            return self.default_path()
        try:
            return resolve_safe_path(filepath, self.config.dump.dir,
                                     base_dir_label="dump directory")
        except MygramError as e:
            raise DumpError(e.message) from None

    # ------------------------------------------------------------------
    def start_save(self, filepath: str = "", with_stats: bool = False,
                   stats: Optional[Dict] = None) -> str:
        """Kick off async save; returns resolved path.
        Raises DumpError if another op is in flight."""
        path = self._resolve(filepath)  # before busy: a raise must not
        with self._lock:                # leave the manager wedged
            if self._busy.is_set():
                raise DumpError("another dump/sync operation is in progress")
            self._busy.set()
            self.progress = DumpProgress(
                operation="save", state="running", filepath=path,
                started_at=time.time(),
                tables_total=len(self.catalog.contexts()))
        self._thread = threading.Thread(
            target=self._save_worker, args=(path, stats), daemon=True,
            name="dump-save")
        self._thread.start()
        return path

    def _save_worker(self, path: str, stats: Optional[Dict]) -> None:
        try:
            self.pause_replication()
            try:
                states = []
                for ctx in self.catalog.contexts():
                    states.append(ctx.table_state())
                    self.progress.tables_done += 1
                size = dump_format.save_dump(
                    path, self.config_dict, states,
                    gtid=self.current_gtid(), stats=stats)
                self.progress.bytes_written = size
                self.progress.state = "done"
                StructuredLog().event("dump_saved").field("path", path) \
                    .field("bytes", size).info()
            finally:
                self.resume_replication()
        except Exception as e:  # noqa: BLE001 — worker boundary
            self.progress.state = "failed"
            self.progress.error = str(e)
            StructuredLog().event("dump_save_failed").field(
                "path", path).field("error", str(e)).error()
        finally:
            self.progress.finished_at = time.time()
            self._busy.clear()

    # ------------------------------------------------------------------
    def start_load(self, filepath: str, trusted: bool = False) -> str:
        # trusted=True: operator-supplied CLI path (--restore), not a
        # network command — exempt from the dump-directory confinement
        # (relative names still resolve against dump.dir)
        if trusted and filepath:
            path = (filepath if os.path.isabs(filepath)
                    else os.path.join(self.config.dump.dir, filepath))
        else:
            path = self._resolve(filepath)
        with self._lock:
            if self._busy.is_set():
                raise DumpError("another dump/sync operation is in progress")
            self._busy.set()
            self.progress = DumpProgress(
                operation="load", state="running", filepath=path,
                started_at=time.time())
        self._thread = threading.Thread(
            target=self._load_worker, args=(path,), daemon=True,
            name="dump-load")
        self._thread.start()
        return path

    def _load_worker(self, path: str) -> None:
        try:
            self.pause_replication()
            try:
                # validate-all-then-apply (reference DumpLoadAccess contract)
                info, tables = dump_format.load_dump(path)
                self.progress.tables_total = len(tables)
                by_name = {ts.name: ts for ts in tables}
                missing = [ts.name for ts in tables
                           if self.catalog.resolve(ts.name) is None]
                if missing:
                    raise DumpError(
                        f"dump contains unknown tables: {missing}")
                for name, ts in by_name.items():
                    ctx = self.catalog.resolve(name)
                    ctx.restore_from_state(ts)
                    self.progress.tables_done += 1
                if info.gtid:
                    self.on_loaded_gtid(info.gtid)
                self.on_tables_replaced(list(by_name))
                self.progress.state = "done"
                StructuredLog().event("dump_loaded").field("path", path) \
                    .field("tables", len(tables)).field(
                    "gtid", info.gtid).info()
            finally:
                self.resume_replication()
        except Exception as e:  # noqa: BLE001 — worker boundary
            self.progress.state = "failed"
            self.progress.error = str(e)
            StructuredLog().event("dump_load_failed").field(
                "path", path).field("error", str(e)).error()
        finally:
            self.progress.finished_at = time.time()
            self._busy.clear()

    # ------------------------------------------------------------------
    def wait(self, timeout: float = 60.0) -> bool:
        t = self._thread
        if t is not None:
            t.join(timeout)
            return not t.is_alive()
        return True

    def verify(self, filepath: str) -> dump_format.DumpInfo:
        return dump_format.verify_dump(self._resolve(filepath))

    def info(self, filepath: str) -> dump_format.DumpInfo:
        return dump_format.dump_info(self._resolve(filepath))
