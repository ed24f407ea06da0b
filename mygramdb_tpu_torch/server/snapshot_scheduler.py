"""Periodic auto-dump scheduler with retention.

Reference server/snapshot_scheduler.h:49: every ``dump.interval_sec`` write
``auto_YYYYMMDD_HHMMSS.dmp`` into the dump dir, keep the newest ``retain``
auto dumps, skip a cycle when a manual DUMP/SYNC/OPTIMIZE is running.
"""

from __future__ import annotations

import os
import time
from typing import Callable

from ..utils.periodic import PeriodicWorker
from ..utils.structured_log import StructuredLog

AUTO_PREFIX = "auto_"


class SnapshotScheduler:
    def __init__(self, dump_manager, dump_cfg,
                 busy: Callable[[], bool] = lambda: False):
        self.dm = dump_manager
        self.cfg = dump_cfg
        self.busy = busy
        self._worker = None
        self.last_result = ""

    def start(self) -> None:
        if self.cfg.interval_sec <= 0:
            return
        self._worker = PeriodicWorker(self.cfg.interval_sec, self._tick,
                                      name="snapshot-scheduler")
        self._worker.start()

    def stop(self) -> None:
        if self._worker is not None:
            self._worker.stop()
            self._worker = None

    def apply_interval(self) -> None:
        """Runtime `SET dump.interval_sec` took effect on self.cfg:
        start/stop/retime the worker to match."""
        if self.cfg.interval_sec <= 0:
            self.stop()
        elif self._worker is None:
            self.start()
        else:
            self._worker.set_interval(self.cfg.interval_sec)

    # ------------------------------------------------------------------
    def _tick(self) -> None:
        if self.busy() or self.dm.busy:
            self.last_result = "skipped_busy"
            return
        name = AUTO_PREFIX + time.strftime("%Y%m%d_%H%M%S") + ".dmp"
        try:
            self.dm.start_save(name)
            self.dm.wait(timeout=3600)
            self.last_result = "saved"
            self.cleanup()
        except Exception as e:  # noqa: BLE001 — scheduler boundary
            self.last_result = f"failed: {e}"
            StructuredLog().event("auto_dump_failed").field(
                "error", str(e)).error()

    def cleanup(self) -> int:
        """Delete auto dumps beyond the retention count (newest kept)."""
        try:
            entries = [f for f in os.listdir(self.cfg.dir)
                       if f.startswith(AUTO_PREFIX) and f.endswith(".dmp")]
        except OSError:
            return 0
        entries.sort(reverse=True)
        removed = 0
        for f in entries[max(self.cfg.retain, 0):]:
            try:
                os.unlink(os.path.join(self.cfg.dir, f))
                removed += 1
            except OSError:
                pass
        return removed
