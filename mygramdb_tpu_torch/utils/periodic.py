"""Periodic background worker (reference utils/periodic_worker.h:61).

Thread-based recurring task with prompt shutdown; used by the snapshot
scheduler, cache invalidation queue flusher and stats samplers.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class PeriodicWorker:
    def __init__(self, interval_sec: float, fn: Callable[[], None],
                 name: str = "periodic"):
        self._interval = interval_sec
        self._fn = fn
        self._name = name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name=self._name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self._fn()
            except Exception:
                from .structured_log import StructuredLog
                import traceback
                StructuredLog().event("periodic_worker_error").field(
                    "worker", self._name).field(
                    "error", traceback.format_exc(limit=3)).error()

    def set_interval(self, interval_sec: float) -> None:
        """Takes effect at the next wakeup (the current sleep finishes at
        the old interval); adequate for runtime SET of dump.interval_sec."""
        self._interval = interval_sec

    def trigger_now(self) -> None:
        try:
            self._fn()
        except Exception:
            pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
