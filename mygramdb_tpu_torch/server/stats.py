"""Server statistics (reference server/server_stats.h:82,
statistics_service.h:59): per-command counters, connection counters,
replication counters, memory peak, and the seconds commands waited for an
executor thread; aggregated snapshots feed INFO and the Prometheus
/metrics endpoint."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict


class ServerStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._start = time.time()
        self._commands: Dict[str, int] = defaultdict(int)
        self.total_connections_received = 0
        self.current_connections = 0
        self.rejected_connections = 0
        self.rate_limited_requests = 0
        self.protocol_errors = 0
        self.replication_events_processed = 0
        self.replication_errors = 0
        self.memory_peak_bytes = 0
        self.slow_queries = 0
        self.total_query_time_ms = 0.0
        # from the event loop's hand-off to a worker starting the command
        self.executor_wait_s = 0.0

    # ------------------------------------------------------------------
    def record_command(self, name: str, elapsed_ms: float = 0.0,
                       waited_s: float = 0.0) -> None:
        """waited_s: the command's wait for an executor thread."""
        with self._lock:
            self._commands[name.lower()] += 1
            self.total_query_time_ms += elapsed_ms
            self.executor_wait_s += waited_s
            if elapsed_ms > 100.0:
                self.slow_queries += 1

    def record_connection(self, opened: bool) -> None:
        with self._lock:
            if opened:
                self.total_connections_received += 1
                self.current_connections += 1
            else:
                self.current_connections = max(0, self.current_connections - 1)

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected_connections += 1

    def record_rate_limited(self) -> None:
        with self._lock:
            self.rate_limited_requests += 1

    def record_protocol_error(self, waited_s: float = 0.0) -> None:
        with self._lock:
            self.protocol_errors += 1
            self.executor_wait_s += waited_s

    def record_replication_event(self, error: bool = False) -> None:
        with self._lock:
            if error:
                self.replication_errors += 1
            else:
                self.replication_events_processed += 1

    def observe_memory(self, current_bytes: int) -> None:
        with self._lock:
            self.memory_peak_bytes = max(self.memory_peak_bytes, current_bytes)

    # ------------------------------------------------------------------
    @property
    def uptime_seconds(self) -> int:
        return int(time.time() - self._start)

    @property
    def total_commands(self) -> int:
        return sum(self._commands.values())

    def command_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._commands)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "uptime_seconds": self.uptime_seconds,
                "total_commands": sum(self._commands.values()),
                "commands": dict(self._commands),
                "total_connections_received": self.total_connections_received,
                "current_connections": self.current_connections,
                "rejected_connections": self.rejected_connections,
                "rate_limited_requests": self.rate_limited_requests,
                "protocol_errors": self.protocol_errors,
                "replication_events_processed":
                    self.replication_events_processed,
                "replication_errors": self.replication_errors,
                "memory_peak_bytes": self.memory_peak_bytes,
                "slow_queries": self.slow_queries,
                "executor_wait_s": self.executor_wait_s,
            }
