"""Per-client token-bucket rate limiting (reference server/rate_limiter.h:88).

Token bucket per client IP (capacity = burst, refill_rate tokens/sec),
bounded client tracking with LRU sweep of idle entries. One instance is
shared between the TCP and HTTP planes (tcp_server.h:188-197)."""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Tuple


class RateLimiter:
    def __init__(self, capacity: int = 100, refill_rate: float = 10.0,
                 max_clients: int = 10000, enabled: bool = True):
        self.capacity = float(capacity)
        self.refill_rate = float(refill_rate)
        self.max_clients = max_clients
        self.enabled = enabled
        self._clients: "OrderedDict[str, Tuple[float, float]]" = OrderedDict()
        self._lock = threading.Lock()

    def allow(self, client_ip: str, cost: float = 1.0) -> bool:
        if not self.enabled:
            return True
        now = time.monotonic()
        with self._lock:
            tokens, last = self._clients.get(client_ip, (self.capacity, now))
            tokens = min(self.capacity, tokens + (now - last) * self.refill_rate)
            allowed = tokens >= cost
            if allowed:
                tokens -= cost
            self._clients[client_ip] = (tokens, now)
            self._clients.move_to_end(client_ip)
            while len(self._clients) > self.max_clients:
                self._clients.popitem(last=False)
            return allowed

    def sweep_idle(self, idle_seconds: float = 300.0) -> int:
        """Drop clients idle long enough to have fully refilled."""
        now = time.monotonic()
        removed = 0
        with self._lock:
            for ip in list(self._clients):
                _, last = self._clients[ip]
                if now - last > idle_seconds:
                    del self._clients[ip]
                    removed += 1
        return removed

    @property
    def tracked_clients(self) -> int:
        return len(self._clients)

    def configure(self, capacity: int = None, refill_rate: float = None,
                  enabled: bool = None) -> None:
        with self._lock:
            if capacity is not None:
                self.capacity = float(capacity)
            if refill_rate is not None:
                self.refill_rate = float(refill_rate)
            if enabled is not None:
                self.enabled = enabled
