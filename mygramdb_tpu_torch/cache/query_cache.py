"""LRU query-result cache.

Reference cache/query_cache.h: LRU keyed by a 128-bit digest of the
canonical query (LIMIT/OFFSET/SORT excluded upstream by QueryNormalizer),
compressed result id vectors (zlib here; reference uses LZ4), memory
ceiling, TTL, min-cost admission, and rich stats.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    invalidations: int = 0
    expired: int = 0
    rejected_low_cost: int = 0
    memory_bytes: int = 0
    entry_count: int = 0
    total_saved_ms: float = 0.0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclass
class _Entry:
    payload: bytes
    total: int
    compressed: bool
    cost_ms: float
    created: float
    size: int


class QueryCache:
    def __init__(self, max_memory_mb: int = 32, ttl_seconds: int = 3600,
                 min_query_cost_ms: float = 10.0,
                 compression_enabled: bool = True):
        self.max_memory = max_memory_mb * 1024 * 1024
        self.ttl = ttl_seconds
        self.min_cost_ms = min_query_cost_ms
        self.compress = compression_enabled
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._lock = threading.Lock()
        self._mem = 0
        self.stats = CacheStats()

    # ------------------------------------------------------------------
    def lookup(self, key: str) -> Optional[Tuple[int, np.ndarray, float, float]]:
        """-> (total, ids, age_ms, saved_ms) or None."""
        now = time.time()
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.stats.misses += 1
                return None
            if self.ttl and now - e.created > self.ttl:
                self._remove(key)
                self.stats.expired += 1
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            self.stats.total_saved_ms += e.cost_ms
            payload = zlib.decompress(e.payload) if e.compressed else e.payload
            ids = np.frombuffer(payload, dtype=np.int32).copy()
            return e.total, ids, (now - e.created) * 1000, e.cost_ms

    def insert(self, key: str, total: int, ids: np.ndarray,
               cost_ms: float) -> bool:
        if cost_ms < self.min_cost_ms:
            self.stats.rejected_low_cost += 1
            return False
        raw = np.ascontiguousarray(ids, dtype=np.int32).tobytes()
        compressed = False
        payload = raw
        if self.compress and len(raw) > 64:
            z = zlib.compress(raw, 1)
            if len(z) < len(raw):
                payload = z
                compressed = True
        size = len(payload) + len(key) + 96
        if size > self.max_memory:
            return False
        with self._lock:
            if key in self._entries:
                self._remove(key)
            while self._mem + size > self.max_memory and self._entries:
                _, old = self._entries.popitem(last=False)
                self._mem -= old.size
                self.stats.evictions += 1
            self._entries[key] = _Entry(payload, total, compressed, cost_ms,
                                        time.time(), size)
            self._mem += size
            self.stats.inserts += 1
            self.stats.memory_bytes = self._mem
            self.stats.entry_count = len(self._entries)
        return True

    def _remove(self, key: str) -> None:
        e = self._entries.pop(key, None)
        if e is not None:
            self._mem -= e.size
            self.stats.memory_bytes = self._mem
            self.stats.entry_count = len(self._entries)

    def invalidate(self, key: str) -> bool:
        with self._lock:
            if key in self._entries:
                self._remove(key)
                self.stats.invalidations += 1
                return True
            return False

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._mem = 0
            self.stats.memory_bytes = 0
            self.stats.entry_count = 0
            return n

    @property
    def entry_count(self) -> int:
        return len(self._entries)

    def keys(self):
        with self._lock:
            return list(self._entries.keys())
