"""Precise n-gram cache invalidation.

Reference cache/invalidation_manager.h:50 + invalidation_queue.h:61: a
reverse index (table, n-gram) -> cache keys lets binlog writes invalidate
exactly the cached queries whose gram sets overlap the changed document;
events are queued and flushed after ``batch_size`` unique pairs or
``max_delay_ms`` (deferred batching so a binlog burst costs one sweep).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple


class InvalidationManager:
    """Reverse index: (table, ngram) -> set of cache keys."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_gram: Dict[Tuple[str, str], Set[str]] = {}
        self._by_key: Dict[str, List[Tuple[str, str]]] = {}

    def register(self, table: str, ngrams, key: str) -> None:
        with self._lock:
            pairs = [(table, g) for g in ngrams]
            self._by_key[key] = pairs
            for p in pairs:
                self._by_gram.setdefault(p, set()).add(key)

    def unregister(self, key: str) -> None:
        with self._lock:
            for p in self._by_key.pop(key, ()):
                s = self._by_gram.get(p)
                if s is not None:
                    s.discard(key)
                    if not s:
                        del self._by_gram[p]

    def keys_for(self, table: str, ngram: str) -> Set[str]:
        with self._lock:
            return set(self._by_gram.get((table, ngram), ()))

    def keys_for_table(self, table: str) -> Set[str]:
        with self._lock:
            out: Set[str] = set()
            for (t, _), keys in self._by_gram.items():
                if t == table:
                    out |= keys
            return out

    def clear(self) -> None:
        with self._lock:
            self._by_gram.clear()
            self._by_key.clear()


class InvalidationQueue:
    """Deferred batcher: unique (table, ngram) pairs -> flush callback."""

    def __init__(self, flush_fn: Callable[[List[Tuple[str, str]]], None],
                 batch_size: int = 1000, max_delay_ms: int = 100):
        self._flush_fn = flush_fn
        self.batch_size = batch_size
        self.max_delay = max_delay_ms / 1000.0
        self._pending: Set[Tuple[str, str]] = set()
        self._lock = threading.Lock()
        self._first_enqueue: Optional[float] = None
        self._timer: Optional[threading.Timer] = None

    def enqueue(self, table: str, ngrams) -> None:
        flush_now = False
        with self._lock:
            for g in ngrams:
                self._pending.add((table, g))
            if self._first_enqueue is None:
                self._first_enqueue = time.time()
                self._arm_timer()
            if len(self._pending) >= self.batch_size:
                flush_now = True
        if flush_now:
            self.flush()

    def _arm_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(self.max_delay, self.flush)
        self._timer.daemon = True
        self._timer.start()

    def flush(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            pending = list(self._pending)
            self._pending.clear()
            self._first_enqueue = None
        if pending:
            self._flush_fn(pending)

    def stop(self) -> None:
        self.flush()

    @property
    def pending_count(self) -> int:
        return len(self._pending)
