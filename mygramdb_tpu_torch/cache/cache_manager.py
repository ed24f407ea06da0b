"""Cache manager facade (reference cache/cache_manager.h:40).

Glues QueryCache + InvalidationManager + per-table data-version counters.
The version counter closes the lookup/compute/insert race: ``lookup``
captures the table's data version BEFORE the query computes and ``insert``
drops the entry when the version has moved since — mirroring the
reference's capture-at-miss / check-at-insert guard
(search_pipeline.cpp:1510-1513, InsertToCache data_version param).

Hit-time staleness: cached results are sampled against the live document
store on every hit (min 10 ids, ~10% of the set, reference IsCacheStale,
search_pipeline.cpp:1117-1140); a sampled id whose PK no longer resolves
evicts the entry and reports a miss — this closes the window between a
binlog write and the deferred n-gram invalidation flush.

The pipeline-facing API is lookup(table, query) / insert(...): keys come
from QueryNormalizer (LIMIT/OFFSET/SORT excluded) so one cached unsorted
result serves all paginations.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..query.normalizer import QueryNormalizer
from ..query.parser import Query
from .invalidation import InvalidationManager, InvalidationQueue
from .query_cache import QueryCache


class CacheManager:
    def __init__(self, cfg, normalize_term=lambda s: s):
        self.cfg = cfg
        self.cache = QueryCache(
            max_memory_mb=cfg.max_memory_mb,
            ttl_seconds=cfg.ttl_seconds,
            min_query_cost_ms=cfg.min_query_cost_ms,
            compression_enabled=cfg.compression_enabled)
        self.normalizer = QueryNormalizer(normalize_term)
        self.invalidation = InvalidationManager()
        self.queue = InvalidationQueue(
            self._flush_invalidations,
            batch_size=cfg.invalidation.batch_size,
            max_delay_ms=cfg.invalidation.max_delay_ms)
        self.enabled = cfg.enabled
        self.strategy = cfg.invalidation_strategy
        self._versions: Dict[str, int] = {}
        # (table, key) -> component-swap generation at insert (bounded by
        # the cache's own eviction: pruned opportunistically on overflow)
        self._entry_generation: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()
        # last lookup/insert bookkeeping for debug info
        self.last_hit_age_ms = 0.0
        self.last_saved_ms = 0.0

    # ------------------------------------------------------------------
    def apply_setting(self, name: str, value) -> None:
        """Runtime SET for cache knobs that QueryCache snapshots at
        construction (reference runtime_variable_manager.h mutable set)."""
        if name == "cache.max_memory_mb":
            self.cache.max_memory = int(value) * 1024 * 1024
        elif name == "cache.ttl_seconds":
            self.cache.ttl = int(value)
        elif name == "cache.min_query_cost_ms":
            self.cache.min_cost_ms = float(value)

    # ------------------------------------------------------------------
    def data_version(self, table: str) -> int:
        return self._versions.get(table, 0)

    def bump_version(self, table: str) -> None:
        with self._lock:
            self._versions[table] = self._versions.get(table, 0) + 1

    # ------------------------------------------------------------------
    STALE_MIN_SAMPLES = 10      # reference kCacheStaleMinSamples
    STALE_SAMPLE_DIVISOR = 10   # reference kCacheStaleSampleDivisor (~10%)

    def _is_stale(self, ids: np.ndarray, doc_store) -> bool:
        """Sampled existence check of cached doc ids against the live
        document store (reference IsCacheStale)."""
        n = int(ids.size)
        if n == 0 or doc_store is None:
            return False
        sample = min(n, max(self.STALE_MIN_SAMPLES,
                            n // self.STALE_SAMPLE_DIVISOR))
        step = max(1, n // sample)
        sampled = ids[::step][:sample]
        pks = doc_store.primary_keys_batch(sampled.tolist())
        return any(pk is None for pk in pks)

    def lookup(self, table: str, query: Query, doc_store=None,
               generation: Optional[int] = None
               ) -> Tuple[Optional[str], Optional[Tuple[int, np.ndarray]], int]:
        """-> (cache_key, entry or None, data_version at lookup time).

        The version is captured BEFORE the query computes so insert() can
        reject results that raced with a table mutation. Key returned even
        on miss so the pipeline can insert after computing.

        ``generation`` is the caller's component-swap seqlock value: an
        entry inserted under a different generation was computed against a
        swapped-out corpus whose doc ids may be renumbered — PK sampling
        cannot catch that (a SYNC re-load can reuse both PKs and ids), so
        generation mismatch evicts unconditionally. This closes the window
        between a staging swap and the caller's clear_table()."""
        version = self.data_version(table)
        if not self.enabled:
            return None, None, version
        key = table + ":" + self.normalizer.cache_key(query)
        hit = self.cache.lookup(key)
        if hit is None:
            return key, None, version
        total, ids, age_ms, saved_ms = hit
        stale = self._is_stale(ids, doc_store)
        if not stale and generation is not None:
            with self._lock:
                gen_at_insert = self._entry_generation.get((table, key))
            stale = (gen_at_insert is not None
                     and gen_at_insert != generation)
        if stale:
            self.cache.invalidate(key)
            self.invalidation.unregister(key)
            self.cache.stats.misses += 1
            return key, None, version
        self.last_hit_age_ms = age_ms
        self.last_saved_ms = saved_ms
        return key, (total, ids), version

    def insert(self, table: str, key: str, query: Query,
               entry: Tuple[int, np.ndarray], cost_ms: float,
               ngrams: List[str],
               version_at_lookup: Optional[int] = None,
               generation: Optional[int] = None) -> bool:
        if not self.enabled or key is None:
            return False
        if self.strategy == "ngram" and not ngrams:
            # no gram registration => n-gram invalidation could never reach
            # this entry; a write would leave it stale until TTL. Don't cache.
            return False
        version_before = (version_at_lookup if version_at_lookup is not None
                          else self.data_version(table))
        if self.data_version(table) != version_before:
            # table mutated while the query computed: result may be stale
            return False
        total, ids = entry
        ok = self.cache.insert(key, total, ids, cost_ms)
        if ok:
            if generation is not None:
                with self._lock:
                    self._entry_generation[(table, key)] = generation
                    if len(self._entry_generation) > 65536:
                        live = set(self.cache.keys())
                        self._entry_generation = {
                            tk: g for tk, g in
                            self._entry_generation.items()
                            if tk[1] in live}
            if self.data_version(table) != version_before:
                # mutation landed between the check and the insert
                self.cache.invalidate(key)
                self.invalidation.unregister(key)
                return False
            if self.strategy == "ngram":
                self.invalidation.register(table, set(ngrams), key)
        return ok

    # ------------------------------------------------------------------
    # Write-path invalidation (binlog / SYNC)
    # ------------------------------------------------------------------
    def invalidate_by_ngrams(self, table: str, ngrams) -> None:
        self.bump_version(table)
        if not self.enabled:
            return
        if self.strategy == "table":
            self.clear_table(table)
            return
        self.queue.enqueue(table, ngrams)

    def _flush_invalidations(self, pairs) -> None:
        keys = set()
        for table, gram in pairs:
            keys |= self.invalidation.keys_for(table, gram)
        for k in keys:
            self.cache.invalidate(k)
            self.invalidation.unregister(k)

    def clear_table(self, table: str) -> int:
        self.bump_version(table)
        keys = self.invalidation.keys_for_table(table)
        n = 0
        for k in keys:
            if self.cache.invalidate(k):
                n += 1
            self.invalidation.unregister(k)
        # entries without gram registration (strategy=table) need full scan
        prefix = table + ":"
        for k in self.cache.keys():
            if k.startswith(prefix):
                if self.cache.invalidate(k):
                    n += 1
        return n

    def clear_all(self) -> int:
        n = self.cache.clear()
        self.invalidation.clear()
        with self._lock:
            for t in list(self._versions):
                self._versions[t] += 1
        return n

    # ------------------------------------------------------------------
    def set_enabled(self, enabled: bool) -> None:
        self.enabled = enabled

    @property
    def stats(self):
        return self.cache.stats
