"""Canonical query normalization for cache keys.

Reference query/query_normalizer.h:23-36: uppercase keywords, normalized
terms, sorted filters, and — critically — LIMIT/OFFSET/SORT are excluded so
one cached (unsorted) result set serves every pagination of the same query.
"""

from __future__ import annotations

import hashlib
from typing import Callable

from .parser import Query, QueryType


class QueryNormalizer:
    def __init__(self, normalize_term: Callable[[str], str]):
        self._norm = normalize_term

    def canonical(self, query: Query) -> str:
        parts = [query.type.value, query.table]
        if query.search_text:
            # quoted (literal) vs boolean-parsed text are different
            # queries even when the characters match: key them apart
            tag = "QL:" if query.search_text_quoted else "Q:"
            parts.append(tag + self._norm(query.search_text))
        for t in sorted(self._norm(t) for t in query.and_terms):
            parts.append("A:" + t)
        for t in sorted(self._norm(t) for t in query.not_terms):
            parts.append("N:" + t)
        for f in sorted(query.filters,
                        key=lambda f: (f.column, f.op.value, f.value)):
            parts.append(f"F:{f.column}{f.op.value}{f.value}")
        if query.fuzzy_max_distance is not None:
            parts.append(f"Z:{query.fuzzy_max_distance}")
        if query.type == QueryType.FACET:
            parts.append("C:" + query.facet_column)
        return "\x1f".join(parts)

    def cache_key(self, query: Query) -> str:
        """128-bit digest of the canonical form (reference uses MD5,
        cache_key.h)."""
        return hashlib.md5(self.canonical(query).encode("utf-8")).hexdigest()
