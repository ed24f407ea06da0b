"""Result sorting and pagination.

Reference query/result_sorter.h:29: sort by PK (numeric-aware), by a filter
column (NULLs last), or by BM25 score; partial-sort when LIMIT is set. Here
the common PK path is vectorized numpy (doc-id order == PK order shortcut is
upstream on device); column sorts gather filter values once and argsort.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .parser import OrderByClause, SortOrder
from ..storage.document_store import DocumentStore, _pk_sort_key


class ResultSorter:
    @staticmethod
    def sort_and_paginate(doc_ids: np.ndarray, order_by: Optional[OrderByClause],
                          limit: int, offset: int,
                          doc_store: DocumentStore,
                          pk_order_valid: bool = True) -> np.ndarray:
        """doc_ids ascending -> sorted + paginated id array."""
        ob = order_by or OrderByClause()
        desc = ob.order == SortOrder.DESC
        if ob.is_primary_key:
            if pk_order_valid:
                ordered = doc_ids[::-1] if desc else doc_ids
            else:
                pks = doc_store.primary_keys_batch(doc_ids.tolist())
                keys = [_pk_sort_key(p or "") for p in pks]
                idx = [i for i, _ in sorted(enumerate(keys),
                                            key=lambda kv: kv[1],
                                            reverse=desc)]
                ordered = doc_ids[np.asarray(idx, dtype=np.int64)] \
                    if idx else doc_ids
            return ResultSorter.paginate(ordered, limit, offset)
        # filter-column sort: NULLs last in both directions
        vals = doc_store.filter_values_batch(doc_ids.tolist(), ob.column)
        non_null = [(i, v) for i, v in enumerate(vals) if v is not None]
        nulls = [i for i, v in enumerate(vals) if v is None]

        def key(v):
            if isinstance(v, (bool, int, float)):
                return (0, float(v), "")
            return (1, 0.0, str(v))

        # doc id is the tie-breaker, in the SAME direction as the sort
        # (reference SortByFilterColumnUsesDocIdTieBreaker: ASC ties ->
        # ascending ids, DESC ties -> descending ids); doc_ids arrive
        # ascending so the enumerate index orders like the id
        nn_sorted = sorted(non_null, key=lambda iv: (key(iv[1]), iv[0]),
                           reverse=desc)
        idx = [i for i, _ in nn_sorted] + \
            (nulls[::-1] if desc else nulls)
        ordered = doc_ids[np.asarray(idx, dtype=np.int64)] if idx else doc_ids
        return ResultSorter.paginate(ordered, limit, offset)

    @staticmethod
    def sort_by_score(doc_ids: Sequence[int], scores: Sequence[float],
                      descending: bool = True) -> List[int]:
        """BM25 sort; ties broken by doc id descending (stable w.r.t. the
        reference's PK-desc default)."""
        order = sorted(range(len(doc_ids)),
                       key=lambda i: (-scores[i] if descending else scores[i],
                                      -doc_ids[i]))
        return [doc_ids[i] for i in order]

    @staticmethod
    def paginate(ordered: np.ndarray, limit: int, offset: int) -> np.ndarray:
        if offset:
            ordered = ordered[offset:]
        if limit:
            ordered = ordered[:limit]
        return ordered
