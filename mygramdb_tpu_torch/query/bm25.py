"""BM25 relevance scoring (reference index/bm25_scorer.h:41).

Query-time, term-level scoring: IDF = ln((N - df + 0.5)/(df + 0.5) + 1);
TF = non-overlapping occurrences of the normalized search term in the
stored normalized text; doc length in code points; k1=1.2, b=0.75.

The scoring loop is vectorized: TF counting runs per candidate on host
(numpy over python str.count — C speed) and the BM25 combine runs as one
vectorized expression over the (n_candidates, n_terms) TF matrix. Corpus
stats (doc count, total length) live in BM25Stats (reference
server_types.h:140-194 atomic struct).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np


class BM25Stats:
    """Per-table corpus statistics, updated by load/replication.

    Doc lengths live in a flat int32 array indexed by doc id (-1 = absent)
    — doc ids are dense uint32 assigned in insertion order (design
    invariant), so the array form costs 4 bytes/doc where the previous
    Python dict cost ~100 (at 4M docs: 16 MB vs ~400 MB host RSS, and the
    dump section is one raw buffer instead of a 4M-entry msgpack map)."""

    _INIT_CAP = 1024

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._doc_count = 0
        self._total_length = 0
        self._arr = np.full(self._INIT_CAP, -1, dtype=np.int32)
        self._hi = 0  # 1 + highest doc id ever set (bounds state())

    def _grow(self, doc_id: int) -> None:
        cap = self._arr.shape[0]
        if doc_id < cap:
            return
        new_cap = max(cap * 2, doc_id + 1, self._INIT_CAP)
        arr = np.full(new_cap, -1, dtype=np.int32)
        arr[:cap] = self._arr
        self._arr = arr

    def add_document(self, doc_id: int, length_cp: int) -> None:
        if doc_id < 0:
            return
        with self._lock:
            self._grow(doc_id)
            old = int(self._arr[doc_id])
            if old >= 0:
                self._total_length -= old
                self._doc_count -= 1
            self._arr[doc_id] = length_cp
            self._hi = max(self._hi, doc_id + 1)
            self._doc_count += 1
            self._total_length += length_cp

    def remove_document(self, doc_id: int) -> None:
        with self._lock:
            if 0 <= doc_id < self._arr.shape[0]:
                old = int(self._arr[doc_id])
                if old >= 0:
                    self._arr[doc_id] = -1
                    self._doc_count -= 1
                    self._total_length -= old

    def clear(self) -> None:
        with self._lock:
            self._doc_count = 0
            self._total_length = 0
            self._arr = np.full(self._INIT_CAP, -1, dtype=np.int32)
            self._hi = 0

    @property
    def doc_count(self) -> int:
        return self._doc_count

    @property
    def total_length(self) -> int:
        return self._total_length

    @property
    def avg_doc_length(self) -> float:
        return self._total_length / self._doc_count if self._doc_count else 0.0

    def doc_length(self, doc_id: int) -> int:
        if 0 <= doc_id < self._arr.shape[0]:
            v = int(self._arr[doc_id])
            return v if v >= 0 else 0
        return 0

    def doc_length_array(self) -> np.ndarray:
        """Doc-id-indexed lengths, absents clipped to 0 — the device
        positional index's BM25-norm row (catalog restore/optimize)."""
        with self._lock:
            return np.maximum(self._arr[:self._hi], 0)

    def state(self) -> Dict:
        with self._lock:
            return {"doc_len_arr": self._arr[:self._hi].tobytes()}

    @classmethod
    def from_state(cls, state: Dict) -> "BM25Stats":
        s = cls()
        raw = state.get("doc_len_arr")
        if raw is not None:
            arr = np.frombuffer(raw, dtype=np.int32).copy()
            s._arr = arr if arr.size else np.full(cls._INIT_CAP, -1,
                                                  dtype=np.int32)
            s._hi = arr.size
            live = arr >= 0
            s._doc_count = int(np.sum(live))
            s._total_length = int(arr[live].astype(np.int64).sum())
            return s
        # legacy dict form (pre-array dumps)
        for d, l in state.get("doc_lengths", {}).items():
            s.add_document(int(d), int(l))
        return s


class BM25Scorer:
    @staticmethod
    def compute_idf(total_docs: int, doc_freq: int) -> float:
        return math.log((total_docs - doc_freq + 0.5) / (doc_freq + 0.5) + 1.0)

    @staticmethod
    def count_term_occurrences(text: str, term: str) -> int:
        if not term:
            return 0
        return text.count(term)

    @staticmethod
    def score_from_tf(tf: np.ndarray, doc_lens: np.ndarray,
                      term_doc_freqs: Sequence[int], total_docs: int,
                      avg_doc_length: float, k1: float = 1.2,
                      b: float = 0.75) -> np.ndarray:
        """BM25 combine over a precomputed (n, t) TF matrix (the TF source
        may be the host text scan or the device counting kernel)."""
        idf = np.asarray([BM25Scorer.compute_idf(total_docs, df)
                          for df in term_doc_freqs], dtype=np.float64)
        tf = tf.astype(np.float64)
        dl = doc_lens.astype(np.float64)
        if avg_doc_length <= 0:
            avg_doc_length = 1.0
        norm = k1 * (1.0 - b + b * dl / avg_doc_length)
        return (tf * (k1 + 1.0) / (tf + norm[:, None])) @ idf

    @staticmethod
    def score_documents(candidates: Sequence[int],
                        search_terms: Sequence[str],
                        term_doc_freqs: Sequence[int],
                        texts: Sequence[Optional[str]],
                        total_docs: int, avg_doc_length: float,
                        k1: float = 1.2, b: float = 0.75) -> np.ndarray:
        """-> (n,) float64 scores aligned with candidates.

        texts[i] is the stored normalized text of candidates[i] (None -> 0).
        """
        n = len(candidates)
        t = len(search_terms)
        if n == 0 or t == 0:
            return np.zeros(n, dtype=np.float64)
        idf = np.asarray([BM25Scorer.compute_idf(total_docs, df)
                          for df in term_doc_freqs], dtype=np.float64)
        from .. import native
        tf_i, dl_i = native.count_occurrences(texts, list(search_terms))
        tf = tf_i.astype(np.float64)
        dl = dl_i.astype(np.float64)
        if avg_doc_length <= 0:
            avg_doc_length = 1.0
        norm = k1 * (1.0 - b + b * dl / avg_doc_length)
        scores = (tf * (k1 + 1.0) / (tf + norm[:, None])) @ idf
        return scores
