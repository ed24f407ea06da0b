"""The plain reference: what every query of the benchmark must answer,
from the generated documents alone, in numpy and Python.

Semantics (the configuration's, restated; see ``textrules``):

- A term matches a document when every one of the term's grams is a
  substring of the document's normalized text. On a table that verifies
  text (``memory.verify_text: all``) the normalized term itself must be a
  substring too.
- A query matches a document when every term does and, with ``FILTER
  status = 1``, the document's ``status`` is 1.
- ``COUNT`` answers the number of matches; ``SEARCH ... SORT id DESC LIMIT
  n`` the count and the n largest matching ids, largest first.
- ``SORT _score DESC`` ranks by BM25 (reference ``index/bm25_scorer.h``):
  IDF ln((N - df + 0.5) / (df + 0.5) + 1) with df the term's gram-AND
  document count over the table and N its documents; TF the
  non-overlapping occurrences of the normalized term (``str.count``);
  document length in code points; k1 1.2, b 0.75; float64; ties by the
  larger id first.

It imports nothing of the program and takes nothing the program made.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from . import gramindex, textrules

K1, B = 1.2, 0.75


class Reference:
    def __init__(self, corpus: gramindex.Corpus, status: np.ndarray,
                 table: dict, verify_text: bool,
                 postings: Dict[str, np.ndarray]):
        self.corpus = corpus
        self.texts = corpus.texts
        self.status = status
        self.table = table
        self.verify_text = verify_text
        self.postings = postings
        self.n_docs = corpus.n_docs
        self.avgdl = float(corpus.doc_len[1:].sum()) / self.n_docs
        self.sets = gramindex.Sets(self.n_docs)
        self.filter_bits = np.packbits(status == 1, bitorder="little")
        self._df: Dict[str, int] = {}

    @classmethod
    def for_queries(cls, corpus, status, table, verify_text, queries):
        grams = {g for q in queries for t in q["terms"]
                 for g in textrules.query_grams(t, table)}
        return cls(corpus, status, table, verify_text,
                   corpus.postings(grams))

    def grams(self, terms) -> list:
        return sorted({g for t in terms
                       for g in textrules.query_grams(t, self.table)})

    def candidates(self, q: dict) -> gramindex.Result:
        """Docs holding every gram of every term, and passing the
        filter."""
        r = self.sets.intersect([(g, self.postings[g])
                                 for g in self.grams(q["terms"])])
        return r.where(self.filter_bits) if q["filter"] else r

    def result(self, q: dict) -> gramindex.Result:
        """Docs the query matches."""
        r = self.candidates(q)
        checks = [t for t in q["terms"]
                  if textrules.query_grams(t, self.table) != [t]]
        if not self.verify_text or not checks:
            return r
        ids = r.ids()
        texts = self.texts
        for t in checks:
            ids = ids[np.array([t in texts[d] for d in ids.tolist()],
                               dtype=bool)]
        return gramindex.Result(ids=ids)

    def df(self, term: str) -> int:
        """The term's gram-AND document count over the table."""
        if term not in self._df:
            self._df[term] = self.sets.intersect(
                [(g, self.postings[g]) for g in self.grams([term])]).count()
        return self._df[term]

    def bm25(self, q: dict, ids: np.ndarray, rnd=None) -> np.ndarray:
        """BM25 of ids in float64, or with every intermediate rounded by
        rnd (the control's lower precision)."""
        rnd = rnd or (lambda x: np.asarray(x, dtype=np.float64))
        dl = rnd(self.corpus.doc_len[ids])
        norm = rnd(rnd(K1) * rnd(rnd(1.0 - B) + rnd(rnd(B) * rnd(
            dl / rnd(self.avgdl)))))
        score = rnd(np.zeros(ids.size))
        for t in q["terms"]:
            df = self.df(t)
            idf = rnd(math.log((self.n_docs - df + 0.5) / (df + 0.5) + 1.0))
            tf = rnd([self.texts[d].count(t) for d in ids.tolist()])
            part = rnd(rnd(tf * rnd(K1 + 1.0)) / rnd(tf + norm))
            score = rnd(score + rnd(idf * part))
        return score

    def answer(self, q: dict, rnd=None) -> dict:
        """{"count"; for SEARCH "page", the ids in answer order; for a
        score page also "exact", id -> float64 score, and "ranked", the
        best float64 scores position by position}. rnd ranks a score page
        by scores computed in a lower precision (the control)."""
        r = self.result(q)
        out = {"count": r.count()}
        if q["cmd"] == "COUNT":
            return out
        n = q["limit"]
        if not q["score"]:
            out["page"] = r.top(n)
            return out
        ids = r.ids()
        exact = self.bm25(q, ids)
        sc = exact if rnd is None else self.bm25(q, ids, rnd)
        out["page"] = ids[np.lexsort((-ids, -sc))[:n]]
        out["ranked"] = exact[np.lexsort((-ids, -exact))[:n]]
        out["exact"] = dict(zip(ids.tolist(), exact.tolist()))
        return out


def bf16(x) -> np.ndarray:
    """x rounded to bfloat16 (to nearest, ties to even), as float64."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32).astype(np.float64)
