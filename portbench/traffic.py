"""The one traffic generator: a traffic file's parameters in, a list of
distinct queries and their replay order out.

A traffic file (``portbench/traffic/<name>.json``) holds:

- ``connections``, ``client_processes``: the closed loop's callers;
- ``queries``: how many distinct queries the list holds;
- ``list_seed``: the seed of the list (terms and classes), the same for
  every run, so that every run does the same work; ``--seed`` orders it;
- ``warmup_per_class``: the warm-up asks the first this many queries of
  each class of the list (command, terms, lead, filter, dense or sparse);
- ``warmup_s``: seconds of load after those, before the window opens;
- ``limit``: the page size of a SEARCH;
- ``commands``: shares of ``search_id_desc`` (``SORT id DESC LIMIT n``),
  ``search_score`` (``SORT _score DESC LIMIT n``) and ``count``;
- ``terms``: shares of queries with 1, 2, 3 ... ANDed terms;
- ``lead``: shares of the lead term's language, ``en`` and ``ja``;
- ``filter_share``: the share with ``FILTER status = 1``;
- ``dense``: for each lead language, the share of its queries whose
  every gram is in at least ``dense_min_df`` of the documents (the rest
  have a rarer gram), or null for no constraint;
- ``max_rarest_df``: every query's rarest gram is in fewer documents than
  this, or null;
- ``en_min_len``: the shortest EN word asked for; ``ja_run``: the shortest
  and longest CJK run.

Each dimension's shares are met exactly (largest remainders) and the
dimensions are paired at random. A query's terms are cut from one
generated document of the lead's language, so that ANDed terms co-occur as
a caller's would: EN words, or runs of CJK ideographs. Document
frequencies come from every 16th document.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from . import gramindex, textrules

# the protocol's keywords: a term must not read as one
KEYWORDS = {"and", "or", "not", "filter", "sort", "limit", "offset",
            "highlight", "fuzzy", "asc", "desc", "tag", "snippet_len",
            "max_fragments"}
SAMPLE_EVERY = 16
DOCS_A_BATCH = 2048
MAX_TRIES = 20000
JA_RUNS = 8  # the CJK runs of a document a query's terms are cut from


def apportion(shares: Dict[str, float], n: int) -> List[str]:
    """n labels in the given shares, exactly, by largest remainders."""
    keys = sorted(shares)
    total = sum(shares[k] for k in keys)
    exact = [shares[k] / total * n for k in keys]
    base = [int(x) for x in exact]
    order = sorted(range(len(keys)), key=lambda i: base[i] - exact[i])
    for i in order[:n - sum(base)]:
        base[i] += 1
    return [k for k, c in zip(keys, base) for _ in range(c)]


def render(q: dict) -> str:
    parts = [q["cmd"], q["table"], q["terms"][0]]
    for t in q["terms"][1:]:
        parts += ["AND", t]
    if q["filter"]:
        parts += ["FILTER", "status", "=", "1"]
    if q["cmd"] == "SEARCH":
        parts += ["SORT", "_score" if q["score"] else "id", "DESC",
                  "LIMIT", str(q["limit"])]
    return " ".join(parts)


class Generator:
    def __init__(self, spec: dict, table: dict, texts: Sequence[str],
                 is_ja: np.ndarray):
        """texts: docs 1..N (texts[0] unused); is_ja: which are Japanese."""
        self.spec = spec
        self.table = table
        self.texts = texts
        self.n_docs = len(texts) - 1
        ids = np.arange(1, self.n_docs + 1)
        self.docs = {"ja": ids[is_ja[1:]], "en": ids[~is_ja[1:]]}
        sample = gramindex.Corpus(
            [""] + [texts[d] for d in range(SAMPLE_EVERY, self.n_docs + 1,
                                            SAMPLE_EVERY)])
        self.sample_df = sample.doc_freq()
        self.df: Dict[str, float] = {}

    def candidates(self, doc: int, lang: str, rng) -> List[str]:
        """The terms a caller could cut from a document: its EN words, or
        a run of ``ja_run`` CJK ideographs from each of up to JA_RUNS of
        its runs, drawn at random."""
        text = self.texts[doc]
        if lang == "en":
            lo = self.spec["en_min_len"]
            return sorted({w for w in text.split()
                           if len(w) >= lo and w.isascii()
                           and w.isalpha() and w not in KEYWORDS})
        lo, hi = self.spec["ja_run"]
        runs = textrules.CJK_RUN.findall(text)
        if lo > 1:
            runs = [r for r in runs if len(r) >= lo]
        out = set()
        for k in rng.permutation(len(runs))[:JA_RUNS].tolist():
            run = runs[k]
            L = int(rng.integers(lo, min(hi, len(run)) + 1))
            p = int(rng.integers(0, len(run) - L + 1))
            out.add(run[p:p + L])
        return sorted(out)

    def gram_df(self, gram: str) -> float:
        """A gram's document frequency, estimated from the sample."""
        if gram not in self.df:
            self.df[gram] = float(self.sample_df(gram) * SAMPLE_EVERY)
        return self.df[gram]

    def _ok(self, terms: List[str], dense: str) -> bool:
        dfs = [self.gram_df(g) for t in terms
               for g in textrules.query_grams(t, self.table)]
        if min(dfs) == 0:
            return False
        cut = self.spec["dense_min_df"] * self.n_docs
        if dense == "dense" and min(dfs) < cut:
            return False
        if dense == "sparse" and min(dfs) >= cut:
            return False
        top = self.spec["max_rarest_df"]
        return top is None or min(dfs) < top

    def queries(self) -> List[dict]:
        spec = self.spec
        n = spec["queries"]
        rng = np.random.default_rng(spec["list_seed"])
        dims = {"cmd": spec["commands"],
                "n": {str(k): v for k, v in spec["terms"].items()},
                "lead": spec["lead"],
                "filter": {"1": spec["filter_share"],
                           "0": 1 - spec["filter_share"]}}
        labels = {k: rng.permutation(apportion(v, n))
                  for k, v in dims.items()}
        labels["dense"] = np.full(n, "any", dtype=object)
        for lang, share in spec["dense"].items():
            if share is None:
                continue
            mine = np.flatnonzero(labels["lead"] == lang)
            labels["dense"][mine] = rng.permutation(apportion(
                {"dense": share, "sparse": 1 - share}, mine.size))
        pools = {lang: self._pools(lang, rng) for lang in ("en", "ja")}
        out, seen = [], set()
        for i in range(n):
            cls = {k: str(v[i]) for k, v in labels.items()}
            out.append(self._query(cls, rng, seen, pools))
        return out

    def _pools(self, lang: str, rng):
        """Endless candidate pools of random documents of lang."""
        while True:
            for d in rng.choice(self.docs[lang], DOCS_A_BATCH):
                yield self.candidates(int(d), lang, rng)

    def _query(self, cls: dict, rng, seen: set, pools: dict) -> dict:
        nterms, lang = int(cls["n"]), cls["lead"]
        dense = cls.get("dense", "any")
        for _ in range(MAX_TRIES):
            pool = next(pools[lang])
            if len(pool) < nterms:
                continue
            terms = [pool[j] for j in rng.choice(len(pool), nterms,
                                                 replace=False)]
            if not self._ok(terms, dense):
                continue
            q = {"table": self.spec["table"],
                 "cmd": "COUNT" if cls["cmd"] == "count" else "SEARCH",
                 "score": cls["cmd"] == "search_score",
                 "terms": terms, "filter": cls["filter"] == "1",
                 "limit": self.spec["limit"],
                 "cls": "/".join(f"{k}={v}" for k, v in sorted(cls.items()))}
            q["line"] = render(q)
            if q["line"] not in seen:
                seen.add(q["line"])
                return q
        raise RuntimeError(f"no query of class {cls} in {MAX_TRIES} tries")


def replay_order(n: int, seed: int) -> np.ndarray:
    """The run's order of the list, from --seed."""
    return np.random.default_rng(seed).permutation(n)
