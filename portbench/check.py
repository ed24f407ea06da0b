"""The comparison that decides ``correct``: each distinct answer the
window gave to a query, held against the reference's answer.

Numbers compared, each with its limit (the configuration's ``limits``):

- ``wrong``: answers that differ from the reference, plus every ERROR,
  timeout or lost connection in the window. A COUNT must equal the
  reference's count; an id page its count and its ids, in order; a score
  page its count, as many distinct ids as the reference's page, each in
  the reference's result set. Limit 0.
- ``bm25_gap``: on score pages, the widest gap, relative to the reference's
  score there, between the reference (float64) score of the id served at a
  position and the best reference score at that position. It allows ties
  and float32 sums in another order, and catches a page out of order.

``controls`` holds the reference put in the program's place with one
guarantee broken or one precision lowered.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .reference import Reference, bf16

F16_MAX = 65504


def render(q: dict, ans: dict) -> str:
    """The protocol's line for a reference answer."""
    if q["cmd"] == "COUNT":
        return f"OK COUNT {ans['count']}"
    return " ".join([f"OK RESULTS {ans['count']}"]
                    + [str(int(d)) for d in ans["page"]])


def judge(q: dict, want: dict, got: str) -> Tuple[bool, Optional[float]]:
    """-> (right, bm25 gap of a score page or None)."""
    parts = got.split()
    if q["cmd"] == "COUNT":
        return parts == ["OK", "COUNT", str(want["count"])], None
    if parts[:2] != ["OK", "RESULTS"] or len(parts) < 3 \
            or parts[2] != str(want["count"]):
        return False, None
    try:
        page = [int(x) for x in parts[3:]]
    except ValueError:
        return False, None
    if not q["score"]:
        return page == [int(d) for d in want["page"]], None
    exact = want["exact"]
    if len(page) != len(want["page"]) or len(set(page)) != len(page) \
            or any(d not in exact for d in page):
        return False, None
    if not page:
        return True, 0.0
    best = np.asarray(want["ranked"])
    served = np.asarray([exact[d] for d in page])
    gap = np.abs(served - best) / np.maximum(np.abs(best), 1e-12)
    return True, float(gap.max())


def compare(ref: Reference, queries: List[dict],
            answers: Dict[int, Iterable[str]], failures: int,
            limits: dict, examples: Optional[list] = None
            ) -> Dict[str, dict]:
    """Numbers compared, each {"value", "limit"}. examples, when given,
    collects (query, answer, reference answer) of the first wrong
    answers."""
    wrong = failures
    gap = None
    for qi, got in answers.items():
        q = queries[qi]
        want = ref.answer(q)
        for line in got:
            ok, g = judge(q, want, line)
            if not ok:
                wrong += 1
                if examples is not None and len(examples) < 5:
                    examples.append([q["line"], line[:300],
                                     render(q, want)[:300]])
            if g is not None:
                gap = g if gap is None else max(gap, g)
    out = {"wrong": {"value": wrong, "limit": limits["wrong"]}}
    if "bm25_gap" in limits:
        out["bm25_gap"] = {"value": gap if gap is not None else 0.0,
                           "limit": limits["bm25_gap"]}
    return out


def control_answers(ref: Reference, queries: List[dict], qis,
                    control: str) -> Dict[int, List[str]]:
    """The reference in the program's place, with the control's fault:
    ``f16_counts``, every count rounded to float16, as a count reduced in
    half precision would be (exact up to 2,048, then to the nearest 2, 4,
    8 ...); ``bf16_bm25``, a score page ranked by BM25 computed in
    bfloat16."""
    out = {}
    for qi in qis:
        q = queries[qi]
        if control == "bf16_bm25":
            ans = ref.answer(q, rnd=bf16)
        elif control == "f16_counts":
            ans = dict(ref.answer(q))
            ans["count"] = int(np.float16(min(ans["count"], F16_MAX)))
        else:
            raise ValueError(f"unknown control {control!r}")
        out[qi] = [render(q, ans)]
    return out
