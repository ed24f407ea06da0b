"""Snippet generation with match highlighting.

Reference query/highlighter.h:33-65: find non-overlapping match spans in the
stored normalized text, expand to context windows (snippet_length code
points), merge overlapping windows, join up to max_fragments with ellipsis,
and wrap matches in tags.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .parser import HighlightOptions

ELLIPSIS = "..."


def _find_spans(text: str, terms: Sequence[str]) -> List[Tuple[int, int]]:
    """Non-overlapping match spans, leftmost-first across all terms."""
    spans: List[Tuple[int, int]] = []
    for term in terms:
        if not term:
            continue
        start = 0
        while True:
            i = text.find(term, start)
            if i < 0:
                break
            spans.append((i, i + len(term)))
            start = i + len(term)
    # same start: keep the LONGEST match (reference
    # FindMatchPositions_OverlappingSameStartKeepsLongest); later
    # overlaps drop in favor of the earliest-kept span
    spans.sort(key=lambda se: (se[0], -se[1]))
    out: List[Tuple[int, int]] = []
    last_end = -1
    for s, e in spans:
        if s >= last_end:
            out.append((s, e))
            last_end = e
    return out


class Highlighter:
    def __init__(self, options: HighlightOptions):
        self.opt = options

    def snippet(self, normalized_text: str,
                normalized_terms: Sequence[str]) -> str:
        text = normalized_text
        spans = _find_spans(text, normalized_terms)
        if not spans:
            # no match: head of the document as context
            head = text[:self.opt.snippet_length]
            return head + (ELLIPSIS if len(text) > len(head) else "")
        ctx = max((self.opt.snippet_length - 1) // 2, 0)
        windows: List[Tuple[int, int]] = []
        for s, e in spans:
            ws = max(0, s - ctx)
            we = min(len(text), e + ctx)
            if windows and ws <= windows[-1][1]:
                windows[-1] = (windows[-1][0], max(windows[-1][1], we))
            else:
                windows.append((ws, we))
        windows = windows[:max(self.opt.max_fragments, 1)]

        frags: List[str] = []
        for ws, we in windows:
            inner = []
            pos = ws
            for s, e in spans:
                if s >= we or e <= ws:
                    continue
                s2, e2 = max(s, ws), min(e, we)
                inner.append(text[pos:s2])
                inner.append(self.opt.open_tag + text[s2:e2] +
                             self.opt.close_tag)
                pos = e2
            inner.append(text[pos:we])
            frags.append("".join(inner))
        joined = ELLIPSIS.join(frags)
        if windows[0][0] > 0:
            joined = ELLIPSIS + joined
        if windows[-1][1] < len(text):
            joined = joined + ELLIPSIS
        return joined

    def snippets(self, texts: Sequence[str],
                 normalized_terms: Sequence[str]) -> List[str]:
        return [self.snippet(t or "", normalized_terms) for t in texts]
