"""Synonym dictionary (reference query/synonym_dictionary.h:27).

Per-table TSV file: tab-separated synonym groups per line, ``#`` comments.
Expansion is bidirectional within a group; terms are normalized with the
index normalizer at load so lookups match query normalization. Search
semantics: OR within a group, AND across groups
(search_pipeline.h:255-259).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set


class SynonymDictionary:
    def __init__(self, normalize: Callable[[str], str] = lambda s: s):
        self._normalize = normalize
        self._groups: List[List[str]] = []
        self._term_to_groups: Dict[str, List[int]] = {}

    def load_from_file(self, path: str) -> int:
        with open(path, "r", encoding="utf-8") as f:
            return self.load_from_text(f.read())

    def load_from_text(self, text: str) -> int:
        count = 0
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            terms = [self._normalize(t.strip())
                     for t in line.split("\t") if t.strip()]
            terms = [t for t in terms if t]
            if len(terms) < 2:
                continue
            gid = len(self._groups)
            # dedupe preserving order
            seen: Set[str] = set()
            group = []
            for t in terms:
                if t not in seen:
                    seen.add(t)
                    group.append(t)
            self._groups.append(group)
            for t in group:
                self._term_to_groups.setdefault(t, []).append(gid)
            count += 1
        return count

    @property
    def group_count(self) -> int:
        return len(self._groups)

    def expand(self, term: str) -> List[str]:
        """All synonyms of a normalized term (including itself), or just the
        term when unknown."""
        norm = self._normalize(term)
        gids = self._term_to_groups.get(norm)
        if not gids:
            return [norm]
        out: List[str] = []
        seen: Set[str] = set()
        for g in gids:
            for t in self._groups[g]:
                if t not in seen:
                    seen.add(t)
                    out.append(t)
        return out

    def has(self, term: str) -> bool:
        return self._normalize(term) in self._term_to_groups

    def clear(self) -> None:
        self._groups.clear()
        self._term_to_groups.clear()
