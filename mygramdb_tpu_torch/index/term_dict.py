"""Host-side n-gram term dictionary.

Maps n-gram strings to dense integer term ids (the row/slice index into the
device posting structures). The reference stores string keys directly in an
absl::flat_hash_map per posting (index/index.h:343); on TPU the hot path
wants integer ids so the dictionary is the host-side front door.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional


class TermDict:
    __slots__ = ("_map", "_terms")

    def __init__(self) -> None:
        self._map: Dict[str, int] = {}
        self._terms: List[str] = []

    def __len__(self) -> int:
        return len(self._terms)

    def get(self, term: str) -> Optional[int]:
        return self._map.get(term)

    def get_or_add(self, term: str) -> int:
        tid = self._map.get(term)
        if tid is None:
            tid = len(self._terms)
            self._map[term] = tid
            self._terms.append(term)
        return tid

    def term(self, tid: int) -> str:
        return self._terms[tid]

    def lookup_many(self, terms: Iterable[str]) -> List[Optional[int]]:
        m = self._map
        return [m.get(t) for t in terms]

    def terms(self) -> List[str]:
        return self._terms

    def state(self):
        return list(self._terms)

    @classmethod
    def from_state(cls, terms: List[str]) -> "TermDict":
        td = cls()
        td._terms = list(terms)
        td._map = {t: i for i, t in enumerate(td._terms)}
        return td
