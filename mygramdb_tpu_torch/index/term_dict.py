"""Host-side n-gram term dictionary.

Maps n-gram strings to dense integer term ids (the row/slice index into the
device posting structures). The reference stores string keys directly in an
absl::flat_hash_map per posting (index/index.h:343); on TPU the hot path
wants integer ids so the dictionary is the host-side front door.

The port's copy differs from the JAX package's: where the port's term
table library is loaded (``native.TermTable``), the dictionary lives there,
with no Python string or dict entry per term, and ``resolve`` numbers a
bulk build's new grams in one call. Strings are made only when asked for
(``term``, ``terms``, ``state``). Without the table it is the JAX package's
dict and list.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .. import native


class TermDict:
    __slots__ = ("_map", "_terms", "_table")

    def __init__(self) -> None:
        self._table = native.TermTable.create()
        self._map: Dict[str, int] = {}
        self._terms: List[str] = []

    @property
    def native(self) -> bool:
        """True where the native term table holds the dictionary."""
        return self._table is not None

    def __len__(self) -> int:
        if self._table is not None:
            return len(self._table)
        return len(self._terms)

    def get(self, term: str) -> Optional[int]:
        if self._table is not None:
            tid = self._table.id_of(term, False)
            return None if tid < 0 else tid
        return self._map.get(term)

    def get_or_add(self, term: str) -> int:
        if self._table is not None:
            return self._table.id_of(term, True)
        tid = self._map.get(term)
        if tid is None:
            tid = len(self._terms)
            self._map[term] = tid
            self._terms.append(term)
        return tid

    def get_or_add_many(self, terms: Sequence[str]) -> List[int]:
        """``get_or_add`` of each term in order, in one call."""
        if self._table is not None and terms:
            return self._table.add_in_order(terms).tolist()
        return [self.get_or_add(t) for t in terms]

    def term(self, tid: int) -> str:
        if self._table is not None:
            if tid < 0:
                raise IndexError("term id out of range")
            return self._table.terms(tid, tid + 1)[0]
        return self._terms[tid]

    def lookup_many(self, terms: Iterable[str]) -> List[Optional[int]]:
        if self._table is not None:
            return [self.get(t) for t in terms]
        m = self._map
        return [m.get(t) for t in terms]

    def resolve(self, flat: np.ndarray, starts: np.ndarray,
                lens: np.ndarray, hashes: np.ndarray):
        """A bulk build's grams (flat[starts[i]:starts[i] + lens[i]],
        hashed by the shredder) -> (tids int32, term_collisions) in one
        native call that numbers the new grams: the distinct ones, in
        ascending hash order (code-point order on a shared hash), from
        ``len(self)``. None without the table."""
        if self._table is None:
            return None
        return self._table.resolve(flat, starts, lens, hashes, False)

    def terms(self) -> List[str]:
        if self._table is not None:
            return self._table.terms()
        return self._terms

    def state(self):
        if self._table is not None:
            return self._table.terms()
        return list(self._terms)

    @classmethod
    def from_state(cls, terms: List[str]) -> "TermDict":
        td = cls()
        if td._table is not None:
            td._table.add_in_order(terms)
            return td
        td._terms = list(terms)
        td._map = {t: i for i, t in enumerate(td._terms)}
        return td
