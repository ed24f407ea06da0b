"""Fluent query builder (reference client/search_expression.h).

    expr = (SearchExpression("articles")
            .query("hello world")
            .and_term("fast")
            .not_term("slow")
            .filter("status", "=", 1)
            .sort("_score", "DESC")
            .limit(10).offset(5)
            .fuzzy(1))
    line = expr.build()            # the SEARCH protocol line
    result = client.search_expr(expr)
"""

from __future__ import annotations

from typing import List, Optional, Union


def _quote(term: str) -> str:
    if any(c.isspace() for c in term) or '"' in term:
        return '"' + term.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return term


class SearchExpression:
    def __init__(self, table: str):
        self.table = table
        self._query = ""
        self._and: List[str] = []
        self._not: List[str] = []
        self._filters: List[str] = []
        self._sort = ""
        self._limit: Optional[int] = None
        self._offset: Optional[int] = None
        self._fuzzy: Optional[int] = None
        self._highlight: Optional[str] = None
        self._count_mode = False

    def query(self, text: str) -> "SearchExpression":
        self._query = text
        return self

    def and_term(self, term: str) -> "SearchExpression":
        self._and.append(term)
        return self

    def not_term(self, term: str) -> "SearchExpression":
        self._not.append(term)
        return self

    def filter(self, column: str, op: str,
               value: Union[str, int, float]) -> "SearchExpression":
        self._filters.append(f"{column} {op} {value}")
        return self

    def sort(self, column: str, order: str = "DESC") -> "SearchExpression":
        self._sort = f"{column} {order.upper()}"
        return self

    def limit(self, n: int) -> "SearchExpression":
        self._limit = n
        return self

    def offset(self, n: int) -> "SearchExpression":
        self._offset = n
        return self

    def fuzzy(self, distance: int = 1) -> "SearchExpression":
        self._fuzzy = distance
        return self

    def highlight(self, open_tag: str = "<em>",
                  close_tag: str = "</em>") -> "SearchExpression":
        self._highlight = f"TAG {_quote(open_tag)} {_quote(close_tag)}"
        return self

    def as_count(self) -> "SearchExpression":
        self._count_mode = True
        return self

    def build(self) -> str:
        cmd = "COUNT" if self._count_mode else "SEARCH"
        parts = [cmd, self.table, _quote(self._query)]
        for t in self._and:
            parts.append(f"AND {_quote(t)}")
        for t in self._not:
            parts.append(f"NOT {_quote(t)}")
        for f in self._filters:
            parts.append(f"FILTER {f}")
        if self._sort and not self._count_mode:
            parts.append(f"SORT {self._sort}")
        if self._limit is not None and not self._count_mode:
            parts.append(f"LIMIT {self._limit}")
        if self._offset is not None and not self._count_mode:
            parts.append(f"OFFSET {self._offset}")
        if self._highlight and not self._count_mode:
            parts.append(f"HIGHLIGHT {self._highlight}")
        if self._fuzzy is not None:
            parts.append(f"FUZZY {self._fuzzy}")
        return " ".join(parts)
