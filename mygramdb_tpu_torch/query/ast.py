"""Boolean search-expression AST (reference query/query_ast.h).

Grammar (precedence NOT > AND > OR; query_ast.h:43-51):
    query    -> or_expr
    or_expr  -> and_expr (OR and_expr)*
    and_expr -> not_expr ((AND)? not_expr)*
    not_expr -> NOT not_expr | primary
    primary  -> TERM | '(' or_expr ')'

Caps: depth 32, 64 terms (query_ast.h:184-185). Evaluation maps TERM ->
device AND over the term's n-grams, AND/OR/NOT -> id-set algebra on the
(small) materialized results; ``matches_text`` re-evaluates the AST against
one normalized text for the verify_text post-filter
(search_pipeline.cpp:271-307).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from ..utils.errors import QueryParseError

MAX_DEPTH = 32
MAX_TERMS = 64


class NodeType(enum.Enum):
    AND = "AND"
    OR = "OR"
    NOT = "NOT"
    TERM = "TERM"


@dataclass
class QueryNode:
    type: NodeType
    term: str = ""
    children: List["QueryNode"] = field(default_factory=list)

    def to_string(self) -> str:
        if self.type == NodeType.TERM:
            return f'"{self.term}"'
        if self.type == NodeType.NOT:
            return f"NOT({self.children[0].to_string()})"
        sep = f" {self.type.value} "
        return "(" + sep.join(c.to_string() for c in self.children) + ")"

    def collect_terms(self, out: Optional[List[str]] = None) -> List[str]:
        if out is None:
            out = []
        if self.type == NodeType.TERM:
            out.append(self.term)
        else:
            for c in self.children:
                c.collect_terms(out)
        return out

    def collect_scoring_terms(self, out: Optional[List[str]] = None,
                              under_not: bool = False) -> List[str]:
        """Positive terms only (NOT-subtree terms don't contribute to BM25)."""
        if out is None:
            out = []
        if self.type == NodeType.TERM:
            if not under_not:
                out.append(self.term)
        elif self.type == NodeType.NOT:
            self.children[0].collect_scoring_terms(out, True)
        else:
            for c in self.children:
                c.collect_scoring_terms(out, under_not)
        return out

    # ------------------------------------------------------------------
    def evaluate(self, search_term: Callable[[str], np.ndarray],
                 all_docs: Callable[[], np.ndarray]) -> np.ndarray:
        """-> sorted ascending int32 doc ids.

        search_term(term) returns the doc ids matching a TERM leaf;
        all_docs() returns the full corpus id vector (for NOT complement).
        """
        if self.type == NodeType.TERM:
            return search_term(self.term)
        if self.type == NodeType.AND:
            result: Optional[np.ndarray] = None
            for c in self.children:
                ids = c.evaluate(search_term, all_docs)
                result = ids if result is None else \
                    np.intersect1d(result, ids, assume_unique=True)
                if result.size == 0:
                    break
            return result if result is not None else np.empty(0, np.int32)
        if self.type == NodeType.OR:
            result = np.empty(0, dtype=np.int32)
            for c in self.children:
                result = np.union1d(result, c.evaluate(search_term, all_docs))
            return result.astype(np.int32)
        # NOT: complement against corpus
        child = self.children[0].evaluate(search_term, all_docs)
        universe = all_docs()
        if child.size == 0:
            return universe
        return np.setdiff1d(universe, child, assume_unique=True)

    def matches_text(self, contains: Callable[[str], bool]) -> bool:
        """Evaluate the AST against one document text; ``contains(term)``
        does the normalized substring check."""
        if self.type == NodeType.TERM:
            return contains(self.term)
        if self.type == NodeType.AND:
            return all(c.matches_text(contains) for c in self.children)
        if self.type == NodeType.OR:
            return any(c.matches_text(contains) for c in self.children)
        return not self.children[0].matches_text(contains)

    def evaluate_masks(self, get_mask: Callable[[str], np.ndarray]
                       ) -> np.ndarray:
        """Vectorized matches_text over a candidate batch: get_mask(term)
        returns a (C,) bool contains-column (device verify kernel output);
        the AST evaluates with numpy boolean algebra instead of a per-doc
        Python loop (the boolean exact-text post-filter at 1M+ docs)."""
        if self.type == NodeType.TERM:
            return get_mask(self.term)
        if self.type == NodeType.AND:
            out = self.children[0].evaluate_masks(get_mask)
            for c in self.children[1:]:
                out = out & c.evaluate_masks(get_mask)
            return out
        if self.type == NodeType.OR:
            out = self.children[0].evaluate_masks(get_mask)
            for c in self.children[1:]:
                out = out | c.evaluate_masks(get_mask)
            return out
        return ~self.children[0].evaluate_masks(get_mask)

    def evaluate_device(self, term_words: Callable[[str], "object"],
                        ones_words: "object", bm_ops) -> "object":
        """Evaluate the AST as device bitmap algebra: term_words(term)
        returns a (W,) uint32 word bitmap on device; AND/OR/NOT map to
        fused word ops (the reference's in-process Roaring set algebra,
        index.cpp:378-446 — here nothing but the final W words ever
        crosses to the host)."""
        if self.type == NodeType.TERM:
            return term_words(self.term)
        if self.type == NodeType.AND:
            out = self.children[0].evaluate_device(term_words, ones_words,
                                                   bm_ops)
            for c in self.children[1:]:
                out = bm_ops.bm_and(
                    out, c.evaluate_device(term_words, ones_words, bm_ops))
            return out
        if self.type == NodeType.OR:
            out = self.children[0].evaluate_device(term_words, ones_words,
                                                   bm_ops)
            for c in self.children[1:]:
                out = bm_ops.bm_or(
                    out, c.evaluate_device(term_words, ones_words, bm_ops))
            return out
        child = self.children[0].evaluate_device(term_words, ones_words,
                                                 bm_ops)
        return bm_ops.bm_andnot(ones_words, child)


class _TokType(enum.Enum):
    AND = "AND"
    OR = "OR"
    NOT = "NOT"
    LPAREN = "("
    RPAREN = ")"
    TERM = "TERM"
    END = "END"


@dataclass
class _Tok:
    type: _TokType
    value: str = ""


def _lex(text: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        if ch == "(":
            toks.append(_Tok(_TokType.LPAREN))
            i += 1
            continue
        if ch == ")":
            toks.append(_Tok(_TokType.RPAREN))
            i += 1
            continue
        if ch in "\"'":
            j = i + 1
            buf = []
            while j < n and text[j] != ch:
                buf.append(text[j])
                j += 1
            if j >= n:
                raise QueryParseError("unclosed quote in boolean expression")
            toks.append(_Tok(_TokType.TERM, "".join(buf)))
            i = j + 1
            continue
        # bare word (up to whitespace or paren)
        j = i
        while j < n and not text[j].isspace() and text[j] not in "()":
            j += 1
        word = text[i:j]
        if word == "AND":
            toks.append(_Tok(_TokType.AND, word))
        elif word == "OR":
            toks.append(_Tok(_TokType.OR, word))
        elif word == "NOT":
            toks.append(_Tok(_TokType.NOT, word))
        else:
            toks.append(_Tok(_TokType.TERM, word))
        i = j
    toks.append(_Tok(_TokType.END))
    return toks


def contains_boolean_syntax(search_text: str) -> bool:
    """True when an uppercase AND/OR/NOT operator is adjacent to a primary
    (reference ContainsBooleanSyntax, search_pipeline.cpp:170)."""
    try:
        toks = _lex(search_text)
    except QueryParseError:
        return False

    def is_op(t: _Tok) -> bool:
        return t.type in (_TokType.AND, _TokType.OR, _TokType.NOT) and \
            t.value in ("AND", "OR", "NOT")

    def ends_primary(t: _Tok) -> bool:
        return t.type in (_TokType.TERM, _TokType.RPAREN)

    def starts_primary(t: _Tok) -> bool:
        return t.type in (_TokType.TERM, _TokType.LPAREN) or is_op(t)

    for i, t in enumerate(toks):
        if not is_op(t):
            continue
        prev_ok = i > 0 and ends_primary(toks[i - 1])
        next_ok = i + 1 < len(toks) and toks[i + 1].type != _TokType.END \
            and starts_primary(toks[i + 1])
        if prev_ok or next_ok:
            return True
    return False


class QueryASTParser:
    """Recursive-descent parser with depth/term caps."""

    def __init__(self) -> None:
        self.error = ""

    def parse(self, text: str) -> Optional[QueryNode]:
        self.error = ""
        try:
            toks = _lex(text)
        except QueryParseError as e:
            self.error = str(e)
            return None
        self._toks = toks
        self._pos = 0
        self._terms = 0
        try:
            node = self._or_expr(0)
        except QueryParseError as e:
            self.error = str(e)
            return None
        if self._peek().type != _TokType.END:
            self.error = f"unexpected token in boolean expression"
            return None
        return node

    def _peek(self) -> _Tok:
        return self._toks[self._pos]

    def _next(self) -> _Tok:
        t = self._toks[self._pos]
        self._pos += 1
        return t

    def _or_expr(self, depth: int) -> QueryNode:
        if depth > MAX_DEPTH:
            raise QueryParseError("boolean expression too deeply nested")
        left = self._and_expr(depth + 1)
        children = [left]
        while self._peek().type == _TokType.OR:
            self._next()
            children.append(self._and_expr(depth + 1))
        if len(children) == 1:
            return left
        node = QueryNode(NodeType.OR)
        node.children = children
        return node

    def _and_expr(self, depth: int) -> QueryNode:
        if depth > MAX_DEPTH:
            raise QueryParseError("boolean expression too deeply nested")
        children = [self._not_expr(depth + 1)]
        while True:
            t = self._peek()
            if t.type == _TokType.AND:
                self._next()
                children.append(self._not_expr(depth + 1))
            elif t.type in (_TokType.TERM, _TokType.LPAREN,
                            _TokType.NOT):
                # implicit AND
                children.append(self._not_expr(depth + 1))
            else:
                break
        if len(children) == 1:
            return children[0]
        node = QueryNode(NodeType.AND)
        node.children = children
        return node

    def _not_expr(self, depth: int) -> QueryNode:
        if depth > MAX_DEPTH:
            raise QueryParseError("boolean expression too deeply nested")
        if self._peek().type == _TokType.NOT:
            self._next()
            node = QueryNode(NodeType.NOT)
            node.children = [self._not_expr(depth + 1)]
            return node
        return self._primary(depth)

    def _primary(self, depth: int) -> QueryNode:
        t = self._next()
        if t.type == _TokType.LPAREN:
            node = self._or_expr(depth + 1)
            if self._next().type != _TokType.RPAREN:
                raise QueryParseError("expected closing parenthesis")
            return node
        if t.type == _TokType.TERM:
            self._terms += 1
            if self._terms > MAX_TERMS:
                raise QueryParseError(
                    f"boolean expression has too many terms (max {MAX_TERMS})")
            return QueryNode(NodeType.TERM, term=t.value)
        raise QueryParseError("expected term or parenthesized expression")
