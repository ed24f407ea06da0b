"""Text-protocol query parser.

Parses the full MygramDB command grammar (reference query/query_parser.h:37-87
for the command set; clause semantics per query_parser_clauses.cpp):

  SEARCH <table> <text> [AND t] [NOT t] [FILTER col op v] [SORT col ASC|DESC]
         [LIMIT n | off,cnt] [OFFSET n] [HIGHLIGHT [TAG o c] [SNIPPET_LEN n]
         [MAX_FRAGMENTS n]] [FUZZY [1|2]]
  COUNT <table> <text> [clauses]         FACET <table> <col> [text] [clauses]
  GET <table> <pk>                       INFO
  DUMP SAVE [path] [--with-stats] | LOAD path | VERIFY path | INFO path | STATUS
  SAVE/LOAD [path]  (legacy)             REPLICATION STATUS|STOP|START
  SYNC [table] | SYNC STATUS | SYNC STOP [table]
  CONFIG [HELP|SHOW [path] | VERIFY path]     OPTIMIZE [table]
  DEBUG ON|OFF        CACHE CLEAR [table]|STATS|ENABLE|DISABLE
  SET var = value [, var2 = value2]      SHOW VARIABLES [LIKE 'pat']

Flat AND/NOT clauses stay clauses; a top-level OR or a parenthesized boolean
operand keeps the whole expression in search_text for the AST parser
(query_parser_commands.cpp behavior).
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..utils.errors import QueryParseError


class QueryType(enum.Enum):
    SEARCH = "SEARCH"
    COUNT = "COUNT"
    GET = "GET"
    INFO = "INFO"
    DUMP_SAVE = "DUMP_SAVE"
    DUMP_LOAD = "DUMP_LOAD"
    DUMP_VERIFY = "DUMP_VERIFY"
    DUMP_INFO = "DUMP_INFO"
    DUMP_STATUS = "DUMP_STATUS"
    SAVE = "SAVE"
    LOAD = "LOAD"
    REPLICATION_STATUS = "REPLICATION_STATUS"
    REPLICATION_STOP = "REPLICATION_STOP"
    REPLICATION_START = "REPLICATION_START"
    SYNC = "SYNC"
    SYNC_STATUS = "SYNC_STATUS"
    SYNC_STOP = "SYNC_STOP"
    CONFIG_HELP = "CONFIG_HELP"
    CONFIG_SHOW = "CONFIG_SHOW"
    CONFIG_VERIFY = "CONFIG_VERIFY"
    OPTIMIZE = "OPTIMIZE"
    DEBUG_ON = "DEBUG_ON"
    DEBUG_OFF = "DEBUG_OFF"
    CACHE_CLEAR = "CACHE_CLEAR"
    CACHE_STATS = "CACHE_STATS"
    CACHE_ENABLE = "CACHE_ENABLE"
    CACHE_DISABLE = "CACHE_DISABLE"
    SET = "SET"
    SHOW_VARIABLES = "SHOW_VARIABLES"
    FACET = "FACET"
    UNKNOWN = "UNKNOWN"


class FilterOp(enum.Enum):
    EQ = "="
    NE = "!="
    GT = ">"
    GTE = ">="
    LT = "<"
    LTE = "<="


_FILTER_OPS = {
    "=": FilterOp.EQ, "==": FilterOp.EQ, "!=": FilterOp.NE, "<>": FilterOp.NE,
    ">": FilterOp.GT, ">=": FilterOp.GTE, "≥": FilterOp.GTE,
    "<": FilterOp.LT, "<=": FilterOp.LTE, "≤": FilterOp.LTE,
}


class SortOrder(enum.Enum):
    ASC = "ASC"
    DESC = "DESC"


@dataclass
class FilterCondition:
    column: str
    op: FilterOp = FilterOp.EQ
    value: str = ""


@dataclass
class OrderByClause:
    column: str = ""              # empty = primary key
    order: SortOrder = SortOrder.DESC

    @property
    def is_primary_key(self) -> bool:
        return self.column == ""

    @property
    def is_score(self) -> bool:
        return self.column == "_score"


@dataclass
class HighlightOptions:
    open_tag: str = "<em>"
    close_tag: str = "</em>"
    snippet_length: int = 100
    max_fragments: int = 3


@dataclass
class Query:
    type: QueryType = QueryType.UNKNOWN
    table: str = ""
    search_text: str = ""
    and_terms: List[str] = field(default_factory=list)
    not_terms: List[str] = field(default_factory=list)
    filters: List[FilterCondition] = field(default_factory=list)
    order_by: Optional[OrderByClause] = None
    limit: int = 100
    offset: int = 0
    limit_explicit: bool = False
    offset_explicit: bool = False
    primary_key: str = ""
    filepath: str = ""
    dump_with_stats: bool = False
    variable_assignments: List[Tuple[str, str]] = field(default_factory=list)
    variable_like_pattern: str = ""
    facet_column: str = ""
    highlight: Optional[HighlightOptions] = None
    fuzzy_max_distance: Optional[int] = None
    cache_key: Optional[str] = None
    # True when the search text came from quoted token(s): it is ONE
    # literal term — downstream boolean-syntax detection must not
    # re-parse AND/OR/NOT out of it (reference quoted-region semantics)
    search_text_quoted: bool = False

    @property
    def all_terms(self) -> List[str]:
        out = [self.search_text] if self.search_text else []
        out.extend(self.and_terms)
        return out


# Clause keywords that terminate search-text accumulation.
_NON_EXPR_KEYWORDS = {"FILTER", "SORT", "LIMIT", "OFFSET", "HIGHLIGHT",
                      "FUZZY"}
_EXPR_KEYWORDS = {"AND", "NOT"}
_ALL_CLAUSE_KEYWORDS = _NON_EXPR_KEYWORDS | _EXPR_KEYWORDS

_WS_RE = re.compile(r"\s")


# A token is a list of (text, was_quoted) segments: '("abc' tokenizes to
# [('(', False), ('abc', True)]. Quoted segments are literal search text
# and must never be read as clause/boolean keywords or grouping parens
# (reference: the parser's keyword logic "must skip quoted regions",
# http_server_search_test.cpp:1604).
TokenSegments = List[Tuple[str, bool]]


def tokenize(text: str) -> List[str]:
    """Whitespace split with single/double quotes and backslash escapes."""
    return [_seg_text(t) for t in tokenize_segments(text)]


def tokenize_segments(text: str) -> List[TokenSegments]:
    tokens: List[TokenSegments] = []
    segs: TokenSegments = []
    buf: List[str] = []
    buf_quoted = False
    has_token = False
    quote = ""
    escape = False

    def push_buf() -> None:
        nonlocal buf
        if buf:
            segs.append(("".join(buf), buf_quoted))
            buf = []

    def put(ch: str, quoted: bool) -> None:
        nonlocal buf_quoted
        if buf and buf_quoted != quoted:
            push_buf()
        buf_quoted = quoted
        buf.append(ch)

    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if escape:
            put({"n": "\n", "t": "\t", "r": "\r"}.get(ch, ch), bool(quote))
            escape = False
            i += 1
            continue
        if ch == "\\":
            escape = True
            has_token = True
            i += 1
            continue
        if quote:
            if ch == quote:
                quote = ""
            else:
                put(ch, True)
            i += 1
            continue
        if ch in "\"'":
            quote = ch
            has_token = True
            # an empty quoted region still marks the token as quoted
            if not buf or not buf_quoted:
                push_buf()
                buf_quoted = True
            i += 1
            continue
        if ch.isspace():
            if has_token:
                push_buf()
                tokens.append(segs)
                segs = []
                has_token = False
                buf_quoted = False
            i += 1
            continue
        put(ch, False)
        has_token = True
        i += 1
    if escape:
        raise QueryParseError("trailing backslash in query")
    if quote:
        raise QueryParseError("unclosed quote in query")
    if has_token:
        push_buf()
        tokens.append(segs)
    return tokens


def _seg_text(segs: TokenSegments) -> str:
    return "".join(s for s, _ in segs)


def _seg_any_quoted(segs: TokenSegments) -> bool:
    return any(q for _, q in segs) or not segs


def _seg_parens(segs: TokenSegments) -> Tuple[int, int]:
    """(open, close) counts over UNQUOTED segments only — quoted parens
    are literal text, not grouping."""
    o = c = 0
    for s, q in segs:
        if not q:
            o += s.count("(")
            c += s.count(")")
    return o, c


def _count_parens(token: str) -> Tuple[int, int]:
    return token.count("("), token.count(")")


def _finalize_search_text(toks: List[TokenSegments]) -> Tuple[str, bool]:
    """Assemble accumulated search tokens -> (search_text, quoted_flag).

    Decision mirrors the pipeline's own routing test: assemble the
    boolean form (quoted segments re-quoted) and ask the quote-aware
    ``contains_boolean_syntax`` whether it actually parses as a boolean
    expression. If yes, keep the boolean form. If not, the text is ONE
    literal substring term: strip quotes and flag it quoted when any
    part was, so downstream never re-parses AND/OR/NOT out of it."""
    from .ast import contains_boolean_syntax
    bool_form = _assemble_search_text(toks, True)
    if contains_boolean_syntax(bool_form):
        return bool_form, False
    literal = _assemble_search_text(toks, False)
    return literal, any(_seg_any_quoted(t) for t in toks)


def _requote(s: str) -> str:
    qc = '"' if '"' not in s else "'"
    return qc + s + qc


def _assemble_search_text(toks: List[TokenSegments],
                          is_bool_expr: bool) -> str:
    """Join accumulated search tokens back into search_text.

    Literal (non-boolean) text: plain space join, quotes stripped — the
    whole text is ONE substring term. Boolean expressions: quoted
    SEGMENTS are RE-QUOTED so the AST lexer (quote-aware) keeps them as
    literal terms ('(a OR b) AND "c d"', '("a" AND "b")'), and the
    paren-adjacency join is preserved for grouping tokens."""
    parts: List[str] = []
    for i, segs in enumerate(toks):
        if i > 0:
            prev = toks[i - 1]
            prev_open = (prev and not prev[-1][1]
                         and prev[-1][0].endswith("("))
            cur_close = (segs and not segs[0][1]
                         and segs[0][0].startswith(")"))
            if not (prev_open or cur_close):
                parts.append(" ")
        if is_bool_expr:
            parts.extend(_requote(s) if q else s for s, q in segs)
        else:
            parts.append(_seg_text(segs))
    return "".join(parts)


def parse_search_expression(text: str) -> Tuple[str, bool]:
    """Parse a bare search expression (the HTTP plane's ``q`` field) with
    the SAME semantics as the TCP SEARCH operand: quoted phrases,
    boolean AND/OR/NOT, grouping. -> (search_text, search_text_quoted).

    Clause keywords (LIMIT/FILTER/SORT/...) outside quotes are parameter
    pollution and rejected — the JSON body has dedicated fields for them
    (reference http_server_search_test.cpp:1604-1639: quoted keywords
    and boolean operators pass, bare clause keywords do not)."""
    toks = tokenize_segments(text)
    if not toks:
        return "", False
    depth = 0
    for segs in toks:
        up = _seg_text(segs).upper()
        unquoted = not _seg_any_quoted(segs)
        if depth == 0 and unquoted and (up in _NON_EXPR_KEYWORDS
                                        or up == "ORDER"):
            raise QueryParseError(
                f"clause keyword {up} is not allowed in q (use the "
                "request's own fields)")
        o, c = _seg_parens(segs)
        depth += o - c
        if depth < 0:
            raise QueryParseError("Unmatched closing parenthesis")
    if depth > 0:
        raise QueryParseError("Unclosed parenthesis")
    return _finalize_search_text(toks)


class QueryParser:
    """Stateless parser: parse(line) -> Query (raises QueryParseError)."""

    def __init__(self, default_limit: int = 100, max_query_length: int = 0):
        self.default_limit = default_limit
        self.max_query_length = max_query_length

    # ------------------------------------------------------------------
    def parse(self, line: str) -> Query:
        line = line.strip()
        if not line:
            raise QueryParseError("empty query")
        if self.max_query_length and len(line) > max(self.max_query_length, 0) \
                and line.split(None, 1)[0].upper() in ("SEARCH", "COUNT", "FACET"):
            raise QueryParseError("query too long")
        segs = tokenize_segments(line)
        tokens = [_seg_text(t) for t in segs]
        if not tokens:
            raise QueryParseError("empty query")
        cmd = tokens[0].upper()
        if _seg_any_quoted(segs[0]):
            raise QueryParseError(f"unknown command: {tokens[0]}")
        handler = self._COMMANDS.get(cmd)
        if handler is None:
            raise QueryParseError(f"unknown command: {tokens[0]}")
        if cmd in ("SEARCH", "COUNT", "FACET"):
            return handler(self, tokens, segs)
        return handler(self, tokens)

    # ------------------------------------------------------------------
    def _parse_search(self, tokens: List[str],
                      segs: Optional[List[TokenSegments]] = None) -> Query:
        return self._parse_search_like(tokens, QueryType.SEARCH, segs=segs)

    def _parse_count(self, tokens: List[str],
                     segs: Optional[List[TokenSegments]] = None) -> Query:
        return self._parse_search_like(tokens, QueryType.COUNT, segs=segs)

    def _parse_facet(self, tokens: List[str],
                     segs: Optional[List[TokenSegments]] = None) -> Query:
        if len(tokens) < 3:
            raise QueryParseError("FACET requires table and column")
        sub_segs = None if segs is None else \
            [segs[0], segs[1]] + segs[3:]
        q = self._parse_search_like(
            ["FACET", tokens[1]] + tokens[3:], QueryType.FACET,
            require_search_text=False, segs=sub_segs)
        q.facet_column = tokens[2]
        return q

    def _parse_search_like(self, tokens: List[str], qtype: QueryType,
                           require_search_text: bool = True,
                           segs: Optional[List[TokenSegments]] = None
                           ) -> Query:
        if len(tokens) < 2:
            raise QueryParseError(f"{qtype.value} requires a table name")
        q = Query(type=qtype, table=tokens[1], limit=self.default_limit)
        if segs is None:
            # plain-token call (tests/back-compat): everything unquoted
            segs = [[(t, False)] if t else [] for t in tokens]
        if "," in q.table or (len(tokens) > 2 and tokens[2] == ","):
            raise QueryParseError(
                "Multiple tables not supported. Hint: MygramDB searches a "
                "single table at a time.")
        pos = 2
        # parenthesis balance check (quoted parens are literal text)
        depth = 0
        for i in range(pos, len(tokens)):
            o, c = _seg_parens(segs[i])
            depth += o - c
            if depth < 0:
                raise QueryParseError("Unmatched closing parenthesis")
        if depth > 0:
            raise QueryParseError("Unclosed parenthesis")

        # classify: top-level OR / grouped operand => whole boolean
        # expression. Quoted keywords/parens never count.
        has_top_or = False
        has_grouped = False
        scan_depth = 0
        seen_top_op = False
        for i in range(pos, len(tokens)):
            unquoted = not _seg_any_quoted(segs[i])
            up = tokens[i].upper()
            o, c = _seg_parens(segs[i])
            if scan_depth == 0 and o > 0 and seen_top_op:
                has_grouped = True
            scan_depth += o - c
            if scan_depth == 0 and unquoted:
                if up in _NON_EXPR_KEYWORDS or up == "ORDER":
                    break
                if up == "OR":
                    has_top_or = True
                    break
                if up in ("AND", "NOT"):
                    seen_top_op = True
        is_bool_expr = has_top_or or has_grouped

        # accumulate search text (clause keywords only terminate at depth
        # 0 and only when unquoted — quoted keywords are search text)
        search_toks: List[TokenSegments] = []
        depth = 0
        while pos < len(tokens):
            up = tokens[pos].upper()
            if depth == 0 and not _seg_any_quoted(segs[pos]):
                if up == "ORDER":
                    raise QueryParseError(
                        "ORDER BY is not supported. Use SORT instead.")
                if up in _NON_EXPR_KEYWORDS or \
                        (not is_bool_expr and up in _EXPR_KEYWORDS):
                    break
            o, c = _seg_parens(segs[pos])
            depth += o - c
            search_toks.append(segs[pos])
            pos += 1

        if search_toks:
            q.search_text, q.search_text_quoted = \
                _finalize_search_text(search_toks)
        elif require_search_text:
            raise QueryParseError(f"{qtype.value} requires search text")
        if require_search_text and search_toks and \
                not any(_seg_text(t) for t in search_toks):
            raise QueryParseError(f"{qtype.value} requires search text")

        # clauses
        while pos < len(tokens):
            kw = tokens[pos].upper()
            if kw == "AND":
                if pos + 1 >= len(tokens):
                    raise QueryParseError("AND requires a term")
                q.and_terms.append(tokens[pos + 1])
                pos += 2
            elif kw == "NOT":
                if pos + 1 >= len(tokens):
                    raise QueryParseError("NOT requires a term")
                q.not_terms.append(tokens[pos + 1])
                pos += 2
            elif kw == "FILTER":
                pos = self._parse_filter(tokens, pos, q)
            elif kw == "SORT":
                pos = self._parse_sort(tokens, pos, q)
            elif kw == "LIMIT":
                pos = self._parse_limit(tokens, pos, q)
            elif kw == "OFFSET":
                if pos + 1 >= len(tokens):
                    raise QueryParseError("OFFSET requires a number")
                q.offset = self._parse_uint(tokens[pos + 1], "OFFSET")
                q.offset_explicit = True
                pos += 2
            elif kw == "HIGHLIGHT":
                pos = self._parse_highlight(tokens, pos, q)
            elif kw == "FUZZY":
                pos = self._parse_fuzzy(tokens, pos, q)
            elif kw == "ORDER":
                raise QueryParseError("ORDER BY is not supported. Use SORT instead.")
            else:
                raise QueryParseError(f"unexpected token: {tokens[pos]}")
        if q.type == QueryType.COUNT:
            q.limit = 0
        return q

    # README/CLI compound forms: FILTER status=1 / FILTER status= 1.
    # Longest operators first so 'a>=2' never parses as op '>' value '=2'
    # (reference ParseFilterArguments, query_parser_clauses.cpp:96-151).
    _COMPOUND_OPS = (">=", "<=", "!=", "<>", "=", ">", "<")
    _MAX_FILTER_COLUMN = 128   # query_parser.h:273
    _MAX_FILTER_VALUE = 1024   # query_parser.h:274

    # ------------------------------------------------------------------
    def _parse_filter(self, tokens: List[str], pos: int, q: Query) -> int:
        if len(tokens) - pos < 2:
            raise QueryParseError("FILTER requires column, operator and value")
        f = self._parse_compound_filter(tokens, pos + 1)
        if f is not None:
            cond, consumed = f
        else:
            if len(tokens) - pos < 4:
                raise QueryParseError(
                    "FILTER requires column, operator and value")
            op_tok = tokens[pos + 2]
            op = _FILTER_OPS.get(op_tok)
            if op is None:
                raise QueryParseError(f"invalid filter operator: {op_tok}")
            cond = FilterCondition(column=tokens[pos + 1], op=op,
                                   value=tokens[pos + 3])
            consumed = 3
        if len(cond.column) > self._MAX_FILTER_COLUMN:
            raise QueryParseError("FILTER column name exceeds maximum "
                                  f"length ({self._MAX_FILTER_COLUMN})")
        if len(str(cond.value)) > self._MAX_FILTER_VALUE:
            raise QueryParseError("FILTER value exceeds maximum length "
                                  f"({self._MAX_FILTER_VALUE})")
        q.filters.append(cond)
        return pos + 1 + consumed

    def _parse_compound_filter(self, tokens: List[str], pos: int
                               ) -> Optional[Tuple[FilterCondition, int]]:
        """'col=value' / 'col=' + 'value' single-token operator forms.
        -> (condition, tokens consumed starting at pos) or None to fall
        back to the three-token 'col op value' form."""
        token = tokens[pos]
        for sym in self._COMPOUND_OPS:
            cut = token.find(sym)
            if cut == -1:
                continue
            col, val = token[:cut], token[cut + len(sym):]
            if not col:
                return None
            op = _FILTER_OPS.get(sym)
            if op is None:
                return None
            if val:
                return FilterCondition(column=col, op=op, value=val), 1
            if pos + 1 >= len(tokens):
                return None
            nxt = tokens[pos + 1]
            if nxt[:1] in ("=", "<", ">", "!"):
                return None
            return FilterCondition(column=col, op=op, value=nxt), 2
        return None

    def _parse_sort(self, tokens: List[str], pos: int, q: Query) -> int:
        if pos + 1 >= len(tokens):
            raise QueryParseError("SORT requires a column")
        col = tokens[pos + 1]
        order = SortOrder.DESC
        pos += 2
        if pos < len(tokens) and tokens[pos].upper() in ("ASC", "DESC"):
            order = SortOrder[tokens[pos].upper()]
            pos += 1
        if pos < len(tokens) and tokens[pos].upper() not in \
                _ALL_CLAUSE_KEYWORDS:
            raise QueryParseError(
                "Multiple column sorting is not supported. Hint: Sort by a "
                "single column only.")
        q.order_by = OrderByClause(column=col, order=order)
        return pos

    def _parse_limit(self, tokens: List[str], pos: int, q: Query) -> int:
        if pos + 1 >= len(tokens):
            raise QueryParseError("LIMIT requires a number")
        arg = tokens[pos + 1]
        if "," in arg:
            off_s, cnt_s = arg.split(",", 1)
            q.offset = self._parse_uint(off_s, "LIMIT offset")
            q.limit = self._parse_uint(cnt_s, "LIMIT count")
            q.offset_explicit = True
        else:
            q.limit = self._parse_uint(arg, "LIMIT")
        q.limit_explicit = True
        return pos + 2

    def _parse_highlight(self, tokens: List[str], pos: int, q: Query) -> int:
        hl = HighlightOptions()
        pos += 1
        while pos < len(tokens):
            kw = tokens[pos].upper()
            if kw == "TAG":
                if pos + 2 >= len(tokens):
                    raise QueryParseError("HIGHLIGHT TAG requires open and close tags")
                hl.open_tag = tokens[pos + 1]
                hl.close_tag = tokens[pos + 2]
                pos += 3
            elif kw == "SNIPPET_LEN":
                if pos + 1 >= len(tokens):
                    raise QueryParseError("SNIPPET_LEN requires a number")
                hl.snippet_length = self._parse_uint(tokens[pos + 1],
                                                     "SNIPPET_LEN")
                pos += 2
            elif kw == "MAX_FRAGMENTS":
                if pos + 1 >= len(tokens):
                    raise QueryParseError("MAX_FRAGMENTS requires a number")
                hl.max_fragments = self._parse_uint(tokens[pos + 1],
                                                    "MAX_FRAGMENTS")
                pos += 2
            else:
                break
        q.highlight = hl
        return pos

    def _parse_fuzzy(self, tokens: List[str], pos: int, q: Query) -> int:
        pos += 1
        dist = 1
        if pos < len(tokens):
            t = tokens[pos]
            if t.isdigit():
                dist = int(t)
                if dist < 1 or dist > 2:
                    raise QueryParseError(
                        f"FUZZY distance must be 1 or 2, got: {t}")
                pos += 1
            elif t.upper() not in _ALL_CLAUSE_KEYWORDS:
                raise QueryParseError(f"invalid FUZZY argument: {t}")
        q.fuzzy_max_distance = dist
        return pos

    @staticmethod
    def _parse_uint(s: str, what: str) -> int:
        if not s.isdigit():
            raise QueryParseError(f"{what} must be a non-negative integer, got: {s}")
        return int(s)

    # ------------------------------------------------------------------
    # Non-search commands
    # ------------------------------------------------------------------
    def _parse_get(self, tokens: List[str]) -> Query:
        if len(tokens) < 3:
            raise QueryParseError("GET requires table and primary key")
        return Query(type=QueryType.GET, table=tokens[1],
                     primary_key=tokens[2])

    def _parse_info(self, tokens: List[str]) -> Query:
        return Query(type=QueryType.INFO)

    def _parse_save(self, tokens: List[str]) -> Query:
        q = Query(type=QueryType.SAVE)
        if len(tokens) > 1:
            q.filepath = tokens[1]
        return q

    def _parse_load(self, tokens: List[str]) -> Query:
        q = Query(type=QueryType.LOAD)
        if len(tokens) > 1:
            q.filepath = tokens[1]
        return q

    def _parse_dump(self, tokens: List[str]) -> Query:
        if len(tokens) < 2:
            raise QueryParseError(
                "DUMP requires a subcommand (SAVE, LOAD, VERIFY, INFO, STATUS)")
        sub = tokens[1].upper()
        q = Query()
        if sub == "SAVE":
            q.type = QueryType.DUMP_SAVE
            for t in tokens[2:]:
                if not t:
                    continue
                if t == "--with-stats":
                    q.dump_with_stats = True
                elif not t.startswith("-"):
                    q.filepath = t
                else:
                    raise QueryParseError(f"Unknown DUMP SAVE flag: {t}")
        elif sub in ("LOAD", "VERIFY", "INFO"):
            q.type = QueryType[f"DUMP_{sub}"]
            if len(tokens) > 2:
                q.filepath = tokens[2]
            else:
                raise QueryParseError(f"DUMP {sub} requires a filepath")
        elif sub == "STATUS":
            q.type = QueryType.DUMP_STATUS
        else:
            raise QueryParseError(f"Unknown DUMP subcommand: {tokens[1]}")
        return q

    def _parse_replication(self, tokens: List[str]) -> Query:
        if len(tokens) < 2:
            raise QueryParseError(
                "REPLICATION requires a subcommand (STATUS, STOP, START)")
        sub = tokens[1].upper()
        if sub not in ("STATUS", "STOP", "START"):
            raise QueryParseError(f"Unknown REPLICATION subcommand: {tokens[1]}")
        return Query(type=QueryType[f"REPLICATION_{sub}"])

    def _parse_sync(self, tokens: List[str]) -> Query:
        if len(tokens) == 1:
            return Query(type=QueryType.SYNC)
        sub = tokens[1].upper()
        if sub == "STATUS":
            return Query(type=QueryType.SYNC_STATUS)
        if sub == "STOP":
            q = Query(type=QueryType.SYNC_STOP)
            if len(tokens) > 2:
                q.table = tokens[2]
            return q
        return Query(type=QueryType.SYNC, table=tokens[1])

    def _parse_config(self, tokens: List[str]) -> Query:
        if len(tokens) == 1:
            return Query(type=QueryType.CONFIG_SHOW)
        sub = tokens[1].upper()
        q = Query()
        if sub == "HELP":
            q.type = QueryType.CONFIG_HELP
            if len(tokens) > 2:
                q.filepath = tokens[2]
        elif sub == "SHOW":
            q.type = QueryType.CONFIG_SHOW
            if len(tokens) > 2:
                q.filepath = tokens[2]
        elif sub == "VERIFY":
            q.type = QueryType.CONFIG_VERIFY
            if len(tokens) > 2:
                q.filepath = tokens[2]
            else:
                raise QueryParseError("CONFIG VERIFY requires a filepath")
        else:
            raise QueryParseError(
                f"Unknown CONFIG subcommand: {tokens[1]} "
                "(expected HELP, SHOW, or VERIFY)")
        return q

    def _parse_optimize(self, tokens: List[str]) -> Query:
        q = Query(type=QueryType.OPTIMIZE)
        if len(tokens) > 1:
            q.table = tokens[1]
        return q

    def _parse_debug(self, tokens: List[str]) -> Query:
        if len(tokens) < 2 or tokens[1].upper() not in ("ON", "OFF"):
            raise QueryParseError("DEBUG requires ON or OFF")
        return Query(type=QueryType.DEBUG_ON if tokens[1].upper() == "ON"
                     else QueryType.DEBUG_OFF)

    def _parse_cache(self, tokens: List[str]) -> Query:
        if len(tokens) < 2:
            raise QueryParseError(
                "CACHE requires a subcommand (CLEAR, STATS, ENABLE, DISABLE)")
        sub = tokens[1].upper()
        if sub == "CLEAR":
            q = Query(type=QueryType.CACHE_CLEAR)
            if len(tokens) > 2:
                q.table = tokens[2]
            return q
        if sub in ("STATS", "ENABLE", "DISABLE"):
            return Query(type=QueryType[f"CACHE_{sub}"])
        raise QueryParseError(f"Unknown CACHE subcommand: {tokens[1]}")

    def _parse_set(self, tokens: List[str]) -> Query:
        # SET var = value [, var2 = value2 ...] — re-join and split on commas
        raw = " ".join(tokens[1:])
        if not raw:
            raise QueryParseError("SET requires variable assignments")
        q = Query(type=QueryType.SET)
        for part in raw.split(","):
            if "=" not in part:
                raise QueryParseError(f"invalid SET syntax: {part.strip()}")
            name, value = part.split("=", 1)
            name = name.strip()
            value = value.strip()
            if not name:
                raise QueryParseError("SET requires a variable name")
            q.variable_assignments.append((name, value))
        return q

    def _parse_show(self, tokens: List[str]) -> Query:
        if len(tokens) < 2 or tokens[1].upper() != "VARIABLES":
            raise QueryParseError("SHOW requires VARIABLES")
        q = Query(type=QueryType.SHOW_VARIABLES)
        if len(tokens) > 2:
            if tokens[2].upper() == "LIKE":
                if len(tokens) < 4:
                    raise QueryParseError("SHOW VARIABLES LIKE requires a pattern")
                q.variable_like_pattern = tokens[3].strip("'\"")
            else:
                raise QueryParseError(
                    f"unexpected token after SHOW VARIABLES: {tokens[2]}")
        return q

    # explicit command table: never dispatch by attribute name (clause
    # helpers like _parse_sort must not be reachable as commands)
    _COMMANDS = {
        "SEARCH": _parse_search,
        "COUNT": _parse_count,
        "FACET": _parse_facet,
        "GET": _parse_get,
        "INFO": _parse_info,
        "SAVE": _parse_save,
        "LOAD": _parse_load,
        "DUMP": _parse_dump,
        "REPLICATION": _parse_replication,
        "SYNC": _parse_sync,
        "CONFIG": _parse_config,
        "OPTIMIZE": _parse_optimize,
        "DEBUG": _parse_debug,
        "CACHE": _parse_cache,
        "SET": _parse_set,
        "SHOW": _parse_show,
    }
